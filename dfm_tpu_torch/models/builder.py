"""Detector builder: a config's `model = dict(type=..., ...)` -> the
port's config dataclass.

Port of `dfm_tpu/models/builder.py:28-106` (`_mk_cfg`, `_build_dfm`,
`_build_dfm_full`, `_build_mvdfm`, `_build_fcos3d`, `_build_pgd`,
`_build_monoflex`, `_build_smoke`) for the types the port runs: `DfM` and
`DfMFull` give `DfMConfig`, `MultiViewDfM` gives `MVDfMConfig`,
`FCOSMono3D` `FCOS3DConfig`, `PGD` `PGDConfig` (their ResNet's depth is the
config's `backbone_depth`, 101 where it has none: `mono_backbone_depth`,
which `mono_model` builds with), `SMOKEMono3D` `SMOKEConfig` and `MonoFlex`
`MonoFlexConfig` (DLA-34, depth 34), `ImVoxelNet` `ImVoxelNetConfig`,
`VoxelNet` `VoxelNetConfig` and `DynamicVoxelNet` `DynamicVoxelNetConfig`
(`_build_voxelnet`, `_build_dynamic_voxelnet`; a `bbox_head` the port
does not run, 'shape_aware', raises NotImplementedError), `CenterPoint`
`CenterPointConfig` (its `head` dict a `CenterHeadConfig`), `SASSD`
`SASSDConfig`, `PointRCNN` `PointRCNNConfig`, `PartA2` `PartA2Config`,
`SSD3DNet` `SSD3DConfig`, `MVXFasterRCNN` and `DynamicMVXFasterRCNN`
`MVXConfig` (`_build_mvx` serves both), `VoteNet` `VoteNetConfig`,
`GroupFree3DNet` `GroupFree3DConfig`, `ImVoteNet` `ImVoteNetConfig` and
`H3DNet` `H3DNetConfig` (`_build_groupfree3d`, `_build_imvotenet`,
`_build_h3dnet`).
DfM and DfMFull evaluate the DfM student alone, so `build_detector`
gives the student's config for both; `atss_config` gives DfMFull's 2D
head its config from the model's `atss` entry, and the train CLI
(`tools/train.py`) builds `DfMFull` from the two and restores its teacher
from `teacher_checkpoint`. For DfM and DfMFull, keys that are no field of
`DfMConfig` are ignored by `build_detector`, as `_mk_cfg` ignores them;
`unused_keys` names them (for the repo's DfM configs: the type and
DfMFull's `atss` and `teacher_checkpoint`, which only training reads).
For the mono types `unused_keys` names the type alone in the repo's
configs (every other key is a field, or `backbone_depth`). The first
detector type of the JAX builder's registry that the port does not run is
`EncoderDecoder3D` (the segmentors). A
`MultiViewDfM` config with a key that is no field of `MVDfMConfig` is
refused (ValueError).
"""

import dataclasses

from .detectors.centerpoint import (CenterPoint, CenterPointConfig,
                                    centerpoint_predict)
from .detectors.dfm import DfMConfig
from .detectors.dynamic_voxelnet import (DynamicVoxelNet,
                                         DynamicVoxelNetConfig)
from .detectors.fcos_mono3d import FCOSMono3D
from .detectors.groupfree3d import (GroupFree3DConfig, GroupFree3DNet,
                                    groupfree3d_predict)
from .detectors.h3dnet import H3DNet, H3DNetConfig, h3dnet_predict
from .detectors.imvotenet import (ImVoteNet, ImVoteNetConfig,
                                  imvotenet_predict)
from .detectors.imvoxelnet import ImVoxelNetConfig
from .detectors.monoflex import MonoFlex
from .detectors.multiview_dfm import MVDfMConfig
from .detectors.mvx_two_stage import MVXConfig, MVXFasterRCNN, mvx_predict
from .detectors.parta2 import PartA2, PartA2Config, parta2_predict
from .detectors.pgd_mono3d import PGDMono3D
from .detectors.point_rcnn import (PointRCNN, PointRCNNConfig,
                                   point_rcnn_predict)
from .detectors.sassd import SASSD, SASSDConfig, sassd_predict
from .detectors.smoke import SMOKEConfig, SMOKEMono3D
from .detectors.ssd3d import SSD3DConfig, SSD3DNet, ssd3d_predict
from .detectors.votenet import VoteNet, VoteNetConfig, votenet_predict
from .detectors.voxelnet import (VoxelNet, VoxelNetConfig, check_bbox_head,
                                 voxelnet_predict)
from .heads.atss2d import ATSS2DConfig
from .heads.fcos_mono3d import FCOS3DConfig
from .heads.monoflex import MonoFlexConfig
from .heads.pgd import PGDConfig

__all__ = ['build_detector', 'atss_config', 'unused_keys', 'PORTED_TYPES',
           'MONO_TYPES', 'DLA_TYPES', 'LIDAR_TYPES', 'VOXELNET_TYPES',
           'MVX_TYPES', 'IMVOTE_TYPES', 'INDOOR_TYPES',
           'mono_backbone_depth', 'mono_class',
           'mono_model', 'lidar_class', 'lidar_predict']

DLA_TYPES = ('SMOKEMono3D', 'MonoFlex')
MONO_TYPES = ('FCOSMono3D', 'PGD') + DLA_TYPES
# the point-cloud detectors: infer(points, point_mask) (VoteNet's,
# GroupFree3D's and H3DNet's points indoor, the others' outdoor)
LIDAR_TYPES = ('VoxelNet', 'DynamicVoxelNet', 'CenterPoint', 'SASSD',
               'PointRCNN', 'PartA2', 'SSD3DNet', 'VoteNet', 'GroupFree3DNet',
               'H3DNet')
# indoor points, an image and its 2D boxes: infer(points, None, img,
# bboxes_2d, depth2img)
IMVOTE_TYPES = ('ImVoteNet',)
# the types that evaluate and train on the indoor datasets' points
INDOOR_TYPES = ('VoteNet', 'GroupFree3DNet', 'H3DNet')
# points and a camera image: infer(points, point_mask, img, lidar2img)
MVX_TYPES = ('MVXFasterRCNN', 'DynamicMVXFasterRCNN')
# the types whose config is a `VoxelNetConfig` (their anchor head's
# `bbox_head` checked)
VOXELNET_TYPES = ('VoxelNet', 'DynamicVoxelNet', 'SASSD', 'PartA2')
PORTED_TYPES = ('DfM', 'DfMFull', 'MultiViewDfM', 'ImVoxelNet') + \
    MONO_TYPES + LIDAR_TYPES + MVX_TYPES + IMVOTE_TYPES
_CONFIG_CLASSES = {'MultiViewDfM': MVDfMConfig, 'ImVoxelNet': ImVoxelNetConfig,
                   'VoxelNet': VoxelNetConfig,
                   'DynamicVoxelNet': DynamicVoxelNetConfig,
                   'CenterPoint': CenterPointConfig, 'SASSD': SASSDConfig,
                   'PointRCNN': PointRCNNConfig, 'PartA2': PartA2Config,
                   'SSD3DNet': SSD3DConfig, 'VoteNet': VoteNetConfig,
                   'GroupFree3DNet': GroupFree3DConfig,
                   'ImVoteNet': ImVoteNetConfig, 'H3DNet': H3DNetConfig,
                   'MVXFasterRCNN': MVXConfig,
                   'DynamicMVXFasterRCNN': MVXConfig,
                   'FCOSMono3D': FCOS3DConfig,
                   'PGD': PGDConfig, 'SMOKEMono3D': SMOKEConfig,
                   'MonoFlex': MonoFlexConfig}
_MONO_MODELS = {FCOS3DConfig: FCOSMono3D, PGDConfig: PGDMono3D,
                SMOKEConfig: SMOKEMono3D, MonoFlexConfig: MonoFlex}
# config class -> (detector module, its predict(outputs, cfg))
_LIDAR_MODELS = {VoxelNetConfig: (VoxelNet, voxelnet_predict),
                 DynamicVoxelNetConfig: (DynamicVoxelNet, voxelnet_predict),
                 SASSDConfig: (SASSD, sassd_predict),
                 CenterPointConfig: (CenterPoint, centerpoint_predict),
                 PointRCNNConfig: (PointRCNN, point_rcnn_predict),
                 PartA2Config: (PartA2, parta2_predict),
                 SSD3DConfig: (SSD3DNet, ssd3d_predict),
                 VoteNetConfig: (VoteNet, votenet_predict),
                 GroupFree3DConfig: (GroupFree3DNet, groupfree3d_predict),
                 ImVoteNetConfig: (ImVoteNet, imvotenet_predict),
                 H3DNetConfig: (H3DNet, h3dnet_predict),
                 MVXConfig: (MVXFasterRCNN, mvx_predict)}


def _mk_cfg(cls, d):
    """Dataclass `cls` from dict `d`, ignoring unknown keys; lists become
    tuples (of tuples), and a dict for a dataclass field (CenterPoint's
    `head`) that dataclass, as the JAX builder makes them."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        sub = fields[k].default_factory
        if hasattr(v, 'to_dict'):
            v = v.to_dict()
        if isinstance(v, dict) and dataclasses.is_dataclass(sub):
            v = _mk_cfg(sub, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)


def _as_dict(model_cfg):
    return model_cfg.to_dict() if hasattr(model_cfg, 'to_dict') \
        else dict(model_cfg)


def _config_class(kind):
    return _CONFIG_CLASSES.get(kind, DfMConfig)


def unused_keys(model_cfg):
    """The keys of `model_cfg` that `build_detector` ignores (a mono
    type's `backbone_depth` is read, by `mono_backbone_depth`)."""
    d = _as_dict(model_cfg)
    fields = {f.name for f in dataclasses.fields(
        _config_class(d.get('type')))}
    if d.get('type') in MONO_TYPES:
        fields.add('backbone_depth')
    return sorted(k for k in d if k not in fields)


def build_detector(model_cfg):
    """`model_cfg` (a dict or `Config` with a `type`) -> `DfMConfig`,
    `MVDfMConfig` for MultiViewDfM, `ImVoxelNetConfig` for ImVoxelNet,
    `VoxelNetConfig` / `DynamicVoxelNetConfig` / `SASSDConfig` for
    VoxelNet / DynamicVoxelNet / SASSD, `CenterPointConfig` for
    CenterPoint, `PointRCNNConfig` for PointRCNN, `PartA2Config` for
    PartA2, `SSD3DConfig` for SSD3DNet, `MVXConfig` for MVXFasterRCNN and
    DynamicMVXFasterRCNN, `VoteNetConfig` for VoteNet,
    `GroupFree3DConfig` / `ImVoteNetConfig` / `H3DNetConfig` for
    GroupFree3DNet / ImVoteNet / H3DNet,
    `FCOS3DConfig` / `PGDConfig` /
    `SMOKEConfig` / `MonoFlexConfig` for FCOSMono3D / PGD / SMOKEMono3D /
    MonoFlex. Raises NotImplementedError for a type
    the port does not run, ValueError for a MultiViewDfM key that is no
    field of `MVDfMConfig`."""
    d = _as_dict(model_cfg)
    if 'type' not in d:
        raise KeyError('model config has no type')
    kind = d['type']
    if kind not in PORTED_TYPES:
        raise NotImplementedError(
            f'model type {kind!r} is not ported to dfm_tpu_torch (ported: '
            f'{", ".join(PORTED_TYPES)})')
    if kind == 'MultiViewDfM':
        unknown = [k for k in unused_keys(d) if k != 'type']
        if unknown:
            raise ValueError(f'MultiViewDfM config keys that are no field '
                             f'of MVDfMConfig: {unknown}')
    cfg = _mk_cfg(_config_class(kind), d)
    if kind in VOXELNET_TYPES:
        check_bbox_head(cfg)
    return cfg


def atss_config(model_cfg):
    """DfMFull's `ATSS2DConfig` from the model config's `atss` dict
    (the defaults where it has none)."""
    atss = _as_dict(model_cfg).get('atss') or {}
    return _mk_cfg(ATSS2DConfig, _as_dict(atss))


def mono_backbone_depth(model_cfg):
    """The trunk depth of a mono config: `backbone_depth`, else 101 for the
    ResNet types (`_build_fcos3d`, `_build_pgd`) and 34 for the DLA ones."""
    d = _as_dict(model_cfg)
    return int(d.get('backbone_depth',
                     34 if d.get('type') in DLA_TYPES else 101))


def mono_class(cfg):
    """The detector module class of an `FCOS3DConfig` (`FCOSMono3D`), a
    `PGDConfig` (`PGDMono3D`), an `SMOKEConfig` (`SMOKEMono3D`) or a
    `MonoFlexConfig` (`MonoFlex`)."""
    return _MONO_MODELS[type(cfg)]


def mono_model(model_cfg):
    """The float32 mono detector module of a mono config (parameters not
    initialised; `utils/weights.py:init_weights` fills them)."""
    kind = _as_dict(model_cfg).get('type')
    if kind not in MONO_TYPES:
        raise ValueError(f'{kind!r} is no mono type ({MONO_TYPES})')
    cfg = build_detector(model_cfg)
    return mono_class(cfg)(cfg, mono_backbone_depth(model_cfg))


def lidar_class(cfg):
    """The detector module class of a LiDAR, MVX or ImVoteNet type's
    config (by its exact class: `SASSDConfig`, `DynamicVoxelNetConfig`
    and `MVXConfig` are `VoxelNetConfig`s, `ImVoteNetConfig` and
    `H3DNetConfig` `VoteNetConfig`s)."""
    return _LIDAR_MODELS[type(cfg)][0]


def lidar_predict(cfg):
    """The decode of a LiDAR type's config: predict(outputs, cfg) ->
    detections."""
    return _LIDAR_MODELS[type(cfg)][1]
