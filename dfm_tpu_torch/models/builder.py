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
does not run, 'shape_aware', raises NotImplementedError).
DfM and DfMFull evaluate the DfM student alone, so `build_detector`
gives the student's config for both; `atss_config` gives DfMFull's 2D
head its config from the model's `atss` entry, and the train CLI
(`tools/train.py`) builds `DfMFull` from the two and restores its teacher
from `teacher_checkpoint`. For DfM and DfMFull, keys that are no field of
`DfMConfig` are ignored by `build_detector`, as `_mk_cfg` ignores them;
`unused_keys` names them (for the repo's DfM configs: the type and
DfMFull's `atss` and `teacher_checkpoint`, which only training reads).
For the mono types `unused_keys` names the type alone in the repo's
configs (every other key is a field, or `backbone_depth`). The first type
of the JAX builder's registry that the port does not run is `CenterPoint`. A
`MultiViewDfM` config with a key that is no field of `MVDfMConfig` is
refused (ValueError).
"""

import dataclasses

from .detectors.dfm import DfMConfig
from .detectors.dynamic_voxelnet import DynamicVoxelNetConfig
from .detectors.fcos_mono3d import FCOSMono3D
from .detectors.imvoxelnet import ImVoxelNetConfig
from .detectors.monoflex import MonoFlex
from .detectors.multiview_dfm import MVDfMConfig
from .detectors.pgd_mono3d import PGDMono3D
from .detectors.smoke import SMOKEConfig, SMOKEMono3D
from .detectors.voxelnet import VoxelNetConfig, check_bbox_head
from .heads.atss2d import ATSS2DConfig
from .heads.fcos_mono3d import FCOS3DConfig
from .heads.monoflex import MonoFlexConfig
from .heads.pgd import PGDConfig

__all__ = ['build_detector', 'atss_config', 'unused_keys', 'PORTED_TYPES',
           'MONO_TYPES', 'DLA_TYPES', 'LIDAR_TYPES', 'mono_backbone_depth',
           'mono_class', 'mono_model']

DLA_TYPES = ('SMOKEMono3D', 'MonoFlex')
MONO_TYPES = ('FCOSMono3D', 'PGD') + DLA_TYPES
LIDAR_TYPES = ('VoxelNet', 'DynamicVoxelNet')
PORTED_TYPES = ('DfM', 'DfMFull', 'MultiViewDfM', 'ImVoxelNet') + \
    MONO_TYPES + LIDAR_TYPES
_CONFIG_CLASSES = {'MultiViewDfM': MVDfMConfig, 'ImVoxelNet': ImVoxelNetConfig,
                   'VoxelNet': VoxelNetConfig,
                   'DynamicVoxelNet': DynamicVoxelNetConfig,
                   'FCOSMono3D': FCOS3DConfig,
                   'PGD': PGDConfig, 'SMOKEMono3D': SMOKEConfig,
                   'MonoFlex': MonoFlexConfig}
_MONO_MODELS = {FCOS3DConfig: FCOSMono3D, PGDConfig: PGDMono3D,
                SMOKEConfig: SMOKEMono3D, MonoFlexConfig: MonoFlex}


def _mk_cfg(cls, d):
    """Dataclass `cls` from dict `d`, ignoring unknown keys; lists become
    tuples (of tuples), as the JAX builder makes them."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, list):
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
    `VoxelNetConfig` / `DynamicVoxelNetConfig` for VoxelNet /
    DynamicVoxelNet,
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
    if kind in LIDAR_TYPES:
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
