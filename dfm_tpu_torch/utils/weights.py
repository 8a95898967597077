"""Weights: the reference key map, flax -> port conversion, seeded init.

The port's modules carry the reference torch names, so the port's
`state_dict` keys are the torch prefixes of `dfm_key_map()` (a copy of
`dfm_tpu/utils/checkpoint_import.py:128-201`).
`state_dict_from_jax` applies the inverse of that importer's layout
rules (:27-34, :59-72):

  flax Conv (k..., I, O)                 -> torch (O, I, k...)
  flax Dense kernel (I, O) (kind 'linear') -> torch (O, I)
  flax attention DenseGeneral kernel (I, heads, head_dim) (kind
      'mha_in': query / key / value) -> torch (heads * head_dim, I), its
      bias (heads, head_dim) flattened; (heads, head_dim, O) (kind
      'mha_out': out) -> torch (O, heads * head_dim)
  flax ConvTranspose kernel[k..., i, o]  -> torch w[i, o, K-1-k...]
      (spatial flip: torch's transposed conv correlates with the flipped
      kernel)
  GroupNorm / BatchNorm / LayerNorm ('ln') scale, bias -> weight, bias
  BatchNorm batch_stats mean, var        -> running_mean, running_var
  a bare parameter (kind 'param': the mono heads' `scales`,
      `fuse_lambda`, `scale_kpts`, `scale_bbox2d`) -> the same array

`load_reference_state_dict` / `load_reference_checkpoint` load a
reference-layout torch checkpoint (the counterpart of the JAX
package's `import_dfm_state_dict`): its keys are already the port's.
"""

import math
import pickle

import numpy as np
import torch

from ..models.backbones.dla import DLA_CHANNELS, DLA_LEVELS
from ..models.backbones.resnet import BASIC_DEPTHS, STAGE_BLOCKS
from ..models.detectors.smoke import SMOKEConfig
from ..models.heads.center_head import HEATMAP_BIAS
from ..models.heads.monoflex import BRANCHES, MonoFlexConfig

__all__ = ['dfm_key_map', 'dfm_full_key_map', 'mvdfm_key_map',
           'imvoxelnet_key_map', 'voxelnet_key_map', 'centerpoint_key_map',
           'sassd_key_map', 'point_rcnn_key_map', 'parta2_key_map',
           'ssd3d_key_map', 'mvx_key_map', 'votenet_key_map',
           'groupfree3d_key_map', 'imvotenet_key_map', 'h3dnet_key_map',
           'dynamic_voxelnet_key_map', 'sparse_teacher_key_map',
           'dfm_with_teacher_key_map',
           'center_head_key_map', 'mono_key_map', 'fcos3d_head_key_map',
           'resnet_key_map', 'dla_key_map', 'dla_neck_key_map',
           'dla_mono_key_map', 'state_dict_from_jax',
           'teacher_state_dict', 'torch_conv_weight',
           'init_weights', 'load_reference_state_dict',
           'load_reference_checkpoint', 'read_checkpoint']


def _norm_mod(norm):
    return 'GroupNorm_0' if norm == 'gn' else 'BatchNorm_0'


def _convnorm(prefix, fpath, ndim, norm='gn'):
    return [(f'{prefix}.conv', fpath + ('Conv_0',), f'conv{ndim}d'),
            (f'{prefix}.{norm}', fpath + (_norm_mod(norm),), norm)]


def _convbn(prefix, fpath, ndim, norm='gn'):
    return [(f'{prefix}.0', fpath + ('Conv_0',), f'conv{ndim}d'),
            (f'{prefix}.1', fpath + (_norm_mod(norm),), norm)]


def _hourglass(prefix, fpath, ndim, norm='gn'):
    out = []
    out += _convbn(f'{prefix}.conv1.0', fpath + ('ConvNorm_0',), ndim, norm)
    out += _convbn(f'{prefix}.conv2', fpath + ('ConvNorm_1',), ndim, norm)
    out += _convbn(f'{prefix}.conv3.0', fpath + ('ConvNorm_2',), ndim, norm)
    out += _convbn(f'{prefix}.conv4.0', fpath + ('ConvNorm_3',), ndim, norm)
    for i, conv in ((0, 'conv5'), (1, 'conv6')):
        out += [(f'{prefix}.{conv}.0',
                 fpath + (f'ConvTransposeNorm_{i}', 'ConvTranspose_0'),
                 f'convt{ndim}d'),
                (f'{prefix}.{conv}.1',
                 fpath + (f'ConvTransposeNorm_{i}', _norm_mod(norm)), norm)]
    return out


def _resnet_basic(prefix, fpath, with_downsample):
    out = [(f'{prefix}.conv1', fpath + ('Conv_0',), 'conv2d'),
           (f'{prefix}.bn1', fpath + ('BatchNorm_0',), 'bn'),
           (f'{prefix}.conv2', fpath + ('Conv_1',), 'conv2d'),
           (f'{prefix}.bn2', fpath + ('BatchNorm_1',), 'bn')]
    if with_downsample:
        out += [(f'{prefix}.downsample.0', fpath + ('Conv_2',), 'conv2d'),
                (f'{prefix}.downsample.1', fpath + ('BatchNorm_2',), 'bn')]
    return out


def dfm_key_map(stage_blocks=(3, 4, 6, 3)):
    """(torch_prefix, flax_path, kind) for the DfM-R34 KITTI layout
    (`stage_blocks` (2, 2, 2, 2) for a ResNet-18 backbone). Only stage 2
    of the LIGA ResNet has a downsample branch."""
    m = [('backbone.conv1', ('backbone', 'Conv_0'), 'conv2d'),
         ('backbone.bn1', ('backbone', 'BatchNorm_0'), 'bn')]
    for li, nblocks in enumerate(stage_blocks, start=1):
        for b in range(nblocks):
            m += _resnet_basic(f'backbone.layer{li}.{b}',
                               ('backbone', f'layer{li}_block{b}'),
                               b == 0 and li == 2)
    for i in range(4):
        m += _convnorm(f'neck.spp_branches.{i}.1', ('neck', f'ConvNorm_{i}'),
                       2)
    for s in range(2):
        m += _convbn(f'neck.upconv_module.conv.{s}',
                     ('neck', 'UpconvModule_0', f'ConvNorm_{2 * s}'), 2, 'bn')
        m += _convbn(f'neck.upconv_module.redir.{s}',
                     ('neck', 'UpconvModule_0', f'ConvNorm_{2 * s + 1}'), 2,
                     'bn')
    m += _convnorm('neck.lastconv.0', ('neck', 'ConvNorm_4'), 2)
    m += [('neck.lastconv.1', ('neck', 'Conv_0'), 'conv2d')]
    m += _convnorm('neck.rpnconv.0', ('neck', 'ConvNorm_5'), 2)
    m += _convnorm('neck.rpnconv.1', ('neck', 'ConvNorm_6'), 2)
    bs = ('backbone_stereo',)
    m += _convnorm('backbone_stereo.dres0', bs + ('dres0_stereo',), 3)
    m += _convnorm('backbone_stereo.dres1', bs + ('dres1_stereo',), 3)
    m += _convnorm('backbone_stereo.dres0_mono', bs + ('dres0_mono',), 3)
    m += _convnorm('backbone_stereo.dres1_mono', bs + ('dres1_mono',), 3)
    m += _hourglass('backbone_stereo.hg_stereo.0', bs + ('hg_stereo_0',), 3)
    m += _hourglass('backbone_stereo.hg_mono.0', bs + ('hg_mono_0',), 3)
    for tag in ('stereo', 'mono'):
        fp = bs + (f'pred_{tag}',)
        m += _convnorm(f'backbone_stereo.pred_{tag}.0.0',
                       fp + ('ConvNorm_0',), 3)
        m += [(f'backbone_stereo.pred_{tag}.0.1', fp + ('Conv_0',),
               'conv3d')]
    m += [('backbone_stereo.aggregate_cost', bs + ('aggregate_cost',),
           'conv2d')]
    m += _convnorm('feature_transformation.voxel_convs.0.0',
                   ('feature_transformation', 'voxel_conv0'), 3)
    m += _convnorm('backbone_3d.compress_conv', ('backbone_3d', 'compress'),
                   2)
    m += _hourglass('backbone_3d.bev_hourglass', ('backbone_3d', 'hg'), 2)
    m += _liga_head('bbox_head_3d', ('bbox_head_3d',))
    return m


def _liga_head(prefix, fpath, num_convs=2):
    """A `LIGAAnchor3DHead` with `num_convs` GroupNorm ConvNorms a tower."""
    m = []
    for i in range(num_convs):
        m += _convnorm(f'{prefix}.cls_convs.{i}', fpath + (f'cls_conv{i}',),
                       2)
        m += _convnorm(f'{prefix}.reg_convs.{i}', fpath + (f'reg_conv{i}',),
                       2)
    return m + [(f'{prefix}.conv_cls', fpath + ('conv_cls',), 'conv2d'),
                (f'{prefix}.conv_reg', fpath + ('conv_reg',), 'conv2d'),
                (f'{prefix}.conv_dir_cls', fpath + ('conv_dir',), 'conv2d')]


def _lidar_teacher(prefix, fpath):
    """A dense `LidarTeacher`: enc0..2 (3D ConvNorm, BatchNorm) and its
    BEV hourglass."""
    m = []
    for i in range(3):
        m += _convnorm(f'{prefix}.enc{i}', fpath + (f'enc{i}',), 3, 'bn')
    m += _convnorm(f'{prefix}.bev.compress_conv', fpath + ('bev', 'compress'),
                   2, 'bn')
    return m + _hourglass(f'{prefix}.bev.bev_hourglass', fpath + ('bev', 'hg'),
                          2, 'bn')


SPARSE_ENCODER_LAYERS = (
    [('conv_input', 'bn_input'), ('enc0_0', 'bn0_0')] +
    [(f'enc{s}_{j}', f'bn{s}_{j}') for s in (1, 2, 3)
     for j in ('down', 1, 2)])


def sparse_teacher_key_map(prefix='', fpath=()):
    """(torch_prefix, flax_path, kind) for a JAX `SparseLidarTeacher`
    tree (the SECOND converter's): `middle_encoder`'s sparse kernels
    ('param': the (K, C_in, C_out) arrays as they are) and `SparseBN`s, and
    the BEV hourglass `bev` (BatchNorm)."""
    me, p = fpath + ('middle_encoder',), prefix + 'middle_encoder.'
    m = []
    for conv, bn in SPARSE_ENCODER_LAYERS:
        m += [(f'{p}{conv}.kernel', me + (conv, 'kernel'), 'param'),
              (f'{p}{bn}', me + (bn,), 'bn')]
    m += [(f'{p}conv_out.kernel', me + ('conv_out', 'kernel'), 'param')]
    m += _convnorm(f'{prefix}bev.compress_conv', fpath + ('bev', 'compress'),
                   2, 'bn')
    return m + _hourglass(f'{prefix}bev.bev_hourglass', fpath + ('bev', 'hg'),
                          2, 'bn')


def dfm_with_teacher_key_map(teacher_encoder='dense'):
    """The JAX `DfMWithTeacher` tree: the student `dfm`, the teacher
    `lidar_teacher` (dense or sparse) and the adapters."""
    m = [(f'dfm.{p}', ('dfm',) + f, k) for p, f, k in dfm_key_map()]
    m += sparse_teacher_key_map('lidar_teacher.', ('lidar_teacher',)) \
        if teacher_encoder == 'sparse' else \
        _lidar_teacher('lidar_teacher', ('lidar_teacher',))
    return m + [('imit_bev', ('imit_bev', 'Conv_0'), 'conv2d'),
                ('imit_vol', ('imit_vol', 'Conv_0'), 'conv3d')]


def voxelnet_key_map(prefix='', fpath=()):
    """(torch_prefix, flax_path, kind) for the JAX `VoxelNet` tree: the
    `LidarTeacher` `encoder` and the anchor head `bbox_head` (two
    GroupNorm towers); `prefix` / `fpath` put it under a parent (the
    `DynamicVoxelNet`'s 'voxelnet')."""
    return _lidar_teacher(prefix + 'encoder', fpath + ('encoder',)) + \
        _liga_head(prefix + 'bbox_head', fpath + ('bbox_head',))


def centerpoint_key_map(cfg):
    """(torch_prefix, flax_path, kind) for the JAX `CenterPoint` tree of
    config `cfg`: `enc0`, `enc1` (3D ConvNorm, BatchNorm), SECOND's
    `backbone.stage{s}_conv{i}`, SECONDFPN's `neck` (a level of stride >
    1: `deblock{i}_conv` and the neck's `BatchNorm_{j}`, j counting those
    levels; else the ConvNorm `deblock{i}`) and the CenterHead
    `bbox_head`."""
    m = _convnorm('enc0', ('enc0',), 3, 'bn') + \
        _convnorm('enc1', ('enc1',), 3, 'bn')
    for s, n in enumerate(cfg.second_layers):
        for i in range(n + 1):
            m += _convnorm(f'backbone.stage{s}_conv{i}',
                           ('backbone', f'stage{s}_conv{i}'), 2, 'bn')
    j = 0
    for i, st in enumerate(cfg.fpn_strides):
        if st > 1:
            m += [(f'neck.deblock{i}.conv', ('neck', f'deblock{i}_conv'),
                   'convt2d'),
                  (f'neck.deblock{i}.bn', ('neck', f'BatchNorm_{j}'), 'bn')]
            j += 1
        else:
            m += _convnorm(f'neck.deblock{i}', ('neck', f'deblock{i}'), 2,
                           'bn')
    return m + center_head_key_map('bbox_head', ('bbox_head',), cfg.head)


def sassd_key_map():
    """The JAX `SASSD` tree: `voxelnet_key_map`'s encoder and head, and
    the auxiliary branch's `point_fc`, `point_cls`, `point_reg` (Dense)."""
    return voxelnet_key_map() + [(k, (k,), 'linear') for k in (
        'point_fc', 'point_cls', 'point_reg')]


def _dense_key_map(module, prefix=''):
    """(torch_prefix, flax_path, kind) of every `Linear` ('linear'; in a
    `MultiHeadAttention` 'mha_in' for its query / key / value and
    'mha_out' for its out), `BatchNormLast` ('bn') and `LayerNorm` ('ln')
    of `module` whose torch path is the flax path (the point-set and
    transformer modules keep flax's names)."""
    from ..models.layers import (BatchNormLast, LayerNorm, Linear,
                                 MultiHeadAttention)
    attn = {n for n, mod in module.named_modules()
            if isinstance(mod, MultiHeadAttention)}
    m = []
    for name, mod in module.named_modules():
        kind = 'linear' if isinstance(mod, Linear) else \
            'bn' if isinstance(mod, BatchNormLast) else \
            'ln' if isinstance(mod, LayerNorm) else None
        if kind == 'linear' and name.rpartition('.')[0] in attn:
            kind = 'mha_out' if name.endswith('.out') else 'mha_in'
        if kind:
            m.append((prefix + name, tuple(name.split('.')), kind))
    return m


def point_rcnn_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `PointRCNN` tree of
    config `cfg`: the MSG `backbone`'s `sa{s}.mlp{i}_{j}` / `bn{i}_{j}`,
    the FP `neck`'s `fp{i}.mlp{j}` / `bn{j}`, the RPN and RCNN heads'
    `Linear`s and the RoI `SAModule`s, each under its flax name."""
    from ..models.detectors.point_rcnn import PointRCNN
    with torch.device('meta'):
        return _dense_key_map(PointRCNN(cfg))


def ssd3d_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `SSD3DNet` tree of
    config `cfg`: the MSG `backbone`'s `sa{s}.mlp{i}_{j}` / `bn{i}_{j}` /
    `aggregation` / `aggregation_bn`, the vote module (`vote_mlp`,
    `vote_bn`, `vote_out`), `vote_aggregation`'s MLPs, `shared{i}` /
    `shared_bn{i}` and the `cls*` / `reg*` heads, each under its flax
    name."""
    from ..models.detectors.ssd3d import SSD3DNet
    with torch.device('meta'):
        return _dense_key_map(SSD3DNet(cfg))


def votenet_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `VoteNet` tree of
    config `cfg`: the SSG `backbone`'s `sa{i}.mlp{j}` / `bn{j}`, `vote0`,
    `vote1`, `vote_out`, `prop0`, `prop1` and `head_out`."""
    from ..models.detectors.votenet import VoteNet
    with torch.device('meta'):
        return _dense_key_map(VoteNet(cfg))


def groupfree3d_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `GroupFree3DNet` tree
    of config `cfg`: the SSG `backbone`'s `sa{i}` / `fp{j}` MLPs, the KPS
    `points_obj_*`, the heads `head_proposal` / `head_s{i}`, the query
    and key projections and position embeddings and the `decoder{i}`
    layers (`self_attn` / `cross_attn` query, key, value, out; `norm0..2`
    LayerNorms; `ffn0`, `ffn1`)."""
    from ..models.detectors.groupfree3d import GroupFree3DNet
    with torch.device('meta'):
        return _dense_key_map(GroupFree3DNet(cfg))


def h3dnet_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `H3DNet` tree of
    config `cfg`: `backbone{t}` (SSG), `fuse`, the `rpn` tower, the
    `prim_{z,xy,line}` heads, the matching (`match_surf`, `match_line`,
    `cue_obj`, `cue_sem`, or `match0`) and `ref0`, `ref1`, `ref_out`."""
    from ..models.detectors.h3dnet import H3DNet
    with torch.device('meta'):
        return _dense_key_map(H3DNet(cfg))


def _liga_resnet(prefix, fpath, model):
    """A port BatchNorm `LIGAResNet` `model` (any strides, factors and
    stages) under `prefix`, JAX's at `fpath`: the stem and each block,
    with its downsample branch where the model has one."""
    m = [(f'{prefix}.conv1', fpath + ('Conv_0',), 'conv2d'),
         (f'{prefix}.bn1', fpath + ('BatchNorm_0',), 'bn')]
    for li in range(1, len(model.out_channels) + 1):
        for b, block in enumerate(getattr(model, f'layer{li}')):
            m += _resnet_basic(f'{prefix}.layer{li}.{b}',
                               fpath + (f'layer{li}_block{b}',),
                               block.downsample is not None)
    return m


def imvotenet_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `ImVoteNet` tree of
    config `cfg`: the SSG `backbone`, `img_mlp`, the `joint` / `pts` /
    `img` towers and, with the image branch, `img_backbone` (the plain
    ResNet-18 form of `LIGAResNet`), the FPN `img_neck` (lateral0..2,
    fpn_conv0..2, extra_conv3..4) and the ATSS `img_bbox_head` (one
    GroupNorm conv a tower, atss_cls / atss_reg / atss_centerness)."""
    from ..models.detectors.imvotenet import ImVoteNet
    with torch.device('meta'):
        model = ImVoteNet(cfg)
    m = _dense_key_map(model)
    if not model.cfg.with_img_branch:
        return m
    m += _liga_resnet('img_backbone', ('img_backbone',), model.img_backbone)
    n = ('img_neck',)
    for i in range(model.img_neck.num_ins):
        m += [(f'img_neck.lateral{i}', n + (f'lateral{i}',), 'conv2d'),
              (f'img_neck.fpn_conv{i}', n + (f'fpn_conv{i}',), 'conv2d')]
    m += [(f'img_neck.extra_conv{j}', n + (f'extra_conv{j}',), 'conv2d')
          for j in range(model.img_neck.num_ins, model.img_neck.num_outs)]
    h = ('img_bbox_head',)
    for i in range(model.img_bbox_head.stacked_convs):
        for tower in ('cls_tower', 'reg_tower'):
            m += _convnorm(f'img_bbox_head.{tower}{i}', h + (f'{tower}{i}',),
                           2)
    return m + [(f'img_bbox_head.{k}', h + (k,), 'conv2d')
                for k in ('atss_cls', 'atss_reg', 'atss_centerness')]


def mvx_key_map(cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `MVXFasterRCNN` tree of
    config `cfg`: the ResNet `img_backbone`, the FPN `img_neck` (lateral0..3,
    fpn_conv0..3, extra_conv4), the PointFusion `fuse0`, `fuse1` (Dense),
    the `LidarTeacher` `pts_encoder` and the anchor head `bbox_head` (two
    GroupNorm towers)."""
    from ..models.detectors.mvx_two_stage import MVXConfig
    cfg = cfg or MVXConfig()
    m = resnet_key_map('img_backbone', ('img_backbone',),
                       cfg.img_backbone_depth)
    n = ('img_neck',)
    for i in range(4):
        m += [(f'img_neck.lateral{i}', n + (f'lateral{i}',), 'conv2d'),
              (f'img_neck.fpn_conv{i}', n + (f'fpn_conv{i}',), 'conv2d')]
    m += [('img_neck.extra_conv4', n + ('extra_conv4',), 'conv2d')]
    m += [(k, (k,), 'linear') for k in ('fuse0', 'fuse1')]
    return m + _lidar_teacher('pts_encoder', ('pts_encoder',)) + \
        _liga_head('bbox_head', ('bbox_head',))


PARTA2_UNET_LAYERS = ('enc0', 'enc0b', 'down0', 'enc1', 'down1', 'enc2',
                      'up1', 'dec1', 'up0', 'dec0')
PARTA2_UNET_NORMS = ('bn0', 'bn0b', 'bn_down0', 'bn_enc1', 'bn_down1',
                     'bn_enc2', 'bn_up1', 'bn_dec1', 'bn_up0', 'bn_dec0')


def parta2_key_map():
    """(torch_prefix, flax_path, kind) for the JAX `PartA2` tree: the
    sparse U-Net `unet` (kernels 'param', `SparseBN`s), `seg_cls`,
    `part_reg` (Dense), `bev_stem` (conv) with its GroupNorm `bev_gn`, the
    anchor head `rpn_head` (two GroupNorm towers), `roi_conv0..1` (3D
    conv) and the Dense `roi_fc0`, `roi_fc1`, `roi_cls`, `roi_reg`."""
    m = [(f'unet.{k}.kernel', ('unet', k, 'kernel'), 'param')
         for k in PARTA2_UNET_LAYERS]
    m += [(f'unet.{k}', ('unet', k), 'bn') for k in PARTA2_UNET_NORMS]
    m += [(k, (k,), 'linear') for k in ('seg_cls', 'part_reg')]
    m += [('bev_stem', ('bev_stem',), 'conv2d'), ('bev_gn', ('bev_gn',), 'gn')]
    m += _liga_head('rpn_head', ('rpn_head',))
    m += [(f'roi_conv{i}', (f'roi_conv{i}',), 'conv3d') for i in (0, 1)]
    return m + [(k, (k,), 'linear') for k in ('roi_fc0', 'roi_fc1',
                                              'roi_cls', 'roi_reg')]


def dynamic_voxelnet_key_map():
    """The JAX `DynamicVoxelNet` tree: a `VoxelNet` under 'voxelnet'."""
    return voxelnet_key_map('voxelnet.', ('voxelnet',))


def dfm_full_key_map(stacked_convs=4):
    """(torch_prefix, flax_path, kind) for the JAX `DfMFull` tree
    (DfM-R34): the student's `dfm_key_map` under 'dfm', the FPN `neck_2d`
    (one input, five outputs), the ATSS head `bbox_head_2d`
    (`stacked_convs` per tower), the teacher `lidar_teacher` (enc0..2 and
    its BEV hourglass, BatchNorm) and the adapters `imit_bev` (1x1) and
    `imit_vol` (1x1x1)."""
    m = [(f'dfm.{p}', ('dfm',) + f, k) for p, f, k in dfm_key_map()]
    n = ('neck_2d',)
    m += [('neck_2d.lateral0', n + ('lateral0',), 'conv2d'),
          ('neck_2d.fpn_conv0', n + ('fpn_conv0',), 'conv2d')]
    m += [(f'neck_2d.extra_conv{j}', n + (f'extra_conv{j}',), 'conv2d')
          for j in range(1, 5)]
    h = ('bbox_head_2d',)
    for i in range(stacked_convs):
        for tower in ('cls_tower', 'reg_tower'):
            m += _convnorm(f'bbox_head_2d.{tower}{i}', h + (f'{tower}{i}',),
                           2)
    m += [(f'bbox_head_2d.{k}', h + (k,), 'conv2d')
          for k in ('atss_cls', 'atss_reg', 'atss_centerness')]
    m += _lidar_teacher('lidar_teacher', ('lidar_teacher',))
    m += [('imit_bev', ('imit_bev', 'Conv_0'), 'conv2d'),
          ('imit_vol', ('imit_vol', 'Conv_0'), 'conv3d')]
    return m


def _dcn(prefix, fpath):
    """A `DeformConv2d` (flax: its 'kernel' and its `conv_offset` Conv)."""
    return [(prefix, fpath, 'conv2d'),
            (f'{prefix}.conv_offset', fpath + ('conv_offset',), 'conv2d')]


def resnet_key_map(prefix, fpath, depth, stage_with_dcn=(False,) * 4):
    """(torch_prefix, flax_path, kind) of a standard ResNet
    (`models/backbones/resnet.py`, flax `dfm_tpu/models/backbones/
    resnet.py`): the stem Conv_0 / BatchNorm_0, then per block the flax
    auto-names in call order, Conv_i / BatchNorm_i for conv{i+1} /
    bn{i+1} and the next index for the downsample branch of the first
    block of a stage whose stride or width changes. In a stage of
    `stage_with_dcn` the 3x3 conv is the named `DeformConv2d`
    (`conv2_dcn` of a Bottleneck, `conv1_dcn` of a BasicBlock) and the
    convs after it take the Conv indices one lower."""
    basic = depth in BASIC_DEPTHS
    nconv = 2 if basic else 3
    at = 0 if basic else 1          # the 3x3 conv that DCN replaces
    m = [(f'{prefix}.conv1', fpath + ('Conv_0',), 'conv2d'),
         (f'{prefix}.bn1', fpath + ('BatchNorm_0',), 'bn')]
    for li, nblocks in enumerate(STAGE_BLOCKS[depth], start=1):
        dcn = stage_with_dcn[li - 1]
        for b in range(nblocks):
            t = f'{prefix}.layer{li}.{b}'
            f = fpath + (f'layer{li}_block{b}',)
            for i in range(nconv):
                if dcn and i == at:
                    m += _dcn(f'{t}.conv{i + 1}', f + (f'conv{i + 1}_dcn',))
                else:
                    j = i - int(dcn and i > at)
                    m += [(f'{t}.conv{i + 1}', f + (f'Conv_{j}',), 'conv2d')]
                m += [(f'{t}.bn{i + 1}', f + (f'BatchNorm_{i}',), 'bn')]
            # every first block but ResNet-18/34's layer1 projects
            if b == 0 and not (basic and li == 1):
                m += [(f'{t}.downsample.0', f + (f'Conv_{nconv - dcn}',),
                       'conv2d'),
                      (f'{t}.downsample.1', f + (f'BatchNorm_{nconv}',),
                       'bn')]
    return m


def _conv_bn(prefix, fpath):
    """A conv + BatchNorm pair that flax auto-names Conv_0 /
    BatchNorm_0 (DLA's `_ConvNormRelu`, `Root`)."""
    return [(f'{prefix}.conv', fpath + ('Conv_0',), 'conv2d'),
            (f'{prefix}.bn', fpath + ('BatchNorm_0',), 'bn')]


def _dla_tree(prefix, fpath, levels, cin, ch):
    m = []
    if cin != ch:
        m += [(f'{prefix}.project.0', fpath + ('project',), 'conv2d'),
              (f'{prefix}.project.1', fpath + ('BatchNorm_0',), 'bn')]
    if levels > 1:
        return m + _dla_tree(f'{prefix}.tree1', fpath + ('tree1',),
                             levels - 1, cin, ch) + \
            _dla_tree(f'{prefix}.tree2', fpath + ('tree2',), levels - 1, ch,
                      ch)
    for tree in ('tree1', 'tree2'):
        for i in range(2):
            sub = fpath + (tree, f'_ConvNormRelu_{i}')
            m += [(f'{prefix}.{tree}.conv{i + 1}', sub + ('Conv_0',),
                   'conv2d'),
                  (f'{prefix}.{tree}.bn{i + 1}', sub + ('BatchNorm_0',),
                   'bn')]
    return m + _conv_bn(f'{prefix}.root', fpath + ('root',))


def dla_key_map(prefix='backbone', fpath=('backbone',)):
    """(torch_prefix, flax_path, kind) of the JAX `DLANet` (DLA-34):
    base_layer, level0, level1 (`_ConvNormRelu`), level2..5 (`Tree`s:
    `project` with the Tree's BatchNorm_0, tree1 / tree2, root)."""
    m = []
    for name in ('base_layer', 'level0', 'level1'):
        m += _conv_bn(f'{prefix}.{name}', fpath + (name,))
    for i in range(4):
        m += _dla_tree(f'{prefix}.level{i + 2}', fpath + (f'level{i + 2}',),
                       DLA_LEVELS[i + 2], DLA_CHANNELS[i + 1],
                       DLA_CHANNELS[i + 2])
    return m


def dla_neck_key_map(prefix='neck', fpath=('neck',), use_dcn=True):
    """(torch_prefix, flax_path, kind) of the JAX `DLANeck` over levels 2-5:
    dla_up0..2 (k + 1 proj / node pairs) and ida_up (2), each `_ProjNode`
    its `dcn` (or Conv_0 with a bias) and BatchNorm_0."""
    m = []
    for name, n in (('dla_up0', 1), ('dla_up1', 2), ('dla_up2', 3),
                    ('ida_up', 2)):
        for i in range(n):
            for part in (f'proj{i}', f'node{i}'):
                t, f = f'{prefix}.{name}.{part}', fpath + (name, part)
                m += _dcn(f'{t}.dcn', f + ('dcn',)) if use_dcn else \
                    [(f'{t}.conv', f + ('Conv_0',), 'conv2d')]
                m += [(f'{t}.bn', f + ('BatchNorm_0',), 'bn')]
    return m


def dla_mono_key_map(cfg):
    """(torch_prefix, flax_path, kind) of the JAX `SMOKEMono3D` (an
    `SMOKEConfig`) or `MonoFlex` (a `MonoFlexConfig`) tree: `dla_key_map`,
    `dla_neck_key_map` (SMOKE's `use_dcn_neck`; MonoFlex always DCN), the
    head's branches ({name}_conv, GroupNorm_<i> in branch order,
    {name}_out) and, with MonoFlex's edge fusion, edge_cls / edge_offset
    (edge_conv, BatchNorm_0, edge_out: 1D convs)."""
    smoke = isinstance(cfg, SMOKEConfig)
    m = dla_key_map() + dla_neck_key_map(
        use_dcn=cfg.use_dcn_neck if smoke else True)
    h = ('bbox_head',)
    for i, name in enumerate(('cls', 'reg') if smoke else BRANCHES):
        m += [(f'bbox_head.{name}_conv', h + (f'{name}_conv',), 'conv2d'),
              (f'bbox_head.{name}_gn', h + (f'GroupNorm_{i}',), 'gn'),
              (f'bbox_head.{name}_out', h + (f'{name}_out',), 'conv2d')]
    if not smoke and cfg.use_edge_fusion:
        for e in ('edge_cls', 'edge_offset'):
            m += [(f'bbox_head.{e}.edge_conv', h + (e, 'edge_conv'),
                   'conv1d'),
                  (f'bbox_head.{e}.edge_bn', h + (e, 'BatchNorm_0'), 'bn'),
                  (f'bbox_head.{e}.edge_out', h + (e, 'edge_out'), 'conv1d')]
    return m


def mvdfm_key_map(depth=101, cfg=None):
    """(torch_prefix, flax_path, kind) for the JAX `MultiViewDfM` tree of
    `cfg` (an `MVDfMConfig`; the camsync one if None): the ResNet
    `backbone`, the FPN `neck` (lateral0..3, fpn_conv0..3); with the 3D
    backbone `backbone_3d_block{i}` (ConvNorm_0..1), with the depth head
    `depth_pred` (ConvNorm_0 with GroupNorm, the scalar Conv_0); the 3D
    neck: `OutdoorImVoxelNeck` (res{i}/ConvNorm_0..1, down{i}) or `DfMNeck`
    ({mono,stereo}_res{i}, _down{i}, _final_conv, the final BatchNorms
    flax auto-names BatchNorm_0 (mono) and BatchNorm_1 (stereo), and
    aggregate_layer); the head: the anchor head's three output convs, or
    the CenterHead's shared_conv and task{t} branches ({name}_conv{i}
    ConvNorms with bias, {name}_final). `depth` is the backbone's
    (`cfg.backbone_depth` is not read)."""
    from ..models.detectors.multiview_dfm import MVDfMConfig, center_config
    cfg = cfg or MVDfMConfig()
    m = _resnet_fpn(depth)
    if cfg.with_backbone_3d:
        for i in range(cfg.num_backbone_3d_blocks):
            for j in range(2):
                m += _convnorm(f'backbone_3d_block{i}.conv{j}',
                               (f'backbone_3d_block{i}', f'ConvNorm_{j}'), 3,
                               'bn')
    if cfg.with_depth_head:
        m += _convnorm('depth_pred.0', ('depth_pred', 'ConvNorm_0'), 3)
        m += [('depth_pred.1', ('depth_pred', 'Conv_0'), 'conv3d')]
    if cfg.neck_3d == 'dfm':
        n = ('neck_3d',)
        for bn, tag in enumerate(('mono', 'stereo')):
            for i in range(3):
                for j in range(2):
                    m += _convnorm(f'neck_3d.{tag}_res{i}.conv{j}',
                                   n + (f'{tag}_res{i}', f'ConvNorm_{j}'), 3,
                                   'bn')
            for i in range(2):
                m += _convnorm(f'neck_3d.{tag}_down{i}',
                               n + (f'{tag}_down{i}',), 3, 'bn')
            m += [(f'neck_3d.{tag}_final_conv', n + (f'{tag}_final_conv',),
                   'conv3d'),
                  (f'neck_3d.{tag}_final_bn', n + (f'BatchNorm_{bn}',), 'bn')]
        m += [('neck_3d.aggregate_layer', n + ('aggregate_layer',),
               'conv2d')]
    else:
        m += _imvoxel_neck()
    if cfg.bbox_head == 'center':
        m += center_head_key_map('bbox_head_3d', ('bbox_head_3d',),
                                 center_config(cfg))
    else:
        m += _anchor_head('bbox_head_3d')
    return m


def _resnet_fpn(depth):
    """A ResNet `backbone` of `depth` and its four-level FPN `neck`."""
    m = resnet_key_map('backbone', ('backbone',), depth)
    for i in range(4):
        m += [(f'neck.lateral{i}', ('neck', f'lateral{i}'), 'conv2d'),
              (f'neck.fpn_conv{i}', ('neck', f'fpn_conv{i}'), 'conv2d')]
    return m


def _imvoxel_neck():
    """`OutdoorImVoxelNeck` under `neck_3d` (res{i}/ConvNorm_0..1,
    down{i})."""
    m, n = [], ('neck_3d',)
    for i in range(3):
        for j in range(2):
            m += _convnorm(f'neck_3d.res{i}.conv{j}',
                           n + (f'res{i}', f'ConvNorm_{j}'), 3, 'bn')
        m += _convnorm(f'neck_3d.down{i}', n + (f'down{i}',), 3, 'bn')
    return m


def _anchor_head(name):
    """The three output convs of an anchor head without towers."""
    return [(f'{name}.conv_cls', (name, 'conv_cls'), 'conv2d'),
            (f'{name}.conv_reg', (name, 'conv_reg'), 'conv2d'),
            (f'{name}.conv_dir_cls', (name, 'conv_dir'), 'conv2d')]


def imvoxelnet_key_map(depth=50):
    """(torch_prefix, flax_path, kind) for the JAX `ImVoxelNet` tree: the
    ResNet `backbone` of `depth`, the FPN `neck` (lateral0..3,
    fpn_conv0..3), the `OutdoorImVoxelNeck` `neck_3d` and the anchor
    head `bbox_head`'s three output convs."""
    return _resnet_fpn(depth) + _imvoxel_neck() + _anchor_head('bbox_head')


def center_head_key_map(prefix, fpath, ccfg):
    """(torch_prefix, flax_path, kind) of a `CenterHead` of config
    `ccfg` under `prefix` / `fpath`: `shared_conv`, then per task the
    branches' `{name}_conv{i}` (ConvNorm with bias, BatchNorm) and
    `{name}_final`."""
    m = _convnorm(f'{prefix}.shared_conv', fpath + ('shared_conv',), 2, 'bn')
    for t in range(ccfg.num_tasks):
        for name, _, num_conv in ccfg.heads(t):
            for i in range(num_conv - 1):
                m += _convnorm(f'{prefix}.task{t}.{name}_conv{i}',
                               fpath + (f'task{t}', f'{name}_conv{i}'), 2,
                               'bn')
            m += [(f'{prefix}.task{t}.{name}_final',
                   fpath + (f'task{t}', f'{name}_final'), 'conv2d')]
    return m


def fcos3d_head_key_map(prefix, fpath, cfg):
    """(torch_prefix, flax_path, kind) of an `FCOSMono3DHead` of config
    `cfg` under `prefix` / `fpath`: the towers (GroupNorm ConvNorms), the
    four output convs, the attribute branch with `pred_attrs`, `scales`."""
    m = []
    for i in range(cfg.stacked_convs):
        for branch in ('cls', 'reg'):
            m += _convnorm(f'{prefix}.{branch}_tower{i}',
                           fpath + (f'{branch}_tower{i}',), 2)
    m += [(f'{prefix}.{k}', fpath + (k,), 'conv2d')
          for k in ('conv_cls', 'conv_reg', 'conv_dir', 'conv_centerness')]
    if cfg.pred_attrs:
        m += _convnorm(f'{prefix}.attr_tower0', fpath + ('attr_tower0',), 2)
        m += [(f'{prefix}.conv_attr', fpath + ('conv_attr',), 'conv2d')]
    return m + [(f'{prefix}.scales', fpath + ('scales',), 'param')]


def mono_key_map(cfg, depth=101, pgd=None):
    """(torch_prefix, flax_path, kind) of the JAX `FCOSMono3D` or
    `PGDMono3D` tree of config `cfg` (PGD when `pgd`, or when `cfg` is a
    `PGDConfig` if None): the ResNet `backbone`, the FPN `neck` from
    stage 1 (lateral0..2, fpn_conv0..2, extra_conv3..4), the head
    `bbox_head` (PGD: FCOS3D's under `bbox_head/fcos3d`, then the depth
    classifier, the weights, `fuse_lambda`, the keypoint and 2D box
    branches with their scales); `dla_mono_key_map` for an `SMOKEConfig`
    or a `MonoFlexConfig` (`depth` not read)."""
    if isinstance(cfg, (SMOKEConfig, MonoFlexConfig)):
        return dla_mono_key_map(cfg)
    if pgd is None:
        pgd = hasattr(cfg, 'num_depth_cls')
    m = resnet_key_map('backbone', ('backbone',), depth)
    for i in range(3):
        m += [(f'neck.lateral{i}', ('neck', f'lateral{i}'), 'conv2d'),
              (f'neck.fpn_conv{i}', ('neck', f'fpn_conv{i}'), 'conv2d')]
    m += [(f'neck.extra_conv{j}', ('neck', f'extra_conv{j}'), 'conv2d')
          for j in (3, 4)]
    h = ('bbox_head',)
    if not pgd:
        return m + fcos3d_head_key_map('bbox_head', h, cfg)
    m += fcos3d_head_key_map('bbox_head.fcos3d', h + ('fcos3d',), cfg)
    if not cfg.use_depth_classifier:
        return m
    for i in range(len(cfg.depth_branch)):
        m += _convnorm(f'bbox_head.depth_cls_prev{i}',
                       h + (f'depth_cls_prev{i}',), 2)
    m += [('bbox_head.conv_depth_cls', h + ('conv_depth_cls',), 'conv2d')]
    m += [(f'bbox_head.conv_weight{i}', h + (f'conv_weight{i}',), 'conv2d')
          for i in range(cfg.weight_dim)]
    m += [('bbox_head.fuse_lambda', h + ('fuse_lambda',), 'param')]
    for on, name in ((cfg.pred_keypoints, 'kpts'),
                     (cfg.pred_bbox2d, 'bbox2d')):
        if on:
            m += [(f'bbox_head.conv_{name}', h + (f'conv_{name}',), 'conv2d'),
                  (f'bbox_head.scale_{name}', h + (f'scale_{name}',),
                   'param')]
    return m


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _conv_weight(kernel, kind):
    k = np.asarray(kernel, np.float32)
    nsp = k.ndim - 2
    if kind.startswith('convt'):
        # (k..., I, O) -> (I, O, k...), spatially flipped
        w = k.transpose((nsp, nsp + 1) + tuple(range(nsp)))
        return w[(slice(None), slice(None)) + (slice(None, None, -1),) * nsp]
    return k.transpose((nsp + 1, nsp) + tuple(range(nsp)))


def torch_conv_weight(kernel):
    """One flax Conv kernel (k..., I, O), e.g. the JAX (3, 3, 3, C, C_out)
    conv3d weights, -> the port's float32 tensor (O, I, k...), the layout
    of `state_dict_from_jax` and of every conv of the port."""
    return torch.from_numpy(np.ascontiguousarray(_conv_weight(kernel,
                                                              'conv')))


def state_dict_from_jax(variables, key_map=None):
    """The port's state_dict from a flax {'params', 'batch_stats'} tree
    of numpy arrays (every leaf of `key_map` must exist; a tree without
    'batch_stats' gives no BatchNorm running statistics)."""
    key_map = dfm_key_map() if key_map is None else key_map
    params = variables['params']
    stats = variables.get('batch_stats')
    sd = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, np.float32))

    for prefix, fpath, kind in key_map:
        node = _get(params, fpath)
        if kind == 'param':
            put(prefix, node)
        elif kind.startswith('conv') or kind == 'linear':
            put(f'{prefix}.weight', _conv_weight(node['kernel'], kind))
            if 'bias' in node:
                put(f'{prefix}.bias', node['bias'])
        elif kind.startswith('mha'):
            k = np.asarray(node['kernel'])
            k = k.reshape(k.shape[0], -1) if kind == 'mha_in' else \
                k.reshape(-1, k.shape[-1])
            put(f'{prefix}.weight', k.T)
            put(f'{prefix}.bias', np.asarray(node['bias']).reshape(-1))
        else:
            put(f'{prefix}.weight', node['scale'])
            put(f'{prefix}.bias', node['bias'])
            if kind == 'bn' and stats is not None:
                st = _get(stats, fpath)
                put(f'{prefix}.running_mean', st['mean'])
                put(f'{prefix}.running_var', st['var'])
    return sd


def teacher_state_dict(tree, encoder='dense'):
    """The state dict of a teacher (keys relative to it) from a teacher
    file's tree, JAX's restore (`tools/train.py:521-537`): its 'params'
    are the teacher's parameters, its 'batch_stats', when present and not
    empty, the running statistics (else none are given). `encoder`
    'dense' reads a `LidarTeacher` tree (enc0..2, bev), 'sparse' a
    `SparseLidarTeacher` tree (the SECOND converter's: middle_encoder,
    bev). Raises KeyError naming every parameter group the tree lacks (a
    sparse tree has no enc0, enc1, enc2; a dense one no middle_encoder)."""
    if encoder == 'sparse':
        entries = sparse_teacher_key_map()
    else:
        entries = [(p[len('lidar_teacher.'):], f[1:], k)
                   for p, f, k in dfm_full_key_map()
                   if f[0] == 'lidar_teacher']
    params = tree.get('params') if isinstance(tree, dict) else None
    if not isinstance(params, dict):
        raise KeyError("the teacher file holds no 'params' tree")

    def has(t, path):
        for k in path:
            if not isinstance(t, dict) or k not in t:
                return False
            t = t[k]
        return True

    missing = sorted({'/'.join(f[:-1] if k == 'param' else f)
                      for _, f, k in entries if not has(params, f)})
    if missing:
        kind = 'SparseLidarTeacher' if encoder == 'sparse' else \
            'dense LidarTeacher'
        raise KeyError(f'the teacher file is not a {kind} tree: '
                       f'{len(missing)} parameter groups missing: {missing} '
                       f'(its params hold {sorted(params)})')
    stats = tree.get('batch_stats') or None
    return state_dict_from_jax(
        {'params': params} if stats is None else
        {'params': params, 'batch_stats': stats}, entries)


def init_weights(model, seed=0):
    """Fill every parameter and buffer of `model` from a `torch.Generator`
    (CPU) seeded with `seed`: conv weights normal with std
    1/sqrt(weight[0].numel()) (lecun-normal for a conv), conv biases 0,
    norms weight 1 / bias 0, BN running stats (0, 1), a sparse conv's
    (K, I, O) kernel std 1/sqrt(K * I), the mono heads'
    scales 1 and `fuse_lambda` 1e-4 (the JAX initialisers), DCNv2's
    `conv_offset` 0 (its offsets and mask logits start at 0), the focal
    prior of the anchor head's cls conv (std 0.01, bias
    -log(99)) and the CenterHead's heatmap bias (-2.19). Touches no global
    RNG."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in list(model.named_parameters()) + \
            list(model.named_buffers()):
        leaf = name.rsplit('.', 1)[-1]
        with torch.no_grad():
            if leaf == 'fuse_lambda':
                val = torch.full(t.shape, 1e-4)
            elif leaf in ('scales', 'scale_kpts', 'scale_bbox2d'):
                val = torch.ones(t.shape)
            elif leaf == 'running_mean' or (leaf == 'bias' and
                                            t.dim() == 1):
                val = torch.zeros(t.shape)
            elif leaf == 'running_var' or t.dim() == 1:
                val = torch.ones(t.shape)
            elif leaf == 'kernel':    # a sparse conv's (K, I, O)
                val = torch.randn(t.shape, generator=gen) / \
                    math.sqrt(t.numel() // t.shape[-1])
            else:       # conv (O, I, k...) / transposed conv (I, O, k...)
                val = torch.randn(t.shape, generator=gen) / \
                    math.sqrt(t[0].numel())
            if '.conv_offset.' in name or name.startswith('conv_offset.'):
                val = torch.zeros(t.shape)
            elif name.endswith('conv_cls.weight'):
                val = torch.randn(t.shape, generator=gen) * 0.01
            elif name.endswith('conv_cls.bias'):
                val = torch.full(t.shape, -math.log((1 - 0.01) / 0.01))
            elif name.endswith('heatmap_final.bias'):
                val = torch.full(t.shape, HEATMAP_BIAS)
            t.copy_(val.to(t.dtype))
    return model


def load_reference_state_dict(model, state_dict):
    """Load a reference-layout DfM state dict (an mmcv checkpoint dict
    {'meta', 'state_dict', ...} or a bare {key: tensor}) into `model`.

    The keys of `model.state_dict()`, those of `dfm_key_map()`, are
    taken; each must be present with the model's shape, else KeyError
    (naming every missing key) or ValueError. Values are cast to the
    model's types. Returns the sorted keys that were not taken: a DfMFull
    checkpoint's teacher (`lidar_model.*`) and 2D ATSS head, and
    BatchNorm's `num_batches_tracked`.
    """
    if 'state_dict' in state_dict and isinstance(state_dict['state_dict'],
                                                 dict):
        state_dict = state_dict['state_dict']
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state_dict)
    if missing:
        raise KeyError(f'{len(missing)} keys of the model are not in the '
                       f'checkpoint: {missing}')
    for k, t in own.items():
        got = tuple(state_dict[k].shape)
        if got != tuple(t.shape):
            raise ValueError(f'shape mismatch at {k}: the model has '
                             f'{tuple(t.shape)}, the checkpoint {got}')
    model.load_state_dict({k: state_dict[k] for k in own}, strict=True)
    return sorted(k for k in state_dict if k not in own)


def load_reference_checkpoint(model, path):
    """`load_reference_state_dict(model, read_checkpoint(path))`."""
    return load_reference_state_dict(model, read_checkpoint(path))


def read_checkpoint(path):
    """The checkpoint at `path`, read with `torch.load(...,
    map_location='cpu', weights_only=True)`: tensors and plain
    containers only, never arbitrary objects."""
    try:
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        raise RuntimeError(
            f'{path} holds objects other than tensors and plain containers '
            '(an mmcv meta entry, for example), which torch.load refuses '
            'with weights_only=True; it is not unpickled. Save its '
            "'state_dict' alone (torch.save(ckpt['state_dict'], path)) "
            f'and load that. torch.load said: {e}') from e
    return ckpt
