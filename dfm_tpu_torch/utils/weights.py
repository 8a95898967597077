"""Weights: the reference key map, flax -> port conversion, seeded init.

The port's modules carry the reference torch names, so the port's
`state_dict` keys are the torch prefixes of `dfm_key_map()` (a copy of
`dfm_tpu/utils/checkpoint_import.py:128-201`).
`state_dict_from_jax` applies the inverse of that importer's layout
rules (:27-34, :59-72):

  flax Conv (k..., I, O)                 -> torch (O, I, k...)
  flax ConvTranspose kernel[k..., i, o]  -> torch w[i, o, K-1-k...]
      (spatial flip: torch's transposed conv correlates with the flipped
      kernel)
  GroupNorm / BatchNorm scale, bias      -> weight, bias
  BatchNorm batch_stats mean, var        -> running_mean, running_var

`load_reference_state_dict` / `load_reference_checkpoint` load a
reference-layout torch checkpoint (the counterpart of the JAX
package's `import_dfm_state_dict`): its keys are already the port's.
"""

import math
import pickle

import numpy as np
import torch

__all__ = ['dfm_key_map', 'state_dict_from_jax', 'torch_conv_weight',
           'init_weights', 'load_reference_state_dict',
           'load_reference_checkpoint']


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
    h = ('bbox_head_3d',)
    for i in range(2):
        m += _convnorm(f'bbox_head_3d.cls_convs.{i}', h + (f'cls_conv{i}',),
                       2)
        m += _convnorm(f'bbox_head_3d.reg_convs.{i}', h + (f'reg_conv{i}',),
                       2)
    m += [('bbox_head_3d.conv_cls', h + ('conv_cls',), 'conv2d'),
          ('bbox_head_3d.conv_reg', h + ('conv_reg',), 'conv2d'),
          ('bbox_head_3d.conv_dir_cls', h + ('conv_dir',), 'conv2d')]
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
    of numpy arrays (every leaf of `key_map` must exist)."""
    key_map = dfm_key_map() if key_map is None else key_map
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(value, np.float32)))

    for prefix, fpath, kind in key_map:
        node = _get(params, fpath)
        if kind.startswith('conv'):
            put(f'{prefix}.weight', _conv_weight(node['kernel'], kind))
            if 'bias' in node:
                put(f'{prefix}.bias', node['bias'])
        else:
            put(f'{prefix}.weight', node['scale'])
            put(f'{prefix}.bias', node['bias'])
            if kind == 'bn':
                st = _get(stats, fpath)
                put(f'{prefix}.running_mean', st['mean'])
                put(f'{prefix}.running_var', st['var'])
    return sd


def init_weights(model, seed=0):
    """Fill every parameter and buffer of `model` from a `torch.Generator`
    (CPU) seeded with `seed`: conv weights normal with std
    1/sqrt(weight[0].numel()) (lecun-normal for a conv), conv biases 0,
    norms weight 1 / bias 0, BN running stats (0, 1),
    and the focal prior of the anchor head's cls conv (std 0.01, bias
    -log(99)). Touches no global RNG."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in list(model.named_parameters()) + \
            list(model.named_buffers()):
        leaf = name.rsplit('.', 1)[-1]
        with torch.no_grad():
            if leaf == 'running_mean' or (leaf == 'bias' and t.dim() == 1):
                val = torch.zeros(t.shape)
            elif leaf == 'running_var' or t.dim() == 1:
                val = torch.ones(t.shape)
            else:       # conv (O, I, k...) / transposed conv (I, O, k...)
                val = torch.randn(t.shape, generator=gen) / \
                    math.sqrt(t[0].numel())
            if name.endswith('conv_cls.weight'):
                val = torch.randn(t.shape, generator=gen) * 0.01
            elif name.endswith('conv_cls.bias'):
                val = torch.full(t.shape, -math.log((1 - 0.01) / 0.01))
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
    """`load_reference_state_dict(model, <the checkpoint at path>)`,
    read with `torch.load(..., map_location='cpu', weights_only=True)`:
    tensors and plain containers only, never arbitrary objects."""
    try:
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        raise RuntimeError(
            f'{path} holds objects other than tensors and plain containers '
            '(an mmcv meta entry, for example), which torch.load refuses '
            'with weights_only=True; it is not unpickled. Save its '
            "'state_dict' alone (torch.save(ckpt['state_dict'], path)) "
            f'and load that. torch.load said: {e}') from e
    return load_reference_state_dict(model, ckpt)
