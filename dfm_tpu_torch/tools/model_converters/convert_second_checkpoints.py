"""A LIGA SECOND teacher checkpoint -> the sparse teacher file.

    python -m dfm_tpu_torch.tools.model_converters.convert_second_checkpoints \
        SRC.pth DST [--encoder sparse|dense]

Port of `tools/model_converters/convert_second_checkpoints.py:24-121`:
`torch.load` reads the reference's .pth (its 'state_dict', the
`lidar_model.` prefix of a DfM checkpoint stripped) and the file written
is the flax msgpack tree of a `SparseLidarTeacher` ({'params',
'batch_stats'} of `middle_encoder` and `bev`), the layout JAX's converter
writes and `utils/weights.py:teacher_state_dict(tree, 'sparse')` reads:

* `middle_encoder`: the CustomSparseEncoder's convs (spconv v2 weights
  (kz, ky, kx, C_in, C_out), or (C_out, C_in, kz, ky, kx)) as tap-major
  (27, C_in, C_out) kernels, conv_out (1, 64, 32), and each BatchNorm1d's
  scale, bias, mean and var (JAX `:24-78`);
* `bev`: the BEV hourglass ('backbone.compress_conv',
  'backbone.bev_hourglass'; JAX `dfm_tpu/utils/checkpoint_import.py:
  324-333`), torch (O, I, k...) kernels as flax (k..., I, O), transposed
  ones spatially flipped.

Every key is required: a checkpoint without one of them is refused,
naming it (JAX's importer leaves an absent BEV key at its random init).
`--encoder dense` exits 2, as JAX's does: the reference has no dense
teacher checkpoint.
"""

import argparse
import sys

import numpy as np
import torch

from ...utils.msgpack_tree import msgpack_dumps
from ...utils.weights import SPARSE_ENCODER_LAYERS, _convnorm, _hourglass

__all__ = ['convert_sparse_encoder', 'bev_key_map', 'convert_bev',
           'convert_state_dict', 'main']


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t,
                      np.float32)


def _sparse_kernel(t, key):
    """A spconv kernel -> (taps, C_in, C_out)."""
    if t.ndim == 5 and t.shape[0] == t.shape[1] == t.shape[2] == 3:
        return t.reshape(27, t.shape[3], t.shape[4])
    if t.ndim == 5:                          # (C_out, C_in, kz, ky, kx)
        return t.transpose(2, 3, 4, 1, 0).reshape(-1, t.shape[1],
                                                  t.shape[0])
    raise ValueError(f'{key}: {t.shape}')


def convert_sparse_encoder(sd, prefix='middle_encoder.'):
    """CustomSparseEncoder torch keys -> (params, batch_stats) of
    `SparseEncoder05` (numpy float32)."""
    def get(key):
        if prefix + key not in sd:
            raise KeyError(f'the checkpoint has no {prefix + key}')
        return _np(sd[prefix + key])

    torch_layers = ['conv_input', 'encoder_layers.encoder_layer1.0'] + [
        f'encoder_layers.encoder_layer{s + 1}.{j}'
        for s in (1, 2, 3) for j in (0, 1, 2)]
    params, stats = {}, {}
    for (conv, bn), layer in zip(SPARSE_ENCODER_LAYERS, torch_layers):
        key = f'{layer}.0.weight'
        params[conv] = {'kernel': _sparse_kernel(get(key), key)}
        params[bn] = dict(scale=get(f'{layer}.1.weight'),
                          bias=get(f'{layer}.1.bias'))
        stats[bn] = dict(mean=get(f'{layer}.1.running_mean'),
                         var=get(f'{layer}.1.running_var'))
    cw = get('conv_out.0.weight')
    if cw.ndim == 5:
        cw = cw.reshape(1, cw.shape[-2], cw.shape[-1]) if cw.shape[0] == 1 \
            else cw.transpose(2, 3, 4, 1, 0).reshape(1, cw.shape[1],
                                                     cw.shape[0])
    params['conv_out'] = {'kernel': cw}
    return params, stats


def bev_key_map():
    """The reference teacher's BEV hourglass torch keys -> flax paths
    under 'bev' (JAX `checkpoint_import.py:teacher_key_map`)."""
    return _convnorm('backbone.compress_conv', ('bev', 'compress'), 2, 'bn') \
        + _hourglass('backbone.bev_hourglass', ('bev', 'hg'), 2, 'bn')


def _flax_kernel(w, kind):
    nsp = w.ndim - 2
    if kind.startswith('convt'):       # (I, O, k...) flipped -> (k..., I, O)
        w = w[(slice(None), slice(None)) + (slice(None, None, -1),) * nsp]
        return np.ascontiguousarray(
            w.transpose(tuple(range(2, 2 + nsp)) + (0, 1)))
    return np.ascontiguousarray(w.transpose(tuple(range(2, 2 + nsp)) +
                                            (1, 0)))


def convert_bev(sd):
    """The BEV hourglass keys of `sd` -> (params, batch_stats) trees of
    'bev'."""
    params, stats = {}, {}

    def put(tree, path, leaf, value):
        for k in path:
            tree = tree.setdefault(k, {})
        tree[leaf] = value

    for prefix, fpath, kind in bev_key_map():
        def get(name):
            if f'{prefix}.{name}' not in sd:
                raise KeyError(f'the checkpoint has no {prefix}.{name}')
            return _np(sd[f'{prefix}.{name}'])
        if kind.startswith('conv'):
            put(params, fpath, 'kernel', _flax_kernel(get('weight'), kind))
            if f'{prefix}.bias' in sd:
                put(params, fpath, 'bias', get('bias'))
        else:
            put(params, fpath, 'scale', get('weight'))
            put(params, fpath, 'bias', get('bias'))
            put(stats, fpath, 'mean', get('running_mean'))
            put(stats, fpath, 'var', get('running_var'))
    return params['bev'], stats['bev']


def convert_state_dict(sd):
    """A SECOND state dict (reference key names, `lidar_model.` stripped
    where every key has it) -> the `SparseLidarTeacher` tree."""
    if any(k.startswith('lidar_model.') for k in sd):
        sd = {k[len('lidar_model.'):]: v for k, v in sd.items()
              if k.startswith('lidar_model.')}
    enc, enc_stats = convert_sparse_encoder(sd)
    bev, bev_stats = convert_bev(sd)
    return {'params': {'middle_encoder': enc, 'bev': bev},
            'batch_stats': {'middle_encoder': enc_stats, 'bev': bev_stats}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('src')
    p.add_argument('dst')
    p.add_argument('--encoder', default='sparse', choices=['sparse',
                                                           'dense'])
    args = p.parse_args(argv)
    if args.encoder != 'sparse':
        print('dense teacher import: the reference has no dense teacher '
              'checkpoint; a dense teacher file is a flax tree of '
              '`LidarTeacher` (utils/weights.py:dfm_full_key_map)',
              file=sys.stderr)
        return 2
    ckpt = torch.load(args.src, map_location='cpu', weights_only=True)
    sd = ckpt.get('state_dict', ckpt)
    tree = convert_state_dict(sd)
    with open(args.dst, 'wb') as f:
        f.write(msgpack_dumps(tree))
    print(f'wrote {args.dst}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
