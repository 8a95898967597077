"""Wrappers of the conv-chain kernels (K4, K7a, K8a), CUDA C++ for sm_90a.

| wrapper         | kernel source       | replaces (TPU, ops/pallas/conv_chain.py) |
| `pack_vol`      | csrc/conv_chain.cu  | pack_vol -> _pack_call                   |
| `conv_p2p`      | csrc/conv_chain.cu  | conv_p2p -> _conv_p2p_call               |
| `unpack_affine` | csrc/conv_chain.cu  | unpack_affine_res -> _unpack_ar_call     |

On a CPU tensor a wrapper returns its plain PyTorch version
(`ops/conv_chain.py`). On a CUDA tensor it checks device, dtype, shape
and contiguity, allocates the outputs with `torch.empty` (the kernels
write the zero border of every chain tensor themselves), launches on the
current stream, raises if the launch reports an error, and adds one to
its count in `LAUNCHES` (the table shared with `sampling.py`). There is
no fallback. The kernels take bfloat16 volumes of 32 channels, any
D, H, W >= 1.
"""

import math

import torch

from ..conv_chain import (ChainVol, conv_p2p_plain, pack_vol_plain,
                          unpack_affine_plain)
from .build import load
from .sampling import LAUNCHES, _check, _on_cpu, _raise_on, _stream

__all__ = ['pack_vol', 'conv_p2p', 'unpack_affine']

CHANNELS = 32
TILE = (16, 32)        # (rows, columns) a block of K4 owns; csrc TY, TX
_BF16 = (torch.bfloat16,)


def _check_vol(t, name):
    _check(t, name, 4, _BF16)
    if t.shape[-1] != CHANNELS:
        raise ValueError(f'{name}: the chain kernels take {CHANNELS} '
                         f'channels, got {tuple(t.shape)}')


def _check_chain(cv, name):
    _check_vol(cv.data, name)
    if min(cv.shape[:3]) < 1:
        raise ValueError(f'{name}: empty volume {cv.shape}')


def pack_vol(x):
    """K8a. Dense (D, H, W, 32) -> ChainVol (copy + zero border)."""
    if _on_cpu(x):
        return pack_vol_plain(x)
    _check_vol(x, 'x')
    d, h, w, c = x.shape
    out = torch.empty((d + 2, h + 2, w + 2, c), dtype=x.dtype,
                      device=x.device)
    rc = load('conv_chain').dfm_pack_vol(x.data_ptr(), out.data_ptr(), d, h,
                                         w, _stream())
    _raise_on(rc, 'pack_vol')
    LAUNCHES['pack_vol'] += 1
    return ChainVol(out)


def blocked_weight(weight, dtype=torch.bfloat16):
    """(Cout, Cin, 3, 3, 3) -> [tap 27][k half][n half][k 16][n 16] in
    `dtype`, the tiles K4 reads from shared memory (k = input channel,
    n = output channel, tap = (dz * 3 + dy) * 3 + dx)."""
    w = weight.to(dtype).permute(2, 3, 4, 1, 0).reshape(27, 2, 16, 2, 16)
    return w.permute(0, 1, 3, 2, 4).contiguous()


def _z_chunk(d, tiles, sms):
    """Depth slices per block: the fewest rounds of `sms` blocks, each
    block paying about one slice of start-up (weights and halo)."""
    return min(range(1, d + 1), key=lambda zc: (
        math.ceil(tiles * math.ceil(d / zc) / sms) * (zc + 1), -zc))


def conv_p2p(cv, weight, residual=False):
    """K4. 3x3x3 stride-1 'same' conv C32 -> C32 on the chain format,
    weight (32, 32, 3, 3, 3) float32 (rounded to bf16 for the tensor
    cores), f32 accumulation; `residual` adds the input. Returns
    (ChainVol, ps (D, tiles, 2, 32) float32): per depth slice and spatial
    tile the per-channel sum and sum of squares of the unrounded
    result."""
    if _on_cpu(cv.data, weight):
        return conv_p2p_plain(cv, weight, residual)
    _check_chain(cv, 'cv')
    if tuple(weight.shape) != (CHANNELS, CHANNELS, 3, 3, 3):
        raise ValueError(f'weight: expected (32, 32, 3, 3, 3), got '
                         f'{tuple(weight.shape)}')
    d, h, w, c = cv.shape
    tiles = math.ceil(h / TILE[0]) * math.ceil(w / TILE[1])
    dev = cv.data.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty_like(cv.data)
    ps = torch.empty((d, tiles, 2, c), dtype=torch.float32, device=dev)
    wt = blocked_weight(weight)
    rc = load('conv_chain').dfm_conv_p2p(
        cv.data.data_ptr(), wt.data_ptr(), out.data_ptr(), ps.data_ptr(), d,
        h, w, tiles, _z_chunk(d, tiles, sms), int(bool(residual)), _stream())
    _raise_on(rc, 'conv_p2p')
    LAUNCHES['conv_p2p'] += 1
    return ChainVol(out), ps


def unpack_affine(u, sc, bs, res=None, relu=False):
    """K7a. ChainVol u -> dense (D, H, W, 32): u * sc + bs per channel in
    f32 (sc, bs (32,) float32), relu if asked, then + res (a ChainVol of
    the same shape, added unnormalised), stored bf16."""
    tensors = [u.data, sc, bs] + ([] if res is None else [res.data])
    if _on_cpu(*tensors):
        return unpack_affine_plain(u, sc, bs, res, relu)
    _check_chain(u, 'u')
    for t, name in ((sc, 'sc'), (bs, 'bs')):
        _check(t, name, 1, (torch.float32,))
        if t.shape[0] != CHANNELS:
            raise ValueError(f'{name}: expected ({CHANNELS},), got '
                             f'{tuple(t.shape)}')
    if res is not None:
        _check_chain(res, 'res')
        if res.data.shape != u.data.shape:
            raise ValueError(f'res {res.shape} does not match u {u.shape}')
    d, h, w, c = u.shape
    out = torch.empty((d, h, w, c), dtype=u.data.dtype, device=u.data.device)
    rc = load('conv_chain').dfm_unpack_affine(
        u.data.data_ptr(), None if res is None else res.data.data_ptr(),
        sc.data_ptr(), bs.data_ptr(), out.data_ptr(), d, h, w,
        int(bool(relu)), _stream())
    _raise_on(rc, 'unpack_affine_res')
    LAUNCHES['unpack_affine_res'] += 1
    return out
