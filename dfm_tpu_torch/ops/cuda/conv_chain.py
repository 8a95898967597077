"""Wrappers of the conv-chain kernels (K4-K8b), CUDA C++ for sm_90a.

| wrapper         | kernel source           | replaces (TPU, ops/pallas/conv_chain.py) |
| `pack_vol`      | csrc/conv_chain.cu      | pack_vol -> _pack_call                   |
| `unpack_vol`    | csrc/conv_chain.cu      | unpack_vol -> _unpack_call               |
| `conv_p2p`      | csrc/conv_chain.cu      | conv_p2p -> _conv_p2p_call               |
| `unpack_affine` | csrc/conv_chain.cu      | unpack_affine_res -> _unpack_ar_call     |
| `affine_chain`  | csrc/conv_chain.cu      | gn_affine_res_packed -> _affine_res_call |
| `conv_s2_p2d`   | csrc/hourglass_chain.cu | conv_s2_p2d -> _conv_s2_call             |
| `pack_parity8`  | csrc/hourglass_chain.cu | pack_parity8 -> _pack_zpair_call         |

On a CPU tensor a wrapper returns its plain PyTorch version
(`ops/conv_chain.py`). On a CUDA tensor it checks device, dtype, shape
and contiguity, allocates the outputs with `torch.empty` (the kernels
write the zero border of every chain tensor themselves), launches on the
current stream, raises if the launch reports an error, and adds one to
its count in `LAUNCHES` (the table shared with `sampling.py`). There is
no fallback. The kernels take bfloat16 volumes of 32 channels, any
D, H, W >= 1 (K5: even D, H, W; its dense output has 64 channels).
"""

import math

import torch

from ..conv_chain import (ChainVol, affine_mask, conv_p2p_plain,
                          conv_s2_plain, pack_parity8_plain, pack_vol_plain,
                          unpack_affine_plain, unpack_vol_plain)
from .build import load
from .sampling import LAUNCHES, _check, _on_cpu, _raise_on, _stream

__all__ = ['pack_vol', 'unpack_vol', 'conv_p2p', 'conv_s2_p2d',
           'pack_parity8', 'unpack_affine', 'affine_chain',
           'wgmma_weight', 'cached_wgmma_weight']

CHANNELS = 32
TILE = (8, 64)         # (rows, columns) of K4's output tile; csrc k4::TY, TX
TILE_S2 = (2, 64)      # output (rows, columns) of K5's tile; csrc k5::TY, TX
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


def unpack_vol(cv):
    """K8b. ChainVol -> dense contiguous (D, H, W, 32) (copy)."""
    if _on_cpu(cv.data):
        return unpack_vol_plain(cv)
    _check_chain(cv, 'cv')
    d, h, w, c = cv.shape
    out = torch.empty((d, h, w, c), dtype=cv.data.dtype,
                      device=cv.data.device)
    rc = load('conv_chain').dfm_unpack_vol(cv.data.data_ptr(),
                                           out.data_ptr(), d, h, w,
                                           _stream())
    _raise_on(rc, 'unpack_vol')
    LAUNCHES['unpack_vol'] += 1
    return out


def wgmma_weight(weight, dtype=torch.bfloat16, koct=None):
    """(Cout, C, 3, 3, 3) -> [tap 27][k octet koct][n Cout][k 8] in
    `dtype`: the B operand of the `wgmma` convolutions (K4, K5, K9b) as
    it lies in shared memory, the no-swizzle K-major layout (k = input
    channel 8 * octet + k, n = output channel, tap = (dz * 3 + dy) * 3 +
    dx). `koct` (default C / 8) may exceed C / 8: the extra octets are
    zeros. C % 8 == 0."""
    cout, cin = weight.shape[:2]
    koct = cin // 8 if koct is None else koct
    w = weight.permute(2, 3, 4, 1, 0).reshape(27, cin // 8, 8, cout)
    w = w.permute(0, 1, 3, 2)
    out = torch.zeros((27, koct, cout, 8), dtype=dtype, device=weight.device)
    out[:, :cin // 8].copy_(w)
    return out


_WGMMA_WEIGHTS = {}    # laid-out weights, by the weight they came from
_SMS = {}


def cached_wgmma_weight(weight, koct=None):
    """`wgmma_weight(weight, koct=koct)`, laid out once per weight: keyed
    by its address, shape and strides (a view of a parameter, as the
    model slices one, finds the same entry) and `koct`, and valid while
    its version counter, which every in-place update through torch
    bumps, is unchanged. The entry holds `weight`, so its memory is not
    reused while the entry lives."""
    key = (weight.data_ptr(), tuple(weight.shape), weight.stride(),
           weight.dtype, weight.device, koct)
    hit = _WGMMA_WEIGHTS.get(key)
    if hit is not None and hit[1] == weight._version:
        return hit[2]
    wt = wgmma_weight(weight, koct=koct)
    if len(_WGMMA_WEIGHTS) >= 64:
        _WGMMA_WEIGHTS.clear()
    _WGMMA_WEIGHTS[key] = (weight, weight._version, wt)
    return wt


def _sm_count(dev):
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


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
    if cv.data.data_ptr() % 16:
        raise ValueError('cv must start on 16 bytes (a TMA tensor map)')
    d, h, w, c = cv.shape
    tiles = math.ceil(h / TILE[0]) * math.ceil(w / TILE[1])
    dev = cv.data.device
    out = torch.empty_like(cv.data)
    ps = torch.empty((d, tiles, 2, c), dtype=torch.float32, device=dev)
    wt = cached_wgmma_weight(weight)
    rc = load('conv_chain').dfm_conv_p2p(
        cv.data.data_ptr(), wt.data_ptr(), out.data_ptr(), ps.data_ptr(), d,
        h, w, tiles, _sm_count(dev), int(bool(residual)), _stream())
    _raise_on(rc, 'conv_p2p')
    LAUNCHES['conv_p2p'] += 1
    return ChainVol(out), ps


def conv_s2_p2d(cv, weight):
    """K5. 3x3x3 stride-2 'same' conv C32 -> C64 on the chain format,
    D, H, W even, weight (64, 32, 3, 3, 3) float32 (rounded to bf16 for
    the tensor cores), f32 accumulation. Returns (dense
    (D/2, H/2, W/2, 64) bf16, ps (D/2, tiles, 2, 64) float32): per output
    slice and spatial tile the per-channel sum and sum of squares of the
    unrounded result."""
    if _on_cpu(cv.data, weight):
        return conv_s2_plain(cv, weight)
    _check_chain(cv, 'cv')
    if tuple(weight.shape) != (2 * CHANNELS, CHANNELS, 3, 3, 3):
        raise ValueError(f'weight: expected (64, 32, 3, 3, 3), got '
                         f'{tuple(weight.shape)}')
    d, h, w, _ = cv.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f'conv_s2_p2d needs even D, H, W, got {cv.shape}')
    if cv.data.data_ptr() % 16:
        raise ValueError('cv must start on 16 bytes (a TMA tensor map)')
    d2, h2, w2 = d // 2, h // 2, w // 2
    tiles = math.ceil(h2 / TILE_S2[0]) * math.ceil(w2 / TILE_S2[1])
    dev = cv.data.device
    out = torch.empty((d2, h2, w2, 2 * CHANNELS), dtype=cv.data.dtype,
                      device=dev)
    ps = torch.empty((d2, tiles, 2, 2 * CHANNELS), dtype=torch.float32,
                     device=dev)
    wt = cached_wgmma_weight(weight)
    rc = load('hourglass_chain').dfm_conv_s2(
        cv.data.data_ptr(), wt.data_ptr(), out.data_ptr(), ps.data_ptr(),
        d2, h2, w2, tiles, _sm_count(dev), _stream())
    _raise_on(rc, 'conv_s2_p2d')
    LAUNCHES['conv_s2_p2d'] += 1
    return out, ps


def pack_parity8(par):
    """K6. (8, D2, H2, W2, 32) bf16 parity sub-volumes (index 4 rz + 2 ry
    + rx, `ops/conv_chain.py:convt1_parity`) -> (ChainVol of the
    interleaved (2 D2, 2 H2, 2 W2, 32) volume, ps (2 D2, 2 H2, 2, 32)
    float32: per slice and row the per-channel sum and sum of squares of
    the values as stored). `par` may be a strided view whose channels are
    contiguous and whose voxels start on 16 bytes, as `convt1_parity`
    returns it."""
    if _on_cpu(par):
        return pack_parity8_plain(par)
    if par.dim() != 5 or par.shape[0] != 8 or par.shape[-1] != CHANNELS \
            or par.numel() == 0:
        raise ValueError(f'par: expected (8, D2, H2, W2, {CHANNELS}), got '
                         f'{tuple(par.shape)}')
    if par.dtype not in _BF16:
        raise TypeError(f'par: dtype {par.dtype} not in {_BF16}')
    strides = par.stride()
    if strides[-1] != 1 or any(s % 8 for s in strides[:4]) \
            or par.data_ptr() % 16:
        raise ValueError(f'par: strides {strides} are not whole 16-byte '
                         f'voxel chunks')
    _, d2, h2, w2, c = par.shape
    dev = par.device
    out = torch.empty((2 * d2 + 2, 2 * h2 + 2, 2 * w2 + 2, c),
                      dtype=par.dtype, device=dev)
    ps = torch.empty((2 * d2, 2 * h2, 2, c), dtype=torch.float32, device=dev)
    rc = load('hourglass_chain').dfm_pack_parity8(
        par.data_ptr(), out.data_ptr(), ps.data_ptr(), d2, h2, w2,
        *strides[:4], _stream())
    _raise_on(rc, 'pack_parity8')
    LAUNCHES['pack_parity8'] += 1
    return ChainVol(out), ps


def _check_affine(u, sc, bs, res):
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


def _affine_tensors(u, sc, bs, res):
    return [u.data, sc, bs] + ([] if res is None else [res.data])


def affine_chain(u, sc, bs, res=None, relu=False):
    """K7b. ChainVol u -> ChainVol: u * sc + bs per channel in f32 (sc, bs
    (32,) float32), relu if asked, then + res (a ChainVol of the same
    shape, added unnormalised), stored bf16 with a zero border."""
    if _on_cpu(*_affine_tensors(u, sc, bs, res)):
        return affine_mask(u, sc, bs, relu, res)
    _check_affine(u, sc, bs, res)
    d, h, w, _ = u.shape
    out = torch.empty_like(u.data)
    rc = load('conv_chain').dfm_affine_chain(
        u.data.data_ptr(), None if res is None else res.data.data_ptr(),
        sc.data_ptr(), bs.data_ptr(), out.data_ptr(), d, h, w,
        int(bool(relu)), _stream())
    _raise_on(rc, 'gn_affine_res_packed')
    LAUNCHES['gn_affine_res_packed'] += 1
    return ChainVol(out)


def unpack_affine(u, sc, bs, res=None, relu=False):
    """K7a. ChainVol u -> dense (D, H, W, 32): u * sc + bs per channel in
    f32 (sc, bs (32,) float32), relu if asked, then + res (a ChainVol of
    the same shape, added unnormalised), stored bf16."""
    if _on_cpu(*_affine_tensors(u, sc, bs, res)):
        return unpack_affine_plain(u, sc, bs, res, relu)
    _check_affine(u, sc, bs, res)
    d, h, w, c = u.shape
    out = torch.empty((d, h, w, c), dtype=u.data.dtype, device=u.data.device)
    rc = load('conv_chain').dfm_unpack_affine(
        u.data.data_ptr(), None if res is None else res.data.data_ptr(),
        sc.data_ptr(), bs.data_ptr(), out.data_ptr(), d, h, w,
        int(bool(relu)), _stream())
    _raise_on(rc, 'unpack_affine_res')
    LAUNCHES['unpack_affine_res'] += 1
    return out
