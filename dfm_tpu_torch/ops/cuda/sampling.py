"""Wrappers of the three sampling kernels (K1-K3), CUDA C++ for sm_90a.

| wrapper                 | kernel source            | replaces (TPU)                                  |
| `warp_prev`             | csrc/warp_prev.cu        | ops/pallas/cost_warp.py:warp_prev_band          |
| `frustum_stereo_sample` | csrc/frustum_sample.cu   | ops/pallas/frustum_sample.py:_call (+_batched)  |
| `attention_sample`      | csrc/frustum_sample.cu   | ops/pallas/frustum_sample.py:_att_call          |

On a CPU tensor a wrapper returns its plain PyTorch version
(`ops/cost_volume.py`, `ops/frustum_separable.py`). On a CUDA tensor it
checks device, dtype, shape and contiguity, allocates the outputs,
launches on the current stream, raises if the launch reports an error,
and adds one to its count in `LAUNCHES`. There is no fallback.
"""

import numpy as np
import torch

from ..cost_volume import warp_prev_plain
from ..frustum_separable import (attention_sample_plain, depth_tables,
                                 stereo_sample_plain)
from .build import load

__all__ = ['LAUNCHES', 'reset_launch_counts', 'warp_prev',
           'frustum_stereo_sample', 'attention_sample', 'attention_xtab']

# one table for every kernel of the port (K4-K8b: `conv_chain.py`, K9a /
# K9b: `conv3d.py`), under the names of the JAX functions they replace
LAUNCHES = {'warp_prev': 0, 'frustum_stereo_sample': 0,
            'attention_sample': 0, 'pack_vol': 0, 'conv_p2p': 0,
            'unpack_affine_res': 0, 'conv_s2_p2d': 0, 'pack_parity8': 0,
            'gn_affine_res_packed': 0, 'unpack_vol': 0, 'conv3d_zpack': 0,
            'conv3d_pallas': 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*tensors):
    devs = {t.device.type for t in tensors}
    if devs == {'cpu'}:
        return True
    if devs != {'cuda'} or len({t.device for t in tensors}) != 1:
        raise ValueError(f'tensors must all lie on the CPU or on one CUDA '
                         f'device, got {sorted(devs)}')
    return False


def _check(t, name, ndim, dtypes):
    if t.dim() != ndim:
        raise ValueError(f'{name}: expected {ndim} dims, got {tuple(t.shape)}')
    if t.dtype not in dtypes:
        raise TypeError(f'{name}: dtype {t.dtype} not in {dtypes}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{rc}')


def warp_prev(prev, u, v):
    """K1. prev (B, H, W, C) float32/bf16; u, v (B, D, Hq, Wq) float32
    align-corners pixel coords -> (B, D, Hq, Wq, C) in prev's dtype."""
    if _on_cpu(prev, u, v):
        return warp_prev_plain(prev, u, v)
    _check(prev, 'prev', 4, _DTYPES)
    _check(u, 'u', 4, (torch.float32,))
    _check(v, 'v', 4, (torch.float32,))
    b, h, w, c = prev.shape
    if u.shape != v.shape or u.shape[0] != b:
        raise ValueError(f'u {tuple(u.shape)} / v {tuple(v.shape)} do not '
                         f'match prev {tuple(prev.shape)}')
    out = torch.empty(tuple(u.shape) + (c,), dtype=prev.dtype,
                      device=prev.device)
    per_b = u[0].numel()
    rc = load('warp_prev').dfm_warp_prev(
        prev.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
        w, c, per_b, _DTYPES[prev.dtype], _stream())
    _raise_on(rc, 'warp_prev')
    LAUNCHES['warp_prev'] += 1
    return out


def _frustum_args(table, u, v, ds, name):
    """Shared checks of K2/K3; returns the depth tables on the device."""
    _check(u, 'u', 3, (torch.float32,))
    _check(v, 'v', 3, (torch.float32,))
    b, d = table.shape[:2]
    nx = u.shape[1]
    if u.shape[0] != b or v.shape[:2] != (b, nx):
        raise ValueError(f'{name}: u {tuple(u.shape)} / v {tuple(v.shape)} '
                         f'do not match the table {tuple(table.shape)}')
    if len(ds['z0']) != nx or max(ds['z0'].max(), ds['z1'].max()) >= d:
        raise ValueError(f'{name}: depth taps do not fit {nx} slabs of a '
                         f'{d}-bin table')
    return depth_tables(ds, table.device)


def frustum_stereo_sample(vol, u, v, ds, pad_shape):
    """K2. vol (B, D, H, W, C) float32/bf16; u (B, nx, ny), v (B, nx, nz)
    float32; ds the numpy taps of `slab_depth_static(num_bins=D)`.
    Returns (B, nz, ny, nx, C) in vol's dtype, zero where not
    valid2d & in_range, and valid2d (B, nz, ny, nx) bool."""
    if _on_cpu(vol, u, v):
        return stereo_sample_plain(vol, u, v,
                                   *depth_tables(ds, vol.device), pad_shape)
    _check(vol, 'vol', 5, _DTYPES)
    z0, z1, w0, w1, inr = _frustum_args(vol, u, v, ds,
                                        'frustum_stereo_sample')
    b, d, h, w, c = vol.shape
    nx, ny = u.shape[1:]
    nz = v.shape[2]
    out = torch.empty((b, nz, ny, nx, c), dtype=vol.dtype,
                      device=vol.device)
    valid2d = torch.empty((b, nz, ny, nx), dtype=torch.bool,
                          device=vol.device)
    rc = load('frustum_sample').dfm_frustum_stereo_sample(
        vol.data_ptr(), u.data_ptr(), v.data_ptr(), z0.data_ptr(),
        z1.data_ptr(), w0.data_ptr(), w1.data_ptr(), inr.data_ptr(),
        out.data_ptr(), valid2d.data_ptr(), b, d, h, w, c, nz, ny, nx,
        float(pad_shape[0]), float(pad_shape[1]), _DTYPES[vol.dtype],
        _stream())
    _raise_on(rc, 'frustum_stereo_sample')
    LAUNCHES['frustum_stereo_sample'] += 1
    return out, valid2d


_XTABS = {}           # attention_xtab's tables on the device, by content
_INT32 = 2 ** 31


def attention_xtab(ds, d, device):
    """K3's per-slab depth table: (nx, 4) float32 rows (z0, z1, w0, w1)
    of `ds` = `slab_depth_static(num_bins=d)`, both weights zero where
    the slab is out of the depth range (the kernel then drops its voxels,
    as the plain version's `in_range` mask does). Checked and copied to
    `device` once per table, then cached by content: a call of the kernel
    makes no host-to-device copy."""
    key = (device, d) + tuple(ds[k].tobytes() for k in
                              ('z0', 'z1', 'w0', 'w1', 'in_range'))
    tab = _XTABS.get(key)
    if tab is None:
        z0, z1 = ds['z0'], ds['z1']
        if min(z0.min(), z1.min()) < 0 or max(z0.max(), z1.max()) >= d:
            raise ValueError(f'attention_sample: depth taps do not fit a '
                             f'{d}-bin table')
        keep = ds['in_range'].astype(np.float32)
        tab = np.stack([z0.astype(np.float32), z1.astype(np.float32),
                        ds['w0'].astype(np.float32) * keep,
                        ds['w1'].astype(np.float32) * keep], axis=1)
        tab = torch.from_numpy(np.ascontiguousarray(tab)).to(device)
        if len(_XTABS) >= 16:
            _XTABS.clear()
        _XTABS[key] = tab
    return tab


def attention_sample(sm, u, v, ds, pad_shape):
    """K3. sm (B, D_f, H_f, W_f) float32/bf16 fine softmax volume; u, v
    as K2; ds the taps of `slab_depth_static(num_bins=D_f)`. Returns
    (B, nz, ny, nx) float32 attention, zero where not valid2d &
    in_range. The kernel indexes in 32 bits: D_f * H_f * W_f and the
    sizes of u, v and the output stay below 2^31."""
    if _on_cpu(sm, u, v):
        return attention_sample_plain(sm, u, v,
                                      *depth_tables(ds, sm.device),
                                      pad_shape)
    _check(sm, 'sm', 4, _DTYPES)
    _check(u, 'u', 3, (torch.float32,))
    _check(v, 'v', 3, (torch.float32,))
    b, d, h, w = sm.shape
    nx, ny = u.shape[1:]
    nz = v.shape[2]
    if u.shape[0] != b or v.shape[:2] != (b, nx) or len(ds['z0']) != nx:
        raise ValueError(f'attention_sample: u {tuple(u.shape)} / v '
                         f'{tuple(v.shape)} / {len(ds["z0"])} depth taps do '
                         f'not match the table {tuple(sm.shape)}')
    if max(d * h * w, u.numel(), v.numel(), b * nz * ny * nx) >= _INT32:
        raise ValueError(f'attention_sample: sizes beyond 32-bit indices, '
                         f'table {tuple(sm.shape)}, grid {(nz, ny, nx)}')
    xtab = attention_xtab(ds, d, sm.device)
    out = torch.empty((b, nz, ny, nx), dtype=torch.float32,
                      device=sm.device)
    rc = load('frustum_sample').dfm_attention_sample(
        sm.data_ptr(), u.data_ptr(), v.data_ptr(), xtab.data_ptr(),
        out.data_ptr(), b, d, h, w, nz, ny, nx, float(pad_shape[0]),
        float(pad_shape[1]), _DTYPES[sm.dtype], _stream())
    _raise_on(rc, 'attention_sample')
    LAUNCHES['attention_sample'] += 1
    return out
