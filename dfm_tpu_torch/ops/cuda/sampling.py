"""Wrappers of the three sampling kernels (K1-K3), CUDA C++ for sm_90a.

| wrapper                  | source            | replaces (TPU, under dfm_tpu/ops/) |
| `warp_prev_sweep`        | warp_prev.cu      | pallas/cost_warp.py:warp_prev_band |
|                          |                   | + cost_volume.py:plane_sweep_grids |
| `frustum_voxel_features` | frustum_sample.cu | pallas/frustum_sample.py:_call +   |
|                          |                   | the neck's `_fused` glue           |
| `attention_sample`       | frustum_sample.cu | pallas/frustum_sample.py:_att_call |

(sources under `dfm_tpu_torch/csrc/`). Their launches count under the
names of the TPU functions: K1 `warp_prev`, K2 `frustum_stereo_sample`,
K3 `attention_sample`.

On a CPU tensor a wrapper returns its plain PyTorch version
(`ops/cost_volume.py`, `ops/frustum_separable.py`). On a CUDA tensor it
checks device, dtype, shape and contiguity, allocates the outputs,
launches on the current stream, raises if the launch reports an error,
and adds one to its count in `LAUNCHES`. There is no fallback. The
kernels index in 32 bits: every tensor they touch stays below 2^31
elements, which the wrappers check.
"""

import numpy as np
import torch

from ..cost_volume import (SWEEP_PARAMS, sweep_coords_plain,
                           warp_prev_plain)
from ..frustum_separable import (attention_sample_plain, depth_tables,
                                 frustum_voxel_features_plain)
from .build import load

__all__ = ['LAUNCHES', 'reset_launch_counts', 'warp_prev_sweep',
           'frustum_voxel_features', 'attention_sample', 'depth_xtab']

# one table for every kernel of the port (K4-K8b: `conv_chain.py`, K9a /
# K9b: `conv3d.py`), under the names of the JAX functions they replace
# (`conv3d_gn_finish`: K9a's GroupNorm finish, which XLA fuses in JAX)
LAUNCHES = {'warp_prev': 0, 'frustum_stereo_sample': 0,
            'attention_sample': 0, 'pack_vol': 0, 'conv_p2p': 0,
            'unpack_affine_res': 0, 'conv_s2_p2d': 0, 'pack_parity8': 0,
            'gn_affine_res_packed': 0, 'unpack_vol': 0, 'conv3d_zpack': 0,
            'conv3d_gn_finish': 0, 'conv3d_pallas': 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32 = 2 ** 31


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


def _fits_int32(name, *tensors_or_sizes):
    for t in tensors_or_sizes:
        n = t.numel() if isinstance(t, torch.Tensor) else int(t)
        if n >= _INT32:
            raise ValueError(f'{name}: {n} elements, beyond the kernel\'s '
                             f'32-bit indices')


def _k1_grid(name, b, d):
    if max(b, d) >= 65536:      # grid (Hq / rows, D, B)
        raise ValueError(f'{name}: B = {b} or D = {d} beyond the grid')


def warp_prev_sweep(prev, params, depths, hq, wq, step):
    """K1 with its grid computed in the kernel. prev (B, H, W, C)
    float32/bf16; params (B, 18) float32 rows of
    `cost_volume.sweep_params`; depths (D,). Output pixel (d, h, w)
    samples prev at the prev-frame point of feature position
    (w * step, h * step) at depths[d] -> (B, D, hq, wq, C) in prev's
    dtype. Plain version: `sweep_coords_plain` + `warp_prev_plain`."""
    depths = depths.float()
    if _on_cpu(prev, params, depths):
        return warp_prev_plain(prev, *sweep_coords_plain(params, depths, hq,
                                                         wq, step))
    _check(prev, 'prev', 4, _DTYPES)
    _check(params, 'params', 2, (torch.float32,))
    _check(depths, 'depths', 1, (torch.float32,))
    b, h, w, c = prev.shape
    d = depths.shape[0]
    if tuple(params.shape) != (b, SWEEP_PARAMS):
        raise ValueError(f'params {tuple(params.shape)}: want ({b}, '
                         f'{SWEEP_PARAMS})')
    out = torch.empty((b, d, hq, wq, c), dtype=prev.dtype,
                      device=prev.device)
    _fits_int32('warp_prev_sweep', prev, out)
    _k1_grid('warp_prev_sweep', b, d)
    rc = load('warp_prev').dfm_warp_prev_sweep(
        prev.data_ptr(), params.data_ptr(), depths.data_ptr(),
        out.data_ptr(), b, h, w, c, d, hq, wq, float(step),
        _DTYPES[prev.dtype], _stream())
    _raise_on(rc, 'warp_prev_sweep')
    LAUNCHES['warp_prev'] += 1
    return out


def frustum_voxel_features(vol, sem, att, u, v, ds, pad_shape):
    """K2 with the neck's glue fused: the voxel feature volume.

    vol (B, D, H, W, C) float32/bf16; sem (B, Hs, Ws, Cs) in vol's dtype
    (on the card Cs > 0; the plain version also takes Cs = 0); att
    (B, nz, ny, nx) float32 (K3's output); u (B, nx, ny), v (B, nx, nz)
    float32; ds the numpy taps of `slab_depth_static(num_bins=D)`.
    Returns (B, nz, ny, nx, C + Cs) in vol's dtype: the stereo sample,
    then the sem sample times att (see `frustum_voxel_features_plain`),
    zero where not valid2d & in_range; valid2d is not materialised."""
    if _on_cpu(vol, sem, att, u, v):
        return frustum_voxel_features_plain(
            vol, sem, att, u, v, *depth_tables(ds, vol.device), pad_shape)
    _check(vol, 'vol', 5, _DTYPES)
    _check(sem, 'sem', 4, (vol.dtype,))
    _check(att, 'att', 4, (torch.float32,))
    _check(u, 'u', 3, (torch.float32,))
    _check(v, 'v', 3, (torch.float32,))
    b, d, h, w, c = vol.shape
    nx, ny = u.shape[1:]
    nz = v.shape[2]
    hs, ws, cs = sem.shape[1:]
    if u.shape[0] != b or v.shape[:2] != (b, nx) or len(ds['z0']) != nx:
        raise ValueError(f'frustum_voxel_features: u {tuple(u.shape)} / v '
                         f'{tuple(v.shape)} / {len(ds["z0"])} depth taps do '
                         f'not match the volume {tuple(vol.shape)}')
    if sem.shape[0] != b or cs == 0 or tuple(att.shape) != (b, nz, ny, nx):
        raise ValueError(f'frustum_voxel_features: sem {tuple(sem.shape)} / '
                         f'att {tuple(att.shape)} do not match the grid '
                         f'{(b, nz, ny, nx)} (the kernel takes Cs > 0)')
    if b * nz >= 65536:
        raise ValueError(f'frustum_voxel_features: B * nz = {b * nz} '
                         f'beyond the grid\'s z extent')
    xtab = depth_xtab(ds, d, vol.device)
    out = torch.empty((b, nz, ny, nx, c + cs), dtype=vol.dtype,
                      device=vol.device)
    _fits_int32('frustum_voxel_features', vol, sem, u, v, out)
    rc = load('frustum_sample').dfm_voxel_features(
        vol.data_ptr(), sem.data_ptr(), att.data_ptr(), u.data_ptr(),
        v.data_ptr(), xtab.data_ptr(), out.data_ptr(), b, d, h, w, c, hs,
        ws, cs, nz, ny, nx, float(pad_shape[0]), float(pad_shape[1]),
        _DTYPES[vol.dtype], _stream())
    _raise_on(rc, 'frustum_voxel_features')
    LAUNCHES['frustum_stereo_sample'] += 1
    return out


_XTABS = {}           # depth_xtab's tables on the device, by content


def depth_xtab(ds, d, device):
    """K2's and K3's per-slab depth table: (nx, 4) float32 rows
    (z0, z1, w0, w1) of `ds` = `slab_depth_static(num_bins=d)`, both
    weights zero where the slab is out of the depth range (the kernel
    then drops its voxels, as the plain version's `in_range` mask does).
    Checked and copied to `device` once per table, then cached by
    content: a call of the kernel makes no host-to-device copy."""
    key = (device, d) + tuple(ds[k].tobytes() for k in
                              ('z0', 'z1', 'w0', 'w1', 'in_range'))
    tab = _XTABS.get(key)
    if tab is None:
        z0, z1 = ds['z0'], ds['z1']
        if min(z0.min(), z1.min()) < 0 or max(z0.max(), z1.max()) >= d:
            raise ValueError(f'depth taps do not fit a {d}-bin table')
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
    xtab = depth_xtab(ds, d, sm.device)
    out = torch.empty((b, nz, ny, nx), dtype=torch.float32,
                      device=sm.device)
    rc = load('frustum_sample').dfm_attention_sample(
        sm.data_ptr(), u.data_ptr(), v.data_ptr(), xtab.data_ptr(),
        out.data_ptr(), b, d, h, w, nz, ny, nx, float(pad_shape[0]),
        float(pad_shape[1]), _DTYPES[sm.dtype], _stream())
    _raise_on(rc, 'attention_sample')
    LAUNCHES['attention_sample'] += 1
    return out
