"""Wrappers of the three sampling kernels (K1-K3) and of the backward
kernels of K1 and K2, CUDA C++ for sm_90a.

| wrapper                      | source            | replaces (TPU, under dfm_tpu/ops/) |
| `warp_prev_sweep`            | warp_prev.cu      | pallas/cost_warp.py:warp_prev_band |
|                              |                   | + cost_volume.py:plane_sweep_grids |
| `frustum_voxel_features`     | frustum_sample.cu | pallas/frustum_sample.py:_call +   |
|                              |                   | the neck's `_fused` glue           |
| `attention_sample`           | frustum_sample.cu | pallas/frustum_sample.py:_att_call |
| `warp_prev_sweep_bwd`        | warp_prev.cu      | XLA's autodiff of K1's function    |
| `frustum_voxel_features_bwd` | frustum_sample.cu | XLA's autodiff of K2's function    |

(sources under `dfm_tpu_torch/csrc/`). Their launches count under the
names of the TPU functions: K1 `warp_prev`, K2 `frustum_stereo_sample`,
K3 `attention_sample`, and `warp_prev_bwd`, `frustum_stereo_sample_bwd`.

K1 and K2 are differentiable: on a CUDA tensor `warp_prev_sweep` and
`frustum_voxel_features` are `torch.autograd.Function`s whose backward
launches the backward kernel (the gradients of prev, and of vol and sem;
none of the sample points, the parameters or the attention, which the
model takes from a detached cost); on the CPU the plain versions run
under autograd. K3's input is a constant of a training step (the neck
detaches the cost), so it has no backward. The backward kernels sum with
atomics: their results are not bit-reproducible from run to run. Their
plain versions, `torch.autograd.grad` of the plain forwards, are
`warp_prev_sweep_bwd_plain` and `frustum_voxel_features_bwd_plain`.

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
           'warp_prev_sweep_bwd', 'warp_prev_sweep_bwd_plain',
           'frustum_voxel_features', 'frustum_voxel_features_bwd',
           'frustum_voxel_features_bwd_plain', 'attention_sample',
           'depth_xtab']

# one table for every kernel of the port (K4-K8b: `conv_chain.py`, K9a /
# K9b: `conv3d.py`), under the names of the JAX functions they replace
# (`conv3d_gn_finish`: K9a's GroupNorm finish, which XLA fuses in JAX)
LAUNCHES = {'warp_prev': 0, 'frustum_stereo_sample': 0,
            'attention_sample': 0, 'pack_vol': 0, 'conv_p2p': 0,
            'unpack_affine_res': 0, 'conv_s2_p2d': 0, 'pack_parity8': 0,
            'gn_affine_res_packed': 0, 'unpack_vol': 0, 'conv3d_zpack': 0,
            'conv3d_gn_finish': 0, 'conv3d_pallas': 0, 'warp_prev_bwd': 0,
            'frustum_stereo_sample_bwd': 0}

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
    dtype. Plain version: `sweep_coords_plain` + `warp_prev_plain`.
    Differentiable in prev (backward: `warp_prev_sweep_bwd`)."""
    depths = depths.float()
    if _on_cpu(prev, params, depths):
        return warp_prev_plain(prev, *sweep_coords_plain(params, depths, hq,
                                                         wq, step))
    return _WarpPrev.apply(prev, params, depths, hq, wq, step)


def _warp_prev_checks(name, prev_shape, params, depths):
    _check(params, 'params', 2, (torch.float32,))
    _check(depths, 'depths', 1, (torch.float32,))
    b = prev_shape[0]
    if tuple(params.shape) != (b, SWEEP_PARAMS):
        raise ValueError(f'params {tuple(params.shape)}: want ({b}, '
                         f'{SWEEP_PARAMS})')
    _k1_grid(name, b, depths.shape[0])


def _warp_prev_launch(prev, params, depths, hq, wq, step):
    _check(prev, 'prev', 4, _DTYPES)
    _warp_prev_checks('warp_prev_sweep', prev.shape, params, depths)
    b, h, w, c = prev.shape
    d = depths.shape[0]
    out = torch.empty((b, d, hq, wq, c), dtype=prev.dtype,
                      device=prev.device)
    _fits_int32('warp_prev_sweep', prev, out)
    rc = load('warp_prev').dfm_warp_prev_sweep(
        prev.data_ptr(), params.data_ptr(), depths.data_ptr(),
        out.data_ptr(), b, h, w, c, d, hq, wq, float(step),
        _DTYPES[prev.dtype], _stream())
    _raise_on(rc, 'warp_prev_sweep')
    LAUNCHES['warp_prev'] += 1
    return out


class _WarpPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prev, params, depths, hq, wq, step):
        ctx.save_for_backward(params, depths)
        ctx.prev = (tuple(prev.shape), prev.dtype, step)
        return _warp_prev_launch(prev, params, depths, hq, wq, step)

    @staticmethod
    def backward(ctx, grad_out):
        params, depths = ctx.saved_tensors
        shape, dtype, step = ctx.prev
        grad = warp_prev_sweep_bwd(grad_out.contiguous(), params, depths,
                                   shape, step).to(dtype)
        return grad, None, None, None, None, None


def warp_prev_sweep_bwd(grad_out, params, depths, prev_shape, step):
    """K1's backward: the gradient of `warp_prev_sweep`'s prev (of shape
    `prev_shape` (B, H, W, C)) for grad_out (B, D, hq, wq, C)
    float32/bf16, as a float32 (B, H, W, C) tensor (the caller casts it).
    On a CPU tensor its plain version."""
    depths = depths.float()
    if _on_cpu(grad_out, params, depths):
        return warp_prev_sweep_bwd_plain(grad_out, params, depths,
                                         prev_shape, step)
    _check(grad_out, 'grad_out', 5, _DTYPES)
    _warp_prev_checks('warp_prev_sweep_bwd', prev_shape, params, depths)
    b, h, w, c = prev_shape
    d, hq, wq = grad_out.shape[1:4]
    if tuple(grad_out.shape) != (b, depths.shape[0], hq, wq, c):
        raise ValueError(f'grad_out {tuple(grad_out.shape)} does not match '
                         f'prev {tuple(prev_shape)} and {depths.shape[0]} '
                         f'depths')
    grad = torch.zeros(prev_shape, dtype=torch.float32,
                       device=grad_out.device)
    _fits_int32('warp_prev_sweep_bwd', grad_out, grad)
    rc = load('warp_prev').dfm_warp_prev_sweep_bwd(
        grad_out.data_ptr(), params.data_ptr(), depths.data_ptr(),
        grad.data_ptr(), b, h, w, c, d, hq, wq, float(step),
        _DTYPES[grad_out.dtype], _stream())
    _raise_on(rc, 'warp_prev_sweep_bwd')
    LAUNCHES['warp_prev_bwd'] += 1
    return grad


def warp_prev_sweep_bwd_plain(grad_out, params, depths, prev_shape, step):
    """Plain version of K1's backward: `torch.autograd.grad` of the plain
    forward (the sampling does not depend on prev's values), float32."""
    hq, wq = grad_out.shape[2:4]
    prev = torch.zeros(prev_shape, dtype=grad_out.dtype,
                       device=grad_out.device, requires_grad=True)
    with torch.enable_grad():
        out = warp_prev_plain(prev, *sweep_coords_plain(
            params, depths.float(), hq, wq, step))
        grad, = torch.autograd.grad(out, prev, grad_out)
    return grad.float()


def frustum_voxel_features(vol, sem, att, u, v, ds, pad_shape):
    """K2 with the neck's glue fused: the voxel feature volume.

    vol (B, D, H, W, C) float32/bf16; sem (B, Hs, Ws, Cs) in vol's dtype
    (on the card Cs > 0; the plain version also takes Cs = 0); att
    (B, nz, ny, nx) float32 (K3's output); u (B, nx, ny), v (B, nx, nz)
    float32; ds the numpy taps of `slab_depth_static(num_bins=D)`.
    Returns (B, nz, ny, nx, C + Cs) in vol's dtype: the stereo sample,
    then the sem sample times att (see `frustum_voxel_features_plain`),
    zero where not valid2d & in_range; valid2d is not materialised.
    Differentiable in vol and sem (backward:
    `frustum_voxel_features_bwd`); att takes no gradient."""
    if _on_cpu(vol, sem, att, u, v):
        return frustum_voxel_features_plain(
            vol, sem, att, u, v, *depth_tables(ds, vol.device), pad_shape)
    return _VoxelFeatures.apply(vol, sem, att, u, v, ds, pad_shape)


def _voxel_checks(name, vol_shape, sem_shape, att, u, v, ds):
    _check(att, 'att', 4, (torch.float32,))
    _check(u, 'u', 3, (torch.float32,))
    _check(v, 'v', 3, (torch.float32,))
    b = vol_shape[0]
    nx, ny = u.shape[1:]
    nz = v.shape[2]
    if u.shape[0] != b or v.shape[:2] != (b, nx) or len(ds['z0']) != nx:
        raise ValueError(f'{name}: u {tuple(u.shape)} / v '
                         f'{tuple(v.shape)} / {len(ds["z0"])} depth taps do '
                         f'not match the volume {tuple(vol_shape)}')
    if sem_shape[0] != b or sem_shape[3] == 0 or \
            tuple(att.shape) != (b, nz, ny, nx):
        raise ValueError(f'{name}: sem {tuple(sem_shape)} / att '
                         f'{tuple(att.shape)} do not match the grid '
                         f'{(b, nz, ny, nx)} (the kernel takes Cs > 0)')
    if b * nz >= 65536:
        raise ValueError(f'{name}: B * nz = {b * nz} beyond the grid\'s z '
                         f'extent')
    return nz, ny, nx


def _voxel_features_launch(vol, sem, att, u, v, ds, pad_shape):
    _check(vol, 'vol', 5, _DTYPES)
    _check(sem, 'sem', 4, (vol.dtype,))
    nz, ny, nx = _voxel_checks('frustum_voxel_features', vol.shape,
                               sem.shape, att, u, v, ds)
    b, d, h, w, c = vol.shape
    hs, ws, cs = sem.shape[1:]
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


class _VoxelFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, sem, att, u, v, ds, pad_shape):
        ctx.save_for_backward(att, u, v)
        ctx.shapes = (tuple(vol.shape), tuple(sem.shape), vol.dtype, ds,
                      pad_shape)
        return _voxel_features_launch(vol, sem, att, u, v, ds, pad_shape)

    @staticmethod
    def backward(ctx, grad_out):
        att, u, v = ctx.saved_tensors
        vol_shape, sem_shape, dtype, ds, pad_shape = ctx.shapes
        g_vol, g_sem = frustum_voxel_features_bwd(
            grad_out.contiguous(), att, u, v, ds, pad_shape, vol_shape,
            sem_shape)
        return g_vol.to(dtype), g_sem.to(dtype), None, None, None, None, None


def frustum_voxel_features_bwd(grad_out, att, u, v, ds, pad_shape,
                               vol_shape, sem_shape):
    """K2's backward: the gradients of `frustum_voxel_features`' vol
    (of shape `vol_shape`) and sem (`sem_shape`) for grad_out
    (B, nz, ny, nx, C + Cs) float32/bf16, as float32 tensors (the caller
    casts them). On a CPU tensor its plain version."""
    if _on_cpu(grad_out, att, u, v):
        return frustum_voxel_features_bwd_plain(
            grad_out, att, u, v, ds, pad_shape, vol_shape, sem_shape)
    _check(grad_out, 'grad_out', 5, _DTYPES)
    nz, ny, nx = _voxel_checks('frustum_voxel_features_bwd', vol_shape,
                               sem_shape, att, u, v, ds)
    b, d, h, w, c = vol_shape
    hs, ws, cs = sem_shape[1:]
    if tuple(grad_out.shape) != (b, nz, ny, nx, c + cs):
        raise ValueError(f'grad_out {tuple(grad_out.shape)}: want '
                         f'{(b, nz, ny, nx, c + cs)}')
    xtab = depth_xtab(ds, d, grad_out.device)
    f32 = dict(dtype=torch.float32, device=grad_out.device)
    g_vol = torch.zeros(vol_shape, **f32)
    g_sem = torch.zeros(sem_shape, **f32)
    _fits_int32('frustum_voxel_features_bwd', grad_out, g_vol, g_sem)
    rc = load('frustum_sample').dfm_voxel_features_bwd(
        grad_out.data_ptr(), att.data_ptr(), u.data_ptr(), v.data_ptr(),
        xtab.data_ptr(), g_vol.data_ptr(), g_sem.data_ptr(), b, d, h, w, c,
        hs, ws, cs, nz, ny, nx, float(pad_shape[0]), float(pad_shape[1]),
        _DTYPES[grad_out.dtype], _stream())
    _raise_on(rc, 'frustum_voxel_features_bwd')
    LAUNCHES['frustum_stereo_sample_bwd'] += 1
    return g_vol, g_sem


def frustum_voxel_features_bwd_plain(grad_out, att, u, v, ds, pad_shape,
                                     vol_shape, sem_shape):
    """Plain version of K2's backward: `torch.autograd.grad` of
    `frustum_voxel_features_plain` in vol and sem (the sampling does not
    depend on their values), float32."""
    kw = dict(dtype=grad_out.dtype, device=grad_out.device,
              requires_grad=True)
    vol = torch.zeros(vol_shape, **kw)
    sem = torch.zeros(sem_shape, **kw)
    with torch.enable_grad():
        out = frustum_voxel_features_plain(
            vol, sem, att, u, v, *depth_tables(ds, vol.device), pad_shape)
        g_vol, g_sem = torch.autograd.grad(out, (vol, sem), grad_out)
    return g_vol.float(), g_sem.float()


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
