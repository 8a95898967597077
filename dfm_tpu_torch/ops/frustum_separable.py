"""Frustum -> voxel sampling for KITTI-form projection matrices.

Port of `dfm_tpu/ops/frustum_separable.py`. For a rectified camera
(P[0,1] = P[1,0] = P[2,0] = P[2,1] = 0) each voxel-x slab projects on
an axis-aligned grid: u depends on (x, y), v on (x, z) and the depth
bin on x alone (static). The JAX package turns this into hat-matrix
matmuls for the TPU's matrix unit; on the GPU the three samples are
direct gathers:

* `stereo_sample_plain` — the stereo half of K2 (trilinear sample of
  the stereo volume, masked by validity), the TPU kernel's function;
* `attention_sample_plain` — plain version of K3 (trilinear sample of
  the x4 fine depth-softmax volume) — kernel
  `ops/cuda/sampling.py:attention_sample`;
* `sem_sample` — bilinear gather of the 2D semantic features (left to
  XLA in the JAX package as well);
* `frustum_voxel_features_plain` — plain version of the fused K2: the
  stereo sample, the sem sample times the attention, and their concat,
  the composition of the JAX neck's `_fused` cond — kernel
  `ops/cuda/sampling.py:frustum_voxel_features`.

Index convention (all three): x_idx = u / (pad_w - 1) * (w - 1), the
same for y; taps outside the table weigh zero; validity
`valid2d = (0 <= u <= pad_w) & (0 <= v <= pad_h)` (inclusive of pad_w /
pad_h), times the static depth range check.
"""

import numpy as np
import torch

from .resize import interp_matrix

__all__ = ['slab_uv', 'slab_depth_static', 'depth_tables',
           'build_fine_softmax_volume', 'stereo_sample_plain',
           'attention_sample_plain', 'sem_sample', 'valid_2d',
           'frustum_voxel_features_plain']


def slab_uv(cam2img, xs, ys, zs):
    """Per-slab image coordinates, float32.

    Args:
        cam2img: (B, 4, 4) augmented intrinsics, KITTI P-form.
        xs (nx,), ys (ny,), zs (nz,): pseudo-lidar voxel centres.

    Returns:
        u (B, nx, ny), v (B, nx, nz).
    """
    c = cam2img.float()
    kw = dict(dtype=torch.float32, device=c.device)
    xs = torch.as_tensor(xs, **kw)
    ys = torch.as_tensor(ys, **kw)
    zs = torch.as_tensor(zs, **kw)
    p = lambda i, j: c[:, i, j, None]                       # noqa: E731
    den = p(2, 2) * xs + p(2, 3)                            # (B, nx)
    u = (-p(0, 0)[..., None] * ys[None, None, :] +
         (p(0, 2) * xs + p(0, 3))[..., None]) / den[..., None]
    v = (-p(1, 1)[..., None] * zs[None, None, :] +
         (p(1, 2) * xs + p(1, 3))[..., None]) / den[..., None]
    return u, v


def slab_depth_static(xs, depth_min, depth_max, num_bins):
    """Static per-slab depth-bin taps (numpy): z0, z1 (clamped), tap
    weights w0 / w1 with border masking, and `in_range`, all (nx,)."""
    xs = np.asarray(xs, np.float32)
    rng = np.float32(depth_max) - np.float32(depth_min)
    z_norm = (xs - np.float32(depth_min)) / rng
    z_idx = z_norm * np.float32(num_bins - 1)
    z0 = np.floor(z_idx)
    f = z_idx - z0
    v0 = (z0 >= 0) & (z0 <= num_bins - 1)
    v1 = (z0 + 1 >= 0) & (z0 + 1 <= num_bins - 1)
    in_range = (z_norm >= 0) & (z_norm <= 1)
    return dict(
        z0=np.clip(z0, 0, num_bins - 1).astype(np.int32),
        z1=np.clip(z0 + 1, 0, num_bins - 1).astype(np.int32),
        w0=((1 - f) * v0).astype(np.float32),
        w1=(f * v1).astype(np.float32),
        in_range=in_range,
    )


def depth_tables(ds, device):
    """The static depth taps as device tensors (z0, z1 int32; w0, w1
    float32; in_range as uint8), the form the kernels take."""
    return (torch.as_tensor(ds['z0'], dtype=torch.int32, device=device),
            torch.as_tensor(ds['z1'], dtype=torch.int32, device=device),
            torch.as_tensor(ds['w0'], dtype=torch.float32, device=device),
            torch.as_tensor(ds['w1'], dtype=torch.float32, device=device),
            torch.as_tensor(ds['in_range'].astype(np.uint8),
                            device=device))


def build_fine_softmax_volume(cost, up_factor, pad_shape, dtype):
    """softmax_D(trilinear x`up_factor` upsample of cost) on the fine
    grid: (B, D, h, w) -> (B, D*up, H_f, W_f) in `dtype`. The three
    interpolation products and the softmax run in float32
    (`frustum_separable.py:254-277`)."""
    b, d, h, w = cost.shape
    h_f, w_f = pad_shape
    dev = cost.device
    wh = interp_matrix(h, h_f, device=dev)
    ww = interp_matrix(w, w_f, device=dev)
    wd = interp_matrix(d, d * up_factor, device=dev)
    x = cost.float()
    x = torch.matmul(wh, x)                                 # (B, D, Hf, w)
    x = torch.matmul(x, ww.t())                             # (B, D, Hf, Wf)
    x = torch.matmul(wd, x.reshape(b, d, h_f * w_f))        # (B, Df, Hf*Wf)
    x = torch.softmax(x, dim=1)
    return x.reshape(b, d * up_factor, h_f, w_f).to(dtype)


def valid_2d(u, v, pad_shape):
    """(B, nz, ny, nx) image-validity mask of the voxel projections."""
    pad_h, pad_w = pad_shape
    vu = (u >= 0) & (u <= pad_w)                            # (B, nx, ny)
    vv = (v >= 0) & (v <= pad_h)                            # (B, nx, nz)
    return vu.transpose(1, 2)[:, None] & vv.transpose(1, 2)[:, :, None]


def _axis_taps(idx, n):
    """Floor taps of fractional indices along an axis of length n:
    [(index clamped, weight with out-of-range taps zeroed)] x 2."""
    i0 = torch.floor(idx)
    f = idx - i0
    taps = []
    for di, wt in ((0, 1 - f), (1, f)):
        i = i0 + di
        ok = (i >= 0) & (i <= n - 1)
        taps.append((i.clamp(0, n - 1).long(), wt * ok.float()))
    return taps


def _voxel_taps(u, v, pad_shape, h, w):
    """Per-voxel (y, x) tap lists broadcast to (B, nz, ny, nx). The
    divisors are tensors so that the divisions are true ones on every
    device, as in the kernels: torch multiplies a CUDA tensor divided by
    a Python number by the number's reciprocal, which rounds otherwise."""
    last_h, last_w = (torch.tensor(p - 1., dtype=torch.float32,
                                   device=u.device) for p in pad_shape)
    x_idx = (u.float() / last_w * (w - 1)).transpose(1, 2)[:, None]
    y_idx = (v.float() / last_h * (h - 1)).transpose(1, 2)[:, :, None]
    return _axis_taps(y_idx, h), _axis_taps(x_idx, w)


def stereo_sample_plain(vol, u, v, z0, z1, w0, w1, in_range, pad_shape):
    """The stereo half of K2, the TPU kernel's function (and valid2d).

    Args:
        vol: (B, D, H, W, C) stereo volume.
        u (B, nx, ny), v (B, nx, nz): f32 pixel coords from `slab_uv`.
        z0, z1, w0, w1, in_range: (nx,) static depth taps
            (`depth_tables` of `slab_depth_static(num_bins=D)`).

    Returns:
        out (B, nz, ny, nx, C) in vol's dtype, zero where not
        `valid2d & in_range`; valid2d (B, nz, ny, nx) bool.
    """
    b, d, h, w, c = vol.shape
    flat = vol.reshape(-1, c)
    bidx = torch.arange(b, device=vol.device).view(b, 1, 1, 1)
    ys, xs = _voxel_taps(u, v, pad_shape, h, w)
    out = 0.
    for zi, wz in ((z0, w0), (z1, w1)):
        zrow = bidx * d + zi.long()                         # (B,1,1,nx)
        for yi, wy in ys:
            for xi, wx in xs:
                idx = ((zrow * h + yi) * w + xi)
                out = out + flat[idx].float() * (wz * wy * wx)[..., None]
    valid2d = valid_2d(u, v, pad_shape)
    keep = valid2d & in_range.bool()
    return (out * keep[..., None]).to(vol.dtype), valid2d


def attention_sample_plain(sm, u, v, z0, z1, w0, w1, in_range, pad_shape):
    """Plain version of K3: trilinear sample of the fine softmax volume
    sm (B, D_f, H_f, W_f) at every voxel; (B, nz, ny, nx) float32, zero
    where not `valid2d & in_range`. Depth taps from
    `slab_depth_static(num_bins=D_f)`."""
    b, d, h, w = sm.shape
    flat = sm.reshape(-1)
    bidx = torch.arange(b, device=sm.device).view(b, 1, 1, 1)
    ys, xs = _voxel_taps(u, v, pad_shape, h, w)
    out = 0.
    for zi, wz in ((z0, w0), (z1, w1)):
        zrow = bidx * d + zi.long()
        for yi, wy in ys:
            for xi, wx in xs:
                idx = ((zrow * h + yi) * w + xi)
                out = out + flat[idx].float() * (wz * wy * wx)
    keep = valid_2d(u, v, pad_shape) & in_range.bool()
    return out * keep


def sem_sample(sem, u, v, pad_shape, valid2d):
    """Bilinear sample of sem (B, Hs, Ws, Cs) at each voxel's (u, v)
    (depth ignored); (B, nz, ny, nx, Cs) in sem's dtype, zero where not
    valid2d. Cast before the mask multiply, as the JAX version."""
    b, hs, ws, cs = sem.shape
    flat = sem.reshape(-1, cs)
    bidx = torch.arange(b, device=sem.device).view(b, 1, 1, 1)
    ys, xs = _voxel_taps(u, v, pad_shape, hs, ws)
    out = 0.
    for yi, wy in ys:
        for xi, wx in xs:
            idx = (bidx * hs + yi) * ws + xi
            out = out + flat[idx].float() * (wy * wx)[..., None]
    return out.to(sem.dtype) * valid2d[..., None].to(sem.dtype)


def frustum_voxel_features_plain(vol, sem, att, u, v, z0, z1, w0, w1,
                                 in_range, pad_shape):
    """Plain version of the fused K2: the voxel feature volume the voxel
    ConvNorm reads.

    Args:
        vol: (B, D, H, W, C) stereo volume; sem: (B, Hs, Ws, Cs) semantic
            features in vol's dtype (Cs may be 0); att: (B, nz, ny, nx)
            float32 attention (K3's output).
        u, v, z0, z1, w0, w1, in_range, pad_shape: as
            `stereo_sample_plain`.

    Returns:
        (B, nz, ny, nx, C + Cs) in vol's dtype: the stereo sample, then
        the sem sample (zero where not valid2d) times att cast to the
        dtype.
    """
    voxel, valid2d = stereo_sample_plain(vol, u, v, z0, z1, w0, w1,
                                         in_range, pad_shape)
    if sem.shape[-1] == 0:
        return voxel
    sem = sem_sample(sem, u, v, pad_shape, valid2d)
    sem = sem * att.to(sem.dtype)[..., None]
    return torch.cat([voxel, sem], dim=-1)
