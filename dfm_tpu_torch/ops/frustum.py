"""Frustum -> voxel lifting for any projection (FrustumToVoxel's generic
branch).

Port of the functions that `dfm_tpu/models/necks/frustum_to_voxel.py:
207-236` computes with `dfm_tpu/ops/frustum.py`: the voxel centres
projected into (u, v, depth) (`project_voxels_to_frustum`, `:40`), the
stereo volume sampled trilinearly at them (`:71-95`), the depth-softmax
attention, softmax over depth of the x`up_factor` trilinearly upsampled
cost, sampled trilinearly at them (`:108-131, 215-256, 287-444`), and the
semantic features sampled bilinearly (`:259-283`). The JAX package packs
taps into wide rows and evaluates the attention through a base-27 table
with hat weights, layouts for the TPU's gathers; here each is a direct
gather per tap: the fine volume is never built either, each of the 8
fine taps of a query is the trilinear interpolant of the coarse cost at
that tap (its 8 coarse taps), less the log-sum-exp over depth of its
fine pixel (`depth_softmax_lse_map`, made a band of fine rows at a time).

Index conventions are the reference's (feature_transformation.py:
100-160): u, v scaled by (pad - 1) onto the map's (size - 1), depth by
[depth_min, depth_max] onto (D - 1); a tap outside its grid contributes
0 (`F.grid_sample`'s zeros padding, align corners); a query outside the
image (u in [0, pad_w], v in [0, pad_h]) or the depth range gives 0.
Plain PyTorch: no Pallas kernel lies on this branch in JAX.
"""

import torch

from ..core.boxes import pseudo_lidar_to_cam_points
from ..core.transforms import points_cam2img
from .resize import interp_matrix

__all__ = ['project_voxels_to_frustum', 'trilinear_gather',
           'bilinear_gather', 'sample_stereo_volume',
           'depth_softmax_lse_map', 'sample_softmax_attention',
           'sample_sem_features', 'frustum_voxel_features_generic']


def project_voxels_to_frustum(coors_pl, cam2img):
    """(..., 3) pseudo-LiDAR voxel centres and a (4, 4) cam2img ->
    (..., 3) = (u, v, camera depth)."""
    cam = pseudo_lidar_to_cam_points(coors_pl)
    uv = points_cam2img(cam.reshape(-1, 3), cam2img)
    return torch.cat([uv.reshape(cam.shape[:-1] + (2,)), cam[..., 2:3]], -1)


def _floor(x):
    x0 = torch.floor(x)
    return x0, x - x0


def trilinear_gather(vol, x, y, z):
    """Trilinear sample of a (D, H, W, C) volume at float indices x, y, z
    (...) -> (..., C) float32 (float64 for a float64 volume); a tap
    outside the volume contributes 0."""
    d, h, w, c = vol.shape
    flat = vol.reshape(d * h * w, c)
    acc = torch.float64 if vol.dtype == torch.float64 else torch.float32
    x0, fx = _floor(x)
    y0, fy = _floor(y)
    z0, fz = _floor(z)
    out = 0.
    for dz, wz in ((0, 1 - fz), (1, fz)):
        zi = z0 + dz
        vz = (zi >= 0) & (zi <= d - 1)
        zi = zi.clamp(0, d - 1).long()
        for dy, wy in ((0, 1 - fy), (1, fy)):
            yi = y0 + dy
            vy = vz & (yi >= 0) & (yi <= h - 1)
            yi = yi.clamp(0, h - 1).long()
            for dx, wx in ((0, 1 - fx), (1, fx)):
                xi = x0 + dx
                v = vy & (xi >= 0) & (xi <= w - 1)
                xi = xi.clamp(0, w - 1).long()
                wgt = (wx * wy * wz * v).to(acc)
                out = out + wgt[..., None] * \
                    flat[(zi * h + yi) * w + xi].to(acc)
    return out


def bilinear_gather(feat, x, y):
    """Bilinear sample of an (H, W, C) map at float indices x, y (...) ->
    (..., C) float32 (float64 for a float64 map); taps outside give 0."""
    h, w, c = feat.shape
    flat = feat.reshape(h * w, c)
    acc = torch.float64 if feat.dtype == torch.float64 else torch.float32
    x0, fx = _floor(x)
    y0, fy = _floor(y)
    out = 0.
    for dy, wy in ((0, 1 - fy), (1, fy)):
        yi = y0 + dy
        vy = (yi >= 0) & (yi <= h - 1)
        yi = yi.clamp(0, h - 1).long()
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi = x0 + dx
            v = vy & (xi >= 0) & (xi <= w - 1)
            xi = xi.clamp(0, w - 1).long()
            out = out + (wx * wy * v).to(acc)[..., None] * \
                flat[yi * w + xi].to(acc)
    return out


def _scaled(coord_img, pad_shape, sizes, depth_min, depth_max):
    """(x, y, z) indices of (u, v, depth) on a (D, H, W) grid, and the
    image (valid2d) and image + depth (valid) masks."""
    d, h, w = sizes
    pad_h, pad_w = pad_shape
    u, v, dep = coord_img.unbind(-1)
    z_norm = (dep - depth_min) / (depth_max - depth_min)
    valid2d = (u >= 0) & (u <= pad_w) & (v >= 0) & (v <= pad_h)
    valid = valid2d & (z_norm >= 0) & (z_norm <= 1)
    return (u / (pad_w - 1) * (w - 1), v / (pad_h - 1) * (h - 1),
            z_norm * (d - 1), valid2d, valid)


def sample_stereo_volume(stereo_vol, coord_img, pad_shape, depth_min,
                         depth_max):
    """The (D, H', W', C) stereo volume at the queries (..., 3) -> (...,
    C) in its dtype (0 outside the image or the depth range), valid2d,
    valid."""
    x, y, z, valid2d, valid = _scaled(coord_img, pad_shape,
                                      stereo_vol.shape[:3], depth_min,
                                      depth_max)
    out = trilinear_gather(stereo_vol, x, y, z) * valid[..., None]
    return out.to(stereo_vol.dtype), valid2d, valid


def depth_softmax_lse_map(cost, up_factor, pad_shape, band_bytes=1 << 26):
    """(H_f, W_f) float32 log-sum-exp over depth of the x`up_factor`
    trilinearly upsampled (align corners) (D, H, W) cost, made a band of
    fine rows at a time (at most about `band_bytes` of fine values)."""
    d, h, w = cost.shape
    h_f, w_f = pad_shape
    d_f = d * up_factor
    dev = cost.device
    wh = interp_matrix(h, h_f, device=dev)
    ww = interp_matrix(w, w_f, device=dev)
    wd = interp_matrix(d, d_f, device=dev)
    cost_w = torch.matmul(cost.float(), ww.t())                 # (D, H, W_f)
    rows = max(1, band_bytes // (4 * d_f * w_f))
    lse = torch.empty((h_f, w_f), dtype=torch.float32, device=dev)
    for r0 in range(0, h_f, rows):
        band = torch.matmul(wh[r0:r0 + rows], cost_w)    # (D, rows, W_f)
        fine = torch.matmul(wd, band.reshape(d, -1))     # (D_f, rows * W_f)
        lse[r0:r0 + rows] = torch.logsumexp(fine, 0).reshape(-1, w_f)
    return lse


def sample_softmax_attention(cost, lse, coord_img, pad_shape, depth_min,
                             depth_max, up_factor=4, base_dtype=None):
    """softmax_D(upsample x`up_factor`(cost)) sampled trilinearly at the
    queries (..., 3) -> (...) float32, from the (D, H, W) cost and its
    `depth_softmax_lse_map`: each of the 8 fine taps (clipped to the fine
    grid, weight 0 outside it) is exp(F - lse) with F the trilinear
    interpolant of the cost at the tap's coarse coordinate; `base_dtype`
    rounds the cost for F (JAX's generic branch reads it from a bfloat16
    table, `build_base27_tables(dtype=bfloat16)`); 0 outside the image or
    the depth range."""
    d, h, w = cost.shape
    h_f, w_f = lse.shape
    d_f = d * up_factor
    base = cost if base_dtype is None else cost.to(base_dtype)
    base = base.float()[..., None]
    x_f, y_f, z_f, _, valid = _scaled(coord_img, pad_shape, (d_f, h_f, w_f),
                                      depth_min, depth_max)
    x0, fx = _floor(x_f)
    y0, fy = _floor(y_f)
    z0, fz = _floor(z_f)
    sx, sy, sz = (w - 1) / (w_f - 1), (h - 1) / (h_f - 1), \
        (d - 1) / (d_f - 1)

    def tap(i0, di, n):
        i = i0 + di
        return i.clamp(0, n - 1), (i >= 0) & (i <= n - 1)

    out = 0.
    for dz, wz in ((0, 1 - fz), (1, fz)):
        zi, vz = tap(z0, dz, d_f)
        for dy, wy in ((0, 1 - fy), (1, fy)):
            yi, vy = tap(y0, dy, h_f)
            for dx, wx in ((0, 1 - fx), (1, fx)):
                xi, vx = tap(x0, dx, w_f)
                f = trilinear_gather(base, xi * sx, yi * sy, zi * sz)[..., 0]
                lt = lse[yi.long(), xi.long()]
                prob = torch.exp(torch.clamp(f - lt, max=60.0))
                out = out + wx * wy * wz * (vx & vy & vz) * prob
    return torch.where(valid, out, torch.zeros_like(out))


def sample_sem_features(sem_feat, coord_img, pad_shape, valid2d):
    """The (Hs, Ws, C) semantic map sampled bilinearly at the queries'
    (u, v) -> (..., C) in its dtype, 0 outside the image."""
    hs, ws = sem_feat.shape[:2]
    pad_h, pad_w = pad_shape
    u, v = coord_img[..., 0], coord_img[..., 1]
    out = bilinear_gather(sem_feat, u / (pad_w - 1) * (ws - 1),
                          v / (pad_h - 1) * (hs - 1)) * valid2d[..., None]
    return out.to(sem_feat.dtype)


def frustum_voxel_features_generic(stereo_vol, depth_cost, sem_feat,
                                   coors_3d, cam2img, pad_shape, depth_min,
                                   depth_max, up_factor=4):
    """FrustumToVoxel's generic voxel features (`single`,
    `frustum_to_voxel.py:207-236`) of a batch, in DfM's configuration
    (the sem features weighted by the attention, the stereo ones not),
    the attention's coarse cost read rounded to bfloat16 as JAX's table
    holds it.

    Args:
        stereo_vol: (B, D, H', W', Cv).
        depth_cost: (B, D, H', W') (no gradient is taken through the
            attention: JAX's stop_gradient).
        sem_feat: (B, Hs, Ws, Cs) or None.
        coors_3d: (Nz, Ny, Nx, 3) pseudo-LiDAR voxel centres (tensor).
        cam2img: (B, 4, 4).

    Returns:
        (B, Nz, Ny, Nx, Cv [+ Cs]) in the stereo volume's dtype: the stereo
        sample, then the sem sample x the attention.
    """
    coors = torch.as_tensor(coors_3d, dtype=torch.float32,
                            device=stereo_vol.device)
    out = []
    for i in range(stereo_vol.shape[0]):
        coord = project_voxels_to_frustum(coors, cam2img[i].float())
        voxel, valid2d, _ = sample_stereo_volume(
            stereo_vol[i], coord, pad_shape, depth_min, depth_max)
        if sem_feat is not None:
            with torch.no_grad():
                cost = depth_cost[i].detach()
                lse = depth_softmax_lse_map(cost, up_factor, pad_shape)
                att = sample_softmax_attention(
                    cost, lse, coord, pad_shape, depth_min, depth_max,
                    up_factor, torch.bfloat16)[..., None].to(voxel.dtype)
            sem = sample_sem_features(sem_feat[i], coord, pad_shape, valid2d)
            voxel = torch.cat([voxel, (sem * att).to(voxel.dtype)], -1)
        out.append(voxel)
    return torch.stack(out)
