"""Temporal-stereo plane-sweep cost volume.

Port of `dfm_tpu/ops/cost_volume.py` (`plane_sweep_grids` :31-91 and
`build_plane_sweep_cost(split=True)` :152-188). Coordinates stay in
align-corners pixel index space (no [-1, 1] normalisation). The cur
half of the volume is a strided slice of the cur features (constant
along depth); the prev half is a bilinear warp, kernel K1, whose plain
version is `warp_prev_plain` below. The kernel computes each sample
point itself from a parameter row per sample (`sweep_params`: the
composed projective map and the augmentation) and the depth
(`ops/cuda/sampling.py:warp_prev_sweep`, plain version
`sweep_coords_plain` + `warp_prev_plain`, which it takes on the CPU), so
the grids are never materialised. `plane_sweep_grids`, the JAX
package's grids, stays as the tests' reference for those points. The
kernel has no band limit, so the JAX package's `band_ok` / `lax.cond`
gather fallback has no counterpart.
"""

import torch
from torch.profiler import record_function

from ..core.transforms import apply_mat, homogeneous, points_cam2img, \
    points_img2cam

__all__ = ['plane_sweep_grids', 'sweep_params', 'sweep_coords_plain',
           'warp_prev_plain', 'build_plane_sweep_cost']


def plane_sweep_grids(depths, cam2img, cur2prev, feat_shape,
                      cost_sample_factor, feat_sample_factor, org_w, flip,
                      crop_offset, scale_factor):
    """Cur/prev sampling grids in float32, batched.

    Args:
        depths: (D,) depth hypotheses.
        cam2img, cur2prev: (B, 4, 4).
        feat_shape: (h_in, w_in) of the stereo feature maps.
        org_w, flip, scale_factor: (B,); crop_offset: (B, 2).

    Returns:
        cur_grid, prev_grid: (B, D, H', W', 2) pixel coords (x, y).
    """
    f32 = dict(dtype=torch.float32, device=depths.device)
    cam2img = cam2img.float()
    cur2prev = cur2prev.float()
    b = cam2img.shape[0]
    h_in, w_in = feat_shape
    h_out = round(h_in / cost_sample_factor)
    w_out = round(w_in / cost_sample_factor)
    step = feat_sample_factor * cost_sample_factor
    ws = torch.arange(w_out, **f32) * step
    hs = torch.arange(h_out, **f32) * step
    dd, yy, xx = torch.meshgrid(depths.float(), hs, ws, indexing='ij')
    n = dd.numel()
    xx, yy, dd = (t.reshape(1, n).expand(b, n) for t in (xx, yy, dd))

    flip = flip.float()[:, None] > 0
    org_w = org_w.float()[:, None]
    sf = scale_factor.float()[:, None]
    co = crop_offset.float()
    # undo augmentation: crop back -> scale back -> flip back
    u = (xx + co[:, :1]) / sf
    v = (yy + co[:, 1:]) / sf
    u = torch.where(flip, org_w - u, u)
    grid3d = points_img2cam(torch.stack([u, v, dd], -1), cam2img)
    cur_uv = points_cam2img(grid3d, cam2img)
    prev3d = apply_mat(homogeneous(grid3d), cur2prev)[..., :3]
    prev_uv = points_cam2img(prev3d, cam2img)

    def reapply_aug(uv):
        u = torch.where(flip, org_w - uv[..., 0], uv[..., 0])
        uv = torch.stack([u, uv[..., 1]], dim=-1)
        uv = uv * sf[..., None] - co[:, None]
        return (uv / feat_sample_factor).reshape(
            b, depths.shape[0], h_out, w_out, 2)

    return reapply_aug(cur_uv), reapply_aug(prev_uv)


SWEEP_PARAMS = 18     # floats of a parameter row of `sweep_params`


def sweep_params(cam2img, cur2prev, org_w, flip, crop_offset, scale_factor,
                 feat_sample_factor=1):
    """The (B, 18) float32 parameter rows of the plane sweep, on the
    device of cam2img, with no host sync: rows 0-2 of
    M = cam2img . cur2prev . cam2img^-1 (12, row-major), where the 4th
    component of the camera point is taken as 1 after each of the last
    two maps (`points_img2cam` and `homogeneous` do so), then org_w,
    flip, crop_offset (x, y), scale_factor and 1 / feat_sample_factor.
    M is composed in float64 (one 4 x 4 solve per sample) and rounded
    once."""
    p = cam2img.double()
    b = p.shape[0]
    eye = torch.eye(4, dtype=torch.float64, device=p.device).expand(b, 4, 4)
    inv, _ = torch.linalg.solve_ex(p, eye)
    keep_w = lambda m: torch.cat([m[:, :3], eye[:, 3:]], 1)   # noqa: E731
    m = torch.matmul(torch.matmul(p, keep_w(cur2prev.double())),
                     keep_w(inv))[:, :3].reshape(b, 12)
    f32 = dict(dtype=torch.float32, device=p.device)
    cols = [m.float(), org_w.float()[:, None], flip.float()[:, None],
            crop_offset.float().reshape(b, 2), scale_factor.float()[:, None],
            torch.full((b, 1), 1.0 / feat_sample_factor, **f32)]
    return torch.cat(cols, 1).contiguous()


def sweep_coords_plain(params, depths, hq, wq, step):
    """The prev-frame sample points of the plane sweep from
    `sweep_params` rows, evaluated as K1's sweep computes them, each
    product, sum and quotient rounded alone in this order.

    Args:
        params: (B, 18) float32 rows of `sweep_params`.
        depths: (D,) depth hypotheses.
        hq, wq: output rows and columns; step: the feature-pixel step of
            one output pixel (feat_sample_factor * cost_sample_factor).

    Returns:
        u, v: (B, D, hq, wq) float32, the `prev_grid` of
        `plane_sweep_grids`.
    """
    f32 = dict(dtype=torch.float32, device=params.device)
    col = lambda i: params[:, i].view(-1, 1, 1, 1)            # noqa: E731
    org_w, cox, coy, sf, inv = col(12), col(14), col(15), col(16), col(17)
    flip = col(13) > 0
    xx = (torch.arange(wq, **f32) * step).view(1, 1, 1, wq)
    yy = (torch.arange(hq, **f32) * step).view(1, 1, hq, 1)
    dd = depths.float().view(1, -1, 1, 1)
    u = (xx + cox) / sf
    v = (yy + coy) / sf
    u = torch.where(flip, org_w - u, u)
    r = [dd * (col(4 * i) * u + col(4 * i + 1) * v + col(4 * i + 2)) +
         col(4 * i + 3) for i in range(3)]
    pu = r[0] / r[2]
    pv = r[1] / r[2]
    pu = torch.where(flip, org_w - pu, pu)
    return (pu * sf - cox) * inv, (pv * sf - coy) * inv


def warp_prev_plain(prev, u, v):
    """Plain version of K1: bilinear sample of `prev` (B, H, W, C) at
    (u, v) (B, D, Hq, Wq) in align-corners index space, taps outside the
    map weighing zero, f32 accumulation. Returns (B, D, Hq, Wq, C) in
    prev's dtype."""
    b, h, w, c = prev.shape
    u = u.float()
    v = v.float()
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    flat = prev.reshape(b * h * w, c)
    bidx = torch.arange(b, device=prev.device).view(b, 1, 1, 1)
    out = torch.zeros(u.shape + (c,), dtype=torch.float32,
                      device=prev.device)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        yi = y0 + dy
        vy = (yi >= 0) & (yi <= h - 1)
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi = x0 + dx
            vx = (xi >= 0) & (xi <= w - 1)
            wgt = wx * wy * (vx & vy).float()
            idx = (bidx * h + yi.clamp(0, h - 1).long()) * w + \
                xi.clamp(0, w - 1).long()
            out += flat[idx].float() * wgt[..., None]
    return out.to(prev.dtype)


def build_plane_sweep_cost(cur_feats, prev_feats, depths, cam2img, cur2prev,
                           cost_sample_factor=4, feat_sample_factor=4,
                           org_w=None, flip=None, crop_offset=None,
                           scale_factor=None):
    """The split plane-sweep volume (JAX `split=True`).

    Args:
        cur_feats / prev_feats: (B, H, W, C) stereo features.
        depths: (D,); cam2img, cur2prev: (B, 4, 4); aug meta as in
            `plane_sweep_grids` (None = identity aug).

    Returns:
        cur2d (B, H', W', C) — the cur half, constant along depth — and
        prev (B, D, H', W', C), the prev half warped by K1.
    """
    from .cuda.sampling import warp_prev_sweep
    csf = cost_sample_factor
    if float(csf) != float(int(csf)):
        raise ValueError('the cur half must be a pure slice: '
                         'cost_sample_factor has to be an integer')
    csf = int(csf)
    b, h_in, w_in, _ = cur_feats.shape
    f32 = dict(dtype=torch.float32, device=cur_feats.device)
    if org_w is None:
        org_w = torch.full((b,), float(w_in * feat_sample_factor), **f32)
    if flip is None:
        flip = torch.zeros((b,), **f32)
    if crop_offset is None:
        crop_offset = torch.zeros((b, 2), **f32)
    if scale_factor is None:
        scale_factor = torch.ones((b,), **f32)
    h_out = round(h_in / csf)
    w_out = round(w_in / csf)
    cur2d = cur_feats[:, :h_out * csf:csf, :w_out * csf:csf]
    span = 'dfm.stereo_backbone.cost_volume.'
    with record_function(span + 'grid'):
        params = sweep_params(cam2img, cur2prev, org_w, flip, crop_offset,
                              scale_factor, feat_sample_factor)
    with record_function(span + 'warp'):
        return cur2d, warp_prev_sweep(prev_feats.contiguous(), params, depths,
                                      h_out, w_out, feat_sample_factor * csf)
