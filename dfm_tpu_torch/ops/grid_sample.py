"""Bilinear sampling of a channels-last feature map at pixel indices.

Port of `dfm_tpu/ops/grid_sample.py:31-62` (`bilinear_sample`, the
gather form of `F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True)`): the coordinates are (x, y) pixel indices, not the
normalised [-1, 1] grid, and each of the four taps counts only where it
lies inside the map. The taps are summed in JAX's order, (y0, x0), (y0,
x1), (y1, x0), (y1, x1), each weighted by wx * wy, so the result is JAX's
on the same inputs. MVX's PointFusion samples its image features with it.
"""

import torch

__all__ = ['bilinear_sample']


def bilinear_sample(feat, coords):
    """feat (H, W, C), coords (..., 2) as (x, y) pixel indices -> (..., C)
    samples; taps outside the map contribute 0."""
    h, w, c = feat.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = feat.reshape(h * w, c)
    out = 0.
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            xi_c = torch.clamp(xi, 0, w - 1).long()
            yi_c = torch.clamp(yi, 0, h - 1).long()
            vals = flat[yi_c * w + xi_c]
            wgt = (wx * wy * valid.to(feat.dtype))[..., None]
            out = out + wgt * vals
    return out
