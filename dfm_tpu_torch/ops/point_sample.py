"""Bilinear sampling of a 2D feature map at scattered points.

Port of `dfm_tpu/ops/packed_sample.py:50-101` (`pack_taps_2d` +
`packed_bilinear_sample`), as MultiViewDfM calls it: the map sampled at
align-corners index coordinates (x, y), each of the four taps weighted
by its bilinear weight and counted only where it lies inside the map
(`padding_mode='zeros'`: a point at floor index -1 gets the edge pixel
at weight fx, one past the far edge the edge pixel at weight 1 - fx).

The JAX package packs the four taps into one row because TPU gathers
are bound by their row count; here the sample is one `F.grid_sample`
call on the card and the CPU alike, the index coordinates normalised to
its align-corners range [-1, 1]. Values come back in float32 (the JAX
package combines bfloat16 taps in float32 too), channels first, so the
caller's (C, P) accumulator is the NCDHW volume once reshaped.
"""

import torch
import torch.nn.functional as F

__all__ = ['point_sample']

# a normalised coordinate whose four taps all lie outside the map
_OUTSIDE = -3.0


def point_sample(feat, coords, valid=None):
    """Sample `feat` (C, H, W) at `coords` (P, 2), (x, y) align-corners
    pixel indices -> (C, P) float32, zero outside the map and, where
    `valid` (P,) is given, zero where it is False (those points are sent
    outside the map, so the sample needs no masking pass of its own).
    A float64 map is sampled in float64."""
    c, h, w = feat.shape
    dtype = torch.float64 if feat.dtype == torch.float64 else torch.float32
    scale = coords.new_tensor([2.0 / (w - 1), 2.0 / (h - 1)], dtype=dtype)
    grid = coords.to(dtype) * scale - 1.0
    if valid is not None:
        grid = torch.where(valid[:, None], grid, _OUTSIDE)
    return F.grid_sample(feat[None].to(dtype), grid.view(1, 1, -1, 2),
                         mode='bilinear', padding_mode='zeros',
                         align_corners=True)[0, :, 0]
