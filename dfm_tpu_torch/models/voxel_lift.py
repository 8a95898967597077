"""The voxel lifting that MultiViewDfM and ImVoxelNet share: the sample
grid, its sample of one view's feature map, and the anchors on the BEV
grid.

Port of what `dfm_tpu/models/detectors/multiview_dfm.py` and
`imvoxelnet.py` each define for themselves: `sample_points` (the aligned
anchor generator's voxel centres, (Nz, Ny, Nx) in (x, y, z)),
`anchor_generator`, the projection and bilinear sample of `sample_one`,
and the per-class anchors of `_mv_anchors` / `_anchors`.
"""

import functools

import torch

from ..core.anchors import (AlignedAnchor3DRangeGenerator,
                            Anchor3DRangeGenerator)
from ..core.transforms import transform_points
from ..ops.point_sample import point_sample

__all__ = ['VoxelGridConfig', 'grid_centres', 'sample_scales', 'view_sample']


def grid_centres(voxel_range, voxel_grid):
    """(Nz, Ny, Nx, 3) float32 centres (x, y, z) of the aligned grid of
    `voxel_grid` (Nz, Ny, Nx) cells over `voxel_range`."""
    gen = AlignedAnchor3DRangeGenerator(
        ranges=[list(voxel_range)], sizes=[[1, 1, 1]], rotations=[0.0])
    a = gen.anchors_single_range(voxel_grid, voxel_range, [1, 1, 1])
    return a[:, :, :, 0, 0, :3]


class VoxelGridConfig:
    """The sample grid and the anchors of a config with `voxel_range`,
    `voxel_grid` (Nz, Ny, Nx) and `anchor_ranges` / `_sizes` /
    `_rotations` (MultiViewDfM's, ImVoxelNet's)."""

    def sample_points(self):
        """(Nz, Ny, Nx, 3) float32 sample-grid centres (x, y, z)."""
        return grid_centres(self.voxel_range, self.voxel_grid)

    def grid_points(self, device):
        """The sample points, (Nz * Ny * Nx, 3) float32 on `device`, made
        once for each grid and device."""
        return _grid_points(tuple(self.voxel_range), tuple(self.voxel_grid),
                            str(device))

    def anchor_generator(self):
        return Anchor3DRangeGenerator(
            ranges=list(self.anchor_ranges), sizes=list(self.anchor_sizes),
            rotations=list(self.anchor_rotations))

    def anchors_per_class(self, featmap_size, device):
        """The (Ny * Nx * R, 7) anchors of each class in the head's (y,
        x, rot) order (the loss's)."""
        grid = self.anchor_generator().grid_anchors(tuple(featmap_size))
        return [torch.as_tensor(grid[0, :, :, c].reshape(-1, 7),
                                device=device)
                for c in range(len(self.anchor_sizes))]

    def flat_anchors(self, featmap_size, device):
        """All anchors, (Ny * Nx * K * R, 7) in the head's order (the
        decode's), made once for each grid and device."""
        return _flat_anchors(tuple(map(tuple, self.anchor_ranges)),
                             tuple(map(tuple, self.anchor_sizes)),
                             tuple(self.anchor_rotations),
                             tuple(featmap_size), str(device))


@functools.lru_cache(maxsize=8)
def _grid_points(voxel_range, voxel_grid, device):
    return torch.as_tensor(grid_centres(voxel_range, voxel_grid)
                           .reshape(-1, 3), device=device)


@functools.lru_cache(maxsize=8)
def _flat_anchors(ranges, sizes, rotations, featmap_size, device):
    grid = Anchor3DRangeGenerator(list(ranges), list(sizes),
                                  list(rotations)).grid_anchors(featmap_size)
    return torch.as_tensor(grid.reshape(-1, 7), device=device)


def sample_scales(pts, img_hw, feat_hw):
    """The (w - 1, h - 1) of the image and of the feature map as tensors
    of `pts`' dtype and device: the sample divides by them as tensors (a
    CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead)."""
    (h, w), (fh, fw) = img_hw, feat_hw
    return pts.new_tensor([w - 1, h - 1]), pts.new_tensor([fw - 1, fh - 1])


def view_sample(feat, pts, lidar2img, img_hw, img_max, feat_max):
    """One view's sample of the grid points: `pts` (P, 3) projected by
    `lidar2img` (4, 4), valid where in front of the camera and inside the
    (H, W) image, the pixel scaled by (fw - 1) / (w - 1) onto the feature
    map (C, fh, fw) -> ((C, P) float32 sample, zero where not valid; (P,)
    bool valid)."""
    h, w = img_hw
    uvw = transform_points(pts, lidar2img.to(pts.dtype))
    depth = uvw[:, 2]
    uv = uvw[:, :2] / depth.abs().clamp(min=1e-5)[:, None]
    valid = ((depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
             & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    return point_sample(feat, uv / img_max * feat_max, valid), valid
