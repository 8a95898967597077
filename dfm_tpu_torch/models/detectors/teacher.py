"""The frozen dense LiDAR teacher of DfMFull (train time only).

Port of `dfm_tpu/models/detectors/teacher.py:33-141` (`voxelize_mean`,
`LidarTeacher`): points scatter-averaged onto a dense grid at the
imitation resolution (the reference's dynamic voxelization + simple VFE;
a cap per voxel gives its hard form), an occupancy channel, three 3^3
ConvNorms with BatchNorm (enc0 16, enc1 and enc2 the volume width), a
mean pool over z by `pool_z`, the height compression (channel z * C + c)
and a BEVHourglass with BatchNorm. The scatter is `index_add_`, plain
PyTorch (JAX: `segment_sum`); the convs are cuDNN's (JAX: XLA's).
Outputs are channels-last, as the JAX package's.
"""

import numpy as np
import torch
import torch.nn as nn

from ..backbones.bev_hourglass import BEVHourglass
from ..layers import ConvNorm

__all__ = ['voxelize_mean', 'LidarTeacher']


def voxelize_mean(points, point_mask, pcr, voxel_size, grid_size,
                  max_points=None):
    """Scatter-mean of one sample's points onto a dense voxel grid.

    Args:
        points: (P, C >= 3) points, padded.
        point_mask: (P,) validity.
        pcr: point-cloud range (6,).
        voxel_size: (vx, vy, vz).
        grid_size: (Nz, Ny, Nx).
        max_points: None averages every point of a voxel; an int keeps
            the first `max_points` of each voxel in arrival order.

    Returns:
        (Nz, Ny, Nx, C) means (0 where empty), (Nz, Ny, Nx) counts.

    Indices are floor((p - lo) / size) (negative coordinates do not
    truncate towards 0); points outside the grid or masked go to a dump
    slot past the grid. Divisions are by tensors, as XLA divides (not by
    a reciprocal).
    """
    nz, ny, nx = grid_size
    lo = torch.as_tensor(pcr[:3], dtype=torch.float32, device=points.device)
    size = torch.as_tensor(voxel_size, dtype=torch.float32,
                           device=points.device)
    idx = torch.floor((points[:, :3] - lo) / size).to(torch.int64)
    ix, iy, iz = idx.unbind(-1)
    inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) &
              (iz >= 0) & (iz < nz) & point_mask.bool())
    dump = nz * ny * nx
    flat = torch.where(inside, (iz * ny + iy) * nx + ix,
                       torch.full_like(ix, dump))
    if max_points is not None:
        # each point's rank within its voxel (arrival order): a stable
        # sort by voxel, then the position less the segment's start
        p = points.shape[0]
        order = torch.argsort(flat, stable=True)
        sorted_flat = flat[order]
        pos = torch.arange(p, device=points.device)
        is_start = torch.ones_like(inside)
        is_start[1:] = sorted_flat[1:] != sorted_flat[:-1]
        seg_start = torch.cummax(torch.where(is_start, pos,
                                             torch.zeros_like(pos)), 0)[0]
        rank = torch.empty_like(pos).scatter_(0, order, pos - seg_start)
        inside = inside & (rank < max_points)
        flat = torch.where(inside, flat, torch.full_like(flat, dump))
    feats = torch.where(inside[:, None], points,
                        torch.zeros((), dtype=points.dtype,
                                    device=points.device))
    c = points.shape[-1]
    sums = torch.zeros((dump + 1, c), dtype=points.dtype,
                       device=points.device).index_add_(0, flat, feats)
    cnts = torch.zeros(dump + 1, dtype=points.dtype,
                       device=points.device).index_add_(
                           0, flat, inside.to(points.dtype))
    mean = sums[:-1] / torch.clamp(cnts[:-1, None], min=1.0)
    return mean.reshape(nz, ny, nx, c), cnts[:-1].reshape(nz, ny, nx)


class LidarTeacher(nn.Module):
    """Dense voxel encoder + BEV hourglass: the imitation targets.
    Keys: enc0, enc1, enc2 (conv + bn), bev (BEVHourglass with 'bn')."""

    def __init__(self, point_cloud_range=(2, -30.4, -3, 59.6, 30.4, 1),
                 voxel_size=(0.2, 0.2, 0.2), pool_z=4, volume_channels=32,
                 bev_channels=64):
        super().__init__()
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.pool_z = pool_z
        nz = self.grid_size()[0]
        # the mean (x, y, z) of each voxel and its occupancy
        self.enc0 = ConvNorm(4, 16, 3, ndim=3, norm='bn')
        self.enc1 = ConvNorm(16, volume_channels, 3, ndim=3, norm='bn')
        self.enc2 = ConvNorm(volume_channels, volume_channels, 3, ndim=3,
                             norm='bn')
        self.bev = BEVHourglass(nz // pool_z * volume_channels,
                                bev_channels, norm='bn')

    def grid_size(self):
        pcr = np.asarray(self.point_cloud_range, np.float32)
        gs = np.round((pcr[3:] - pcr[:3]) /
                      np.asarray(self.voxel_size)).astype(int)
        return int(gs[2]), int(gs[1]), int(gs[0])

    def forward(self, points, point_mask):
        """(B, P, 3) points, (B, P) mask -> volume features (B, Nz /
        pool_z, Ny, Nx, C), BEV features (B, Ny, Nx, C2)."""
        gs = self.grid_size()
        vox, cnt = zip(*[voxelize_mean(p, m, self.point_cloud_range,
                                       self.voxel_size, gs)
                         for p, m in zip(points, point_mask)])
        vox, cnt = torch.stack(vox), torch.stack(cnt)
        x = torch.cat([vox, (cnt > 0).to(vox.dtype)[..., None]], -1)
        x = self.enc2(self.enc1(self.enc0(x.permute(0, 4, 1, 2, 3))))
        b, c, nz, ny, nx = x.shape
        vol = x.reshape(b, c, nz // self.pool_z, self.pool_z, ny,
                        nx).mean(3)                      # (B, C, Nz', Ny, Nx)
        bev = vol.permute(0, 2, 1, 3, 4).reshape(b, -1, ny, nx)
        _, bev_feat = self.bev(bev)
        return vol.permute(0, 2, 3, 4, 1), bev_feat.permute(0, 2, 3, 1)
