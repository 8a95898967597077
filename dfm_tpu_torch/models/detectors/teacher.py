"""The frozen LiDAR teachers of DfMFull and DfMWithTeacher (train time
only), and VoxelNet's encoder.

Port of `dfm_tpu/models/detectors/teacher.py:33-330`.

The dense teacher (`voxelize_mean`, `LidarTeacher`): points
scatter-averaged onto a dense grid at the
imitation resolution (the reference's dynamic voxelization + simple VFE;
a cap per voxel gives its hard form), an occupancy channel, three 3^3
ConvNorms with BatchNorm (enc0 16, enc1 and enc2 the volume width), a
mean pool over z by `pool_z`, the height compression (channel z * C + c)
and a BEVHourglass with BatchNorm. The scatter is `index_add_`, plain
PyTorch (JAX: `segment_sum`); the convs are cuDNN's (JAX: XLA's).

The sparse teacher (`SparseBN`, `SparseEncoder05`, `SparseLidarTeacher`):
the reference's own 0.05 m teacher (CustomSparseEncoder on spconv). Hard
voxelization of at most `capacity` voxels (5 points a voxel) on the
(41, 1216, 1152) grid, a SubM input conv (3 -> 16) and stage 1, three
strided stages (16 -> 32, 32 -> 64 at stride 2; 64 -> 64 at (2, 1, 1)
with padding (0, 1, 1)) of a SparseConv3d and two SubM convs each, every
conv followed by `SparseBN` and ReLU, a 1x1 conv_out (64 -> 32, no norm),
then the dense (5, 304, 288, 32) volume, its height compression and the
BEV hourglass: DfM's imitation grid (`ops/sparse_conv.py`, plain
PyTorch gathers and matmuls). `SparseBN` is BatchNorm1d(eps 1e-3,
momentum 0.01) over the active voxels of the batch only (over the
global batch in a process group), dead slots 0 on output; its running
statistics follow the torch convention (running = 0.99 running + 0.01
batch, the biased variance as JAX stores it).

Outputs are channels-last, as the JAX package's.
"""

import numpy as np
import torch
import torch.nn as nn

from ..backbones.bev_hourglass import BEVHourglass
from ..layers import ConvNorm, stat_float
from ...ops.sparse_conv import (neighbor_table, sparse_conv_downsample,
                                sparse_to_dense, sparse_voxelize_mean,
                                subm_conv)
from ...parallel import dist as D

__all__ = ['voxelize_mean', 'LidarTeacher', 'SparseBN', 'SpKernel',
           'SparseEncoder05', 'SparseLidarTeacher']


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
    """Dense voxel encoder + BEV hourglass: the imitation targets, and
    VoxelNet's encoder. Keys: enc0, enc1, enc2 (conv + bn), bev
    (BEVHourglass with 'bn'). `max_points` caps each voxel's points in
    arrival order (hard voxelization, SECOND's 5; None averages them all,
    JAX `teacher.py:92-101, 117-122`); the voxel features go into the
    encoder in `dtype`."""

    def __init__(self, point_cloud_range=(2, -30.4, -3, 59.6, 30.4, 1),
                 voxel_size=(0.2, 0.2, 0.2), pool_z=4, volume_channels=32,
                 bev_channels=64, max_points=None, dtype=torch.float32):
        super().__init__()
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.pool_z = pool_z
        self.max_points = max_points
        self.dtype = dtype
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
        return self.encode(self.voxelize(points, point_mask))

    def voxelize(self, points, point_mask):
        """The encoder's input (B, 4, Nz, Ny, Nx) in `dtype`: each voxel's
        mean (x, y, z) and its occupancy."""
        gs = self.grid_size()
        vox, cnt = zip(*[voxelize_mean(p, m, self.point_cloud_range,
                                       self.voxel_size, gs, self.max_points)
                         for p, m in zip(points, point_mask)])
        vox, cnt = torch.stack(vox), torch.stack(cnt)
        x = torch.cat([vox, (cnt > 0).to(vox.dtype)[..., None]],
                      -1).to(self.dtype)
        return x.permute(0, 4, 1, 2, 3)

    def encode(self, x):
        """`voxelize`'s output -> (volume features, BEV features)."""
        x = self.enc2(self.enc1(self.enc0(x)))
        b, c, nz, ny, nx = x.shape
        vol = x.reshape(b, c, nz // self.pool_z, self.pool_z, ny,
                        nx).mean(3)                      # (B, C, Nz', Ny, Nx)
        bev = vol.permute(0, 2, 1, 3, 4).reshape(b, -1, ny, nx)
        _, bev_feat = self.bev(bev)
        return vol.permute(0, 2, 3, 4, 1), bev_feat.permute(0, 2, 3, 1)


class SparseBN(nn.Module):
    """BatchNorm1d over the active voxels (JAX `teacher.py:146-187`):
    x (B, V, C), vmask (B, V) -> (B, V, C), 0 at dead slots."""
    eps = 1e-3
    momentum = 0.01

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.empty(c))
        self.register_buffer('running_var', torch.empty(c))

    def forward(self, x, vmask):
        m = vmask[..., None].to(stat_float(x).dtype)
        xf = stat_float(x)
        if self.training:
            sums = D.sum_over_group(torch.cat([(xf * m).sum((0, 1)),
                                               m.sum().reshape(1)]))
            cnt = torch.clamp(sums[-1], min=1.0)
            mean = sums[:-1] / cnt
            var = D.sum_over_group(((xf - mean) ** 2 * m).sum((0, 1))) / cnt
            with torch.no_grad():
                mo = self.momentum
                self.running_mean.copy_((1 - mo) * self.running_mean +
                                        mo * mean)
                self.running_var.copy_((1 - mo) * self.running_var +
                                       mo * var)
        else:
            mean = stat_float(self.running_mean)
            var = stat_float(self.running_var)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * stat_float(self.weight) + stat_float(self.bias)
        return (y * m).to(x.dtype)


class SpKernel(nn.Module):
    """A sparse conv's tap-major kernel `kernel` (K, C_in, C_out)."""

    def __init__(self, taps, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout))


class SparseEncoder05(nn.Module):
    """LIGA's CustomSparseEncoder at 0.05 m (JAX `teacher.py:202-281`):
    keys (B, V) sorted, feats (B, V, C_in), vmask (B, V) -> the dense (B,
    Nz, Ny, Nx, 32) volume, (5, 304, 288) for the (41, 1216, 1152) grid.
    Level capacities: V x 0.5, 0.25 and 0.5 (multiples of 8) after the
    three strided convs. Keys: conv_input, bn_input, enc0_0, bn0_0,
    enc{s}_down, bn{s}_down, enc{s}_{1,2}, bn{s}_{1,2} (s = 1..3),
    conv_out."""

    # (stride, padding, channels, capacity fraction) of the strided stages
    SPECS = (((2, 2, 2), (1, 1, 1), (16, 32, 32, 32), 0.5),
             ((2, 2, 2), (1, 1, 1), (32, 64, 64, 64), 0.25),
             ((2, 1, 1), (0, 1, 1), (64, 64, 64, 64), 0.5))

    def __init__(self, sparse_shape=(41, 1216, 1152), dtype=torch.float32):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.dtype = dtype
        self.conv_input = SpKernel(27, 3, 16)
        self.bn_input = SparseBN(16)
        self.enc0_0 = SpKernel(27, 16, 16)
        self.bn0_0 = SparseBN(16)
        for s, (_, _, chs, _) in enumerate(self.SPECS, start=1):
            setattr(self, f'enc{s}_down', SpKernel(27, chs[0], chs[1]))
            setattr(self, f'bn{s}_down', SparseBN(chs[1]))
            for j in (1, 2):
                setattr(self, f'enc{s}_{j}', SpKernel(27, chs[j], chs[j + 1]))
                setattr(self, f'bn{s}_{j}', SparseBN(chs[j + 1]))
        self.conv_out = SpKernel(1, 64, 32)

    def out_grid(self):
        g = self.sparse_shape
        for stride, pad, _, _ in self.SPECS:
            g = tuple((n + 2 * p - 3) // st + 1
                      for n, st, p in zip(g, stride, pad))
        return g

    def _subm(self, x, tables, name):
        w = getattr(self, name).kernel.to(self.dtype)
        return torch.stack([subm_conv(f.to(self.dtype), t, w)
                            for f, t in zip(x, tables)])

    def _bn_relu(self, x, vmask, name):
        return torch.relu(getattr(self, name)(x, vmask))

    def forward(self, keys, feats, vmask):
        v = keys.shape[1]
        grid = self.sparse_shape
        nbr = [neighbor_table(k, m, grid) for k, m in zip(keys, vmask)]
        x = self._bn_relu(self._subm(feats, nbr, 'conv_input'), vmask,
                          'bn_input')
        x = self._bn_relu(self._subm(x, nbr, 'enc0_0'), vmask, 'bn0_0')
        for s, (stride, pad, _, frac) in enumerate(self.SPECS, start=1):
            cap = max(int(v * frac) // 8 * 8, 8)
            downs = [sparse_conv_downsample(k, m, grid, stride, pad, cap)
                     for k, m in zip(keys, vmask)]
            keys = torch.stack([d[0] for d in downs])
            vmask = torch.stack([d[1] for d in downs])
            grid = downs[0][2]
            x = self._bn_relu(self._subm(x, [d[3] for d in downs],
                                         f'enc{s}_down'), vmask,
                              f'bn{s}_down')
            nbr = [neighbor_table(k, m, grid) for k, m in zip(keys, vmask)]
            for j in (1, 2):
                x = self._bn_relu(self._subm(x, nbr, f'enc{s}_{j}'), vmask,
                                  f'bn{s}_{j}')
        w = self.conv_out.kernel[0].to(self.dtype)
        x = torch.matmul(x.to(self.dtype), w) * vmask[..., None].to(
            self.dtype)
        return torch.stack([sparse_to_dense(k, m, f, grid)
                            for k, m, f in zip(keys, vmask, x)])


class SparseLidarTeacher(nn.Module):
    """The teacher with the reference's 0.05 m sparse encoder (JAX
    `teacher.py:284-314`): `LidarTeacher`'s outputs, volume features (B,
    5, 304, 288, 32) and BEV features, the volume from `SparseEncoder05`
    (module `middle_encoder`) on the hard voxelization, then `bev`."""

    def __init__(self, point_cloud_range=(2, -30.4, -3, 59.6, 30.4, 1),
                 voxel_size=(0.05, 0.05, 0.1), sparse_shape=(41, 1216, 1152),
                 capacity=24576, max_points=5, bev_channels=64,
                 dtype=torch.float32):
        super().__init__()
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.sparse_shape = tuple(sparse_shape)
        self.capacity = capacity
        self.max_points = max_points
        self.middle_encoder = SparseEncoder05(self.sparse_shape, dtype=dtype)
        nz = self.middle_encoder.out_grid()[0]
        self.bev = BEVHourglass(nz * 32, bev_channels, norm='bn')

    def voxelize(self, points, point_mask):
        """(B, P, 3) points, (B, P) mask -> keys (B, V), feats (B, V, 3),
        vmask (B, V): each sample's hard voxelization."""
        out = [sparse_voxelize_mean(p, m, self.point_cloud_range,
                                    self.voxel_size, self.sparse_shape,
                                    self.capacity, self.max_points)
               for p, m in zip(points, point_mask)]
        return tuple(torch.stack(x) for x in zip(*out))

    def forward(self, points, point_mask):
        keys, feats, vmask = self.voxelize(points, point_mask)
        vol = self.middle_encoder(keys, feats, vmask)    # (B, Nz, Ny, Nx, C)
        b, nz, ny, nx, c = vol.shape
        bev = vol.permute(0, 1, 4, 2, 3).reshape(b, nz * c, ny, nx)
        _, bev_feat = self.bev(bev)
        return vol, bev_feat.permute(0, 2, 3, 1)
