"""A voxel volume sampled on a camera's frustum grid.

Port of `dfm_tpu/ops/frustum.py:508-569` (`voxel_sample`, reference
fusion_layers/point_fusion.py:324-412, without augmentation) with
`core/transforms.py:points_img2cam` and `ops/grid_sample.py:63`
(`trilinear_sample`): a (D', H', W') grid of image points (u, v, depth),
u and v every `downsample_factor` pixels of the padded image from 0,
the depth bins every `downsample_factor`-th of `depth_samples`;
back-projected to the lidar (vehicle) frame with the camera's lidar2img,
moved to voxel indices with the -0.5 cell-centre offset of the aligned
anchor grid, and sampled trilinearly, each tap outside the grid counting
zero. The JAX package normalises the indices to [-1, 1] by the grid's
extent and maps them back with align-corners (n - 1); `F.grid_sample`
with `align_corners=True` and zero padding does the same in one call (5-D,
(x, y, z) over (Nx, Ny, Nz)). The JAX package computes it outside any
Pallas kernel.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..core.transforms import points_img2cam

__all__ = ['frustum_grid', 'voxel_sample']


def frustum_grid(depth_samples, downsample_factor, pad_shape, device):
    """(D', H', W', 3) float32 image points (u, v, depth)."""
    h, w = pad_shape
    h_out = round(h / downsample_factor)
    w_out = round(w / downsample_factor)
    f32 = dict(dtype=torch.float32, device=device)
    ws = torch.arange(w_out, **f32) * downsample_factor
    hs = torch.arange(h_out, **f32) * downsample_factor
    ds = torch.as_tensor(np.asarray(depth_samples, np.float32)
                         [::downsample_factor], **f32)
    dd, yy, xx = torch.meshgrid(ds, hs, ws, indexing='ij')
    return torch.stack([xx, yy, dd], -1)


def voxel_sample(volume, depth_samples, proj_mat, downsample_factor,
                 pad_shape, voxel_range, voxel_size):
    """Sample `volume` (C, Nz, Ny, Nx) at the frustum grid of one camera.

    Args:
        depth_samples: (D,) full-resolution depth-bin centres (numpy).
        proj_mat: (4, 4) lidar2img of the camera (tensor).
        pad_shape: (H_pad, W_pad), the padded image size the grid spans.
        voxel_range: (6,) (x0, y0, z0, x1, y1, z1); voxel_size (3,) the
            edges (x, y, z), both float32 numpy.

    Returns:
        (C, D', H', W') in the volume's dtype (float32 for a bfloat16 one).
    """
    c, nz, ny, nx = volume.shape
    grid = frustum_grid(depth_samples, downsample_factor, pad_shape,
                        volume.device)
    pts = points_img2cam(grid.reshape(-1, 3), proj_mat.float())
    dev = dict(dtype=torch.float32, device=volume.device)
    vr = torch.as_tensor(np.asarray(voxel_range, np.float32)[:3], **dev)
    vs = torch.as_tensor(np.asarray(voxel_size, np.float32), **dev)
    n3 = torch.tensor([nx, ny, nz], **dev)
    idx = (pts - vr) / vs - 0.5
    norm = idx / n3 * 2 - 1
    vol = volume if volume.dtype == torch.float64 else volume.float()
    return F.grid_sample(vol[None], norm.reshape((1,) + grid.shape).to(
        vol.dtype), mode='bilinear', padding_mode='zeros',
        align_corners=True)[0]
