"""Geometric transforms on tensors.

Port of `dfm_tpu/core/transforms.py` (`limit_period`, `homogeneous`,
`points_cam2img`, `points_img2cam`, `rotation_2d`, `rotation_matrix_3d`,
`rotate_points_3d`, `transform_points`).
The 4x4 products are written as elementwise multiply-adds, so they stay
exact float32 on every device whatever the TF32 settings (the JAX
package runs them at HIGHEST precision).
"""

import torch

__all__ = ['limit_period', 'rotation_2d', 'rotation_matrix_3d',
           'rotate_points_3d', 'homogeneous', 'apply_mat', 'points_cam2img',
           'points_img2cam', 'transform_points']


def limit_period(val, offset=0.5, period=torch.pi):
    """Result in [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotation_2d(points, angles):
    """Rotate (..., 2) points counter-clockwise by `angles`."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x * c - y * s, x * s + y * c], dim=-1)


def rotation_matrix_3d(angles, axis=2):
    """(..., 3, 3) transposed rotation matrices: `points @ R_T` rotates
    the points by `angles` around `axis` (mmdet3d `rotation_3d_in_axis`,
    `dfm_tpu/core/transforms.py:50-69`)."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis in (1, -2):
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    elif axis in (2, -1):
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    elif axis in (0, -3):
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    else:
        raise ValueError(f'axis should be in [-3..2], got {axis}')
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_points_3d(points, angles, axis=2):
    """Rotate (..., M, 3) points by per-box angles (...,) around `axis`,
    as exact f32 sums."""
    rot_t = rotation_matrix_3d(angles, axis)                # (..., 3, 3)
    return (points[..., :, :, None] * rot_t[..., None, :, :]).sum(-2)


def homogeneous(points):
    """(..., D) -> (..., D+1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def apply_mat(points_h, mat):
    """(..., N, 4) @ mat^T for (..., 4, 4) `mat`, as exact f32 sums."""
    return (points_h[..., :, None, :] * mat[..., None, :, :]).sum(-1)


def points_cam2img(points_3d, proj_mat):
    """(..., N, 3) camera points -> (..., N, 2) pixels; `proj_mat`
    (..., 4, 4) broadcast over N."""
    uvw = apply_mat(homogeneous(points_3d), proj_mat)
    return uvw[..., :2] / uvw[..., 2:3]


def points_img2cam(points, cam2img):
    """(..., N, 3) = (u, v, depth) -> (..., N, 3) camera points, by a
    linear solve with (..., 4, 4) `cam2img`."""
    xys = points[..., :2]
    depths = points[..., 2:3]
    homo = homogeneous(torch.cat([xys * depths, depths], dim=-1))
    # solve_ex: no host sync for the singularity check
    out, _ = torch.linalg.solve_ex(cam2img, homo.transpose(-1, -2))
    return out.transpose(-1, -2)[..., :3]


def transform_points(points, mat4):
    """(..., 3) points through a (4, 4) transform (batched as the points'
    leading axes): the first three rows of mat4 @ [p, 1], no perspective
    divide (`dfm_tpu/core/transforms.py:137-141`)."""
    return apply_mat(homogeneous(points), mat4)[..., :3]
