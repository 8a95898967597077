"""Rotated box overlap. Port of `dfm_tpu/core/iou.py:32-172`.

Convex intersection without vertex sorting: the boundary of P & Q is
made of the parts of P's edges inside Q and of Q's edges inside P; each
part is found by Liang-Barsky clipping against the other box's four
half-planes, and Green's theorem turns the unordered parts into the
area (sum of 0.5 * cross(a, b)). Differentiable almost everywhere:
the clips are `torch.maximum` / `torch.minimum` against tensors, which
split the gradient of a tie in two as `jnp.maximum` does (`clamp`
would pass all of it), so gradients match the JAX package's.
"""

import torch

from .transforms import limit_period, rotation_2d

__all__ = ['box_bev_corners', 'rotated_intersection_area',
           'rotated_iou_bev', 'rotated_iou_3d', 'paired_iou_3d',
           'aligned_iou_2d', 'nearest_bev_iou']

_EPS = 1e-8


def box_bev_corners(boxes_bev):
    """(..., 5) BEV boxes (x, y, dx, dy, yaw) -> (..., 4, 2), CCW."""
    template = torch.tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5],
                             [0.5, -0.5]], dtype=boxes_bev.dtype,
                            device=boxes_bev.device)
    corners = template * boxes_bev[..., None, 2:4]
    corners = rotation_2d(corners, boxes_bev[..., None, 4])
    return corners + boxes_bev[..., None, :2]


def _clipped_boundary_area(p, q, boundary_eps):
    """Sum over P's edges of 0.5 * cross(a, b) for the sub-segment a->b
    inside quad Q; p, q (..., 4, 2) CCW corners."""
    r = torch.roll(p, -1, dims=-2) - p
    e = torch.roll(q, -1, dims=-2) - q
    n = torch.stack([-e[..., 1], e[..., 0]], dim=-1)    # inward normals
    c = (n * q).sum(-1)                                 # (..., 4)
    nk = n[..., None, :, :]                             # (..., 1, 4k, 2)
    pi = p[..., :, None, :]                             # (..., 4i, 1, 2)
    ri = r[..., :, None, :]
    a = nk[..., 0] * pi[..., 0] + nk[..., 1] * pi[..., 1] - c[..., None, :]
    b = nk[..., 0] * ri[..., 0] + nk[..., 1] * ri[..., 1]
    is_par = b.abs() <= _EPS
    t_cross = -a / torch.where(b.abs() > _EPS, b, torch.full_like(b, _EPS))
    lower = torch.where((b > 0) & ~is_par, t_cross, torch.zeros_like(b))
    upper = torch.where((b < 0) & ~is_par, t_cross, torch.ones_like(b))
    t0 = torch.maximum(lower.amax(-1), torch.zeros_like(lower[..., 0]))
    t1 = torch.minimum(upper.amin(-1), torch.ones_like(upper[..., 0]))
    feasible = (~is_par | (a >= boundary_eps)).all(-1)
    valid = feasible & (t1 > t0)
    a_pt = p + t0[..., None] * r
    b_pt = p + t1[..., None] * r
    contrib = 0.5 * (a_pt[..., 0] * b_pt[..., 1] - a_pt[..., 1] * b_pt[..., 0])
    return torch.where(valid, contrib, torch.zeros_like(contrib)).sum(-1)


def _intersection(c1, c2):
    """Intersection areas of quads with CCW corners c1, c2 (..., 4, 2)."""
    # shared-boundary segments counted once: strict for the second sweep
    area = _clipped_boundary_area(c1, c2, -1e-6) + \
        _clipped_boundary_area(c2, c1, 1e-6)
    return torch.maximum(area, torch.zeros_like(area))


def rotated_intersection_area(boxes1, boxes2):
    """(N, 5) x (M, 5) -> (N, M) intersection areas."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1 = box_bev_corners(boxes1)[:, None].expand(n, m, 4, 2)
    c2 = box_bev_corners(boxes2)[None, :].expand(n, m, 4, 2)
    return _intersection(c1, c2)


def rotated_iou_bev(boxes1, boxes2):
    """Pairwise rotated IoU in BEV: (N, 5) x (M, 5) -> (N, M)."""
    inter = rotated_intersection_area(boxes1, boxes2)
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    union = a1[:, None] + a2[None, :] - inter
    return inter / _at_least(union, _EPS)


def _at_least(x, lo):
    """max(x, lo) with `jnp.maximum`'s gradient."""
    return torch.maximum(x, torch.full_like(x, lo))


def _iou_3d(b1, b2, inter_bev):
    """3D IoU of broadcastable (..., 7) boxes (bottom centre z) from their
    BEV intersection areas."""
    z_overlap = _at_least(
        torch.minimum(b1[..., 2] + b1[..., 5], b2[..., 2] + b2[..., 5]) -
        torch.maximum(b1[..., 2], b2[..., 2]), 0.0)
    inter = inter_bev * z_overlap
    vol1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    vol2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    return inter / _at_least(vol1 + vol2 - inter, _EPS)


def rotated_iou_3d(boxes1, boxes2):
    """Pairwise rotated 3D IoU of LiDAR-frame (N, 7) x (M, 7) boxes
    (bottom centre z): BEV rotated intersection x z-extent overlap over
    the union, as mmcv `diff_iou_rotated_3d`; differentiable."""
    inter = rotated_intersection_area(boxes1[:, [0, 1, 3, 4, 6]],
                                      boxes2[:, [0, 1, 3, 4, 6]])
    return _iou_3d(boxes1[:, None], boxes2[None, :], inter)


def paired_iou_3d(boxes1, boxes2):
    """`rotated_iou_3d` of each matched pair (boxes1[i], boxes2[i]) of
    (N, 7) boxes -> (N,), without the N x N matrix (the JAX package
    vmaps the 1 x 1 case)."""
    inter = _intersection(box_bev_corners(boxes1[:, [0, 1, 3, 4, 6]]),
                          box_bev_corners(boxes2[:, [0, 1, 3, 4, 6]]))
    return _iou_3d(boxes1, boxes2, inter)


def aligned_iou_2d(boxes1, boxes2):
    """Pairwise IoU of axis-aligned (N, 4) x (M, 4) xyxy boxes."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = _at_least(boxes1[:, 2] - boxes1[:, 0], 0.0) * \
        _at_least(boxes1[:, 3] - boxes1[:, 1], 0.0)
    a2 = _at_least(boxes2[:, 2] - boxes2[:, 0], 0.0) * \
        _at_least(boxes2[:, 3] - boxes2[:, 1], 0.0)
    return inter / _at_least(a1[:, None] + a2[None, :] - inter, _EPS)


def nearest_bev_xyxy(boxes_bev):
    """Axis-aligned BEV boxes (x1, y1, x2, y2) with the rotation snapped
    to the nearest axis: dims swapped where |limit_period(yaw)| > pi / 4
    (`dfm_tpu/core/boxes.py:82-95`)."""
    rot = limit_period(boxes_bev[..., 4], 0.5, torch.pi)
    swap = rot.abs() > (torch.pi / 4)
    dx = torch.where(swap, boxes_bev[..., 3], boxes_bev[..., 2])
    dy = torch.where(swap, boxes_bev[..., 2], boxes_bev[..., 3])
    cx, cy = boxes_bev[..., 0], boxes_bev[..., 1]
    return torch.stack([cx - dx / 2, cy - dy / 2, cx + dx / 2, cy + dy / 2],
                       dim=-1)


def nearest_bev_iou(boxes1, boxes2):
    """`BboxOverlapsNearest3D` IoU of LiDAR-frame (N, 7) x (M, 7) boxes:
    rotations snapped to the nearest axis, then plain 2D IoU (anchor
    target assignment)."""
    bev = lambda b: b[..., [0, 1, 3, 4, 6]]                 # noqa: E731
    return aligned_iou_2d(nearest_bev_xyxy(bev(boxes1)),
                          nearest_bev_xyxy(bev(boxes2)))
