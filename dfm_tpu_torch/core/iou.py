"""Rotated BEV box overlap. Port of `dfm_tpu/core/iou.py:32-112`.

Convex intersection without vertex sorting: the boundary of P & Q is
made of the parts of P's edges inside Q and of Q's edges inside P; each
part is found by Liang-Barsky clipping against the other box's four
half-planes, and Green's theorem turns the unordered parts into the
area (sum of 0.5 * cross(a, b)).
"""

import torch

from .transforms import rotation_2d

__all__ = ['box_bev_corners', 'rotated_intersection_area',
           'rotated_iou_bev']

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
    t0 = lower.amax(-1).clamp(min=0.0)
    t1 = upper.amin(-1).clamp(max=1.0)
    feasible = (~is_par | (a >= boundary_eps)).all(-1)
    valid = feasible & (t1 > t0)
    a_pt = p + t0[..., None] * r
    b_pt = p + t1[..., None] * r
    contrib = 0.5 * (a_pt[..., 0] * b_pt[..., 1] - a_pt[..., 1] * b_pt[..., 0])
    return torch.where(valid, contrib, torch.zeros_like(contrib)).sum(-1)


def rotated_intersection_area(boxes1, boxes2):
    """(N, 5) x (M, 5) -> (N, M) intersection areas."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1 = box_bev_corners(boxes1)[:, None].expand(n, m, 4, 2)
    c2 = box_bev_corners(boxes2)[None, :].expand(n, m, 4, 2)
    # shared-boundary segments counted once: strict for the second sweep
    area = _clipped_boundary_area(c1, c2, -1e-6) + \
        _clipped_boundary_area(c2, c1, 1e-6)
    return area.clamp(min=0.0)


def rotated_iou_bev(boxes1, boxes2):
    """Pairwise rotated IoU in BEV: (N, 5) x (M, 5) -> (N, M)."""
    inter = rotated_intersection_area(boxes1, boxes2)
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    union = a1[:, None] + a2[None, :] - inter
    return inter / union.clamp(min=_EPS)
