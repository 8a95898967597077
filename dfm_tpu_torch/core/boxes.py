"""Box tests in BEV. Port of `dfm_tpu/core/boxes.py:110`
(`points_in_rotated_boxes_bev`)."""

from .transforms import rotation_2d

__all__ = ['points_in_rotated_boxes_bev']


def points_in_rotated_boxes_bev(points_xy, boxes):
    """(P, G) mask of (P, 2) points inside (G, 7) LiDAR-frame boxes (x,
    y, dx, dy, yaw used): each point rotated into the box frame by -yaw,
    inside where |local| <= the half extents (edges included)."""
    rel = points_xy[:, None, :] - boxes[None, :, :2]
    local = rotation_2d(rel, -boxes[None, :, 6])
    half = boxes[None, :, 3:5] * 0.5
    return (local.abs() <= half).all(-1)
