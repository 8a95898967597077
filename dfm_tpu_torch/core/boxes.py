"""Functional 3D box ops on tensors.

Port of `dfm_tpu/core/boxes.py`: `corners_lidar` (:49), `corners_cam`
(:63), `points_in_rotated_boxes_bev` (:110) and the camera <-> pseudo-LiDAR
box conversions (:131-164). Boxes are (..., 7) `(x, y, z, x_size, y_size,
z_size, yaw)`; a LiDAR box's origin is its bottom centre (relative origin
(0.5, 0.5, 0)), its yaw around z; a camera box's origin is its bottom
centre (relative origin (0.5, 1.0, 0.5)), its yaw around y; pseudo-LiDAR is
`(z_cam, -x_cam, -y_cam)`.
"""

import math

import numpy as np
import torch

from .transforms import limit_period, rotate_points_3d, rotation_2d

__all__ = ['corners_lidar', 'corners_cam', 'points_in_rotated_boxes_bev',
           'cam_to_pseudo_lidar_points', 'pseudo_lidar_to_cam_points',
           'cam_to_pseudo_lidar_boxes', 'pseudo_lidar_to_cam_boxes']

# corner template in the reference's unravel order [0,1,3,2,4,5,7,6]
_CORNERS_NORM = np.stack(np.unravel_index(np.arange(8), [2] * 3),
                         axis=1)[[0, 1, 3, 2, 4, 5, 7, 6]].astype(np.float32)


def corners_lidar(boxes):
    """Corners of LiDAR-frame boxes: (..., 7) -> (..., 8, 3)
    (LiDARInstance3DBoxes.corners: relative origin (0.5, 0.5, 0), yaw
    around z)."""
    norm = torch.as_tensor(_CORNERS_NORM - np.array([0.5, 0.5, 0.0],
                                                    np.float32),
                           dtype=boxes.dtype, device=boxes.device)
    corners = boxes[..., None, 3:6] * norm
    return rotate_points_3d(corners, boxes[..., 6], axis=2) + \
        boxes[..., None, :3]


def corners_cam(boxes):
    """Corners of camera-frame boxes: (..., 7) -> (..., 8, 3)
    (CameraInstance3DBoxes.corners)."""
    norm = torch.as_tensor(_CORNERS_NORM - np.array([0.5, 1.0, 0.5],
                                                    np.float32),
                           dtype=boxes.dtype, device=boxes.device)
    corners = boxes[..., None, 3:6] * norm
    return rotate_points_3d(corners, boxes[..., 6], axis=1) + \
        boxes[..., None, :3]


def points_in_rotated_boxes_bev(points_xy, boxes):
    """(P, G) mask of (P, 2) points inside (G, 7) LiDAR-frame boxes (x,
    y, dx, dy, yaw used): each point rotated into the box frame by -yaw,
    inside where |local| <= the half extents (edges included)."""
    rel = points_xy[:, None, :] - boxes[None, :, :2]
    local = rotation_2d(rel, -boxes[None, :, 6])
    half = boxes[None, :, 3:5] * 0.5
    return (local.abs() <= half).all(-1)


def cam_to_pseudo_lidar_points(pts):
    """(..., 3) camera frame -> pseudo-LiDAR: (z, -x, -y)."""
    return torch.stack([pts[..., 2], -pts[..., 0], -pts[..., 1]], dim=-1)


def pseudo_lidar_to_cam_points(pts):
    """(..., 3) pseudo-LiDAR -> camera frame: (-y, -z, x)."""
    return torch.stack([-pts[..., 1], -pts[..., 2], pts[..., 0]], dim=-1)


def cam_to_pseudo_lidar_boxes(boxes):
    """Camera-frame boxes (..., 7) -> pseudo-LiDAR boxes: centres (z, -x,
    -y), sizes (dx, dz, dy), yaw -r - pi/2 in [-pi, pi) (Box3DMode CAM ->
    LIDAR)."""
    yaw = limit_period(-boxes[..., 6:7] - math.pi / 2, period=2 * math.pi)
    return torch.cat([cam_to_pseudo_lidar_points(boxes[..., :3]),
                      boxes[..., [3, 5, 4]], yaw], dim=-1)


def pseudo_lidar_to_cam_boxes(boxes):
    """Inverse of `cam_to_pseudo_lidar_boxes` (LIDAR -> CAM)."""
    yaw = limit_period(-boxes[..., 6:7] - math.pi / 2, period=2 * math.pi)
    return torch.cat([pseudo_lidar_to_cam_points(boxes[..., :3]),
                      boxes[..., [3, 5, 4]], yaw], dim=-1)
