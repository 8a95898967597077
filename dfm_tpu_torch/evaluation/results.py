"""Detections -> KITTI-format annotations (host-side numpy).

A copy of `dfm_tpu/evaluation/results.py`, the equivalent of the
reference's `bbox2result_kitti` + `convert_valid_bboxes`
(mmdet3d/datasets/kitti_dataset.py:446-757, pseudo-lidar branch): padded
device detections (pseudo-LiDAR frame) are converted to camera-frame
KITTI records with projected 2D boxes and alpha, ready for
`kitti_eval.kitti_eval`. It takes numpy arrays: the caller moves a
frame's detections to the host once.
"""

import numpy as np

from .kitti_eval import CLASS_NAMES

__all__ = ['detections_to_kitti_annos', 'cam_detections_to_kitti_annos',
           'pseudo_lidar_boxes_to_cam']


def pseudo_lidar_boxes_to_cam(boxes_pl):
    """(N, 7) pseudo-lidar -> camera-frame KITTI (loc bottom-center,
    dims (l, h, w), ry). Inverse of data.kitti.cam_label_to_pseudo_lidar."""
    x_pl, y_pl, z_pl = boxes_pl[:, 0], boxes_pl[:, 1], boxes_pl[:, 2]
    dx, dy, dz = boxes_pl[:, 3], boxes_pl[:, 4], boxes_pl[:, 5]
    yaw_pl = boxes_pl[:, 6]
    # center: pl bottom-center (x,y,z) -> cam (-y, -z, x); cam y is the
    # *bottom* (KITTI label location is the bottom center)
    loc = np.stack([-y_pl, -z_pl, x_pl], axis=1)
    dims_lhw = np.stack([dx, dy, dz], axis=1)[:, [0, 2, 1]]  # l=dx,h=dz,w=dy
    ry = -yaw_pl - np.pi / 2
    ry = ry - np.floor(ry / (2 * np.pi) + 0.5) * (2 * np.pi)
    return loc, dims_lhw, ry


def _corners_cam(loc, dims_lhw, ry):
    """(N, 8, 3) camera-frame corners for KITTI boxes."""
    l, h, w = dims_lhw[:, 0], dims_lhw[:, 1], dims_lhw[:, 2]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2,
                    l / 2, l / 2, -l / 2, -l / 2], 1)
    y_c = np.stack([np.zeros_like(h)] * 4 + [-h] * 4, 1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2,
                    w / 2, -w / 2, -w / 2, w / 2], 1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    x = c * x_c + s * z_c
    z = -s * x_c + c * z_c
    return np.stack([x + loc[:, None, 0], y_c + loc[:, None, 1],
                     z + loc[:, None, 2]], axis=-1)


def detections_to_kitti_annos(det, calib_p2, image_shape,
                              class_names=CLASS_NAMES):
    """Convert one image's padded detections to a KITTI anno dict.

    Args:
        det: dict with 'boxes3d' (M, 7) pseudo-lidar, 'scores' (M,),
            'labels' (M,), 'mask' (M,) (numpy arrays).
        calib_p2: (3, 4) or (4, 4) original-image P2.
        image_shape: (H, W) original image size for bbox clipping.

    Returns:
        KITTI anno dict (name/truncated/occluded/alpha/bbox/dimensions/
        location/rotation_y/score).
    """
    mask = np.asarray(det['mask']).astype(bool)
    boxes = np.asarray(det['boxes3d'])[mask]
    scores = np.asarray(det['scores'])[mask]
    labels = np.asarray(det['labels'])[mask]
    if len(boxes) == 0:
        return _empty_annos()
    loc, dims, ry = pseudo_lidar_boxes_to_cam(boxes)
    return _cam_to_annos(loc, dims, ry, scores, labels, calib_p2,
                         image_shape, class_names)


def cam_detections_to_kitti_annos(det, calib_p2, image_shape,
                                  class_names=CLASS_NAMES):
    """Same as detections_to_kitti_annos but for CAMERA-frame boxes7
    (loc bottom-center, dims (l, h, w), ry) — the mono-family
    (FCOS3D/PGD/SMOKE) decode output (reference
    mmdet3d/datasets/kitti_mono_dataset.py bbox2result_kitti2d+3d)."""
    mask = np.asarray(det['mask']).astype(bool)
    boxes = np.asarray(det['boxes3d'])[mask]
    scores = np.asarray(det['scores'])[mask]
    labels = np.asarray(det['labels'])[mask]
    if len(boxes) == 0:
        return _empty_annos()
    return _cam_to_annos(boxes[:, :3], boxes[:, 3:6], boxes[:, 6],
                         scores, labels, calib_p2, image_shape,
                         class_names)


def _empty_annos():
    return dict(name=np.array([]), truncated=np.array([]),
                occluded=np.array([]), alpha=np.array([]),
                bbox=np.zeros((0, 4)), dimensions=np.zeros((0, 3)),
                location=np.zeros((0, 3)), rotation_y=np.array([]),
                score=np.array([]))


def _cam_to_annos(loc, dims, ry, scores, labels, calib_p2, image_shape,
                  class_names):
    p2 = np.asarray(calib_p2, np.float64)[:3, :4]
    loc = np.asarray(loc, np.float64)
    dims = np.asarray(dims, np.float64)
    ry = np.asarray(ry, np.float64)
    corners = _corners_cam(loc, dims, ry)                 # (M, 8, 3)
    homo = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    uvw = homo @ p2.T
    uv = uvw[..., :2] / np.maximum(uvw[..., 2:3], 1e-3)
    h_img, w_img = image_shape[:2]
    bbox = np.stack([uv[..., 0].min(1), uv[..., 1].min(1),
                     uv[..., 0].max(1), uv[..., 1].max(1)], 1)
    bbox[:, 0::2] = np.clip(bbox[:, 0::2], 0, w_img)
    bbox[:, 1::2] = np.clip(bbox[:, 1::2], 0, h_img)
    # keep boxes in front of the camera and inside the image
    keep = (loc[:, 2] > 0) & (bbox[:, 2] > bbox[:, 0]) & \
        (bbox[:, 3] > bbox[:, 1])
    loc, dims, ry = loc[keep], dims[keep], ry[keep]
    bbox, scores, labels = bbox[keep], scores[keep], labels[keep]
    alpha = ry - np.arctan2(loc[:, 0], loc[:, 2])
    return dict(
        name=np.array([class_names[int(c)] for c in labels]),
        truncated=np.zeros(len(labels)),
        occluded=np.zeros(len(labels), np.int64),
        alpha=alpha,
        bbox=bbox,
        dimensions=dims,
        location=loc,
        rotation_y=ry,
        score=scores)
