"""Anchor target assignment with static shapes (padded GT + masks).

Port of `dfm_tpu/core/targets.py:23-139` (the reference's
`AnchorTrainMixin.anchor_target_3d` + mmdet `MaxIoUAssigner`): ground
truths are padded to a fixed count and every rule is a vectorised select,
batched over a leading axis where the JAX package vmaps.
"""

import math

import torch

from .coders import delta_xyzwlhr_encode
from .iou import nearest_bev_iou
from .transforms import limit_period

__all__ = ['max_iou_assign', 'anchor_targets_single_class',
           'get_direction_target', 'add_sin_difference']


def max_iou_assign(overlaps, gt_mask, pos_iou_thr, neg_iou_thr,
                   min_pos_iou=0.0, gt_max_assign_all=True):
    """MaxIoU assignment.

    Args:
        overlaps: (G, A) IoU between (padded) gts and anchors.
        gt_mask: (G,) bool validity of each gt row.

    Returns:
        (A,) int32: -1 ignore, 0 negative, g + 1 matched to gt g. With no
        valid gt every anchor is a negative; each gt claims its best
        anchors, later gts overwriting earlier ones (the reference's
        sequential loop).
    """
    overlaps = torch.where(gt_mask[:, None], overlaps,
                           torch.full_like(overlaps, -1.0))
    max_overlaps, argmax_overlaps = overlaps.max(dim=0)
    # torch.max returns the first maximum's index, as jnp.argmax does
    a = overlaps.shape[1]
    assigned = torch.full((a,), -1, dtype=torch.int32,
                          device=overlaps.device)
    no_gt = ~gt_mask.any()
    neg = no_gt | ((max_overlaps >= 0) & (max_overlaps < neg_iou_thr))
    assigned = torch.where(neg, torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr,
                           argmax_overlaps.to(torch.int32) + 1, assigned)
    if gt_max_assign_all:
        gt_max = overlaps.amax(dim=1)                       # (G,)
        claim = (overlaps == gt_max[:, None]) & \
            (gt_max >= min_pos_iou)[:, None] & gt_mask[:, None]
        gt_ids = torch.arange(1, overlaps.shape[0] + 1, dtype=torch.int32,
                              device=overlaps.device)
        claimed = torch.where(claim, gt_ids[:, None],
                              torch.zeros_like(gt_ids[:, None])).amax(0)
        assigned = torch.where(claimed > 0, claimed, assigned)
    return assigned


def get_direction_target(anchors_yaw, reg_targets_yaw, dir_offset=0.7854,
                         num_bins=2):
    """Direction-bin classification targets (int64)."""
    rot_gt = reg_targets_yaw + anchors_yaw
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    dir_cls = torch.floor(offset_rot / (2 * math.pi / num_bins)).long()
    return dir_cls.clamp(0, num_bins - 1)


def add_sin_difference(boxes1, boxes2):
    """Replace the yaw channel by sin(r1) cos(r2) / cos(r1) sin(r2)."""
    rad1 = torch.sin(boxes1[..., 6:7]) * torch.cos(boxes2[..., 6:7])
    rad2 = torch.cos(boxes1[..., 6:7]) * torch.sin(boxes2[..., 6:7])
    return (torch.cat([boxes1[..., :6], rad1, boxes1[..., 7:]], dim=-1),
            torch.cat([boxes2[..., :6], rad2, boxes2[..., 7:]], dim=-1))


def anchor_targets_single_class(anchors, gt_boxes, gt_mask, pos_iou_thr,
                                neg_iou_thr, min_pos_iou, class_id,
                                num_classes, dir_offset=0.7854):
    """Targets for one class's anchors against that class's gts.

    Args:
        anchors: (A, 7) this class's anchors (flattened grid).
        gt_boxes: (G, 7) padded gts; gt_mask: (G,) validity.

    Returns:
        dict of labels (A,) int64 in [0, num_classes] (num_classes =
        background), label_weights, bbox_targets (A, 7), bbox_weights,
        dir_targets (A,) int64, dir_weights, pos_mask (A,) bool.
    """
    overlaps = nearest_bev_iou(gt_boxes, anchors)           # (G, A)
    assigned = max_iou_assign(overlaps, gt_mask, pos_iou_thr, neg_iou_thr,
                              min_pos_iou)
    pos = assigned > 0
    neg = assigned == 0
    gt_idx = (assigned - 1).clamp(min=0).long()
    # the anchor itself stands in for non-positives *before* encoding:
    # padded gts are all zero and log(0 / wa) would poison the gradients
    # even through a masking where (NaN * 0 = NaN in the backward pass)
    matched_gt = torch.where(pos[:, None], gt_boxes[gt_idx], anchors)
    labels = torch.where(pos, torch.full_like(gt_idx, class_id),
                         torch.full_like(gt_idx, num_classes))
    bbox_targets = torch.where(pos[:, None],
                               delta_xyzwlhr_encode(anchors, matched_gt),
                               torch.zeros_like(anchors))
    dir_targets = torch.where(
        pos, get_direction_target(anchors[..., 6], bbox_targets[..., 6],
                                  dir_offset), torch.zeros_like(gt_idx))
    w = pos.float()
    return dict(labels=labels, label_weights=(pos | neg).float(),
                bbox_targets=bbox_targets, bbox_weights=w,
                dir_targets=dir_targets, dir_weights=w, pos_mask=pos)
