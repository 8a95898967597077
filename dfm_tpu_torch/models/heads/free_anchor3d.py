"""FreeAnchor 3D loss: the likelihood over each object's bag of anchors.

Port of `dfm_tpu/models/heads/free_anchor3d.py:29-147` (reference
mmdet3d free_anchor3d_head.py:49-285): the tower is the plain anchor
head's; training replaces MaxIoU assignment by the FreeAnchor bags. Each
GT owns the `pre_anchor_topk` anchors of highest (nearest-BEV) IoU with
it and pays the mean-max positive likelihood of its bag; every anchor
pays a focal negative loss weighted by how unlikely it is to be matched
(1 - P{a in A+}, from the IoU of its decoded box with each GT, without a
gradient). Padded GTs are masked out of both terms and the normaliser.
The bag is chosen by a stable descending sort, so ties go to the lower
anchor index as `lax.top_k` gives them. All math in float32.
"""

import torch

from ..layers import stat_float
from ...core.coders import delta_xyzwlhr_decode, delta_xyzwlhr_encode
from ...core.iou import nearest_bev_iou
from ...core.targets import add_sin_difference, get_direction_target
from ...parallel import dist as D

__all__ = ['free_anchor3d_loss']


def _smooth_l1(pred, target, beta):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def free_anchor3d_loss(preds, flat_anchors, gt_boxes, gt_labels, gt_mask,
                       num_classes=3, pre_anchor_topk=50, bbox_thr=0.6,
                       gamma=2.0, alpha=0.5, dir_offset=0.7854,
                       beta=1.0 / 9.0, bbox_loss_weight=2.0,
                       dir_loss_weight=0.2, dist_norm=False):
    """FreeAnchor positive / negative bag losses.

    Args:
        preds: (cls_score, bbox_pred, dir_pred or None), each (B, Ny, Nx,
            A * X).
        flat_anchors: (J, 7), J = Ny * Nx * A, in the channels' order.
        gt_boxes: (B, G, 7) padded; gt_labels (B, G); gt_mask (B, G).
        dist_norm: in a process group, the number of GTs of the global
            batch as the normaliser (a no-op without a group).

    Returns:
        {'positive_bag_loss', 'negative_bag_loss'} scalars.
    """
    cls_score, bbox_pred, dir_pred = preds
    b = cls_score.shape[0]
    j = flat_anchors.shape[0]
    cls_score = stat_float(cls_score).reshape(b, j, num_classes)
    bbox_pred = stat_float(bbox_pred).reshape(b, j, 7)
    anchors = flat_anchors.to(cls_score.dtype)
    pos_sum = neg_sum = 0.
    for i in range(b):
        gtm = gt_mask[i].bool()
        gtb = gt_boxes[i].to(cls_score.dtype)
        gtl = gt_labels[i].long()
        deltas = bbox_pred[i]
        cls_prob = torch.sigmoid(cls_score[i])                     # (J, C)
        with torch.no_grad():
            iou = nearest_bev_iou(gtb, delta_xyzwlhr_decode(anchors,
                                                            deltas))
            iou = torch.where(gtm[:, None], iou, torch.zeros_like(iou))
            t2 = torch.clamp(iou.max(1, keepdim=True)[0], min=bbox_thr + 1e-6)
            obj_box_prob = ((iou - bbox_thr) / (t2 - bbox_thr)).clamp(0, 1)
            image_box_prob = torch.stack(
                [torch.where(((gtl == c) & gtm)[:, None], obj_box_prob,
                             torch.zeros_like(obj_box_prob)).max(0)[0]
                 for c in range(num_classes)], -1)                 # (J, C)
            mq = nearest_bev_iou(gtb, anchors)
            mq = torch.where(gtm[:, None], mq, torch.full_like(mq, -1.0))
            matched = torch.sort(mq, dim=1, descending=True,
                                 stable=True)[1][:, :pre_anchor_topk]
        gtl_safe = gtl.clamp(0, num_classes - 1)
        matched_cls_prob = torch.gather(
            cls_prob[matched], 2,
            gtl_safe[:, None, None].expand(-1, matched.shape[1], 1))[..., 0]
        matched_anchors = anchors[matched]                         # (G, K, 7)
        # a padded GT is a zero box whose encoding is -inf (log 0): the
        # anchor itself stands in for it (zero target)
        matched_gt = torch.where(gtm[:, None, None],
                                 gtb[:, None, :].expand_as(matched_anchors),
                                 matched_anchors)
        targets = delta_xyzwlhr_encode(matched_anchors, matched_gt)
        matched_deltas = deltas[matched]
        loss_dir = 0.
        if dir_pred is not None:
            dir_t = get_direction_target(matched_anchors[..., 6],
                                         targets[..., 6], dir_offset)
            logp = torch.log_softmax(
                stat_float(dir_pred[i]).reshape(j, 2)[matched], -1)
            loss_dir = -dir_loss_weight * torch.gather(
                logp, -1, dir_t[..., None])[..., 0]
        p_sin, t_sin = add_sin_difference(matched_deltas, targets)
        loss_bbox = bbox_loss_weight * _smooth_l1(p_sin, t_sin,
                                                  beta).sum(-1)    # (G, K)
        matched_box_prob = torch.exp(-(loss_bbox + loss_dir))
        p = matched_cls_prob * matched_box_prob
        w = 1.0 / torch.clamp(1.0 - p, min=1e-12)
        w = w / w.sum(1, keepdim=True)
        bag_prob = torch.clamp((w * p).sum(1), 1e-12, 1.0)
        pos_sum = pos_sum + (-alpha * torch.log(bag_prob) * gtm).sum()
        neg_prob = torch.clamp(cls_prob * (1.0 - image_box_prob), 0.0,
                               1.0 - 1e-12)
        neg_sum = neg_sum + ((1 - alpha) * neg_prob ** gamma *
                             (-torch.log1p(-neg_prob))).sum()
    npos = gt_mask.to(cls_score.dtype).sum()
    if dist_norm:
        npos = D.global_sum(npos)
    num_pos = torch.clamp(npos, min=1.0)
    return {'positive_bag_loss': pos_sum / num_pos,
            'negative_bag_loss': neg_sum / (num_pos * pre_anchor_topk)}
