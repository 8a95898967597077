"""LIGA anchor head: forward, training targets and loss, inference decode.

Port of `dfm_tpu/models/heads/anchor3d_head.py:30-68` (forward),
`:71-222` (`anchor3d_head_targets`, `anchor3d_head_loss`) and `:225-273`
(`anchor3d_head_get_bboxes`). Keys: cls_convs.i, reg_convs.i, conv_cls,
conv_reg, conv_dir_cls. Head outputs are returned channels-last
(B, Ny, Nx, A * X), as in the JAX package.
"""

import torch
import torch.nn as nn

from ..layers import Conv, ConvNorm, stat_float
from ...parallel import dist as D
from ...core import losses as L
from ...core.coders import delta_xyzwlhr_decode
from ...core.nms import box3d_multiclass_nms
from ...core.targets import add_sin_difference, anchor_targets_single_class
from ...core.transforms import limit_period


class LIGAAnchor3DHead(nn.Module):
    """`num_convs` ConvNorm (`norm`) per tower, then the three output
    convs; MultiViewDfM's head has no towers (num_convs=0), its output
    convs read the BEV map itself."""

    def __init__(self, num_classes=3, in_channels=64, feat_channels=64,
                 num_anchors=6, num_convs=2, norm='gn'):
        super().__init__()
        cins = [in_channels, *[feat_channels] * (num_convs - 1)][:num_convs]
        self.cls_convs = nn.ModuleList(
            [ConvNorm(c, feat_channels, 3, norm=norm) for c in cins])
        self.reg_convs = nn.ModuleList(
            [ConvNorm(c, feat_channels, 3, norm=norm) for c in cins])
        cout = feat_channels if num_convs else in_channels
        self.conv_cls = Conv(cout, num_anchors * num_classes, 3, bias=True)
        self.conv_reg = Conv(cout, num_anchors * 7, 3, bias=True)
        self.conv_dir_cls = Conv(cout, num_anchors * 2, 1, bias=True)

    def forward(self, x):
        cls_feats = reg_feats = x
        for cls_conv, reg_conv in zip(self.cls_convs, self.reg_convs):
            cls_feats = cls_conv(cls_feats)
            reg_feats = reg_conv(reg_feats)
        nhwc = (lambda t: t.permute(0, 2, 3, 1))            # noqa: E731
        return (nhwc(self.conv_cls(cls_feats)),
                nhwc(self.conv_reg(reg_feats)),
                nhwc(self.conv_dir_cls(cls_feats)))


def anchor3d_head_targets(anchors_per_class, gt_boxes, gt_labels, gt_mask,
                          assigner_cfgs, num_classes, dir_offset=0.7854):
    """Per-class assignment of one sample (reference `anchor_target_3d`
    with assign_per_class=True).

    Args:
        anchors_per_class: list of (A_c, 7) per class.
        gt_boxes: (G, 7) padded; gt_labels: (G,); gt_mask: (G,).
        assigner_cfgs: per-class dicts (pos_iou_thr, neg_iou_thr,
            min_pos_iou).

    Returns:
        per-class list of target dicts, the positive count.
    """
    out = []
    total_pos = 0
    for cls_id, (anchors, cfg) in enumerate(zip(anchors_per_class,
                                                assigner_cfgs)):
        t = anchor_targets_single_class(
            anchors, gt_boxes, gt_mask & (gt_labels == cls_id),
            cfg['pos_iou_thr'], cfg['neg_iou_thr'], cfg['min_pos_iou'],
            class_id=cls_id, num_classes=num_classes, dir_offset=dir_offset)
        total_pos = total_pos + t['pos_mask'].sum()
        out.append(t)
    return out, total_pos


def anchor3d_head_loss(preds, anchors_per_class, gt_boxes, gt_labels,
                       gt_mask, assigner_cfgs, num_classes=3,
                       dir_offset=0.7854, loss_weights=(1.0, 0.5, 0.2, 1.0),
                       normalizer_clamp_value=10.0, use_iou_loss=True,
                       dist_norm=False):
    """LIGAAnchor3DHead.loss (reference liga_anchor3d_head.py:130-226),
    batched, static shapes.

    Args:
        preds: (cls_score, bbox_pred, dir_pred), each (B, Ny, Nx,
            num_anchors * X), anchor order (size, rot).
        anchors_per_class: list of (A_c, 7) flat per-class anchors in the
            head's (y, x, rot) order.
        gt_boxes: (B, G, 7); gt_labels: (B, G); gt_mask: (B, G).
        dist_norm: in a process group, normalise by the positives of the
            global batch (summed over the group), as JAX's loss on the
            sharded batch does: the rank's terms are then its share of
            the global batch's, which the ranks' sum gives
            (`parallel/dist.py`). A no-op without a group.

    Returns:
        dict of scalar losses loss_cls, loss_bbox, loss_dir, loss_iou.
    """
    cls_score, bbox_pred, dir_pred = preds
    b = cls_score.shape[0]
    num_rot = anchors_per_class[0].shape[0] // (cls_score.shape[1] *
                                                cls_score.shape[2])

    def per_class(x, per_anchor):
        # (B, Ny, Nx, S*R*per) -> per-class (B, Ny*Nx*R, per)
        x = stat_float(x).reshape(b, -1, num_classes, num_rot, per_anchor)
        return [x[:, :, c].reshape(b, -1, per_anchor)
                for c in range(num_classes)]

    cls_per = per_class(cls_score, num_classes)
    box_per = per_class(bbox_pred, 7)
    dir_per = per_class(dir_pred, 2)

    targets, pos = [], 0
    for i in range(b):
        t, p = anchor3d_head_targets(anchors_per_class, gt_boxes[i],
                                     gt_labels[i], gt_mask[i],
                                     assigner_cfgs, num_classes, dir_offset)
        targets.append(t)
        pos = pos + p
    # focal-loss heads normalise by the positives only (mmdet
    # anchor3d_head.py:100, 380); LIGA adds the clamp for cls and clamps
    # from below for reg / dir / iou (liga_anchor3d_head.py:142-223)
    num_total = torch.as_tensor(pos, dtype=torch.float32,
                                device=cls_score.device)
    if dist_norm:
        num_total = D.global_sum(num_total)
    avg_cls = num_total + normalizer_clamp_value
    avg_reg = torch.clamp(num_total, min=normalizer_clamp_value)

    # per-class terms stacked and summed at the end, as the JAX package
    terms = {'loss_cls': [], 'loss_bbox': [], 'loss_dir': [], 'loss_iou': []}
    for c in range(num_classes):
        t = {k: torch.stack([tb[c][k] for tb in targets])
             for k in targets[0][c]}
        anchors = anchors_per_class[c][None].expand(
            (b,) + tuple(anchors_per_class[c].shape))
        terms['loss_cls'].append(L.sigmoid_focal_loss(
            cls_per[c], t['labels'], t['label_weights'], avg_factor=avg_cls))
        pred_sin, target_sin = add_sin_difference(box_per[c],
                                                  t['bbox_targets'])
        terms['loss_bbox'].append(L.smooth_l1_loss(
            pred_sin, target_sin, t['bbox_weights'][..., None],
            beta=1.0 / 9.0, avg_factor=avg_reg))
        terms['loss_dir'].append(L.softmax_cross_entropy(
            dir_per[c], t['dir_targets'], t['dir_weights'],
            avg_factor=avg_reg))
        if use_iou_loss:
            # non-positives get the anchor itself AND a zero weight: the
            # rotated clip is degenerate on identical boxes
            msk = t['pos_mask'][..., None]
            dec_pred = torch.where(
                msk, delta_xyzwlhr_decode(anchors, box_per[c]), anchors)
            dec_tgt = torch.where(
                msk, delta_xyzwlhr_decode(anchors, t['bbox_targets']),
                anchors)
            terms['loss_iou'].append(L.iou3d_loss(
                dec_pred.reshape(-1, 7), dec_tgt.reshape(-1, 7),
                weights=t['pos_mask'].reshape(-1).float(),
                avg_factor=avg_reg))

    out = {'loss_cls': loss_weights[0] * torch.stack(terms['loss_cls']).sum(),
           'loss_bbox': loss_weights[1] *
           torch.stack(terms['loss_bbox']).sum(),
           'loss_dir': loss_weights[2] * torch.stack(terms['loss_dir']).sum()}
    if use_iou_loss:
        out['loss_iou'] = loss_weights[3] * \
            torch.stack(terms['loss_iou']).sum()
    return out


def anchor3d_head_get_bboxes(preds, flat_anchors, num_classes=3,
                             dir_offset=0.7854, dir_limit_offset=0.0,
                             score_thr=0.1, nms_thr=0.25, nms_pre=1024,
                             max_num=500):
    """Decode + multi-class rotated NMS with static output shapes.

    Args:
        preds: (cls_score, bbox_pred, dir_pred), each (B, Ny, Nx, ...).
        flat_anchors: (A, 7) tensor, A = Ny * Nx * num_anchors, in the
            head's channel order.

    Returns:
        dict of (B, max_num, ...) padded detections and 'mask'.
    """
    cls_score, bbox_pred, dir_pred = preds
    b = cls_score.shape[0]
    a = flat_anchors.shape[0]
    scores = torch.sigmoid(cls_score.float()).reshape(b, a, num_classes)
    deltas = bbox_pred.float().reshape(b, a, 7)
    dir_score = dir_pred.reshape(b, a, 2).argmax(-1)
    k = min(nms_pre, a)
    outs = []
    for i in range(b):
        _, topk = torch.topk(scores[i].amax(-1), k)
        boxes = delta_xyzwlhr_decode(flat_anchors[topk], deltas[i, topk])
        out = box3d_multiclass_nms(
            boxes, boxes[:, [0, 1, 3, 4, 6]], scores[i, topk], score_thr,
            nms_thr, max_num, dir_scores=dir_score[i, topk])
        # direction correction
        yaw = out['boxes3d'][:, 6]
        yaw = limit_period(yaw - dir_offset, dir_limit_offset, torch.pi) + \
            dir_offset + torch.pi * out['dir_scores'].to(yaw.dtype)
        out['boxes3d'][:, 6] = torch.where(out['mask'], yaw,
                                           torch.zeros_like(yaw))
        outs.append(out)
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}
