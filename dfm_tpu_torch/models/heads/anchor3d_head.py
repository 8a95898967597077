"""LIGA anchor head: forward and inference decode.

Port of `dfm_tpu/models/heads/anchor3d_head.py:30-68` (forward) and
`:225-273` (`anchor3d_head_get_bboxes`). Keys: cls_convs.i, reg_convs.i,
conv_cls, conv_reg, conv_dir_cls. Head outputs are returned
channels-last (B, Ny, Nx, A * X), as in the JAX package.
"""

import torch
import torch.nn as nn

from ..layers import Conv, ConvNorm
from ...core.coders import delta_xyzwlhr_decode
from ...core.nms import box3d_multiclass_nms
from ...core.transforms import limit_period


class LIGAAnchor3DHead(nn.Module):
    def __init__(self, num_classes=3, in_channels=64, feat_channels=64,
                 num_anchors=6):
        super().__init__()
        cins = [in_channels, feat_channels]          # two convs per tower
        self.cls_convs = nn.ModuleList(
            [ConvNorm(c, feat_channels, 3) for c in cins])
        self.reg_convs = nn.ModuleList(
            [ConvNorm(c, feat_channels, 3) for c in cins])
        self.conv_cls = Conv(feat_channels, num_anchors * num_classes, 3,
                             bias=True)
        self.conv_reg = Conv(feat_channels, num_anchors * 7, 3, bias=True)
        self.conv_dir_cls = Conv(feat_channels, num_anchors * 2, 1,
                                 bias=True)

    def forward(self, x):
        cls_feats = reg_feats = x
        for cls_conv, reg_conv in zip(self.cls_convs, self.reg_convs):
            cls_feats = cls_conv(cls_feats)
            reg_feats = reg_conv(reg_feats)
        nhwc = (lambda t: t.permute(0, 2, 3, 1))            # noqa: E731
        return (nhwc(self.conv_cls(cls_feats)),
                nhwc(self.conv_reg(reg_feats)),
                nhwc(self.conv_dir_cls(cls_feats)))


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
