"""2D ATSS head of DfMFull and ImVoteNet: forward, assignment, loss and
decode.

Port of `dfm_tpu/models/heads/atss2d.py:31-258` (`ATSS2DConfig`,
`ATSS2DHead`, `level_anchors`, `atss_assign`, `atss2d_loss`; the
reference's `LIGAATSSHead` with the `ATSS3DCenterAssigner`, where each
gt's centre for the candidate selection is its projected 3D centre; and
`atss2d_decode`, ImVoteNet's in-graph 2D detections: the top
`max_boxes` anchors by sigmoid(cls) x sigmoid(centerness), no NMS,
`highest_k`'s order, ties to the lower index, as `lax.top_k`).
The GroupNorm towers are shared by the levels. Keys: cls_tower<i>,
reg_tower<i> (conv + gn), atss_cls, atss_reg, atss_centerness. Level
outputs are returned channels-last (B, h, w, X), as in the JAX package,
so that each level flattens in its (y, x) then channel order, the order
of `level_anchors`.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..backbones.pointnet2 import highest_k
from ..layers import Conv, ConvNorm
from ...core import losses as L
from ...core.iou import aligned_iou_2d
from ...parallel import dist as D

__all__ = ['ATSS2DConfig', 'ATSS2DHead', 'level_anchors', 'atss_assign',
           'atss2d_anchors', 'atss2d_targets', 'atss2d_loss',
           'atss2d_decode']


@dataclasses.dataclass(frozen=True)
class ATSS2DConfig:
    num_classes: int = 3
    in_channels: int = 64
    feat_channels: int = 64
    stacked_convs: int = 4
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    anchor_scale: float = 16.0    # octave_base_scale, ratio 1.0
    topk: int = 9
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)


class ATSS2DHead(nn.Module):
    def __init__(self, cfg: ATSS2DConfig = ATSS2DConfig()):
        super().__init__()
        cins = [cfg.in_channels] + [cfg.feat_channels] * (
            cfg.stacked_convs - 1)
        for i, c in enumerate(cins):
            setattr(self, f'cls_tower{i}', ConvNorm(c, cfg.feat_channels, 3))
            setattr(self, f'reg_tower{i}', ConvNorm(c, cfg.feat_channels, 3))
        self.stacked_convs = cfg.stacked_convs
        self.atss_cls = Conv(cfg.feat_channels, cfg.num_classes, 3,
                             bias=True)
        self.atss_reg = Conv(cfg.feat_channels, 4, 3, bias=True)
        self.atss_centerness = Conv(cfg.feat_channels, 1, 3, bias=True)

    def forward(self, feats):
        """NCHW levels -> a list of dicts of channels-last cls_score
        (B, h, w, num_classes), bbox_pred (.., 4), centerness (.., 1)."""
        outs = []
        for x in feats:
            c = r = x
            for i in range(self.stacked_convs):
                c = getattr(self, f'cls_tower{i}')(c)
                r = getattr(self, f'reg_tower{i}')(r)
            outs.append({k: v.permute(0, 2, 3, 1) for k, v in dict(
                cls_score=self.atss_cls(c), bbox_pred=self.atss_reg(r),
                centerness=self.atss_centerness(r)).items()})
        return outs


def level_anchors(featmap_size, stride, scale):
    """(h * w, 4) square xyxy anchors centred on the grid, (y, x) order
    (numpy float32)."""
    h, w = featmap_size
    ys = (np.arange(h, dtype=np.float32) + 0.5) * stride
    xs = (np.arange(w, dtype=np.float32) + 0.5) * stride
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    half = scale * stride / 2
    return np.stack([xx - half, yy - half, xx + half, yy + half],
                    -1).reshape(-1, 4)


def atss_assign(anchors, level_sizes, gt_boxes, gt_centers, gt_mask,
                topk=9):
    """ATSS assignment of one sample, static shapes.

    Args:
        anchors: (A, 4) tensor, the levels' anchors concatenated.
        level_sizes: the anchor count of each level.
        gt_boxes: (G, 4) xyxy; gt_centers: (G, 2), the projected 3D
            centres; gt_mask: (G,).

    Returns:
        assigned (A,) int64, -1 or the matched gt; the (A, G) IoUs.

    Per level, the top-k anchors by centre distance are candidates (a
    stable sort, as `jnp.argsort`: ties go to the lower index); a gt's
    IoU threshold is the mean + std of its candidates' IoUs; a positive
    is a candidate at or above it whose centre lies strictly inside the
    gt; an anchor takes the first gt of highest IoU among its positives.
    """
    a_ctr = (anchors[:, :2] + anchors[:, 2:]) / 2
    g = gt_boxes.shape[0]
    ious = aligned_iou_2d(anchors, gt_boxes)                  # (A, G)
    dist = torch.linalg.norm(a_ctr[:, None] - gt_centers[None], dim=-1)
    cand_masks = []
    start = 0
    for n in level_sizes:
        d_l = dist[start:start + n]
        idx = torch.argsort(d_l, dim=0, stable=True)[:min(topk, n)]
        cand_masks.append(torch.zeros((n, g), dtype=torch.bool,
                                      device=anchors.device).scatter_(
                                          0, idx, True))
        start += n
    cand = torch.cat(cand_masks, 0)                           # (A, G)
    cand_ious = torch.where(cand, ious, torch.full_like(ious, torch.nan))
    mean = torch.nanmean(cand_ious, 0)
    std = torch.sqrt(torch.nanmean((cand_ious - mean[None]) ** 2, 0))
    thr = mean + std
    inside = ((a_ctr[:, None, 0] > gt_boxes[None, :, 0]) &
              (a_ctr[:, None, 0] < gt_boxes[None, :, 2]) &
              (a_ctr[:, None, 1] > gt_boxes[None, :, 1]) &
              (a_ctr[:, None, 1] < gt_boxes[None, :, 3]))
    pos = cand & (ious >= thr[None]) & inside & gt_mask[None].bool()
    best = torch.argmax(torch.where(pos, ious, torch.full_like(ious, -1.0)),
                        1)
    return torch.where(pos.any(1), best, torch.full_like(best, -1)), ious


def atss2d_anchors(img_hw, cfg: ATSS2DConfig, device):
    """The levels' anchors of an (H, W) input, concatenated (A, 4), and
    each level's anchor count."""
    h, w = img_hw
    sizes = [((h + s - 1) // s, (w + s - 1) // s) for s in cfg.strides]
    anchors = torch.as_tensor(np.concatenate([
        level_anchors(sz, s, cfg.anchor_scale)
        for sz, s in zip(sizes, cfg.strides)], 0), device=device)
    return anchors, [sz[0] * sz[1] for sz in sizes]


def atss2d_targets(anchors, level_sizes, gt, cfg: ATSS2DConfig):
    """Per sample of `gt` (as `atss2d_loss`'s): labels (B, A), the class
    or num_classes; matched gt boxes (B, A, 4); positives (B, A)."""
    labels, matched, pos = [], [], []
    for gt2d, c2d, gl, gm in zip(gt['gt_bboxes2d'], gt['centers2d'],
                                 gt['gt_labels'], gt['gt_mask']):
        assigned, _ = atss_assign(anchors, level_sizes, gt2d, c2d, gm,
                                  cfg.topk)
        p = assigned >= 0
        gi = assigned.clamp(min=0)
        labels.append(torch.where(p, gl.long()[gi],
                                  torch.full_like(gi, cfg.num_classes)))
        matched.append(gt2d[gi])
        pos.append(p)
    return torch.stack(labels), torch.stack(matched), torch.stack(pos)


def atss2d_loss(level_outs, img_hw, gt, cfg: ATSS2DConfig, dist_norm=False):
    """Focal classification + GIoU box (x 2) + BCE centerness, each over
    the positive count (mmdet `ATSSHead.loss`).

    Args:
        level_outs: `ATSS2DHead.forward` outputs.
        img_hw: the input image's (H, W).
        gt: 'gt_bboxes2d' (B, G, 4), 'centers2d' (B, G, 2), 'gt_labels'
            (B, G), 'gt_mask' (B, G).
        dist_norm: in a process group, the positives of the global batch
            (`anchor3d_head_loss`'s rule); a no-op without a group.

    Returns:
        dict loss_cls2d, loss_bbox2d, loss_centerness2d.
    """
    device = level_outs[0]['cls_score'].device
    anchors, level_sizes = atss2d_anchors(img_hw, cfg, device)

    def flat(key, per):
        return torch.cat([o[key].float().reshape(o[key].shape[0], -1, per)
                          for o in level_outs], 1)

    cls_score = flat('cls_score', cfg.num_classes)
    bbox_pred = flat('bbox_pred', 4)
    centerness = flat('centerness', 1)[..., 0]

    labels, matched, pos = atss2d_targets(anchors, level_sizes, gt, cfg)
    num_pos = pos.sum().float()
    if dist_norm:
        num_pos = D.global_sum(num_pos)
    num_pos = torch.clamp(num_pos, min=1.0)

    loss_cls = L.sigmoid_focal_loss(cls_score, labels, avg_factor=num_pos)

    # DeltaXYWH predictions decoded on the anchors
    stds = torch.as_tensor(cfg.target_stds, device=device)
    wa = anchors[:, 2] - anchors[:, 0]
    ha = anchors[:, 3] - anchors[:, 1]
    xa = (anchors[:, 0] + anchors[:, 2]) / 2
    ya = (anchors[:, 1] + anchors[:, 3]) / 2
    d = bbox_pred * stds[None, None]
    xg = xa[None] + d[..., 0] * wa[None]
    yg = ya[None] + d[..., 1] * ha[None]
    wg = wa[None] * torch.exp(torch.clamp(d[..., 2], -10, 10))
    hg = ha[None] * torch.exp(torch.clamp(d[..., 3], -10, 10))
    decoded = torch.stack([xg - wg / 2, yg - hg / 2, xg + wg / 2,
                           yg + hg / 2], -1)
    wmask = pos.float()
    zero = torch.zeros((), device=device)
    matched_s = torch.where(pos[..., None], matched, zero)
    decoded_s = torch.where(pos[..., None], decoded, zero)
    loss_bbox = L.giou_loss_2d(decoded_s, matched_s, wmask,
                               avg_factor=num_pos) * 2.0

    # centerness targets from the anchor centre's l / r / t / b distances
    lr = torch.stack([xa[None] - matched[..., 0], matched[..., 2] - xa[None]],
                     -1).clamp(min=1e-3)
    tb = torch.stack([ya[None] - matched[..., 1], matched[..., 3] - ya[None]],
                     -1).clamp(min=1e-3)
    ctr_tgt = torch.sqrt((lr.amin(-1) / lr.amax(-1)) *
                         (tb.amin(-1) / tb.amax(-1)))
    loss_ctr = L.binary_cross_entropy(centerness, ctr_tgt, wmask,
                                      avg_factor=num_pos)
    return dict(loss_cls2d=loss_cls, loss_bbox2d=loss_bbox,
                loss_centerness2d=loss_ctr)


def atss2d_decode(level_outs, img_hw, cfg: ATSS2DConfig, max_boxes=16):
    """`ATSS2DHead` outputs of an (H, W) image -> (B, max_boxes, 6) slots
    (l, t, r, b, conf, cls): the anchors of the `max_boxes` highest
    confidences (the best class's sigmoid(cls) x sigmoid(centerness)),
    their DeltaXYWH boxes clipped to the image, the class as a float;
    float32, as JAX computes them in any model dtype."""
    h, w = img_hw
    device = level_outs[0]['cls_score'].device
    anchors, _ = atss2d_anchors(img_hw, cfg, device)

    def flat(key, per):
        return torch.cat([o[key].float().reshape(o[key].shape[0], -1, per)
                          for o in level_outs], 1)

    score = torch.sigmoid(flat('cls_score', cfg.num_classes)) * \
        torch.sigmoid(flat('centerness', 1))
    conf, label = score.max(-1).values, torch.argmax(score, -1)
    anchors = anchors.to(conf.dtype)
    stds = torch.as_tensor(cfg.target_stds, dtype=conf.dtype, device=device)
    d = flat('bbox_pred', 4) * stds
    wa = anchors[:, 2] - anchors[:, 0]
    ha = anchors[:, 3] - anchors[:, 1]
    xa = (anchors[:, 0] + anchors[:, 2]) / 2
    ya = (anchors[:, 1] + anchors[:, 3]) / 2
    xg = xa + d[..., 0] * wa
    yg = ya + d[..., 1] * ha
    wg = wa * torch.exp(torch.clamp(d[..., 2], -10, 10))
    hg = ha * torch.exp(torch.clamp(d[..., 3], -10, 10))
    boxes = torch.stack([
        torch.clamp(xg - wg / 2, 0, w - 1), torch.clamp(yg - hg / 2, 0, h - 1),
        torch.clamp(xg + wg / 2, 0, w - 1), torch.clamp(yg + hg / 2, 0, h - 1)],
        -1)
    top_conf, idx = highest_k(conf, max_boxes)
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(
        idx.shape + (4,)))
    top_label = torch.gather(label, 1, idx)
    return torch.cat([top_boxes, top_conf[..., None],
                      top_label[..., None].to(conf.dtype)], -1)
