"""PointRCNN: the two-stage point-based LiDAR detector.

Port of `dfm_tpu/models/detectors/point_rcnn.py:43-344` (reference
mmdet3d point_rcnn.py:9-95 with PointRPNHead, PointNetFPNeck,
PointRCNNRoIHead + PointRCNNBboxHead and PointXYZWHLRBBoxCoder), both
stages in one forward, the JAX package's static shapes:

* `backbone` (`PointNet2SAMSG`: four D-FPS stages of two radii, no
  aggregation) and `neck` (`PointNetFPNeck`) give 128 features a point;
  `rpn_cls{0,1,_out}` / `rpn_reg{0,1,_out}` (`Linear` + ReLU) the
  per-point class logits and the 8 box codes (`point_coder_decode`: the
  class's mean size, gravity-centre z);
* proposals: per sample the top min(1024, N) objectness scores (the max
  class sigmoid; ties to the lower index), class-agnostic rotated NMS
  (`core/nms.py:nms_bev`), the top `num_proposals` kept (slots past the
  kept ones take suppressed candidates, masked by `prop_mask`, as
  `lax.top_k` picks them: lower index first), with the argmax class;
* RoI stage: per proposal the first `roi_num_points` points inside it in
  index order, then the first outside it (`lax.top_k` of the 0/1 mask;
  `has` masks those), rotated into the proposal's frame about its centre,
  with the objectness and the normalised depth, `xyz_up{0,1}` and
  `merge`, two `SAModule`s (`roi_sa0`, `roi_sa1`) on the canonical
  points, `roi_global` and max, `rcnn_cls*` / `rcnn_reg*`.

`point_rcnn_loss`: the RPN's sigmoid focal loss (positives: points in a
gt box, their first box; background: points outside every box enlarged
by `enlarge_width`; the ring ignored) and smooth L1 (beta 1/9) of the
codes, over the positives; the RCNN's binary cross entropy (IoU above
`cls_pos_thr` positive, below `cls_neg_thr` negative) and smooth L1 (beta
1) of the residual codes (IoU at least `reg_pos_thr`; the target's yaw
flipped by pi into the half circle nearest the proposal); every count
over the global batch in a process group. JAX's loss takes an `rng` it
never reads; this one takes none. `point_rcnn_predict`: the refined
boxes, rotated NMS at `rcnn_nms_thr` over scores above `score_thr`, the
top `max_num`.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.coders import delta_xyzwlhr_decode, delta_xyzwlhr_encode
from ...core.iou import _at_least, rotated_iou_3d
from ...core.losses import sigmoid_focal_loss, smooth_l1_loss
from ...core.nms import nms_bev
from ...parallel import dist as D
from ..backbones.pointnet2 import (SAModule, gather_points, highest_k,
                                   lowest_k)
from ..backbones.pointnet2_msg import PointNet2SAMSG
from ..layers import Linear
from ..necks.pointnet2_fp import PointNetFPNeck

__all__ = ['PointRCNN', 'PointRCNNConfig', 'point_rcnn_loss',
           'point_rcnn_predict', 'point_coder_encode', 'point_coder_decode',
           'points_in_boxes', 'rcnn_targets', 'rcnn_losses',
           'refine_predict']

SA_CHANNELS = (((16, 16, 32), (32, 32, 64)), ((64, 64, 128), (64, 96, 128)),
               ((128, 196, 256), (128, 196, 256)),
               ((256, 256, 512), (256, 384, 512)))
FP_CHANNELS = ((512, 512), (512, 512), (256, 256), (128, 128))


@dataclasses.dataclass(frozen=True)
class PointRCNNConfig:
    """The fields and defaults of the JAX `PointRCNNConfig`."""
    num_classes: int = 3
    point_cloud_range: Tuple[float, ...] = (0, -40, -3, 70.4, 40, 1)
    mean_sizes: Tuple[Tuple[float, float, float], ...] = (
        (3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
    enlarge_width: float = 0.1
    num_proposals: int = 128          # static nms_post (ref 512)
    rpn_nms_thr: float = 0.8
    roi_num_points: int = 512
    cls_pos_thr: float = 0.7
    cls_neg_thr: float = 0.25
    reg_pos_thr: float = 0.55
    depth_normalizer: float = 70.0
    score_thr: float = 0.1
    rcnn_nms_thr: float = 0.1
    max_num: int = 50
    sa_points: Tuple[int, ...] = (4096, 1024, 256, 64)
    sa_radii: Tuple[Tuple[float, float], ...] = (
        (0.1, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0))
    sa_samples: Tuple[Tuple[int, int], ...] = (
        (16, 32), (16, 32), (16, 32), (16, 32))


def _mean_sizes(mean_sizes, labels, like):
    ms = torch.as_tensor(mean_sizes, dtype=like.dtype, device=like.device)
    return ms[labels]


def point_coder_encode(gt_boxes, points, labels, mean_sizes):
    """PointXYZWHLRBBoxCoder.encode -> (..., 8) codes of gravity-centre
    boxes at their points."""
    ms = _mean_sizes(mean_sizes, labels, gt_boxes)
    diag = torch.sqrt(ms[..., 0] ** 2 + ms[..., 1] ** 2)
    dims = _at_least(gt_boxes[..., 3:6], 1e-5)
    xt = (gt_boxes[..., 0] - points[..., 0]) / diag
    yt = (gt_boxes[..., 1] - points[..., 1]) / diag
    zt = (gt_boxes[..., 2] - points[..., 2]) / ms[..., 2]
    dt = torch.log(dims / ms)
    return torch.stack([xt, yt, zt, dt[..., 0], dt[..., 1], dt[..., 2],
                        torch.cos(gt_boxes[..., 6]),
                        torch.sin(gt_boxes[..., 6])], -1)


def point_coder_decode(enc, points, labels, mean_sizes):
    """(..., 8) codes at their points -> (..., 7) gravity-centre boxes."""
    ms = _mean_sizes(mean_sizes, labels, points)
    diag = torch.sqrt(ms[..., 0] ** 2 + ms[..., 1] ** 2)
    x = enc[..., 0] * diag + points[..., 0]
    y = enc[..., 1] * diag + points[..., 1]
    z = enc[..., 2] * ms[..., 2] + points[..., 2]
    dims = torch.exp(enc[..., 3:6]) * ms
    yaw = torch.atan2(enc[..., 7], enc[..., 6])
    return torch.cat([torch.stack([x, y, z], -1), dims, yaw[..., None]], -1)


def points_in_boxes(points, boxes, enlarge=0.0):
    """(N, 3) points x (G, 7) bottom-centre boxes -> (N, G) bool, each box
    enlarged by `enlarge` on every side (JAX `_points_in_boxes`)."""
    local = points[:, None, :] - boxes[None, :, :3]
    yaw = boxes[:, 6]
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    lx = local[..., 0] * c - local[..., 1] * s
    ly = local[..., 0] * s + local[..., 1] * c
    lz = local[..., 2]
    dx = boxes[:, 3] + 2 * enlarge
    dy = boxes[:, 4] + 2 * enlarge
    dz = boxes[:, 5] + 2 * enlarge
    return ((lx.abs() <= dx / 2) & (ly.abs() <= dy / 2) &
            (lz >= -enlarge) & (lz <= boxes[:, 5] + enlarge)) & \
        (dz[None] > 0)


def _head_layers(owner, tag, cin, widths, cout):
    """Register `Linear`s `{tag}{i}` (each + ReLU) and `{tag}_out` on
    `owner` (flax's names) -> the head's (tag, depth)."""
    for i, w in enumerate(widths):
        setattr(owner, f'{tag}{i}', Linear(cin, w))
        cin = w
    setattr(owner, f'{tag}_out', Linear(cin, cout))
    return tag, len(widths)


def _run_head(owner, head, x):
    tag, n = head
    for i in range(n):
        x = F.relu(getattr(owner, f'{tag}{i}')(x))
    return getattr(owner, f'{tag}_out')(x)


class PointRCNN(nn.Module):
    """The points carry (x, y, z), as every source of the repo gives them
    (no features ahead of the first SA stage)."""

    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or PointRCNNConfig()
        self.cfg = cfg
        self.dtype = dtype
        n = len(cfg.sa_points)
        self.backbone = PointNet2SAMSG(
            3, tuple((p,) for p in cfg.sa_points),
            cfg.sa_radii, cfg.sa_samples, SA_CHANNELS[:n], (None,) * n,
            (('D-FPS',),) * n, ((-1,),) * n, dtype)
        self.neck = PointNetFPNeck(self.backbone.out_channels,
                                   FP_CHANNELS[-n:], dtype)
        feat = FP_CHANNELS[-1][-1]
        self.rpn_cls = _head_layers(self, 'rpn_cls', feat, (256, 256),
                                    cfg.num_classes)
        self.rpn_reg = _head_layers(self, 'rpn_reg', feat, (256, 256), 8)
        self.xyz_up0 = Linear(5, 128)
        self.xyz_up1 = Linear(128, 128)
        self.merge = Linear(128 + feat, 256)
        self.roi_sa0 = SAModule(128, 0.2, 16, (128, 128, 128), 3 + 256,
                                dtype)
        self.roi_sa1 = SAModule(32, 0.4, 16, (128, 128, 256), 3 + 128, dtype)
        self.roi_global = Linear(256, 512)
        self.rcnn_cls = _head_layers(self, 'rcnn_cls', 512, (256, 256), 1)
        self.rcnn_reg = _head_layers(self, 'rcnn_reg', 512, (256, 256), 7)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `point_rcnn_loss` -> (total, terms);
        `point_mask` (None: PointRCNN's batches have none), `generator`
        and `depth_pix_idx` are not read."""
        return point_rcnn_loss(self(points), gt, self.cfg)

    def proposals(self, xyz, cls_pred, reg_pred):
        """Class-agnostic rotated NMS of the decoded points' boxes ->
        (boxes (B, R, 7) bottom-centre, scores, labels, mask)."""
        cfg = self.cfg
        sem = torch.sigmoid(cls_pred.float())
        obj, lab = sem.amax(-1), sem.argmax(-1)
        boxes = point_coder_decode(reg_pred.float().detach(), xyz, lab,
                                   cfg.mean_sizes)
        boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] -
                           boxes[..., 5:6] / 2, boxes[..., 3:]], -1)
        out = []
        for bx, sc in zip(boxes, obj.detach()):
            top_sc, top_i = highest_k(sc, min(1024, bx.shape[0]))
            bxp = bx[top_i]
            keep = nms_bev(bxp[:, [0, 1, 3, 4, 6]], top_sc, cfg.rpn_nms_thr)
            psc, pi = highest_k(torch.where(keep, top_sc, torch.full_like(
                top_sc, -torch.inf)), cfg.num_proposals)
            out.append((bxp[pi], psc, top_i[pi]))
        prop_boxes, prop_scores, prop_idx = (torch.stack(x)
                                             for x in zip(*out))
        prop_mask = torch.isfinite(prop_scores)
        prop_scores = torch.where(prop_mask, prop_scores,
                                  torch.zeros_like(prop_scores))
        return (prop_boxes, prop_scores, torch.gather(lab, 1, prop_idx),
                prop_mask, obj)

    def roi_points(self, pts_xyz, feat, obj, rois):
        """Each proposal's `roi_num_points` points: in-box ones first, in
        index order -> (xyz, features, objectness, has) (B, R, K, ...)."""
        inside = torch.stack([points_in_boxes(p, r).t()
                              for p, r in zip(pts_xyz, rois)])   # (B, R, N)
        pidx = lowest_k((~inside).to(torch.uint8),
                        self.cfg.roi_num_points)
        flat = pidx.reshape(pidx.shape[0], -1)
        take = lambda x: gather_points(x, flat).reshape(   # noqa: E731
            pidx.shape + x.shape[2:])
        return (take(pts_xyz), take(feat), take(obj[..., None])[..., 0],
                torch.gather(inside, 2, pidx))

    def stage1(self, points):
        """points (B, N, 3+) -> (xyz (B, N, 3), features (B, N, 128), class
        logits, box codes): the backbone, the FP neck and the RPN heads."""
        fp = self.neck(self.backbone(points))
        feat = fp['fp_features']
        return (fp['fp_xyz'], feat, _run_head(self, self.rpn_cls, feat),
                _run_head(self, self.rpn_reg, feat))

    def roi_stage(self, points, feat, obj, prop_boxes):
        """The refinement of each proposal from its points -> rcnn_cls (B,
        R), rcnn_reg (B, R, 7)."""
        cfg = self.cfg
        k = cfg.roi_num_points
        sel_xyz, sel_feat, sel_obj, sel_has = self.roi_points(
            points[..., :3], feat, obj, prop_boxes)
        ctr = torch.cat([prop_boxes[..., :2], prop_boxes[..., 2:3] +
                         prop_boxes[..., 5:6] / 2], -1)
        local = sel_xyz - ctr[:, :, None, :]
        yaw = prop_boxes[..., 6]
        c = torch.cos(-yaw)[..., None]
        s = torch.sin(-yaw)[..., None]
        lx = local[..., 0] * c - local[..., 1] * s
        ly = local[..., 0] * s + local[..., 1] * c
        canon = torch.stack([lx, ly, local[..., 2]], -1)
        depth = torch.sqrt((sel_xyz * sel_xyz).sum(-1, keepdim=True)) / \
            torch.tensor(cfg.depth_normalizer, device=sel_xyz.device)
        ext = torch.cat([canon, sel_obj[..., None], depth], -1) * \
            sel_has[..., None]
        b, r = ext.shape[:2]
        x = ext.reshape(b * r, k, 5).to(self.dtype)
        pf = sel_feat.reshape(b * r, k, -1).to(self.dtype)
        x = F.relu(self.xyz_up1(F.relu(self.xyz_up0(x))))
        merged = F.relu(self.merge(torch.cat([x, pf], -1)))
        h_xyz, h = self.roi_sa0(canon.reshape(b * r, k, 3), merged)
        h_xyz, h = self.roi_sa1(h_xyz, h)
        g = F.relu(self.roi_global(h)).amax(1)
        return (_run_head(self, self.rcnn_cls, g).reshape(b, r),
                _run_head(self, self.rcnn_reg, g).reshape(b, r, 7))

    def forward(self, points, point_mask=None):
        """points (B, N, 3+) -> dict: stage 1's 'xyz', 'cls_pred',
        'reg_pred'; 'proposals' (B, R, 7), 'prop_scores', 'prop_labels',
        'prop_mask'; stage 2's 'rcnn_cls' (B, R), 'rcnn_reg' (B, R, 7).
        `point_mask` is not read (JAX's PointRCNN takes none)."""
        with record_function('point_rcnn.stage1'):
            xyz, feat, cls_pred, reg_pred = self.stage1(points)
        with record_function('point_rcnn.proposals'):
            prop_boxes, prop_scores, prop_labels, prop_mask, obj = \
                self.proposals(xyz, cls_pred, reg_pred)
        with record_function('point_rcnn.roi'):
            rc, rr = self.roi_stage(points, feat, obj, prop_boxes)
        return dict(xyz=xyz, cls_pred=cls_pred, reg_pred=reg_pred,
                    proposals=prop_boxes, prop_scores=prop_scores,
                    prop_labels=prop_labels, prop_mask=prop_mask,
                    rcnn_cls=rc, rcnn_reg=rr)


def rcnn_targets(rois, rmask, gt_boxes, gt_mask, cls_pos_thr, cls_neg_thr,
                 reg_pos_thr):
    """One sample's RoI targets (R,): classification target and weight,
    regression weight, and the (R, 7) residual codes (the gt's yaw
    flipped by pi into the half circle nearest the RoI's)."""
    iou = rotated_iou_3d(rois, gt_boxes)
    iou = torch.where(gt_mask[None].bool(), iou, torch.zeros_like(iou))
    best = iou.amax(1)
    best = torch.where(rmask, best, torch.zeros_like(best))
    arg = iou.argmax(1)
    cls_t = (best > cls_pos_thr).float()
    cls_w = ((best > cls_pos_thr) | (best < cls_neg_thr)) & rmask
    regp = (best >= reg_pos_thr) & rmask
    agt = gt_boxes[arg]
    dy = agt[:, 6] - rois[:, 6]
    dy = torch.atan2(torch.sin(dy), torch.cos(dy))
    ny = torch.where(dy.abs() > torch.pi / 2, agt[:, 6] + torch.pi,
                     agt[:, 6])
    agt = torch.cat([agt[:, :6], ny[:, None]], -1)
    return cls_t, cls_w.float(), regp.float(), \
        delta_xyzwlhr_encode(rois, agt)


def rcnn_losses(outputs, gt, cfg, dist_norm=True):
    """The refinement's 'loss_rcnn_cls' (binary cross entropy over the
    weighted RoIs) and 'loss_rcnn_reg' (smooth L1, beta 1, over the
    regressed RoIs), shared by PointRCNN and Part-A2; `dist_norm`: the
    counts over the global batch in a process group."""
    tg = [rcnn_targets(r, m, b, g, cfg.cls_pos_thr, cfg.cls_neg_thr,
                       cfg.reg_pos_thr)
          for r, m, b, g in zip(outputs['proposals'], outputs['prop_mask'],
                                gt['gt_boxes'].float(), gt['gt_mask'])]
    cls_t, cls_w, regp, enc = (torch.stack(x) for x in zip(*tg))
    rc = outputs['rcnn_cls'].float()
    ce = _at_least(rc, 0.0) - rc * cls_t + torch.log1p(torch.exp(-rc.abs()))
    gsum = D.global_sum if dist_norm else (lambda x: x)
    return dict(
        loss_rcnn_cls=(ce * cls_w).sum() / gsum(cls_w.sum()).clamp(min=1.0),
        loss_rcnn_reg=smooth_l1_loss(
            outputs['rcnn_reg'].float(), enc, weights=regp[..., None],
            beta=1.0, avg_factor=gsum(regp.sum()).clamp(min=1.0)))


def point_rcnn_loss(outputs, gt, cfg: PointRCNNConfig):
    """RPN focal + smooth L1 and the RCNN terms -> (total, terms)."""
    xyz = outputs['xyz']
    tgts = []
    for xyz_i, gtb, gtl, gtm in zip(xyz, gt['gt_boxes'].float(),
                                    gt['gt_labels'], gt['gt_mask']):
        gtm = gtm.bool()
        inside = points_in_boxes(xyz_i, gtb) & gtm[None]
        assign = torch.argmax(inside.to(torch.int32), 1)
        pos = inside.any(1)
        ring = points_in_boxes(xyz_i, gtb, cfg.enlarge_width) & gtm[None]
        agt = gtb[assign]
        agt = torch.cat([agt[:, :2], agt[:, 2:3] + agt[:, 5:6] / 2,
                         agt[:, 3:]], -1)
        albl = gtl[assign]
        tgts.append((point_coder_encode(agt, xyz_i, albl, cfg.mean_sizes),
                     albl, pos, ~ring.any(1)))
    tgt, albl, pos, negm = (torch.stack(x) for x in zip(*tgts))
    num_pos = D.global_sum(pos.sum().float()).clamp(min=1.0)
    sem_labels = torch.where(pos, albl, torch.full_like(albl,
                                                        cfg.num_classes))
    losses = dict(
        loss_rpn_cls=sigmoid_focal_loss(
            outputs['cls_pred'].float(), sem_labels,
            weights=(pos | negm).float(), alpha=0.25, gamma=2.0,
            avg_factor=num_pos),
        loss_rpn_bbox=smooth_l1_loss(
            outputs['reg_pred'].float(), tgt, weights=pos[..., None].float(),
            beta=1.0 / 9.0, avg_factor=num_pos))
    losses.update(rcnn_losses(outputs, gt, cfg))
    return sum(losses.values()), losses


def refine_predict(outputs, cfg, nms_thr):
    """The refined boxes of the RoIs, rotated NMS at `nms_thr` over scores
    above `cfg.score_thr`, the top `cfg.max_num` -> padded 'boxes3d',
    'scores', 'labels' (-1 where empty), 'mask'. With fewer RoIs than
    `max_num` (Part-A2's shipped config: 64 against 100) the slots past
    the RoIs stay empty, where JAX's `lax.top_k` raises (ROADMAP §3)."""
    refined = delta_xyzwlhr_decode(outputs['proposals'],
                                   outputs['rcnn_reg'].float())
    score = torch.sigmoid(outputs['rcnn_cls'].float())
    score = torch.where(outputs['prop_mask'], score, torch.zeros_like(score))
    k = min(cfg.max_num, score.shape[1])
    outs = []
    for bx, sc, lb in zip(refined, score, outputs['prop_labels']):
        valid = sc > cfg.score_thr
        neg = torch.full_like(sc, -torch.inf)
        keep = nms_bev(bx[:, [0, 1, 3, 4, 6]], torch.where(valid, sc, neg),
                       nms_thr)
        out_sc, oi = highest_k(torch.where(keep & valid, sc, neg), k)
        m = F.pad(torch.isfinite(out_sc), (0, cfg.max_num - k))
        oi = F.pad(oi, (0, cfg.max_num - k))
        out_sc = F.pad(out_sc, (0, cfg.max_num - k))
        outs.append(dict(
            boxes3d=torch.where(m[:, None], bx[oi], torch.zeros_like(bx[oi])),
            scores=torch.where(m, out_sc, torch.zeros_like(out_sc)),
            labels=torch.where(m, lb[oi], torch.full_like(lb[oi], -1)),
            mask=m))
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def point_rcnn_predict(outputs, cfg: PointRCNNConfig):
    with record_function('point_rcnn.predict'):
        return refine_predict(outputs, cfg, cfg.rcnn_nms_thr)
