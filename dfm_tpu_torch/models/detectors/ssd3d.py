"""3DSSD: the single-stage point-based LiDAR detector.

Port of `dfm_tpu/models/detectors/ssd3d.py:41-317` (reference mmdet3d
ssd3dnet.py + ssd_3d_head.py with the anchor-free box coder), the JAX
package's static shapes:

* `backbone`: `PointNet2SAMSG` with 3DSSD's fusion sampling (D-FPS, FS,
  F-FPS + D-FPS); its last stage's 512 points and 256 features are the
  seeds, the first `num_candidates` of them (the F-FPS half) the
  candidates' seeds;
* the vote module (`vote_mlp` + `vote_bn` + ReLU, `vote_out`): an offset
  per candidate seed, clipped to `vote_xyz_range` per axis, gives the
  candidates;
* `vote_aggregation`: an `SAModuleMSG` without dilation that groups the
  whole seed set around the candidates (`target_xyz`);
* `shared{i}` + `shared_bn{i}` + ReLU, then `cls0` / `cls_out` (the
  per-class centerness logits) and `reg0` / `reg_out` (centre offset,
  half sizes, direction bins and their normalised residuals).

`ssd3d_loss`: per candidate the gt box it lies in (the nearest centre
among several; positives also within `pos_distance_thr` of the box's top
centre), the sigmoid cross entropy against the centerness (in the box's
frame, detached), smooth L1 of the centre, half sizes and direction
residual, the direction bins' cross entropy, the corner loss (boxes
decoded with the target bin) and the vote loss on the candidate seeds
(boxes enlarged by `expand_dims_length`). `ssd3d_predict`: the bin
decode and `box3d_multiclass_nms` per sample. Channels-last, as JAX.
"""

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import corners_lidar, points_in_rotated_boxes_bev
from ...core.nms import box3d_multiclass_nms
from ..backbones.pointnet2_msg import PointNet2SAMSG, SAModuleMSG
from ..layers import BatchNormLast, Linear

__all__ = ['SSD3DConfig', 'SSD3DNet', 'ssd3d_loss', 'ssd3d_predict',
           'points_in_boxes_3d']


@dataclasses.dataclass(frozen=True)
class SSD3DConfig:
    """The fields and defaults of the JAX `SSD3DConfig`."""
    num_classes: int = 1
    num_dir_bins: int = 12
    num_candidates: int = 256
    vote_xyz_range: Tuple[float, float, float] = (3.0, 3.0, 2.0)
    sa_num_points: Tuple[Tuple[int, ...], ...] = ((4096,), (512,),
                                                  (256, 256))
    sa_radii: Tuple[Tuple[float, ...], ...] = (
        (0.2, 0.4, 0.8), (0.4, 0.8, 1.6), (1.6, 3.2, 4.8))
    sa_num_samples: Tuple[Tuple[int, ...], ...] = (
        (32, 32, 64), (32, 32, 64), (32, 32, 32))
    sa_channels: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
        ((16, 16, 32), (16, 16, 32), (32, 32, 64)),
        ((64, 64, 128), (64, 64, 128), (64, 96, 128)),
        ((128, 128, 256), (128, 192, 256), (128, 256, 256)))
    sa_aggregation: Tuple[int, ...] = (64, 128, 256)
    sa_fps_mods: Tuple[Tuple[str, ...], ...] = (
        ('D-FPS',), ('FS',), ('F-FPS', 'D-FPS'))
    sa_fps_ranges: Tuple[Tuple[int, ...], ...] = ((-1,), (-1,),
                                                  (512, -1))
    agg_radii: Tuple[float, ...] = (4.8, 6.4)
    agg_ks: Tuple[int, ...] = (16, 32)
    agg_mlps: Tuple[Tuple[int, ...], ...] = ((256, 256, 256, 512),
                                             (256, 256, 512, 1024))
    shared_channels: Tuple[int, ...] = (512, 128)
    pos_distance_thr: float = 10.0
    expand_dims_length: float = 0.05
    corner_loss_weight: float = 1.0
    point_cloud_range: Tuple[float, ...] = (0, -40, -5, 70, 40, 3)
    max_gt: int = 32
    nms_pre: int = 256
    score_thr: float = 0.05
    nms_thr: float = 0.1
    max_num: int = 64


class SSD3DNet(nn.Module):
    """`point_channels`: 3 + the points' features (4: x, y, z and
    intensity, or the synthetic batches' zero column)."""

    def __init__(self, cfg=None, dtype=torch.float32, point_channels=4):
        super().__init__()
        cfg = cfg or SSD3DConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = PointNet2SAMSG(
            point_channels, cfg.sa_num_points, cfg.sa_radii,
            cfg.sa_num_samples, cfg.sa_channels, cfg.sa_aggregation,
            cfg.sa_fps_mods, cfg.sa_fps_ranges, dtype=dtype)
        seed_c = self.backbone.out_channels[-1]
        self.vote_mlp = Linear(seed_c, 128)
        self.vote_bn = BatchNormLast(128)
        self.vote_out = Linear(128, 3)
        self.vote_aggregation = SAModuleMSG(
            (cfg.num_candidates,), cfg.agg_radii, cfg.agg_ks, cfg.agg_mlps,
            3 + seed_c, dilated=False, dtype=dtype)
        c = self.vote_aggregation.out_channels
        for i, ch in enumerate(cfg.shared_channels):
            setattr(self, f'shared{i}', Linear(c, ch))
            setattr(self, f'shared_bn{i}', BatchNormLast(ch))
            c = ch
        nd = cfg.num_dir_bins
        self.cls0 = Linear(c, 128)
        self.cls_out = Linear(128, cfg.num_classes)
        self.reg0 = Linear(c, 128)
        self.reg_out = Linear(128, 6 + 2 * nd)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `ssd3d_loss` on gt's 'gt_boxes' (B, G, 7),
        'gt_labels', 'gt_mask' -> (total, dict of terms); the mask,
        `generator` and `depth_pix_idx` (TrainStep's) are not read."""
        return ssd3d_loss(self(points), gt, self.cfg)

    def seeds(self, points):
        """points (B, N, 3+C) -> the last stage's (xyz (B, 512, 3),
        features (B, 512, 256))."""
        feat = self.backbone(points)
        return feat['sa_xyz'][-1], feat['sa_features'][-1]

    def candidates(self, seed_xyz, seed_f):
        """The F-FPS half's clipped vote offsets -> (candidates, offsets,
        their seeds), float32."""
        nc = self.cfg.num_candidates
        cand_xyz = seed_xyz[:, :nc]
        v = F.relu(self.vote_bn(self.vote_mlp(seed_f[:, :nc].to(
            self.dtype))))
        offset = self.vote_out(v).float()
        limit = torch.tensor(self.cfg.vote_xyz_range, dtype=offset.dtype,
                             device=offset.device)
        offset = torch.minimum(torch.maximum(offset, -limit), limit)
        return cand_xyz + offset, offset, cand_xyz

    def heads(self, agg_f):
        """The aggregated features -> (class logits, box codes), float32."""
        x = agg_f.to(self.dtype)
        for i in range(len(self.cfg.shared_channels)):
            x = F.relu(getattr(self, f'shared_bn{i}')(
                getattr(self, f'shared{i}')(x)))
        cls = self.cls_out(F.relu(self.cls0(x))).float()
        reg = self.reg_out(F.relu(self.reg0(x))).float()
        return cls, reg

    def forward(self, points, point_mask=None):
        """points (B, N, 3+C) (`point_mask` is not read: the point-based
        batch has none) -> dict 'cls_score' (B, nc, C), 'center_offset',
        'size' (half sizes), 'dir_class', 'dir_res_norm',
        'aggregated_points' (the candidates), 'vote_offset',
        'seed_points' (the candidates' seeds)."""
        with record_function('ssd3d.backbone'):
            seed_xyz, seed_f = self.seeds(points)
        with record_function('ssd3d.vote'):
            cand, offset, cand_seed = self.candidates(seed_xyz, seed_f)
        with record_function('ssd3d.aggregation'):
            _, agg_f, _ = self.vote_aggregation(seed_xyz, seed_f,
                                                target_xyz=cand)
        with record_function('ssd3d.heads'):
            cls, reg = self.heads(agg_f)
        nd = self.cfg.num_dir_bins
        return dict(cls_score=cls, center_offset=reg[..., :3],
                    size=reg[..., 3:6], dir_class=reg[..., 6:6 + nd],
                    dir_res_norm=reg[..., 6 + nd:6 + 2 * nd],
                    aggregated_points=cand, vote_offset=offset,
                    seed_points=cand_seed)


def points_in_boxes_3d(pts, boxes):
    """(P, 3) points, (G, 7) bottom-centre boxes -> (P, G) bool: the BEV
    rotated test and the z interval, edges included."""
    bev = points_in_rotated_boxes_bev(pts[:, :2], boxes)
    z0 = boxes[None, :, 2]
    z1 = z0 + boxes[None, :, 5]
    return bev & (pts[:, 2:3] >= z0) & (pts[:, 2:3] <= z1)


def _smooth_l1(x, beta=1.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _nearest_inside(pts, boxes, centres, gt_m):
    """Each point's box: among the boxes it lies in, the nearest centre
    (the first box where it lies in none) -> (inside any, index)."""
    pm = points_in_boxes_3d(pts, boxes) & gt_m[None, :]
    d2 = ((pts[:, None] - centres[None]) ** 2).sum(-1)
    inf = torch.full_like(d2, torch.inf)
    d2 = torch.where(pm, d2, inf)
    return pm.any(-1), torch.argmin(torch.where(gt_m[None, :], d2, inf), -1)


def _targets(agg_i, seed_i, gt_b, gt_l, gt_m, cfg):
    """JAX's per-sample `single` of `ssd3d_loss` (inputs detached)."""
    nd = cfg.num_dir_bins
    bin_w = 2 * math.pi / nd
    gt_center = torch.cat([gt_b[:, :2], gt_b[:, 2:3] + gt_b[:, 5:6] / 2],
                          -1)
    gt_half = gt_b[:, 3:6] / 2
    yaw = torch.remainder(gt_b[:, 6], 2 * math.pi)
    dir_cls_t = torch.remainder(torch.floor(yaw / bin_w).long(), nd)
    dir_res_t = (yaw - (dir_cls_t.to(yaw.dtype) + 0.5) * bin_w +
                 bin_w / 2) / bin_w
    dir_res_t = dir_res_t - 0.5

    inside, assign = _nearest_inside(agg_i, gt_b, gt_center, gt_m)
    ct, half = gt_center[assign], gt_half[assign]
    top = ct.clone()
    top[:, 2] = top[:, 2] + half[:, 2]
    dist_ok = torch.linalg.vector_norm(agg_i - top, dim=-1) < \
        cfg.pos_distance_thr
    any_gt = gt_m.any()
    pos = inside & dist_ok & any_gt
    neg = ~inside | ~any_gt

    rel = agg_i - ct
    ang = -gt_b[assign, 6]
    cos, sin = torch.cos(ang), torch.sin(ang)
    cx = rel[:, 0] * cos - rel[:, 1] * sin
    cy = rel[:, 0] * sin + rel[:, 1] * cos
    canon = torch.stack([cx, cy, rel[:, 2]], -1)
    d_lo = torch.clamp(half + canon, min=0)
    d_hi = torch.clamp(half - canon, min=0)
    ratio = torch.minimum(d_lo, d_hi) / torch.clamp(
        torch.maximum(d_lo, d_hi), min=1e-6)
    prod = torch.clamp(ratio.prod(-1), min=0)
    centerness = torch.clamp(prod ** (1.0 / 3.0), 0, 1)

    e = cfg.expand_dims_length
    big = gt_b.clone()
    big[:, 3:6] = big[:, 3:6] + 2 * e
    big[:, 2] = big[:, 2] - e
    v_inside, v_assign = _nearest_inside(seed_i, big, gt_center, gt_m)
    vote_t = gt_center[v_assign] - seed_i
    return (ct, half, dir_cls_t[assign], dir_res_t[assign], gt_l[assign],
            corners_lidar(gt_b)[assign], centerness, pos, neg, vote_t,
            v_inside)


def _decode_boxes(outputs, dir_cls, bin_w):
    """Bottom-centre boxes (..., 7) of the outputs with direction bins
    `dir_cls` (JAX's decode: yaw from the bin's centre and residual, full
    sizes at least 0.1)."""
    res = _take(outputs['dir_res_norm'], dir_cls) * bin_w
    yaw = (dir_cls.to(res.dtype) + 0.5) * bin_w + res - bin_w / 2
    dims = torch.clamp(outputs['size'] * 2, min=0.1)
    ctr = outputs['aggregated_points'] + outputs['center_offset']
    bottom = torch.cat([ctr[..., :2], ctr[..., 2:3] - dims[..., 2:3] / 2],
                       -1)
    return torch.cat([bottom, dims, yaw[..., None]], -1)


def ssd3d_loss(outputs, gt, cfg: SSD3DConfig):
    """JAX's `ssd3d_loss` on gt 'gt_boxes' (B, G, 7) (LiDAR frame, bottom
    centre), 'gt_labels', 'gt_mask' -> (total, dict of terms)."""
    agg = outputs['aggregated_points']
    bin_w = 2 * math.pi / cfg.num_dir_bins
    per = [_targets(a, s, b, lab, m, cfg) for a, s, b, lab, m in zip(
        agg.detach(), outputs['seed_points'].detach(),
        gt['gt_boxes'].to(agg.dtype), gt['gt_labels'], gt['gt_mask'])]
    (ct, half_t, dcls_t, dres_t, lbl_t, corner_t, ctr_t, pos, neg, vote_t,
     vote_m) = [torch.stack(x) for x in zip(*per)]

    npos = torch.clamp(pos.sum().to(agg.dtype), min=1.0)
    w_box = pos.to(agg.dtype) / npos
    w_ctr = (pos | neg).to(agg.dtype)
    w_ctr = w_ctr / torch.clamp(w_ctr.sum(), min=1e-6)

    logits = outputs['cls_score']
    # jax.nn.one_hot: a label outside [0, C) gives a row of zeros
    classes = torch.arange(cfg.num_classes, device=logits.device)
    onehot = (lbl_t[..., None] == classes).to(logits.dtype) * \
        ctr_t[..., None]
    ce = torch.clamp(logits, min=0) - logits * onehot + \
        torch.log1p(torch.exp(-logits.abs()))
    loss_centerness = (ce.sum(-1) * w_ctr).sum()

    loss_center = (_smooth_l1(outputs['center_offset'] - (ct - agg))
                   .sum(-1) * w_box).sum()
    loss_size = (_smooth_l1(outputs['size'] - half_t).sum(-1) *
                 w_box).sum()
    dlp = F.log_softmax(outputs['dir_class'], -1)
    loss_dir_cls = (-_take(dlp, dcls_t) * w_box).sum()
    loss_dir_res = (_smooth_l1(_take(outputs['dir_res_norm'], dcls_t) -
                               dres_t) * w_box).sum()
    boxes_p = _decode_boxes(outputs, dcls_t, bin_w)
    loss_corner = (_smooth_l1(corners_lidar(boxes_p) - corner_t)
                   .sum((-1, -2)) * w_box).sum() * cfg.corner_loss_weight

    w_vote = vote_m.to(agg.dtype)
    w_vote = w_vote / torch.clamp(w_vote.sum(), min=1e-6)
    loss_vote = (_smooth_l1(outputs['vote_offset'] - vote_t).sum(-1) *
                 w_vote).sum()
    losses = dict(loss_centerness=loss_centerness, loss_center=loss_center,
                  loss_size=loss_size, loss_dir_cls=loss_dir_cls,
                  loss_dir_res=loss_dir_res, loss_corner=loss_corner,
                  loss_vote=loss_vote)
    return sum(losses.values()), losses


def ssd3d_predict(outputs, cfg: SSD3DConfig):
    """The bin decode + rotated NMS per class -> 'boxes_3d' (B, max_num,
    7), 'scores_3d', 'labels_3d' (-1 where empty), 'mask'."""
    bin_w = 2 * math.pi / cfg.num_dir_bins
    scores = torch.sigmoid(outputs['cls_score'])
    boxes = _decode_boxes(outputs, torch.argmax(outputs['dir_class'], -1),
                          bin_w)
    with record_function('ssd3d.predict'):
        dets = [box3d_multiclass_nms(b, b[:, [0, 1, 3, 4, 6]], s,
                                     cfg.score_thr, cfg.nms_thr, cfg.max_num)
                for b, s in zip(boxes, scores)]
    return {new: torch.stack([d[old] for d in dets]) for new, old in (
        ('boxes_3d', 'boxes3d'), ('scores_3d', 'scores'),
        ('labels_3d', 'labels'), ('mask', 'mask'))}
