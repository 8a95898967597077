"""VoteNet: the indoor point-based detector (ScanNet, SUN RGB-D).

Port of `dfm_tpu/models/detectors/votenet.py:27-185` (reference mmdet3d
votenet.py + vote_head.py + vote_module.py), the JAX package's static
shapes:

* `backbone`: `PointNet2SASSG` (four SA levels, 256 seeds of 256
  features);
* `vote0`, `vote1` (`Linear` + ReLU) and `vote_out`: per seed an xyz
  offset and a feature residual -> the votes;
* `num_proposals` vote centres by FPS, each grouping its `vote_k` nearest
  votes within `vote_radius` (`ball_group`), `prop0`, `prop1` (`Linear` +
  ReLU) and a max over the group;
* `head_out`: per proposal the objectness (2), the centre residual (3),
  per class the size residual (3), the heading bins and residuals and the
  class logits, as one 'raw' vector (`_split_raw`).

`votenet_loss`: JAX's simplified loss family (objectness with positives
within 0.3 m of a gt centre and negatives beyond 0.6 m, the centre
distance, the class, the size residual against the class's mean size,
the heading bin and residual at the positives, and the vote distance of
the seeds within 1 m of a gt centre). `votenet_predict`: boxes (centre,
size, yaw) with the objectness as score, zeroed at or below `score_thr`,
and the argmax class; keys 'boxes_3d', 'scores_3d', 'labels_3d'.
"""

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..backbones.pointnet2 import (PointNet2SASSG, ball_group,
                                   farthest_point_sample, gather_points)
from ..layers import Linear

__all__ = ['VoteNetConfig', 'VoteNet', 'votenet_loss', 'votenet_predict']


@dataclasses.dataclass(frozen=True)
class VoteNetConfig:
    """The fields and defaults of the JAX `VoteNetConfig`."""
    num_classes: int = 10
    num_heading_bins: int = 12
    num_proposals: int = 128
    vote_radius: float = 0.3
    vote_k: int = 16
    mean_sizes: Tuple[Tuple[float, float, float], ...] = tuple(
        (0.8, 0.8, 0.9) for _ in range(10))
    max_gt: int = 32
    score_thr: float = 0.05


class VoteNet(nn.Module):
    """`point_channels`: 3 + the points' features (4: x, y, z and the
    height above the floor that the indoor datasets append)."""

    def __init__(self, cfg=None, dtype=torch.float32, point_channels=4):
        super().__init__()
        cfg = cfg or VoteNetConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = PointNet2SASSG(point_channels, dtype=dtype)
        c = self.backbone.out_channels
        self.vote0 = Linear(c, 256)
        self.vote1 = Linear(256, 256)
        self.vote_out = Linear(256, 3 + c)
        self.prop0 = Linear(3 + c, 128)
        self.prop1 = Linear(128, 128)
        self.head_out = Linear(128, 2 + 3 + cfg.num_classes * 3 +
                               cfg.num_heading_bins * 2 + cfg.num_classes)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `votenet_loss` on gt's 'gt_boxes' (B, G,
        7), 'gt_labels', 'gt_mask' -> (total, dict of terms); the mask,
        `generator` and `depth_pix_idx` (TrainStep's) are not read."""
        return votenet_loss(self(points), gt, self.cfg)

    def votes(self, seed_xyz, seed_f):
        """Seeds -> (vote xyz, vote features)."""
        x = F.relu(self.vote1(F.relu(self.vote0(seed_f))))
        v = self.vote_out(x)
        return seed_xyz + v[..., :3], seed_f + v[..., 3:]

    def proposals(self, vote_xyz, vote_f):
        """FPS centres of the votes and their grouped features -> (centres
        (B, P, 3), raw (B, P, R) float32)."""
        cfg = self.cfg
        cidx = farthest_point_sample(vote_xyz, cfg.num_proposals)
        centers = gather_points(vote_xyz, cidx)
        g = ball_group(vote_xyz, vote_f, centers, cfg.vote_radius, cfg.vote_k)
        agg = F.relu(self.prop1(F.relu(self.prop0(g)))).amax(2)
        return centers, self.head_out(agg).float()

    def forward(self, points, point_mask=None):
        """points (B, N, 3+C) (`point_mask` is not read: the indoor batch
        has none) -> dict 'seed_xyz', 'vote_xyz', 'centers' (B, P, 3) and
        'raw' (B, P, R)."""
        with record_function('votenet.backbone'):
            seed_xyz, seed_f = self.backbone(points.to(self.dtype))
        with record_function('votenet.vote'):
            vote_xyz, vote_f = self.votes(seed_xyz, seed_f)
        with record_function('votenet.proposals'):
            centers, raw = self.proposals(vote_xyz, vote_f)
        return dict(seed_xyz=seed_xyz, vote_xyz=vote_xyz, centers=centers,
                    raw=raw)


def _split_raw(raw, cfg):
    """raw (..., R) -> objectness (..., 2), centre residual (..., 3), size
    residual (..., C, 3), heading bins, heading residuals, class logits."""
    c, hb = cfg.num_classes, cfg.num_heading_bins
    sizes = (2, 3, 3 * c, hb, hb, c)
    obj, center_res, size_res, head_cls, head_res, sem = torch.split(
        raw, sizes, -1)
    return (obj, center_res, size_res.reshape(raw.shape[:-1] + (c, 3)),
            head_cls, head_res, sem)


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _size_res(size_res, labels):
    """The (B, P, 3) size residual of each proposal's class."""
    idx = labels[..., None, None].expand(labels.shape + (1, 3))
    return torch.gather(size_res, 2, idx)[:, :, 0]


def _nearest(xyz, gt_c, gt_mask):
    """Squared distance of each point to its nearest valid gt centre and
    that centre's index."""
    d2 = ((xyz[:, :, None] - gt_c[:, None]) ** 2).sum(-1)
    d2 = torch.where(gt_mask[:, None, :], d2, torch.full_like(d2,
                                                              torch.inf))
    return d2.min(-1).values, torch.argmin(d2, -1)


def votenet_loss(outputs, gt, cfg: VoteNetConfig):
    """JAX's `votenet_loss` on gt 'gt_boxes' (B, G, 7), 'gt_labels',
    'gt_mask' -> (total, dict of terms)."""
    obj, center_res, size_res, head_cls, head_res, sem = _split_raw(
        outputs['raw'], cfg)
    centers = outputs['centers'] + center_res
    gt_boxes = gt['gt_boxes'].to(centers.dtype)
    gt_c, gt_mask = gt_boxes[..., :3], gt['gt_mask']
    near, gi = _nearest(centers, gt_c, gt_mask)
    has_gt = gt_mask.any(-1, keepdim=True)
    pos = (near < 0.3 ** 2) & has_gt
    neg = (near > 0.6 ** 2) | ~has_gt
    w_pos = pos.to(centers.dtype)
    npos = torch.clamp(w_pos.sum(), min=1.0)

    logp = F.log_softmax(obj, -1)
    loss_obj = -(w_pos * logp[..., 1] + neg.to(centers.dtype) *
                 logp[..., 0]).sum() / torch.clamp((pos | neg).sum(), min=1)
    gt_sel = torch.gather(gt_boxes, 1, gi[..., None].expand(gi.shape + (7,)))
    loss_center = torch.where(pos, torch.sqrt(near + 1e-9),
                              torch.zeros_like(near)).sum() / npos
    lbl = torch.gather(gt['gt_labels'].long(), 1, gi)
    loss_sem = -(_take(F.log_softmax(sem, -1), lbl) * w_pos).sum() / npos
    mean = torch.as_tensor(cfg.mean_sizes, dtype=centers.dtype,
                           device=centers.device)[lbl]
    loss_size = ((_size_res(size_res, lbl) - (gt_sel[..., 3:6] - mean) /
                  mean).abs().sum(-1) * w_pos).sum() / npos

    yaw = gt_sel[..., 6]
    bin_w = 2 * math.pi / cfg.num_heading_bins
    yaw_m = torch.remainder(yaw, 2 * math.pi)
    bin_id = torch.floor(yaw_m / bin_w).long()
    loss_hcls = -(_take(F.log_softmax(head_cls, -1), bin_id) *
                  w_pos).sum() / npos
    res_t = yaw_m - (bin_id.to(yaw_m.dtype) + 0.5) * bin_w
    loss_hres = ((_take(head_res, bin_id) - res_t / bin_w).abs() *
                 w_pos).sum() / npos

    snear, _ = _nearest(outputs['vote_xyz'], gt_c, gt_mask)
    sval = (snear < 1.0) & has_gt
    loss_vote = torch.where(sval, torch.sqrt(snear + 1e-9),
                            torch.zeros_like(snear)).sum() / torch.clamp(
                                sval.sum(), min=1.0)
    losses = dict(loss_objectness=loss_obj, loss_center=loss_center,
                  loss_sem=loss_sem, loss_size=loss_size,
                  loss_heading_cls=loss_hcls, loss_heading_res=loss_hres,
                  loss_vote=loss_vote)
    return sum(losses.values()), losses


def votenet_predict(outputs, cfg: VoteNetConfig):
    """Proposals -> 'boxes_3d' (B, P, 7) (centre, size, yaw in [-pi,
    pi)), 'scores_3d' (objectness, 0 at or below `score_thr`),
    'labels_3d' (the argmax class)."""
    obj, center_res, size_res, head_cls, head_res, sem = _split_raw(
        outputs['raw'], cfg)
    centers = outputs['centers'] + center_res
    scores = F.softmax(obj, -1)[..., 1]
    labels = torch.argmax(sem, -1)
    mean = torch.as_tensor(cfg.mean_sizes, dtype=centers.dtype,
                           device=centers.device)[labels]
    dims = torch.clamp(mean * (1 + _size_res(size_res, labels)), min=1e-2)
    bin_w = 2 * math.pi / cfg.num_heading_bins
    bid = torch.argmax(head_cls, -1)
    yaw = (bid.to(centers.dtype) + 0.5) * bin_w + _take(head_res, bid) * bin_w
    yaw = torch.remainder(yaw + math.pi, 2 * math.pi) - math.pi
    boxes = torch.cat([centers, dims, yaw[..., None]], -1)
    scores = torch.where(scores > cfg.score_thr, scores,
                         torch.zeros_like(scores))
    return dict(boxes_3d=boxes, scores_3d=scores, labels_3d=labels)
