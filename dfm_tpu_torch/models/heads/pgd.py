"""PGD (Probabilistic and Geometric Depth) monocular head.

Port of `dfm_tpu/models/heads/pgd.py` (the reference's `PGDHead` on top of
FCOS3D): the FCOS3D head under `fcos3d`, and per level

* a depth classifier over `num_depth_cls` uniform bins (GroupNorm
  ConvNorms `depth_cls_prev{i}`, 1x1 `conv_depth_cls`) whose softmax
  expectation, gated by sigmoid(`fuse_lambda`), replaces the decoded
  depth: sig * direct + (1 - sig) * prob;
* log-variance weights (`conv_weight{i}`) for the uncertainty-weighted
  depth loss;
* the keypoint branch (tanh(scale * 1x1 conv), 8 projected corners) and
  the 2D box branch (relu(scale * 1x1 conv), distances to the sides in
  strides), both in float32 whatever the compute dtype.

`pgd_loss` adds to FCOS3D's terms the uncertain depth, the 2D box, the
keypoint and the projected-box consistency (GIoU) terms. Points that are
not positives get finite dummy inputs ((~pos) * 0.1 boxes, 0.5 targets)
before the projection and every term is masked, so no NaN reaches a
gradient. The normaliser is the positives of the global batch.
"""

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core import losses as L
from ...core.boxes import corners_cam
from ...core.iou import _at_least
from ...core.transforms import limit_period, points_cam2img, points_img2cam
from ..layers import Conv, ConvNorm
from .fcos_mono3d import (FCOS3DConfig, FCOSMono3DHead, _last, assign,
                          fcos3d_loss, flat_outputs, num_positives, pad44)

__all__ = ['PGDConfig', 'PGDHead', 'decode_prob_depth',
           'uncertain_smooth_l1', 'pgd_loss']


@dataclasses.dataclass(frozen=True)
class PGDConfig(FCOS3DConfig):
    use_depth_classifier: bool = True
    depth_range: Tuple[float, float] = (0.0, 70.0)
    depth_unit: float = 10.0
    depth_branch: Tuple[int, ...] = (64,)
    weight_dim: int = 1                 # log-variance channels
    uncertainty_alpha: float = 1.0
    pred_keypoints: bool = True
    pred_bbox2d: bool = True
    kpts_loss_weight: float = 1.0
    bbox2d_loss_weight: float = 1.0
    consistency_loss_weight: float = 1.0

    @property
    def num_depth_cls(self):
        return int((self.depth_range[1] - self.depth_range[0]) /
                   self.depth_unit) + 1


def decode_prob_depth(depth_cls_preds, cfg):
    """Softmax expectation over the uniform depth bins, float32."""
    mult = cfg.depth_unit * torch.arange(
        cfg.num_depth_cls, dtype=torch.float32, device=depth_cls_preds.device)
    prob = torch.softmax(depth_cls_preds.float(), dim=-1)
    return (prob * mult).sum(-1)


class PGDHead(nn.Module):
    """`fcos3d` (FCOSMono3DHead) + the PGD branches. Keys: fcos3d.*,
    depth_cls_prev{i} (.conv, .gn), conv_depth_cls, conv_weight{i},
    fuse_lambda, conv_kpts / scale_kpts, conv_bbox2d / scale_bbox2d."""

    def __init__(self, cfg=None):
        super().__init__()
        cfg = cfg or PGDConfig()
        self.cfg = cfg
        self.fcos3d = FCOSMono3DHead(cfg)
        if not cfg.use_depth_classifier:
            return
        cin = cfg.in_channels
        for i, ch in enumerate(cfg.depth_branch):
            setattr(self, f'depth_cls_prev{i}', ConvNorm(cin, ch, 3,
                                                         norm='gn'))
            cin = ch
        self.conv_depth_cls = Conv(cin, cfg.num_depth_cls, 1, bias=True)
        for i in range(cfg.weight_dim):
            setattr(self, f'conv_weight{i}', Conv(cfg.in_channels, 1, 1,
                                                  bias=True))
        self.fuse_lambda = nn.Parameter(torch.empty(()))
        n_lvl = len(cfg.strides)
        if cfg.pred_keypoints:
            self.conv_kpts = Conv(cfg.in_channels, 16, 1, bias=True)
            self.scale_kpts = nn.Parameter(torch.empty(n_lvl))
        if cfg.pred_bbox2d:
            self.conv_bbox2d = Conv(cfg.in_channels, 4, 1, bias=True)
            self.scale_bbox2d = nn.Parameter(torch.empty(n_lvl))

    def forward(self, feats):
        """FCOS3D's per-level dicts + 'depth_cls_pred', 'weight' (+
        'kpts_pred', 'bbox2d_pred'), the depth channel of 'bbox_pred'
        the lambda-fused estimate."""
        cfg = self.cfg
        outs = self.fcos3d(feats)
        if not cfg.use_depth_classifier:
            return outs
        sig = torch.sigmoid(self.fuse_lambda)
        for lvl, (x, o) in enumerate(zip(feats, outs)):
            f = x
            for i in range(len(cfg.depth_branch)):
                f = getattr(self, f'depth_cls_prev{i}')(f)
            depth_cls = _last(self.conv_depth_cls(f))
            o['depth_cls_pred'] = depth_cls
            if cfg.weight_dim:        # JAX's concatenate of none raises
                o['weight'] = torch.cat(
                    [_last(getattr(self, f'conv_weight{i}')(x))
                     for i in range(cfg.weight_dim)], -1)
            bbox = o['bbox_pred']
            fused = sig * bbox[..., 2] + (1 - sig) * decode_prob_depth(
                depth_cls, cfg)
            o['bbox_pred'] = torch.cat([bbox[..., :2], fused[..., None],
                                        bbox[..., 3:]], -1)
            if cfg.pred_keypoints:
                o['kpts_pred'] = torch.tanh(_last(self.conv_kpts(x)).float()
                                            * self.scale_kpts[lvl])
            if cfg.pred_bbox2d:
                o['bbox2d_pred'] = F.relu(_last(self.conv_bbox2d(x)).float()
                                          * self.scale_bbox2d[lvl])
        return outs


def uncertain_smooth_l1(pred, target, log_var, weights, alpha=1.0,
                        beta=1.0 / 9.0, avg_factor=None):
    """exp(-s) * smooth_l1 + alpha * s (UncertainSmoothL1Loss)."""
    diff = (pred - target).abs()
    sl1 = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    total = ((torch.exp(-log_var) * sl1 + alpha * log_var) * weights).sum()
    return total if avg_factor is None else total / avg_factor


def _projected_corners(bp, dir_pred, t3, points, strides_pp, c2i, cfg):
    """(B, P, 8, 2) image corners of the predicted and the target boxes,
    each point's centre back-projected at the target depth."""
    s = strides_pp[:, None]
    c2d_pred = points - bp[..., :2] * s                       # (B, P, 2)
    c2d_tgt = points - t3[..., :2] * s
    depth_t = t3[..., 2:3]
    ctr3d_t = points_img2cam(torch.cat([c2d_tgt, depth_t], -1), c2i)
    # depth fixed to the target when re-projecting predictions
    ctr3d_p = points_img2cam(torch.cat([c2d_pred, depth_t], -1), c2i)
    fx, cx = c2i[:, None, 0, 0], c2i[:, None, 0, 2]
    ray_p = torch.atan2(c2d_pred[..., 0] - cx, fx)
    ray_t = torch.atan2(c2d_tgt[..., 0] - cx, fx)
    dir_bin = torch.argmax(dir_pred, -1)
    yaw_loc = limit_period(bp[..., 6] - cfg.dir_offset, 0, math.pi) + \
        cfg.dir_offset + math.pi * dir_bin.float()
    yaw_p = yaw_loc + ray_p
    yaw_t = t3[..., 6] + ray_t
    dims_p = _at_least(bp[..., 3:6], 1e-2)
    dims_t = _at_least(t3[..., 3:6], 1e-2)
    # corners_cam takes the bottom centre: y shifted by h / 2
    box_p = torch.cat([ctr3d_p[..., :1], ctr3d_p[..., 1:2] +
                       dims_p[..., 1:2] / 2, ctr3d_p[..., 2:3], dims_p,
                       yaw_p[..., None]], -1)
    box_t = torch.cat([ctr3d_t[..., :1], ctr3d_t[..., 1:2] +
                       dims_t[..., 1:2] / 2, ctr3d_t[..., 2:3], dims_t,
                       yaw_t[..., None]], -1)
    proj = c2i[:, None]                                       # (B, 1, 4, 4)
    return (points_cam2img(corners_cam(box_p), proj),
            points_cam2img(corners_cam(box_t), proj))


def pgd_loss(level_outs, points_np, cfg, batch, cam2img=None):
    """FCOS3D's terms + loss_depth_uncertain, loss_bbox2d and, with
    `cam2img` (B, 3|4, 4), loss_kpts and loss_consistency (reference
    pgd_head.py:526-751). Raises ValueError for `pred_keypoints` or
    `pred_bbox2d` without the depth classifier, whose head makes no
    keypoint or 2D box outputs (JAX's pgd_loss raises KeyError)."""
    if not cfg.use_depth_classifier and (cfg.pred_keypoints or
                                         cfg.pred_bbox2d):
        raise ValueError('PGD without the depth classifier makes no '
                         'keypoint or 2D box outputs: set pred_keypoints '
                         'and pred_bbox2d to False')
    kpts, bbox2d = cfg.pred_keypoints, cfg.pred_bbox2d
    targets = assign(points_np, cfg, batch)
    losses = fcos3d_loss(level_outs, points_np, cfg, batch, targets)
    points, strides_pp, (_, tgt3d, ctr_tgt, pos, argmin) = targets
    w = pos.float()
    keep = pos[..., None]
    num_pos = num_positives(pos)

    if cfg.use_depth_classifier and cfg.weight_dim > 0:
        zero = torch.zeros_like(w)
        losses['loss_depth_uncertain'] = uncertain_smooth_l1(
            torch.where(pos, flat_outputs(level_outs, 'bbox_pred',
                                          cfg.code_size)[..., 2], zero),
            torch.where(pos, tgt3d[..., 2], zero),
            torch.where(pos, flat_outputs(level_outs, 'weight',
                                          cfg.weight_dim)[..., 0], zero),
            w, alpha=cfg.uncertainty_alpha, avg_factor=num_pos)

    if bbox2d:
        bbox2d_pred = flat_outputs(level_outs, 'bbox2d_pred', 4)
        g = torch.gather(batch['gt_bboxes2d'].float(), 1,
                         argmin[..., None].expand(-1, -1, 4))  # (B, P, 4)
        xs, ys = points[:, 0], points[:, 1]
        b2d_tgt = torch.stack([xs - g[..., 0], ys - g[..., 1],
                               g[..., 2] - xs, g[..., 3] - ys], -1) / \
            strides_pp[:, None]
        zero = torch.zeros_like(b2d_tgt)
        losses['loss_bbox2d'] = cfg.bbox2d_loss_weight * L.smooth_l1_loss(
            torch.where(keep, bbox2d_pred, zero),
            torch.where(keep, b2d_tgt, zero),
            w[..., None] * ctr_tgt[..., None], avg_factor=num_pos)

    if cam2img is not None and (kpts or bbox2d):
        bbox_pred = flat_outputs(level_outs, 'bbox_pred', cfg.code_size)[
            ..., :7]
        dir_pred = flat_outputs(level_outs, 'dir_pred', 2)
        max_rr = strides_pp * cfg.regress_ranges[0][1] / cfg.strides[0]
        dummy = (~keep).float() * 0.1                     # finite dummies
        cp, ct = _projected_corners(
            torch.where(keep, bbox_pred, torch.zeros_like(bbox_pred)) + dummy,
            dir_pred, torch.where(keep, tgt3d, torch.full_like(tgt3d, 0.5)),
            points, strides_pp, pad44(cam2img).to(bbox_pred.device), cfg)
        if kpts:
            kpts_pred = flat_outputs(level_outs, 'kpts_pred', 16)
            kpts_tgt = ((ct - points[None, :, None, :]) /
                        max_rr[None, :, None, None]).reshape(
                            ct.shape[0], ct.shape[1], 16).clamp(-10.0, 10.0)
            zero = torch.zeros_like(kpts_tgt)
            losses['loss_kpts'] = cfg.kpts_loss_weight * L.smooth_l1_loss(
                torch.where(keep, kpts_pred, zero),
                torch.where(keep, kpts_tgt, zero),
                w[..., None] * ctr_tgt[..., None], avg_factor=num_pos)
        if bbox2d:
            # GIoU of the projected box's extent and the direct 2D box
            proj_box = torch.cat([cp.amin(2), cp.amax(2)], -1)
            s = strides_pp[None, :, None]
            direct = torch.cat([points[None] - bbox2d_pred[..., :2] * s,
                                points[None] + bbox2d_pred[..., 2:] * s], -1)
            zero = torch.zeros_like(proj_box)
            losses['loss_consistency'] = cfg.consistency_loss_weight * \
                L.giou_loss_2d(torch.where(keep, proj_box, zero),
                               torch.where(keep, direct, zero),
                               w * ctr_tgt, avg_factor=num_pos)
    return losses
