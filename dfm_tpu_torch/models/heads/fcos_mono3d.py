"""FCOS3D monocular head: the module, target assignment, loss and decode.

Port of `dfm_tpu/models/heads/fcos_mono3d.py` (the reference's
`FCOSMono3DHead` / `AnchorFreeMono3DHead` and `FCOS3DBBoxCoder`):

* `FCOSMono3DHead`: cls and reg towers (GroupNorm ConvNorms) shared
  across the FPN levels, then per level the class scores, the 7 (+ 2
  velocity) box channels (offset 2, depth 1, size 3, rot 1; the learnable
  per-level `scales` (levels, 3) on offset / depth / size, depth and size
  decoded with exp, in float32 whatever the compute dtype), direction
  bins, centerness and, with `pred_attrs`, attributes. Outputs channels
  last, (B, H, W, C), as the JAX package gives them.
* `fcos3d_targets`: center sampling around the projected 3D centres with
  per-level regress ranges; the gt of least distance (the first on a tie,
  as `argmin`); centerness exp(-alpha * ||offset|| / 1.414).
* `fcos3d_loss`: focal, smooth-L1 (offset, depth, size, sin-difference
  yaw), direction and centerness terms (+ velocity and attributes for the
  nuScenes options), normalised by the positives of the global batch (a
  count over the torchrun group, `parallel/dist.py`).
* `fcos3d_get_bboxes`: top `nms_pre` by max score x centerness (a stable
  sort: the lower index first on a tie, as `lax.top_k`), centres
  back-projected with the depth, the local yaw turned global
  (`limit_period(yaw - dir_offset, 0, pi) + dir_offset + pi * dir_bin`
  plus the ray angle), the box shifted to its bottom centre, rotated NMS
  in the pseudo-LiDAR BEV; padded camera-frame detections.

Everything is batched over the leading axis where the JAX package vmaps.
"""

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn as nn

from ...core import losses as L
from ...core.boxes import cam_to_pseudo_lidar_boxes
from ...core.nms import box3d_multiclass_nms
from ...core.targets import add_sin_difference, get_direction_target
from ...core.transforms import limit_period, points_img2cam
from ...parallel import dist as D
from ..layers import Conv, ConvNorm

__all__ = ['FCOS3DConfig', 'FCOSMono3DHead', 'level_points',
           'fcos3d_targets', 'fcos3d_loss', 'fcos3d_get_bboxes', 'pad44',
           'INF']

INF = 1e8


@dataclasses.dataclass(frozen=True)
class FCOS3DConfig:
    num_classes: int = 3
    in_channels: int = 256
    feat_channels: int = 256
    stacked_convs: int = 2
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1, 48), (48, 96), (96, 192), (192, 384), (384, INF))
    center_sample_radius: float = 1.5
    centerness_alpha: float = 2.5
    dir_offset: float = 0.7854
    diff_rad_by_sin: bool = True
    norm_on_bbox: bool = True
    max_gt: int = 32
    # nuScenes options: attribute branch on the cls tower, velocity
    # appended to the box code (9 channels)
    pred_attrs: bool = False
    num_attrs: int = 9
    attr_branch_channels: int = 64
    pred_velo: bool = False
    # test
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_thr: float = 0.25
    max_num: int = 100
    # losses (read by no term, as in the JAX package)
    loss_weights: Any = None

    @property
    def code_size(self):
        return 7 + (2 if self.pred_velo else 0)


def _last(x):
    """NCHW -> the (B, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


class FCOSMono3DHead(nn.Module):
    """The head over the FPN levels. Keys: cls_tower{i} / reg_tower{i}
    (.conv, .gn), conv_cls, conv_reg, conv_dir, conv_centerness,
    attr_tower0 / conv_attr with `pred_attrs`, scales."""

    def __init__(self, cfg=None):
        super().__init__()
        cfg = cfg or FCOS3DConfig()
        self.cfg = cfg
        fc = cfg.feat_channels
        for branch in ('cls', 'reg'):
            for i in range(cfg.stacked_convs):
                setattr(self, f'{branch}_tower{i}', ConvNorm(
                    cfg.in_channels if i == 0 else fc, fc, 3, norm='gn'))
        c_last = fc if cfg.stacked_convs else cfg.in_channels
        self.conv_cls = Conv(c_last, cfg.num_classes, 3, bias=True)
        self.conv_reg = Conv(c_last, cfg.code_size, 3, bias=True)
        self.conv_dir = Conv(c_last, 2, 3, bias=True)
        self.conv_centerness = Conv(c_last, 1, 3, bias=True)
        if cfg.pred_attrs:
            self.attr_tower0 = ConvNorm(c_last, cfg.attr_branch_channels, 3,
                                        norm='gn')
            self.conv_attr = Conv(cfg.attr_branch_channels, cfg.num_attrs,
                                  3, bias=True)
        self.scales = nn.Parameter(torch.empty(len(cfg.strides), 3))

    def forward(self, feats):
        """`feats`: the FPN levels, (B, C, H, W) each -> a list of dicts
        of channels-last outputs per level: cls_score, bbox_pred (float32,
        decoded), dir_pred, centerness (+ attr_pred)."""
        cfg = self.cfg
        outs = []
        for lvl, x in enumerate(feats):
            cls_feat = reg_feat = x
            for i in range(cfg.stacked_convs):
                cls_feat = getattr(self, f'cls_tower{i}')(cls_feat)
                reg_feat = getattr(self, f'reg_tower{i}')(reg_feat)
            bbox = _last(self.conv_reg(reg_feat)).float()
            s = self.scales[lvl]
            parts = [bbox[..., :2] * s[0], torch.exp(bbox[..., 2:3] * s[1]),
                     torch.exp(bbox[..., 3:6] * s[2]), bbox[..., 6:7]]
            if cfg.pred_velo:
                parts.append(bbox[..., 7:9])        # raw: no scale, no exp
            out = dict(cls_score=_last(self.conv_cls(cls_feat)),
                       bbox_pred=torch.cat(parts, -1),
                       dir_pred=_last(self.conv_dir(reg_feat)),
                       centerness=_last(self.conv_centerness(reg_feat)))
            if cfg.pred_attrs:
                out['attr_pred'] = _last(self.conv_attr(
                    self.attr_tower0(cls_feat)))
            outs.append(out)
        return outs


def level_points(featmap_size, stride):
    """(H*W, 2) float32 pixel coordinates (x, y) of a level's locations,
    stride // 2 offset (mmdet convention)."""
    h, w = featmap_size
    ys = np.arange(h, dtype=np.float32) * stride + stride // 2
    xs = np.arange(w, dtype=np.float32) * stride + stride // 2
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    return np.stack([xx, yy], -1).reshape(-1, 2)


def point_tables(points_np, cfg, device):
    """The concatenated level points (P, 2) and per point its stride and
    regress range (lo, hi), as float32 tensors on `device`."""
    def per_point(vals):
        return torch.as_tensor(np.concatenate([
            np.full(len(p), v, np.float32) for p, v in zip(points_np, vals)]),
            device=device)

    return (torch.as_tensor(np.concatenate(points_np, 0), device=device),
            per_point(cfg.strides),
            per_point([r[0] for r in cfg.regress_ranges]),
            per_point([r[1] for r in cfg.regress_ranges]))


def _take(x, idx):
    """x (B, G, ...) gathered at idx (B, P) -> (B, P, ...)."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, idx]


def fcos3d_targets(points, strides_pp, regress_lo, regress_hi, gt_bboxes2d,
                   centers2d, depths, gt_boxes_cam, gt_labels, gt_mask,
                   cfg):
    """Targets of a batch over the concatenated level points.

    Args:
        points (P, 2), strides_pp / regress_lo / regress_hi (P,);
        gt_bboxes2d (B, G, 4) xyxy, centers2d (B, G, 2), depths (B, G),
        gt_boxes_cam (B, G, 7) camera frame, gt_labels (B, G), gt_mask
        (B, G).

    Returns:
        labels (B, P) int64 (num_classes = background), bbox targets
        (B, P, 7) (offsets in strides with `norm_on_bbox`, depth, size,
        local yaw), centerness targets (B, P), pos (B, P), argmin (B, P)
        (the assigned gt; 0 where none).
    """
    xs = points[None, :, 0:1]                              # (1, P, 1)
    ys = points[None, :, 1:2]
    gt = gt_boxes_cam.float()
    # global -> local (allocentric) yaw
    local_yaw = -torch.atan2(gt[..., 0], gt[..., 2]) + gt[..., 6]  # (B, G)
    dx = xs - centers2d[:, None, :, 0]                     # (B, P, G)
    dy = ys - centers2d[:, None, :, 1]
    left = xs - gt_bboxes2d[:, None, :, 0]
    right = gt_bboxes2d[:, None, :, 2] - xs
    top = ys - gt_bboxes2d[:, None, :, 1]
    bottom = gt_bboxes2d[:, None, :, 3] - ys
    max_regress = torch.maximum(torch.maximum(left, right),
                                torch.maximum(top, bottom))
    radius = strides_pp[None, :, None] * cfg.center_sample_radius
    inside = (dx.abs() < radius) & (dy.abs() < radius) & \
        (max_regress >= regress_lo[None, :, None]) & \
        (max_regress <= regress_hi[None, :, None]) & \
        gt_mask.bool()[:, None, :]
    dists = torch.sqrt(dx * dx + dy * dy)
    dists = torch.where(inside, dists, torch.full_like(dists, INF))
    argmin = torch.argmin(dists, -1)         # the first minimum, as JAX's
    min_dist = torch.gather(dists, -1, argmin[..., None])[..., 0]
    pos = min_dist < INF
    labels = torch.where(pos, _take(gt_labels.long(), argmin),
                         torch.full_like(argmin, cfg.num_classes))
    off = torch.stack([torch.gather(dx, -1, argmin[..., None])[..., 0],
                       torch.gather(dy, -1, argmin[..., None])[..., 0]], -1)
    if cfg.norm_on_bbox:
        off = off / strides_pp[None, :, None]
    tgt = torch.cat([off, _take(depths.float(), argmin)[..., None],
                     _take(gt[..., 3:6], argmin),
                     _take(local_yaw, argmin)[..., None]], -1)
    rel = torch.sqrt((off * off).sum(-1)) / 1.414
    centerness = torch.exp(-cfg.centerness_alpha * rel)
    return labels, tgt, centerness, pos, argmin


def assign(points_np, cfg, batch):
    """(points, strides per point, the targets of `fcos3d_targets`) of a
    batch dict on the points of `points_np`."""
    dev = batch['gt_bboxes2d'].device
    points, strides_pp, lo, hi = point_tables(points_np, cfg, dev)
    tg = fcos3d_targets(points, strides_pp, lo, hi, batch['gt_bboxes2d'],
                        batch['centers2d'], batch['gt_depths'],
                        batch['gt_boxes_cam'], batch['gt_labels'],
                        batch['gt_mask'], cfg)
    return points, strides_pp, tg


def flat_outputs(level_outs, key, per):
    """The levels' `key` outputs as one float32 (B, P, per) tensor."""
    return torch.cat([o[key].float().reshape(o[key].shape[0], -1, per)
                      for o in level_outs], 1)


def num_positives(pos):
    """The positives of the global batch (summed over a torchrun group,
    JAX's `pmean` of the count), at least 1."""
    return D.global_sum(pos.sum().float()).clamp(min=1.0)


def fcos3d_loss(level_outs, points_np, cfg, batch, targets=None):
    """The FCOS3D loss terms (reference fcos_mono3d_head.py `loss`).

    Args:
        level_outs: the head's per-level dicts.
        points_np: per level the (P_l, 2) numpy points.
        batch: dict of tensors 'gt_bboxes2d' (B, G, 4), 'centers2d'
            (B, G, 2), 'gt_depths' (B, G), 'gt_boxes_cam' (B, G, 7),
            'gt_labels', 'gt_mask' (+ 'gt_velocities' / 'gt_attr_labels'
            for the nuScenes options).
        targets: `assign`'s result, computed here if None.

    Returns:
        dict of loss terms.
    """
    points, strides_pp, tg = targets or assign(points_np, cfg, batch)
    labels, tgt3d, ctr_tgt, pos, argmin = tg
    cls_score = flat_outputs(level_outs, 'cls_score', cfg.num_classes)
    bbox_full = flat_outputs(level_outs, 'bbox_pred', cfg.code_size)
    dir_pred = flat_outputs(level_outs, 'dir_pred', 2)
    centerness = flat_outputs(level_outs, 'centerness', 1)[..., 0]
    num_pos = num_positives(pos)

    loss_cls = L.sigmoid_focal_loss(cls_score, labels, avg_factor=num_pos)
    w = pos.float()
    pred, tgt = bbox_full[..., :7], tgt3d
    if cfg.diff_rad_by_sin:
        pred, tgt = add_sin_difference(pred, tgt)
    keep = pos[..., None]
    tgt = torch.where(keep, tgt, torch.zeros_like(tgt))
    pred = torch.where(keep, pred, torch.zeros_like(pred))
    losses = dict(
        loss_cls=loss_cls,
        loss_offset=L.smooth_l1_loss(pred[..., :2], tgt[..., :2],
                                     w[..., None], avg_factor=num_pos),
        loss_depth=L.smooth_l1_loss(pred[..., 2], tgt[..., 2], w,
                                    avg_factor=num_pos),
        loss_size=L.smooth_l1_loss(pred[..., 3:6], tgt[..., 3:6],
                                   w[..., None], avg_factor=num_pos),
        loss_rotsin=L.smooth_l1_loss(pred[..., 6], tgt[..., 6], w,
                                     avg_factor=num_pos))
    dir_tgt = get_direction_target(torch.zeros_like(tgt3d[..., 6]),
                                   tgt3d[..., 6], cfg.dir_offset)
    losses['loss_dir'] = L.softmax_cross_entropy(dir_pred, dir_tgt, w,
                                                 avg_factor=num_pos)
    losses['loss_centerness'] = L.binary_cross_entropy(
        centerness, ctr_tgt, w, avg_factor=num_pos)
    if cfg.pred_velo and 'gt_velocities' in batch:
        velo_tgt = _take(batch['gt_velocities'].float(), argmin)
        velo_pred = torch.where(keep, bbox_full[..., 7:9],
                                torch.zeros_like(velo_tgt))
        velo_tgt = torch.where(keep, velo_tgt, torch.zeros_like(velo_tgt))
        losses['loss_velo'] = L.smooth_l1_loss(
            velo_pred, velo_tgt, w[..., None], avg_factor=num_pos) * 0.05
    if cfg.pred_attrs and 'gt_attr_labels' in batch:
        attr_pred = flat_outputs(level_outs, 'attr_pred', cfg.num_attrs)
        attr_tgt = _take(batch['gt_attr_labels'].long(), argmin)
        losses['loss_attr'] = L.softmax_cross_entropy(
            attr_pred, attr_tgt.clamp(0, cfg.num_attrs - 1), w,
            avg_factor=num_pos)
    return losses


def pad44(cam2img):
    """(..., 3, 3) / (..., 3, 4) / (..., 4, 4) intrinsics embedded in
    eye(4), float32."""
    c = torch.as_tensor(cam2img).float()
    if c.shape[-2:] == (4, 4):
        return c
    out = torch.eye(4, device=c.device).expand(
        c.shape[:-2] + (4, 4)).clone()
    out[..., :c.shape[-2], :c.shape[-1]] = c
    return out


def fcos3d_get_bboxes(level_outs, points_np, cam2img, cfg):
    """Decode + NMS -> padded camera-frame detections.

    Args:
        level_outs: the head's per-level outputs (offsets in strides with
            `norm_on_bbox`, multiplied back here as the coder does at
            test time).
        cam2img: (B, 3|4, 4) the image's intrinsics.

    Returns:
        dict of (B, max_num, ...) 'boxes3d' (camera frame, bottom
        centre), 'scores', 'labels' (-1 where empty), 'mask' (+
        'velocity', 'attrs' for the nuScenes options).
    """
    b = level_outs[0]['cls_score'].shape[0]
    code = cfg.code_size
    cam2img = pad44(cam2img)
    dev = level_outs[0]['cls_score'].device
    parts = []
    for o, pts, stride in zip(level_outs, points_np, cfg.strides):
        c = o['cls_score'].shape[-1]
        bbox = o['bbox_pred'].float().reshape(b, -1, code)
        if cfg.norm_on_bbox:
            bbox = torch.cat([bbox[..., :2] * stride, bbox[..., 2:]], -1)
        attr = torch.argmax(o['attr_pred'].reshape(b, -1, cfg.num_attrs),
                            -1) if cfg.pred_attrs else \
            torch.zeros(bbox.shape[:2], dtype=torch.long, device=dev)
        # targets encode delta = point - centre => centre = point - delta
        parts.append((
            torch.sigmoid(o['cls_score'].float()).reshape(b, -1, c),
            torch.sigmoid(o['centerness'].float()).reshape(b, -1), bbox,
            torch.argmax(o['dir_pred'].reshape(b, -1, 2), -1),
            torch.as_tensor(pts, device=dev)[None] - bbox[..., :2], attr))
    scores, ctr, bbox, dirc, centers2d, attrs = (
        torch.cat([p[i] for p in parts], 1) for i in range(6))

    results = []
    for i in range(b):
        c2i = cam2img[i]
        ranked = scores[i].amax(-1) * ctr[i]
        k = min(cfg.nms_pre, ranked.shape[0])
        top = torch.sort(ranked, descending=True, stable=True)[1][:k]
        sc = scores[i][top] * ctr[i][top][:, None]
        bb, c2, dr, at = bbox[i][top], centers2d[i][top], dirc[i][top], \
            attrs[i][top]
        ctr3d = points_img2cam(torch.cat([c2, bb[:, 2:3]], -1), c2i)
        # local yaw -> global, dir bins (FCOS3DBBoxCoder.decode_yaw)
        yaw = limit_period(bb[:, 6] - cfg.dir_offset, 0, math.pi) + \
            cfg.dir_offset + math.pi * dr.float()
        yaw = torch.atan2(c2[:, 0] - c2i[0, 2], c2i[0, 0]) + yaw
        boxes_cam = torch.cat([ctr3d[:, :1], ctr3d[:, 1:2] + bb[:, 4:5] / 2,
                               ctr3d[:, 2:3], bb[:, 3:6], yaw[:, None]], -1)
        bev = cam_to_pseudo_lidar_boxes(boxes_cam)[:, [0, 1, 3, 4, 6]]
        extra = [boxes_cam]
        if cfg.pred_velo:
            extra.append(bb[:, 7:9])
        if cfg.pred_attrs:
            extra.append(at[:, None].float())
        out = box3d_multiclass_nms(torch.cat(extra, -1), bev, sc,
                                   cfg.score_thr, cfg.nms_thr, cfg.max_num)
        sel = out.pop('boxes3d')
        out['boxes3d'] = sel[:, :7]
        col = 7
        if cfg.pred_velo:
            out['velocity'] = sel[:, col:col + 2]
            col += 2
        if cfg.pred_attrs:
            out['attrs'] = sel[:, col].long()
        results.append(out)
    return {k: torch.stack([r[k] for r in results]) for k in results[0]}
