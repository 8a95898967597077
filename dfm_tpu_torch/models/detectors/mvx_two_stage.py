"""MVX-FasterRCNN: LiDAR points fused with camera features (PointFusion).

Port of `dfm_tpu/models/detectors/mvx_two_stage.py:40-144` (reference
mmdet3d mvx_two_stage.py / mvx_faster_rcnn.py and
fusion_layers/point_fusion.py), registered as `MVXFasterRCNN` and
`DynamicMVXFasterRCNN`:

* `img_backbone` (ResNet-18, BatchNorm) and `img_neck` (FPN at
  `img_channels`): the finest level's features;
* `point_fusion_sample`: each point projected through lidar2img, kept
  where it lies in front of the camera and inside the image, and the
  level's features sampled bilinearly at its pixel scaled to the level
  (`ops/grid_sample.py:bilinear_sample`, taps outside the map 0);
* `fuse0` / `fuse1` (`Linear` + ReLU): [point || image feature] -> the
  point's `fusion_mid` features;
* `pts_encoder`: the `LidarTeacher` voxel encoder on [xyz || fused] (3 +
  `fusion_mid` channels, hard voxelization of `max_points_per_voxel`),
  then the LIGA anchor head `bbox_head` (two GroupNorm towers).

`mvx_loss` / `mvx_predict` are the anchor head's loss and decode on the
BEV grid's anchors (`anchor3d_head_loss`, `anchor3d_head_get_bboxes`).
Outputs are channels-last, as the JAX package's.
"""

import dataclasses
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.transforms import apply_mat, homogeneous
from ...ops.grid_sample import bilinear_sample
from ..backbones.resnet import ResNet, stage_channels
from ..heads.anchor3d_head import (LIGAAnchor3DHead,
                                   anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..layers import Linear
from ..necks.fpn import FPN
from .teacher import LidarTeacher
from .voxelnet import VoxelNetConfig, anchors_of

__all__ = ['MVXConfig', 'MVXFasterRCNN', 'mvx_loss', 'mvx_predict',
           'point_fusion_sample']


@dataclasses.dataclass(frozen=True)
class MVXConfig(VoxelNetConfig):
    """The JAX `MVXConfig`: `VoxelNetConfig`'s fields, the image branch's
    ResNet depth and FPN width, the fusion width and SECOND's cap of 5
    points a voxel."""
    img_backbone_depth: int = 18
    img_channels: int = 64
    fusion_mid: int = 64
    max_points_per_voxel: Any = 5


def point_fusion_sample(img_feat, points, lidar2img, img_shape):
    """img_feat (Hf, Wf, C) float32, points (P, 3), lidar2img (4, 4),
    img_shape (H, W) of the full image -> (P, C) samples (0 where not
    valid), (P,) validity: in front of the camera (z > 1e-3) and inside
    the image."""
    h, w = img_shape
    hf, wf = img_feat.shape[:2]
    proj = apply_mat(homogeneous(points), lidar2img.float())
    z = proj[:, 2]
    uv = proj[:, :2] / torch.clamp(z[:, None], min=1e-5)
    valid = (z > 1e-3) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
        (uv[:, 1] >= 0) & (uv[:, 1] < h)
    coords = torch.stack([uv[:, 0] * (wf / w), uv[:, 1] * (hf / h)], -1)
    out = bilinear_sample(img_feat, coords)
    return out * valid[:, None].to(out.dtype), valid


class MVXFasterRCNN(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or MVXConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.img_backbone = ResNet(cfg.img_backbone_depth)
        self.img_neck = FPN(stage_channels(cfg.img_backbone_depth),
                            cfg.img_channels)
        self.fuse0 = Linear(3 + cfg.img_channels, cfg.fusion_mid)
        self.fuse1 = Linear(cfg.fusion_mid, cfg.fusion_mid)
        self.pts_encoder = LidarTeacher(
            cfg.point_cloud_range, cfg.voxel_size,
            volume_channels=cfg.cv_channels, bev_channels=cfg.bev_channels,
            max_points=cfg.max_points_per_voxel, dtype=dtype,
            point_channels=3 + cfg.fusion_mid)
        self.bbox_head = LIGAAnchor3DHead(
            cfg.num_classes, cfg.bev_channels, cfg.bev_channels,
            len(cfg.anchor_sizes) * len(cfg.anchor_rotations), norm='gn')

    def forward_train(self, points, cond, gt, generator=None,
                      depth_pix_idx=None):
        """`cond` = (point_mask, img, lidar2img); the forward pass and
        `mvx_loss` on gt's 'gt_boxes' (B, G, 7), 'gt_labels', 'gt_mask' ->
        (total, dict of terms); `generator` / `depth_pix_idx` (TrainStep's)
        are not read."""
        return mvx_loss(self(points, *cond), gt, self.cfg)

    def image_features(self, img):
        """(B, H, W, 3) -> the FPN's finest level, float32 channels-last
        (B, H/4, W/4, C)."""
        x = img.permute(0, 3, 1, 2).to(self.dtype)
        lvl0 = self.img_neck(self.img_backbone(x), levels=1)[0]
        return lvl0.permute(0, 2, 3, 1).float()

    def fuse(self, points, feat, lidar2img, img_shape):
        """The PointFusion of each sample -> ([xyz || fused] (B, P, 3 +
        fusion_mid) float32, validity (B, P))."""
        sampled, valid = zip(*[
            point_fusion_sample(f, p, m, img_shape)
            for f, p, m in zip(feat, points[..., :3].float(), lidar2img)])
        sampled, valid = torch.stack(sampled), torch.stack(valid)
        x = torch.cat([points.to(self.dtype), sampled.to(self.dtype)], -1)
        fused = F.relu(self.fuse1(F.relu(self.fuse0(x))))
        return torch.cat([points[..., :3].float(), fused.float()], -1), valid

    def forward(self, points, point_mask, img, lidar2img):
        """points (B, P, 3), point_mask (B, P), img (B, H, W, 3), lidar2img
        (B, 4, 4) -> dict of the head's maps (B, Ny, Nx, A * X)
        'cls_score', 'bbox_pred', 'dir_pred', 'bev_feat' (B, Ny, Nx, C)
        and 'fusion_valid' (B, P)."""
        with record_function('mvx.image_features'):
            feat = self.image_features(img)
        with record_function('mvx.point_fusion'):
            pts_aug, valid = self.fuse(points, feat, lidar2img,
                                       tuple(img.shape[1:3]))
        with record_function('mvx.pts_encoder'):
            _, bev = self.pts_encoder(pts_aug, point_mask)
        with record_function('mvx.bbox_head'):
            cls, reg, dirs = self.bbox_head(bev.permute(0, 3, 1, 2))
        return dict(cls_score=cls, bbox_pred=reg, dir_pred=dirs,
                    bev_feat=bev, fusion_valid=valid)


def mvx_loss(outputs, gt, cfg: MVXConfig):
    """`anchor3d_head_loss` with each class's anchors on the BEV grid;
    normalisers over the global batch of a process group where
    `cfg.dist_norm` -> (total, dict of terms)."""
    per_class, _ = anchors_of(cfg, outputs['cls_score'].shape[1:3],
                              outputs['cls_score'].device)
    losses = anchor3d_head_loss(
        (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred']),
        per_class, gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
        list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
        dir_offset=cfg.dir_offset,
        normalizer_clamp_value=cfg.normalizer_clamp_value,
        dist_norm=cfg.dist_norm)
    return sum(losses.values()), losses


def mvx_predict(outputs, cfg: MVXConfig):
    """Decode + NMS -> padded LiDAR-frame detections (B, max_num, ...):
    'boxes3d' (bottom centre), 'scores', 'labels', 'mask'."""
    _, flat = anchors_of(cfg, outputs['cls_score'].shape[1:3],
                         outputs['cls_score'].device)
    with record_function('mvx.predict'):
        return anchor3d_head_get_bboxes(
            (outputs['cls_score'], outputs['bbox_pred'],
             outputs['dir_pred']),
            flat, num_classes=cfg.num_classes, dir_offset=cfg.dir_offset,
            score_thr=cfg.score_thr, nms_thr=cfg.nms_thr,
            nms_pre=cfg.nms_pre, max_num=cfg.max_num)
