"""ImVoxelNet: single-view voxel lifting (KITTI car).

Port of `dfm_tpu/models/detectors/imvoxelnet.py` (reference
mmdet3d/models/detectors/imvoxelnet.py:11-138, config
imvoxelnet_4x8_kitti-3d-car.py): a ResNet (BatchNorm) + FPN trunk whose
stride-4 level 0 is sampled at the centres of an aligned voxel grid
(`sample_points`, (Nz, Ny, Nx) in (x, y, z)) projected into the image by
`lidar2img`: a point counts where it lies in front of the camera and
inside the (H, W) input, its pixel scaled by (fw - 1) / (w - 1) onto the
map and sampled bilinearly (align corners, zero outside), zero
elsewhere. `OutdoorImVoxelNeck` reduces the (B, 64, Nz, Ny, Nx) volume
to a 256-channel BEV map and the anchor head without towers gives the
class, box and direction maps. It is MultiViewDfM's sample with one
frame and one view, without the division by the views that saw a point
(one view: 1 where it saw it, the sample is 0 elsewhere).

`imvoxelnet_loss` is the anchor head's loss without the IoU term
(weights 1.0, 2.0, 0.2, 0.0), `imvoxelnet_predict` its decode + NMS, both
with the config's anchors on the BEV grid. Module names are JAX's:
`backbone`, `neck` (lateral0..3, fpn_conv0..3), `neck_3d`, `bbox_head`
(`utils/weights.py:imvoxelnet_key_map`).
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..backbones.resnet import ResNet, stage_channels
from ..heads.anchor3d_head import (LIGAAnchor3DHead,
                                   anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..necks.fpn import FPN
from ..necks.imvoxel_neck import OutdoorImVoxelNeck
from ..voxel_lift import VoxelGridConfig, sample_scales, view_sample

__all__ = ['ImVoxelNetConfig', 'ImVoxelNet', 'imvoxelnet_loss',
           'imvoxelnet_predict']


@dataclasses.dataclass(frozen=True)
class ImVoxelNetConfig(VoxelGridConfig):
    """Fields and defaults of the JAX `ImVoxelNetConfig` (KITTI car:
    a (216, 248, 12) grid over (-0.16, -39.68, -3.08, 68.96, 39.68,
    0.76))."""
    num_classes: int = 1
    feat_channels: int = 64
    voxel_range: Tuple[float, ...] = (-0.16, -39.68, -3.08,
                                      68.96, 39.68, 0.76)
    voxel_grid: Tuple[int, int, int] = (12, 248, 216)    # (Nz, Ny, Nx)
    backbone_depth: int = 50
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (-0.16, -39.68, -1.78, 68.96, 39.68, -1.78),)
    anchor_sizes: Tuple[Tuple[float, ...], ...] = ((3.9, 1.6, 1.56),)
    anchor_rotations: Tuple[float, ...] = (0.0, 1.57)
    dir_offset: float = 0.7854
    assigner_cfgs: Tuple[dict, ...] = (
        dict(pos_iou_thr=0.6, neg_iou_thr=0.45, min_pos_iou=0.45),)
    nms_pre: int = 1024
    score_thr: float = 0.1
    nms_thr: float = 0.25
    max_num: int = 100


class ImVoxelNet(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or ImVoxelNetConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = ResNet(cfg.backbone_depth)
        self.neck = FPN(stage_channels(cfg.backbone_depth),
                        cfg.feat_channels, num_outs=4)
        self.neck_3d = OutdoorImVoxelNeck(cfg.feat_channels, 256, 'bn', dtype)
        self.bbox_head = LIGAAnchor3DHead(
            cfg.num_classes, 256, 256,
            len(cfg.anchor_sizes) * len(cfg.anchor_rotations),
            num_convs=0, norm='none')

    def image_features(self, imgs):
        """(B, H, W, 3) normalised images -> FPN level 0 (B, C, H/4,
        W/4)."""
        x = imgs.permute(0, 3, 1, 2).to(self.dtype)
        return self.neck(self.backbone(x), levels=1)[0]

    def sample_volume(self, feat0, lidar2img, img_hw):
        """Level 0 (B, C, fh, fw) and lidar2img (B, 4, 4) -> the float32
        volume (B, C, Nz, Ny, Nx), zero where a point is not seen (a
        float64 model samples in float64)."""
        b, c, fh, fw = feat0.shape
        pts = self.cfg.grid_points(feat0.device)
        if feat0.dtype == torch.float64:
            pts = pts.double()
        img_max, feat_max = sample_scales(pts, img_hw, (fh, fw))
        vol = torch.stack([
            view_sample(feat0[i], pts, lidar2img[i], img_hw, img_max,
                        feat_max)[0] for i in range(b)])
        return vol.reshape((b, c) + tuple(self.cfg.voxel_grid))

    def forward_train(self, imgs, lidar2img, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `imvoxelnet_loss` on gt's 'gt_boxes' (B,
        G, 7) (lidar frame), 'gt_labels' and 'gt_mask' -> (total, dict of
        terms); `generator` / `depth_pix_idx` (TrainStep's) are not
        read."""
        return imvoxelnet_loss(self(imgs, lidar2img), gt, self.cfg)

    def forward(self, imgs, lidar2img):
        """imgs (B, H, W, 3) normalised, lidar2img (B, 4, 4); points count
        inside the whole (H, W) input, as JAX's model takes it (its
        `img_shape` argument is not read there).

        Returns dict of the head outputs (B, Ny, Nx, A * X) 'cls_score',
        'bbox_pred', 'dir_pred', and 'bev_feat' (B, Ny, Nx, 256),
        'volume_feat' (B, Nz, Ny, Nx, C): channels last as in the JAX
        package (views of the NC... tensors)."""
        img_hw = tuple(imgs.shape[1:3])
        with record_function('imvoxelnet.image_features'):
            feat0 = self.image_features(imgs)
        with record_function('imvoxelnet.sample_volume'):
            vol = self.sample_volume(feat0, lidar2img, img_hw)
        with record_function('imvoxelnet.neck_3d'):
            bev = self.neck_3d(vol)
        out = dict(bev_feat=bev.permute(0, 2, 3, 1),
                   volume_feat=vol.permute(0, 2, 3, 4, 1))
        with record_function('imvoxelnet.bbox_head'):
            out.update(zip(('cls_score', 'bbox_pred', 'dir_pred'),
                           self.bbox_head(bev)))
        return out


def imvoxelnet_loss(outputs, gt, cfg: ImVoxelNetConfig):
    """JAX's `imvoxelnet_loss`: `anchor3d_head_loss` with each class's
    anchors on the BEV grid, no IoU term, weights (1.0, 2.0, 0.2, 0.0)
    for cls, bbox, dir, iou; normalisers over the global batch in a
    process group -> (total, dict of terms)."""
    ny, nx = outputs['cls_score'].shape[1:3]
    losses = anchor3d_head_loss(
        (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred']),
        cfg.anchors_per_class((ny, nx), outputs['cls_score'].device),
        gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
        list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
        dir_offset=cfg.dir_offset, loss_weights=(1.0, 2.0, 0.2, 0.0),
        use_iou_loss=False, dist_norm=True)
    return sum(losses.values()), losses


def imvoxelnet_predict(outputs, cfg: ImVoxelNetConfig):
    """Decode + NMS -> the padded detections (B, max_num, ...) in the
    lidar frame: 'boxes3d', 'scores', 'labels', 'mask'."""
    ny, nx = outputs['cls_score'].shape[1:3]
    anchors = cfg.flat_anchors((ny, nx), outputs['cls_score'].device)
    with record_function('imvoxelnet.predict'):
        return anchor3d_head_get_bboxes(
            (outputs['cls_score'], outputs['bbox_pred'],
             outputs['dir_pred']),
            anchors, num_classes=cfg.num_classes, dir_offset=cfg.dir_offset,
            score_thr=cfg.score_thr, nms_thr=cfg.nms_thr,
            nms_pre=cfg.nms_pre, max_num=cfg.max_num)
