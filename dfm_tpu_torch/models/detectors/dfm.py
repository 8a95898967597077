"""DfM: monocular 3D detection with depth from motion.

Port of `dfm_tpu/models/detectors/dfm.py:45-314`:

  imgs (cur + prev) -> shared LIGAResNet -> SPP-UNet neck
  -> plane-sweep cost volume (K1) + stereo / mono 3D trunks (DfMBackbone)
  -> frustum-to-voxel lifting (K2, K3) -> height compression
  -> BEV hourglass -> LIGA anchor head;  `dfm_predict`: decode + NMS;
  `dfm_loss`: the anchor head's losses + the dense depth loss.

Inputs and outputs keep the JAX package's layouts (images
(B, 2, H, W, 3), channels-last volumes and head maps) so the two can be
compared directly. Each stage runs in a `record_function` span
(`dfm.image_trunk`, `dfm.stereo_backbone` with the backbone's own spans
inside it, `dfm.frustum_to_voxel`, `dfm.bev_head`, `dfm.predict`) that
`dfm_tpu_torch/trace_main.py` reads.
"""

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ...core.anchors import Anchor3DRangeGenerator
from ..backbones.bev_hourglass import BEVHourglass
from ..backbones.dfm_backbone import DfMBackbone
from ..backbones.liga_resnet import LIGAResNet
from ..heads.anchor3d_head import (LIGAAnchor3DHead, anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..heads.depth_head import depth_distribution_loss
from ..necks.frustum_to_voxel import FrustumToVoxel
from ..necks.spp_unet import SPPUNetNeck

__all__ = ['BatchMeta', 'DfMConfig', 'DfM', 'dfm_predict', 'dfm_loss']


@dataclasses.dataclass
class BatchMeta:
    """Per-sample geometry and augmentation state, as tensors."""
    ori_cam2img: torch.Tensor      # (B, 4, 4)
    cam2img: torch.Tensor          # (B, 4, 4) after aug
    cur2prev: torch.Tensor         # (B, 4, 4)
    org_w: torch.Tensor            # (B,)
    flip: torch.Tensor             # (B,) {0, 1}
    crop_offset: torch.Tensor      # (B, 2)
    scale_factor: torch.Tensor     # (B,)

    @staticmethod
    def identity(batch_size, cam2img=None, device=None):
        eye = torch.eye(4, device=device).expand(batch_size, 4, 4)
        c = eye if cam2img is None else torch.as_tensor(
            cam2img, dtype=torch.float32, device=device)
        return BatchMeta(
            ori_cam2img=c, cam2img=c, cur2prev=eye,
            org_w=torch.full((batch_size,), 1242.0, device=device),
            flip=torch.zeros((batch_size,), device=device),
            crop_offset=torch.zeros((batch_size, 2), device=device),
            scale_factor=torch.ones((batch_size,), device=device))

    def to(self, device):
        return BatchMeta(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class DfMConfig:
    """Static hyperparameters (KITTI defaults of the reference config
    configs/dfm/dfm_r34_1x8_kitti-3d-3class.py)."""
    num_classes: int = 3
    depth_num_bins: int = 288
    depth_min: float = 2.0
    depth_max: float = 59.6
    depth_downsample: int = 4
    downsampled_depth_offset: float = 0.5
    point_cloud_range: Tuple[float, ...] = (2, -30.4, -3, 59.6, 30.4, 1)
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 0.2)
    cost_sample_factor: int = 4
    cv_channels: int = 32
    sem_channels: Tuple[int, int] = (128, 32)
    stereo_channels: Tuple[int, int] = (32, 32)
    bev_channels: int = 64
    backbone_depth: int = 34
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (2, -30.4, -1.78, 59.6, 30.4, -1.78),
        (2, -30.4, -0.6, 59.6, 30.4, -0.6),
        (2, -30.4, -0.6, 59.6, 30.4, -0.6))
    anchor_sizes: Tuple[Tuple[float, ...], ...] = (
        (3.9, 1.6, 1.56), (0.8, 0.6, 1.73), (1.76, 0.6, 1.73))
    anchor_rotations: Tuple[float, ...] = (0.0, 1.5707963)
    dir_offset: float = 0.7854
    # train
    assigner_cfgs: Tuple[dict, ...] = (
        dict(pos_iou_thr=0.6, neg_iou_thr=0.45, min_pos_iou=0.45),
        dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.35),
        dict(pos_iou_thr=0.5, neg_iou_thr=0.35, min_pos_iou=0.35))
    normalizer_clamp_value: float = 10.0
    # the loss normalisers over the global batch of a process group (JAX's
    # loss on the sharded batch); False = each rank's own (reference
    # *_wodistnorm.py config)
    dist_norm: bool = True
    depth_loss: Any = dataclasses.field(default_factory=lambda: dict(
        type='balanced_focal', loss_weight=1.0, fg_weight=5, bg_weight=1,
        alpha=1, gamma=2))
    num_depth_sample_pixels: int = 8192
    # test
    nms_pre: int = 1024
    score_thr: float = 0.1
    nms_thr: float = 0.25
    max_num: int = 100

    @property
    def num_downsampled_bins(self):
        return self.depth_num_bins // self.depth_downsample

    def downsampled_depths(self):
        """Downsampled depth-bin centres (numpy float32)."""
        interval = (self.depth_max - self.depth_min) / self.depth_num_bins
        i = np.arange(self.num_downsampled_bins, dtype=np.float32)
        return ((i + self.downsampled_depth_offset) * self.depth_downsample
                * interval + self.depth_min)

    def depth_samples(self):
        """Full-resolution depth-bin centres (numpy float32)."""
        interval = (self.depth_max - self.depth_min) / self.depth_num_bins
        i = np.arange(self.depth_num_bins, dtype=np.float32)
        return (i + 0.5) * interval + self.depth_min

    def voxel_grid_size(self):
        pcr = np.asarray(self.point_cloud_range, np.float32)
        gs = np.round((pcr[3:] - pcr[:3]) /
                      np.asarray(self.voxel_size)).astype(int)
        return int(gs[2]), int(gs[1]), int(gs[0])  # Nz, Ny, Nx

    def coordinates_3d(self):
        """(Nz, Ny, Nx, 3) pseudo-lidar voxel centres (numpy)."""
        nz, ny, nx = self.voxel_grid_size()
        pcr = self.point_cloud_range
        vs = self.voxel_size
        zs = np.linspace(pcr[2] + vs[2] / 2, pcr[5] - vs[2] / 2, nz,
                         dtype=np.float32)
        ys = np.linspace(pcr[1] + vs[1] / 2, pcr[4] - vs[1] / 2, ny,
                         dtype=np.float32)
        xs = np.linspace(pcr[0] + vs[0] / 2, pcr[3] - vs[0] / 2, nx,
                         dtype=np.float32)
        zz, yy, xx = np.meshgrid(zs, ys, xs, indexing='ij')
        return np.stack([xx, yy, zz], axis=-1)

    def anchor_generator(self):
        return Anchor3DRangeGenerator(
            ranges=list(self.anchor_ranges), sizes=list(self.anchor_sizes),
            rotations=list(self.anchor_rotations))


class DfM(nn.Module):
    """Forward producing head outputs and intermediate volumes; the
    inference post-processing is `dfm_predict`. `use_band` and `packed`
    (None, True, 'stem' or False) select the form of `DfMBackbone` (same
    parameters in every form)."""

    def __init__(self, cfg: DfMConfig = DfMConfig(), dtype=torch.float32,
                 use_band=True, packed=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = LIGAResNet(depth=cfg.backbone_depth)
        self.neck = SPPUNetNeck(
            in_channels=(3,) + tuple(self.backbone.out_channels),
            sem_channels=cfg.sem_channels,
            stereo_channels=cfg.stereo_channels)
        self.backbone_stereo = DfMBackbone(
            in_channels=cfg.stereo_channels[1], cv_channels=cfg.cv_channels,
            cost_sample_factor=cfg.cost_sample_factor,
            num_depth_bins_out=cfg.num_downsampled_bins,
            use_band=use_band, packed=packed)
        self.feature_transformation = FrustumToVoxel(
            in_channels=cfg.cv_channels + cfg.sem_channels[1],
            out_channels=cfg.cv_channels, depth_min=cfg.depth_min,
            depth_max=cfg.depth_max, up_factor=cfg.depth_downsample)
        nz = cfg.voxel_grid_size()[0] // self.feature_transformation.pool_z
        self.backbone_3d = BEVHourglass(nz * cfg.cv_channels,
                                        cfg.bev_channels)
        self.bbox_head_3d = LIGAAnchor3DHead(
            num_classes=cfg.num_classes, in_channels=cfg.bev_channels,
            feat_channels=cfg.bev_channels,
            num_anchors=len(cfg.anchor_sizes) * len(cfg.anchor_rotations))
        self._anchors = {}

    def anchors_per_class(self, featmap_size, device):
        """The (Ny * Nx * R, 7) anchors of each class, in the head's
        (y, x, rot) order, on `device`; made once per feature size and
        device, then kept (`dfm_tpu/models/detectors/dfm.py:256-264`)."""
        key = (tuple(featmap_size), str(device))
        if key not in self._anchors:
            grid = self.cfg.anchor_generator().grid_anchors(featmap_size)
            self._anchors[key] = [
                torch.as_tensor(grid[0, :, :, c].reshape(-1, 7),
                                device=device)
                for c in range(len(self.cfg.anchor_sizes))]
        return self._anchors[key]

    @property
    def student(self):
        """The model inference runs: the DfM itself (a `DfMFull`'s
        `dfm`)."""
        return self

    def forward_train(self, img, meta, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `dfm_loss` (gt, generator and
        depth_pix_idx as there) -> (total, dict of terms)."""
        out = self(img, meta)
        anchors = self.anchors_per_class(out['cls_score'].shape[1:3],
                                         out['cls_score'].device)
        return dfm_loss(out, gt, self.cfg, anchors, generator, depth_pix_idx)

    def _stereo_feats(self, img):
        """(B, H, W, 3) image -> stereo (B, H, W, Cs) channels-last and
        sem (B, H/4, W/4, Csem)."""
        x = img.to(self.dtype).permute(0, 3, 1, 2)
        feats = [x] + self.backbone(x)
        stereo, sem = self.neck(feats)
        return (stereo.permute(0, 2, 3, 1).contiguous(),
                sem.permute(0, 2, 3, 1).contiguous())

    def forward(self, img, meta: BatchMeta, prev_stereo_cache=None):
        """
        Args:
            img: (B, 2, H, W, 3) current + previous frame (normalised).
            meta: BatchMeta.
            prev_stereo_cache: optional (B, H, W, Cs) stereo features of
                the previous frame (its 'stereo_cache' output); the
                prev-frame 2D trunk is then skipped.

        Returns:
            dict with 'cls_score', 'bbox_pred', 'dir_pred',
            'depth_cost' (B, D', H/4, W/4), 'volume_feat', 'bev_feat',
            'sem_feat', 'stereo_cache'.
        """
        cfg = self.cfg
        b, n, h, w, _ = img.shape
        if n != 2:
            raise ValueError('DfM-KITTI takes one reference frame')
        with record_function('dfm.image_trunk'):
            cur_stereo, cur_sem = self._stereo_feats(img[:, 0])
            if prev_stereo_cache is not None:
                prev_stereo = prev_stereo_cache.to(self.dtype)
            else:
                prev_stereo, _ = self._stereo_feats(img[:, 1])

        with record_function('dfm.stereo_backbone'):
            depths = torch.as_tensor(cfg.downsampled_depths(),
                                     device=img.device)
            cost, stereo_feats, _ = self.backbone_stereo(
                cur_stereo, prev_stereo, depths, meta.ori_cam2img,
                meta.cur2prev, org_w=meta.org_w, flip=meta.flip,
                crop_offset=meta.crop_offset, scale_factor=meta.scale_factor)
            depth_cost = cost[..., 0]                 # (B, D', H/4, W/4)
        with record_function('dfm.frustum_to_voxel'):
            volume_feat = self.feature_transformation(
                stereo_feats, depth_cost, cur_sem, cfg.coordinates_3d(),
                meta.cam2img, (h, w))
        with record_function('dfm.bev_head'):
            # height compression: (B, Nz', Ny, Nx, C) -> (B, Nz'*C, Ny, Nx)
            bb, nz, ny, nx, c = volume_feat.shape
            bev = volume_feat.permute(0, 1, 4, 2, 3).reshape(bb, nz * c, ny,
                                                             nx)
            _, bev_feat = self.backbone_3d(bev)
            cls_score, bbox_pred, dir_pred = self.bbox_head_3d(bev_feat)
        return dict(cls_score=cls_score, bbox_pred=bbox_pred,
                    dir_pred=dir_pred, depth_cost=depth_cost,
                    volume_feat=volume_feat,
                    bev_feat=bev_feat.permute(0, 2, 3, 1),
                    sem_feat=cur_sem, stereo_cache=cur_stereo)


def dfm_loss(outputs, gt, cfg: DfMConfig, anchors_per_class, generator=None,
             depth_pix_idx=None, dist_norm=None):
    """Total training loss (`dfm_tpu/models/detectors/dfm.py:267-302`).

    Args:
        outputs: `DfM.forward` outputs.
        gt: dict with 'gt_boxes' (B, G, 7) pseudo-lidar, 'gt_labels'
            (B, G), 'gt_mask' (B, G), optional 'depth_img' (B, H, W) and
            'depth_fgmask_img' (`data/collate.py:build_batch`).
        anchors_per_class: `DfM.anchors_per_class` at the head's size.
        generator: torch.Generator of the depth-pixel draw.
        depth_pix_idx: optional (B, P) depth-loss pixels instead of a draw.
        dist_norm: in a process group, every normaliser over the global
            batch, so that the rank's terms are its share of the global
            batch's (`heads/anchor3d_head.py`); None takes
            `cfg.dist_norm` (a no-op without a process group).

    Returns:
        (total, dict of scalar terms).
    """
    dist_norm = cfg.dist_norm if dist_norm is None else dist_norm
    losses = anchor3d_head_loss(
        (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred']),
        anchors_per_class, gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
        list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
        dir_offset=cfg.dir_offset,
        normalizer_clamp_value=cfg.normalizer_clamp_value,
        dist_norm=dist_norm)
    if gt.get('depth_img') is not None:
        losses['loss_dense_depth'] = depth_distribution_loss(
            outputs['depth_cost'], gt['depth_img'],
            gt.get('depth_fgmask_img'),
            torch.as_tensor(cfg.depth_samples(),
                            device=outputs['depth_cost'].device),
            cfg.depth_loss, up_factor=cfg.depth_downsample,
            num_sample_pixels=cfg.num_depth_sample_pixels,
            depth_min=cfg.depth_min, depth_max=cfg.depth_max,
            generator=generator, pix_idx=depth_pix_idx,
            dist_norm=dist_norm)
    return sum(losses.values()), losses


def dfm_predict(outputs, cfg: DfMConfig):
    """Decode + NMS: padded detections in the pseudo-lidar frame."""
    ny, nx = outputs['cls_score'].shape[1:3]
    grid = cfg.anchor_generator().grid_anchors((ny, nx))
    flat_anchors = torch.as_tensor(grid.reshape(-1, 7),
                                   device=outputs['cls_score'].device)
    with record_function('dfm.predict'):
        return anchor3d_head_get_bboxes(
            (outputs['cls_score'], outputs['bbox_pred'],
             outputs['dir_pred']),
            flat_anchors, num_classes=cfg.num_classes,
            dir_offset=cfg.dir_offset, score_thr=cfg.score_thr,
            nms_thr=cfg.nms_thr, nms_pre=cfg.nms_pre, max_num=cfg.max_num)
