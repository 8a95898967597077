"""MultiViewDfM (MV-FCOS3D++): inference and training, every option of
the JAX model.

Port of `dfm_tpu/models/detectors/multiview_dfm.py:33-317` (reference
mmdet3d/models/detectors/multiview_dfm.py:14-353): one ResNet + FPN
trunk over the B*F*V images, its stride-4 level 0 (the earlier frames'
detached); a 3D grid of sample points (the aligned anchor generator's
voxel centres, (Nz, Ny, Nx) in (x, y, z)) projected into every view;
each point's feature bilinearly sampled where it lies in front of the
camera and inside the (padded) image, summed over the views and divided
by the number of views that saw it; the frames averaged
(`frame_fusion='mean'`, the camsync config) or stacked frame-major into
F*C channels (`'concat'`, the 10-sweeps config: channel f*C + c is frame
f's, the current frame first). Then, as the config says:

* `with_backbone_3d`: `num_backbone_3d_blocks` x `ResModule3D` over the
  volume;
* `with_depth_head`: the volume re-sampled on each view's frustum grid
  (`ops/voxel_sample.py`, the current frame's lidar2img) and a dense
  `DepthPredModule` (3^3 ConvNorm with GroupNorm, a 3^3 conv to one
  channel) to a per-view depth cost, which `mvdfm_loss`'s dense depth
  term reads;
* the 3D neck: `OutdoorImVoxelNeck` (`neck_3d='imvoxel'`) or `DfMNeck`
  (`'dfm'`, which needs `'concat'`), to a 256-channel BEV map;
* the head: the anchor head without towers (`bbox_head='anchor'`: class,
  box and direction maps) or the CenterHead (`'center'`: per-task branch
  maps, `heads/center_head.py`).

The views are sampled one at a time into one (C, P) float32 sum, so the
V sampled volumes never exist at once. Training (`forward_train`,
`mvdfm_loss`): the anchor head's loss without the IoU term, + the dense
depth loss where the model has the depth head and the batch a depth
map; or the CenterHead's loss.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ...ops.voxel_sample import voxel_sample
from ..backbones.resnet import ResNet, stage_channels
from ..heads.anchor3d_head import (LIGAAnchor3DHead,
                                   anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..heads.center_head import (CenterHead, CenterHeadConfig,
                                 center_head_decode, center_head_loss)
from ..heads.depth_head import depth_distribution_loss
from ..layers import Conv, ConvNorm
from ..necks.dfm_neck import DfMNeck
from ..necks.fpn import FPN
from ..necks.imvoxel_neck import OutdoorImVoxelNeck, ResModule3D
from ..voxel_lift import VoxelGridConfig, sample_scales, view_sample

__all__ = ['MVDfMConfig', 'MultiViewDfM', 'center_config', 'mvdfm_loss',
           'mvdfm_predict']


@dataclasses.dataclass(frozen=True)
class MVDfMConfig(VoxelGridConfig):
    """Fields and defaults of the JAX `MVDfMConfig` (the camsync
    config's values where it sets them)."""
    num_classes: int = 3
    num_views: int = 5
    num_frames: int = 1
    frame_fusion: str = 'mean'
    feat_channels: int = 64
    voxel_range: Tuple[float, ...] = (-35.0, -75.0, -2, 75.0, 75.0, 4)
    voxel_grid: Tuple[int, int, int] = (12, 240, 300)   # (Nz, Ny, Nx)
    backbone_depth: int = 101
    neck_3d: str = 'imvoxel'
    bbox_head: str = 'anchor'
    center_tasks: Tuple[Tuple[int, ...], ...] = ((0,), (1, 2))
    with_backbone_3d: bool = False
    with_depth_head: bool = False
    num_backbone_3d_blocks: int = 2
    depth_min: float = 2.0
    depth_max: float = 70.0
    depth_num_bins: int = 128
    depth_downsample: int = 4
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (-35.0, -75.0, -0.0345, 75.0, 75.0, -0.0345),
        (-35.0, -75.0, 0.0, 75.0, 75.0, 0.0),
        (-35.0, -75.0, -0.1188, 75.0, 75.0, -0.1188))
    anchor_sizes: Tuple[Tuple[float, ...], ...] = (
        (4.73, 2.08, 1.77), (0.91, 0.84, 1.74), (1.81, 0.84, 1.77))
    anchor_rotations: Tuple[float, ...] = (0.0, 1.57)
    dir_offset: float = 0.7854
    assigner_cfgs: Tuple[dict, ...] = (
        dict(pos_iou_thr=0.55, neg_iou_thr=0.4, min_pos_iou=0.4),
        dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.3),
        dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.3))
    nms_pre: int = 1024
    score_thr: float = 0.1
    nms_thr: float = 0.25
    max_num: int = 500

    @property
    def volume_channels(self):
        """Channels of the sampled volume: F * C under 'concat'."""
        return self.feat_channels * (
            self.num_frames if self.frame_fusion == 'concat' else 1)

    def depth_samples(self):
        """The (depth_num_bins,) float32 full-resolution depth bins."""
        return np.linspace(self.depth_min, self.depth_max,
                           self.depth_num_bins, dtype=np.float32)

    def voxel_size(self):
        """(3,) float32 voxel edges (x, y, z)."""
        vr = np.asarray(self.voxel_range, np.float32)
        return (vr[3:] - vr[:3]) / np.asarray(self.voxel_grid[::-1],
                                              np.float32)


def center_config(cfg: MVDfMConfig):
    """The CenterHead's config of a MultiViewDfM config (`_center_cfg`):
    its tasks, a BEV cell's size and the grid's (x0, y0)."""
    nz, ny, nx = cfg.voxel_grid
    vr = cfg.voxel_range
    return CenterHeadConfig(
        tasks=tuple(tuple(str(c) for c in t) for t in cfg.center_tasks),
        voxel_size=((vr[3] - vr[0]) / nx, (vr[4] - vr[1]) / ny),
        pc_range=(vr[0], vr[1]))


class MultiViewDfM(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or MVDfMConfig()
        if cfg.neck_3d == 'dfm' and cfg.frame_fusion != 'concat':
            raise ValueError("MultiViewDfM: neck_3d='dfm' needs "
                             "frame_fusion='concat'")
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = ResNet(cfg.backbone_depth)
        self.neck = FPN(stage_channels(cfg.backbone_depth),
                        cfg.feat_channels, num_outs=4)
        cv = cfg.volume_channels
        if cfg.with_backbone_3d:
            for i in range(cfg.num_backbone_3d_blocks):
                setattr(self, f'backbone_3d_block{i}', ResModule3D(cv, 'bn'))
        if cfg.with_depth_head:
            self.depth_pred = nn.Sequential(
                ConvNorm(cv, cv, 3, ndim=3, norm='gn'),
                Conv(cv, 1, 3, ndim=3))
        if cfg.neck_3d == 'dfm':
            self.neck_3d = DfMNeck(cfg.feat_channels, 256, cfg.num_frames,
                                   cfg.voxel_grid[0], 'bn', dtype)
        else:
            self.neck_3d = OutdoorImVoxelNeck(cv, 256, 'bn', dtype)
        if cfg.bbox_head == 'center':
            self.bbox_head_3d = CenterHead(center_config(cfg), 256, 'bn',
                                           dtype)
        else:
            self.bbox_head_3d = LIGAAnchor3DHead(
                cfg.num_classes, 256, 256,
                len(cfg.anchor_sizes) * len(cfg.anchor_rotations),
                num_convs=0, norm='none')

    def image_features(self, imgs):
        """(B, F, V, H, W, 3) normalised images -> the FPN's level 0,
        (B, F, V, C, H/4, W/4); previous frames detached."""
        b, f, v, h, w, _ = imgs.shape
        flat = imgs.reshape(b * f * v, h, w, 3).permute(0, 3, 1, 2)
        feat0 = self.neck(self.backbone(flat.to(self.dtype)), levels=1)[0]
        feat0 = feat0.reshape((b, f, v) + feat0.shape[1:])
        if f > 1:
            feat0 = torch.cat([feat0[:, :1], feat0[:, 1:].detach()], 1)
        return feat0

    def sample_volume(self, feat0, lidar2img, img_hw):
        """Level-0 features (B, F, V, C, fh, fw) and lidar2img (B, F, V,
        4, 4) -> the float32 volume (B, C', Nz, Ny, Nx): per point the
        mean over the views that see it (in front of the camera, inside
        the (H, W) image), then the frames' mean (C' = C) or, under
        'concat', the frames one after the other (C' = F * C, frame f's
        channels at [f * C, (f + 1) * C)). A float64 model samples in
        float64."""
        b, f, v, c, fh, fw = feat0.shape
        concat = self.cfg.frame_fusion == 'concat'
        if concat and f != self.cfg.num_frames:
            raise ValueError(f"MultiViewDfM with frame_fusion='concat' "
                             f'takes {self.cfg.num_frames} frames, got {f}')
        pts = self.cfg.grid_points(feat0.device)
        if feat0.dtype == torch.float64:
            pts = pts.double()
        img_max, feat_max = sample_scales(pts, img_hw, (fh, fw))
        vols = []
        for bi in range(b):
            frames = []
            for fi in range(f):
                acc = pts.new_zeros(c, pts.shape[0])
                count = pts.new_zeros(pts.shape[0])
                for vi in range(v):
                    feat, valid = view_sample(
                        feat0[bi, fi, vi], pts, lidar2img[bi, fi, vi],
                        img_hw, img_max, feat_max)
                    acc += feat
                    count += valid
                frames.append(acc / count.clamp(min=1.0))
            if concat:
                vols.append(torch.cat(frames))
            else:
                vols.append(torch.stack(frames).mean(0) if f > 1
                            else frames[0])
        nz, ny, nx = self.cfg.voxel_grid
        return torch.stack(vols).reshape(b, -1, nz, ny, nx)

    def backbone_3d(self, vol):
        """`with_backbone_3d`: the residual blocks over the volume."""
        for i in range(self.cfg.num_backbone_3d_blocks):
            vol = getattr(self, f'backbone_3d_block{i}')(vol, self.dtype)
        return vol

    def depth_head(self, vol, lidar2img, pad_hw):
        """`with_depth_head`: the volume (B, C', Nz, Ny, Nx) sampled on
        each view's frustum grid (`lidar2img` (B, V, 4, 4), the current
        frame's) -> (stereo_feat (B*V, C', D', H', W'), depth_cost (B*V,
        D', H', W')), D' = depth_num_bins / depth_downsample."""
        cfg = self.cfg
        stereo = torch.stack([
            voxel_sample(vol[bi], cfg.depth_samples(), lidar2img[bi, vi],
                         cfg.depth_downsample, pad_hw, cfg.voxel_range,
                         cfg.voxel_size())
            for bi in range(vol.shape[0]) for vi in range(lidar2img.shape[1])])
        cost = self.depth_pred(stereo.to(self.dtype))[:, 0]
        return stereo, cost

    def forward_train(self, imgs, lidar2img, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `mvdfm_loss` on gt's 'gt_boxes' (B, G, 7)
        (vehicle frame), 'gt_labels' and 'gt_mask' (+ 'depth_img' for the
        dense depth loss) -> (total, dict of terms); `generator` /
        `depth_pix_idx` (`TrainStep`'s) the depth loss's pixel draws."""
        return mvdfm_loss(self(imgs, lidar2img), gt, self.cfg, generator,
                          depth_pix_idx)

    def forward(self, imgs, lidar2img, img_hw=None):
        """imgs (B, F, V, H, W, 3) normalised, the current frame first;
        lidar2img (B, F, V, 4, 4) from the current vehicle frame (earlier
        frames rewritten by ego-motion); img_hw the image extent that
        counts as inside (the padded (H, W) if None).

        Returns dict of the head outputs: the anchor head's (B, Ny, Nx,
        A * X), or 'task_outs' (the CenterHead's list of branch dicts,
        (B, Ny, Nx, ch)); 'bev_feat' (B, Ny, Nx, 256), 'volume_feat' (B,
        Nz, Ny, Nx, C') after the 3D backbone, and with the depth head
        'stereo_feat' (B*V, D', H', W', C') and 'depth_cost' (B*V, D', H',
        W'); channels last as in the JAX package (views of the NC...
        tensors)."""
        cfg = self.cfg
        img_hw = img_hw or tuple(imgs.shape[3:5])
        with record_function('mvdfm.image_features'):
            feat0 = self.image_features(imgs)
        with record_function('mvdfm.sample_volume'):
            vol = self.sample_volume(feat0, lidar2img, img_hw)
        out = {}
        if cfg.with_backbone_3d:
            with record_function('mvdfm.backbone_3d'):
                vol = self.backbone_3d(vol)
        if cfg.with_depth_head:
            with record_function('mvdfm.depth_head'):
                stereo, cost = self.depth_head(vol, lidar2img[:, 0],
                                               tuple(imgs.shape[3:5]))
            out.update(stereo_feat=stereo.permute(0, 2, 3, 4, 1),
                       depth_cost=cost)
        with record_function('mvdfm.neck_3d'):
            bev = self.neck_3d(vol)
        out.update(bev_feat=bev.permute(0, 2, 3, 1),
                   volume_feat=vol.permute(0, 2, 3, 4, 1))
        with record_function('mvdfm.bbox_head_3d'):
            if cfg.bbox_head == 'center':
                out['task_outs'] = self.bbox_head_3d(bev)
            else:
                out.update(zip(('cls_score', 'bbox_pred', 'dir_pred'),
                               self.bbox_head_3d(bev)))
        return out


def mvdfm_loss(outputs, gt, cfg: MVDfMConfig, generator=None,
               pix_idx=None):
    """JAX's `mvdfm_loss` (`multiview_dfm.py:264-303`).

    The CenterHead's outputs ('task_outs') give `center_head_loss`'s
    `task{t}_loss_heatmap` / `task{t}_loss_bbox` alone. Else the anchor
    head's `anchor3d_head_loss` with the per-class anchors, no IoU term
    and the weights (1.0, 2.0, 0.2, 0.0) for cls, bbox, dir, iou; + with
    a 'depth_cost' (the depth head), a 'depth_img' (B, V, H, W) in gt and
    a pixel draw (`generator`, or `pix_idx` (B*V, 2048), as JAX's `rng`),
    `loss_dense_depth`: the 'ce' depth loss over the views' costs at
    2048 pixels of each view (`heads/depth_head.py`), up by
    `depth_downsample`. In a process group every normaliser is the
    global batch's (`dist_norm`).

    Args:
        outputs: `MultiViewDfM.forward`'s.
        gt: 'gt_boxes' (B, G, 7) in the vehicle frame, 'gt_labels' (B, G),
            'gt_mask' (B, G) [, 'depth_img'].

    Returns:
        (total, dict of terms).
    """
    if 'task_outs' in outputs:
        losses = center_head_loss(outputs['task_outs'], gt,
                                  center_config(cfg), cfg.center_tasks,
                                  dist_norm=True)
        return sum(losses.values()), losses
    ny, nx = outputs['cls_score'].shape[1:3]
    losses = anchor3d_head_loss(
        (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred']),
        cfg.anchors_per_class((ny, nx), outputs['cls_score'].device),
        gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
        list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
        dir_offset=cfg.dir_offset, loss_weights=(1.0, 2.0, 0.2, 0.0),
        use_iou_loss=False, dist_norm=True)
    if 'depth_cost' in outputs and gt.get('depth_img') is not None and (
            generator is not None or pix_idx is not None):
        cost = outputs['depth_cost']                 # (B*V, D', H', W')
        depth_img = gt['depth_img'].reshape(
            (cost.shape[0],) + gt['depth_img'].shape[-2:])
        # the 'ce' loss weighs every pixel alike: no foreground mask
        losses['loss_dense_depth'] = depth_distribution_loss(
            cost, depth_img, None, torch.as_tensor(cfg.depth_samples(),
                                                   device=cost.device),
            dict(type='ce', loss_weight=1.0), up_factor=cfg.depth_downsample,
            num_sample_pixels=2048, depth_min=cfg.depth_min,
            depth_max=cfg.depth_max, generator=generator, pix_idx=pix_idx,
            dist_norm=True)
    return sum(losses.values()), losses


def mvdfm_predict(outputs, cfg: MVDfMConfig):
    """Decode + NMS: the anchor head's padded detections (B, max_num,
    ...) in the lidar (vehicle) frame; for the CenterHead its decode of
    sample 0, 'boxes_3d' (T * K, 7), 'scores_3d' (0 where dropped),
    'labels_3d'."""
    if 'task_outs' in outputs:
        with record_function('mvdfm.predict'):
            return center_head_decode(outputs['task_outs'],
                                      center_config(cfg), cfg.center_tasks)
    ny, nx = outputs['cls_score'].shape[1:3]
    anchors = cfg.flat_anchors((ny, nx), outputs['cls_score'].device)
    with record_function('mvdfm.predict'):
        return anchor3d_head_get_bboxes(
            (outputs['cls_score'], outputs['bbox_pred'],
             outputs['dir_pred']),
            anchors, num_classes=cfg.num_classes, dir_offset=cfg.dir_offset,
            score_thr=cfg.score_thr, nms_thr=cfg.nms_thr,
            nms_pre=cfg.nms_pre, max_num=cfg.max_num)
