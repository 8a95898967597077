"""MultiViewDfM (MV-FCOS3D++) in the camsync configuration: inference
and training.

Port of `dfm_tpu/models/detectors/multiview_dfm.py:33-279, 304-317`
(reference mmdet3d/models/detectors/multiview_dfm.py:14-353): one
ResNet + FPN trunk over the B*F*V images, its stride-4 level 0; a 3D
grid of sample points (the aligned anchor generator's voxel centres,
(Nz, Ny, Nx) in (x, y, z)) projected into every view; each point's
feature bilinearly sampled where it lies in front of the camera and
inside the (padded) image, summed over the views and divided by the
number of views that saw it, then averaged over the frames; the volume
in (z, y, x) order through `OutdoorImVoxelNeck` to a 256-channel BEV map
and the anchor head (no towers) to class, box and direction maps.

The views are sampled one at a time into one (C, P) float32 sum, so the
V sampled volumes never exist at once. Training (`forward_train`,
`mvdfm_loss`) is the camsync branch of JAX's `mvdfm_loss`: the anchor
head's loss without the IoU term. The other options of the JAX model
(frame_fusion='concat' with neck_3d='dfm', bbox_head='center',
with_backbone_3d, with_depth_head) and their loss branches (CenterHead,
the dense depth loss) are not ported and raise NotImplementedError
(ROADMAP.md §1, Slice C).
"""

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ...core.anchors import (AlignedAnchor3DRangeGenerator,
                             Anchor3DRangeGenerator)
from ...core.transforms import transform_points
from ...ops.point_sample import point_sample
from ..backbones.resnet import ResNet, stage_channels
from ..heads.anchor3d_head import (LIGAAnchor3DHead,
                                   anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..necks.fpn import FPN
from ..necks.imvoxel_neck import OutdoorImVoxelNeck

__all__ = ['MVDfMConfig', 'MultiViewDfM', 'mvdfm_loss', 'mvdfm_predict']


@dataclasses.dataclass(frozen=True)
class MVDfMConfig:
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

    def sample_points(self):
        """(Nz, Ny, Nx, 3) float32 sample-grid centres (x, y, z)."""
        gen = AlignedAnchor3DRangeGenerator(
            ranges=[list(self.voxel_range)], sizes=[[1, 1, 1]],
            rotations=[0.0])
        a = gen.anchors_single_range(self.voxel_grid, self.voxel_range,
                                     [1, 1, 1])
        return a[:, :, :, 0, 0, :3]

    def anchor_generator(self):
        return Anchor3DRangeGenerator(
            ranges=list(self.anchor_ranges), sizes=list(self.anchor_sizes),
            rotations=list(self.anchor_rotations))


def _check_ported(cfg):
    waiting = []
    if cfg.frame_fusion != 'mean' or cfg.neck_3d != 'imvoxel':
        waiting.append("frame_fusion='concat' / neck_3d='dfm' (DfMNeck, "
                       'the 10-sweeps config)')
    if cfg.bbox_head != 'anchor':
        waiting.append("bbox_head='center' (CenterHead)")
    if cfg.with_backbone_3d or cfg.with_depth_head:
        waiting.append('with_backbone_3d / with_depth_head (voxel_sample, '
                       'dfm_tpu/ops/frustum.py:508)')
    if waiting:
        raise NotImplementedError(
            'MultiViewDfM options not ported to dfm_tpu_torch: '
            + '; '.join(waiting))


class MultiViewDfM(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or MVDfMConfig()
        _check_ported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = ResNet(cfg.backbone_depth)
        self.neck = FPN(stage_channels(cfg.backbone_depth),
                        cfg.feat_channels, num_outs=4)
        self.neck_3d = OutdoorImVoxelNeck(cfg.feat_channels, 256, 'bn',
                                          dtype)
        self.bbox_head_3d = LIGAAnchor3DHead(
            cfg.num_classes, 256, 256,
            len(cfg.anchor_sizes) * len(cfg.anchor_rotations),
            num_convs=0, norm='none')
        self._points = {}

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

    def grid_points(self, device):
        """The sample points, (Nz * Ny * Nx, 3) float32 on `device`."""
        key = str(device)
        if key not in self._points:
            self._points[key] = torch.as_tensor(
                self.cfg.sample_points().reshape(-1, 3), device=device)
        return self._points[key]

    def sample_volume(self, feat0, lidar2img, img_hw):
        """Level-0 features (B, F, V, C, fh, fw) and lidar2img (B, F, V,
        4, 4) -> the float32 volume (B, C, Nz, Ny, Nx): per point the
        mean over the views that see it (in front of the camera, inside
        the (H, W) image), then the mean over the frames."""
        b, f, v, c, fh, fw = feat0.shape
        h, w = img_hw
        pts = self.grid_points(feat0.device)
        # true divisions by tensors (a CUDA tensor divided by a Python
        # number is multiplied by its reciprocal)
        img_max = pts.new_tensor([w - 1, h - 1])
        feat_max = pts.new_tensor([fw - 1, fh - 1])
        vols = []
        for bi in range(b):
            frames = []
            for fi in range(f):
                acc = pts.new_zeros(c, pts.shape[0])
                count = pts.new_zeros(pts.shape[0])
                for vi in range(v):
                    uvw = transform_points(pts, lidar2img[bi, fi, vi].float())
                    depth = uvw[:, 2]
                    uv = uvw[:, :2] / depth.abs().clamp(min=1e-5)[:, None]
                    valid = ((depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
                             & (uv[:, 1] >= 0) & (uv[:, 1] < h))
                    coords = uv / img_max * feat_max
                    acc += point_sample(feat0[bi, fi, vi], coords, valid)
                    count += valid
                frames.append(acc / count.clamp(min=1.0))
            vols.append(torch.stack(frames).mean(0) if f > 1 else frames[0])
        nz, ny, nx = self.cfg.voxel_grid
        return torch.stack(vols).reshape(b, c, nz, ny, nx)

    def forward_train(self, imgs, lidar2img, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `mvdfm_loss` on gt's 'gt_boxes' (B, G, 7)
        (vehicle frame), 'gt_labels' and 'gt_mask' -> (total, dict of
        terms). `generator` and `depth_pix_idx` (`TrainStep`'s) are not
        used: the camsync branch has no depth loss."""
        return mvdfm_loss(self(imgs, lidar2img), gt, self.cfg)

    def forward(self, imgs, lidar2img, img_hw=None):
        """imgs (B, F, V, H, W, 3) normalised, the current frame first;
        lidar2img (B, F, V, 4, 4) from the current vehicle frame (earlier
        frames rewritten by ego-motion); img_hw the image extent that
        counts as inside (the padded (H, W) if None).

        Returns dict of the head outputs (B, Ny, Nx, A * X), 'bev_feat'
        (B, Ny, Nx, 256) and 'volume_feat' (B, Nz, Ny, Nx, C), channels
        last as in the JAX package (views of the NC... tensors)."""
        img_hw = img_hw or tuple(imgs.shape[3:5])
        with record_function('mvdfm.image_features'):
            feat0 = self.image_features(imgs)
        with record_function('mvdfm.sample_volume'):
            vol = self.sample_volume(feat0, lidar2img, img_hw)
        with record_function('mvdfm.neck_3d'):
            bev = self.neck_3d(vol)
        with record_function('mvdfm.bbox_head_3d'):
            cls_score, bbox_pred, dir_pred = self.bbox_head_3d(bev)
        return dict(cls_score=cls_score, bbox_pred=bbox_pred,
                    dir_pred=dir_pred, bev_feat=bev.permute(0, 2, 3, 1),
                    volume_feat=vol.permute(0, 2, 3, 4, 1))


@functools.lru_cache(maxsize=4)
def _flat_anchors(ranges, sizes, rotations, ny, nx, device):
    grid = Anchor3DRangeGenerator(list(ranges), list(sizes),
                                  list(rotations)).grid_anchors((ny, nx))
    return torch.as_tensor(grid.reshape(-1, 7), device=device)


def mvdfm_anchors_per_class(cfg: MVDfMConfig, featmap_size, device):
    """The (Ny * Nx * R, 7) anchors of each class in the head's (y, x,
    rot) order (`_mv_anchors`)."""
    grid = cfg.anchor_generator().grid_anchors(tuple(featmap_size))
    return [torch.as_tensor(grid[0, :, :, c].reshape(-1, 7), device=device)
            for c in range(len(cfg.anchor_sizes))]


def mvdfm_loss(outputs, gt, cfg: MVDfMConfig):
    """The camsync branch of JAX's `mvdfm_loss` (`multiview_dfm.py:264-
    279`): `anchor3d_head_loss` on the anchor head's outputs with the
    per-class anchors, no IoU term and the weights (1.0, 2.0, 0.2, 0.0)
    for cls, bbox, dir, iou; in a process group its normaliser is the
    global batch's positives (`dist_norm`).

    Args:
        outputs: `MultiViewDfM.forward`'s.
        gt: 'gt_boxes' (B, G, 7) in the vehicle frame, 'gt_labels' (B, G),
            'gt_mask' (B, G). Outputs with a 'depth_cost' (the
            voxel_sample path's dense depth loss) or 'task_outs'
            (CenterHead) are refused: not ported.

    Returns:
        (total, dict loss_cls, loss_bbox, loss_dir).
    """
    if 'task_outs' in outputs:
        raise NotImplementedError(
            "mvdfm_loss: the CenterHead branch (bbox_head='center') is not "
            'ported to dfm_tpu_torch (ROADMAP.md §1, Slice C)')
    if 'depth_cost' in outputs:
        raise NotImplementedError(
            "mvdfm_loss: the dense depth loss (with_depth_head's "
            'voxel_sample path) is not ported to dfm_tpu_torch (ROADMAP.md '
            '§1, Slice C)')
    ny, nx = outputs['cls_score'].shape[1:3]
    losses = anchor3d_head_loss(
        (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred']),
        mvdfm_anchors_per_class(cfg, (ny, nx), outputs['cls_score'].device),
        gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
        list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
        dir_offset=cfg.dir_offset, loss_weights=(1.0, 2.0, 0.2, 0.0),
        use_iou_loss=False, dist_norm=True)
    return sum(losses.values()), losses


def mvdfm_predict(outputs, cfg: MVDfMConfig):
    """Decode + NMS of the anchor head: padded detections (B, max_num,
    ...) in the lidar (vehicle) frame."""
    ny, nx = outputs['cls_score'].shape[1:3]
    anchors = _flat_anchors(cfg.anchor_ranges, cfg.anchor_sizes,
                            cfg.anchor_rotations, ny, nx,
                            str(outputs['cls_score'].device))
    with record_function('mvdfm.predict'):
        return anchor3d_head_get_bboxes(
            (outputs['cls_score'], outputs['bbox_pred'],
             outputs['dir_pred']),
            anchors, num_classes=cfg.num_classes, dir_offset=cfg.dir_offset,
            score_thr=cfg.score_thr, nms_thr=cfg.nms_thr,
            nms_pre=cfg.nms_pre, max_num=cfg.max_num)
