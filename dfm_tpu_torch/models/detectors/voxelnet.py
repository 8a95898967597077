"""VoxelNet (SECOND): the LiDAR detector that is also DfM's teacher.

Port of `dfm_tpu/models/detectors/voxelnet.py:25-162` (reference
mmdet3d voxelnet.py: Voxelization -> HardSimpleVFE -> middle encoder ->
BEV backbone -> Anchor3DHead): the scatter-mean voxelization, dense 3D
encoder and BEV hourglass of `LidarTeacher` (module `encoder`; a cap of
`max_points_per_voxel` points a voxel, SECOND's 5, or all of them for
None), then the LIGA anchor head with two GroupNorm towers
(`bbox_head`). Outputs are channels-last, as the JAX package's.

`bbox_head` picks the loss: 'anchor3d' (`anchor3d_head_loss`, MaxIoU
assignment per class) or 'free_anchor' (`heads/free_anchor3d.py`, on the
same tower). 'shape_aware' (SSN's ShapeAwareHead, Lyft only) raises
NotImplementedError: it comes with the Lyft slice (ROADMAP). Its anchor
helpers `_task_of_class` and `_shape_aware_anchors` are here already.
`voxelnet_predict` is the head's decode + NMS on the grid's anchors.
"""

import dataclasses
import functools
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..heads.anchor3d_head import (LIGAAnchor3DHead,
                                   anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..heads.free_anchor3d import free_anchor3d_loss
from .dfm import DfMConfig
from .teacher import LidarTeacher

__all__ = ['VoxelNetConfig', 'VoxelNet', 'voxelnet_loss', 'voxelnet_predict',
           'BBOX_HEADS']

BBOX_HEADS = ('anchor3d', 'free_anchor')


@dataclasses.dataclass(frozen=True)
class VoxelNetConfig(DfMConfig):
    """The fields of the JAX `VoxelNetConfig`: `DfMConfig`'s (anchors,
    assigners, test settings of the KITTI 3-class setup), the hard
    voxelization's cap (None: dynamic), the head family and FreeAnchor's
    bag size and IoU threshold."""
    max_points_per_voxel: Any = None
    bbox_head: str = 'anchor3d'
    tasks: Tuple[Any, ...] = ()
    pre_anchor_topk: int = 50
    free_anchor_bbox_thr: float = 0.6


def check_bbox_head(cfg):
    if cfg.bbox_head == 'shape_aware':
        raise NotImplementedError(
            "VoxelNet bbox_head='shape_aware' (SSN's ShapeAwareHead, Lyft) is "
            'not ported yet: it comes with the Lyft slice')
    if cfg.bbox_head not in BBOX_HEADS:
        raise ValueError(f'VoxelNet bbox_head {cfg.bbox_head!r}: one of '
                         f'{BBOX_HEADS}')


class VoxelNet(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or VoxelNetConfig()
        check_bbox_head(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = LidarTeacher(
            cfg.point_cloud_range, cfg.voxel_size,
            volume_channels=cfg.cv_channels, bev_channels=cfg.bev_channels,
            max_points=cfg.max_points_per_voxel, dtype=dtype)
        self.bbox_head = LIGAAnchor3DHead(
            cfg.num_classes, cfg.bev_channels, cfg.bev_channels,
            len(cfg.anchor_sizes) * len(cfg.anchor_rotations), norm='gn')

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `voxelnet_loss` on gt's 'gt_boxes' (B, G,
        7), 'gt_labels', 'gt_mask' -> (total, dict of terms);
        `generator` / `depth_pix_idx` (TrainStep's) are not read."""
        return voxelnet_loss(self(points, point_mask), gt, self.cfg)

    def forward(self, points, point_mask):
        """points (B, P, 3+) and their mask (B, P) -> dict of the head's
        maps (B, Ny, Nx, A * X) 'cls_score', 'bbox_pred', 'dir_pred', and
        'volume_feat' (B, Nz / 4, Ny, Nx, C), 'bev_feat' (B, Ny, Nx, C2).
        Each voxel averages (x, y, z), the points' first three features
        (every source of the repo gives three)."""
        with record_function('voxelnet.encoder'):
            vol, bev = self.encoder(points[..., :3].float(), point_mask)
        with record_function('voxelnet.bbox_head'):
            cls, reg, dirs = self.bbox_head(bev.permute(0, 3, 1, 2))
        return dict(cls_score=cls, bbox_pred=reg, dir_pred=dirs,
                    volume_feat=vol, bev_feat=bev)


@functools.lru_cache(maxsize=8)
def _grid(ranges, sizes, rotations, featmap_size):
    cfg = DfMConfig(anchor_ranges=ranges, anchor_sizes=sizes,
                    anchor_rotations=rotations)
    return cfg.anchor_generator().grid_anchors(featmap_size)


def anchors_of(cfg, featmap_size, device):
    """(each class's (Ny * Nx * R, 7) anchors, all (Ny * Nx * S * R, 7)),
    in the head's order, on `device` (JAX `dfm.py:_anchors_per_class`)."""
    grid = _grid(tuple(map(tuple, cfg.anchor_ranges)),
                 tuple(map(tuple, cfg.anchor_sizes)),
                 tuple(cfg.anchor_rotations), tuple(featmap_size))
    per_class = [torch.as_tensor(grid[0, :, :, c].reshape(-1, 7),
                                 device=device)
                 for c in range(len(cfg.anchor_sizes))]
    return per_class, torch.as_tensor(grid.reshape(-1, 7), device=device)


def _task_of_class(cfg):
    """class index -> its task dict (the tasks list their classes in
    order)."""
    out = []
    for t in cfg.tasks:
        out.extend([t] * int(t['num_class']))
    return out


def _shape_aware_anchors(cfg, bev_hw, device=None):
    """Each class's flat anchors in ShapeAwareHead's anchor-major
    (rotation, y, x) layout, at its task's strided map size, and all of
    them concatenated (reference shape_aware_head.py:379-428)."""
    gen = cfg.anchor_generator()
    grids, per_class, blocks = {}, [], []
    ci = 0
    for t in cfg.tasks:
        stride = int(np.prod([int(s) for s in t['shared_conv_strides']]))
        hw = (bev_hw[0] // stride, bev_hw[1] // stride)
        if hw not in grids:
            grids[hw] = gen.grid_anchors(hw)       # (1, Ny, Nx, S, R, 7)
        for _ in range(int(t['num_class'])):
            a = np.asarray(grids[hw][0, :, :, ci])          # (Ny, Nx, R, 7)
            a = np.transpose(a, (2, 0, 1, 3)).reshape(-1, 7)
            per_class.append(torch.as_tensor(a, device=device))
            blocks.append(a)
            ci += 1
    return per_class, torch.as_tensor(np.concatenate(blocks, 0),
                                      device=device)


def voxelnet_loss(outputs, gt, cfg: VoxelNetConfig):
    """JAX's `voxelnet_loss`: 'anchor3d' -> `anchor3d_head_loss` (cls,
    bbox, dir and IoU terms at DfM's weights), 'free_anchor' ->
    `free_anchor3d_loss` (positive and negative bag terms); normalisers
    over the global batch of a process group where `cfg.dist_norm` ->
    (total, dict of terms)."""
    check_bbox_head(cfg)
    preds = (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred'])
    per_class, flat = anchors_of(cfg, outputs['cls_score'].shape[1:3],
                                 outputs['cls_score'].device)
    if cfg.bbox_head == 'free_anchor':
        losses = free_anchor3d_loss(
            preds, flat, gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
            num_classes=cfg.num_classes, pre_anchor_topk=cfg.pre_anchor_topk,
            bbox_thr=cfg.free_anchor_bbox_thr, dir_offset=cfg.dir_offset,
            dist_norm=cfg.dist_norm)
    else:
        losses = anchor3d_head_loss(
            preds, per_class, gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
            list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
            dir_offset=cfg.dir_offset,
            normalizer_clamp_value=cfg.normalizer_clamp_value,
            dist_norm=cfg.dist_norm)
    return sum(losses.values()), losses


def voxelnet_predict(outputs, cfg: VoxelNetConfig):
    """Decode + NMS -> the padded detections (B, max_num, ...) in the
    LiDAR frame: 'boxes3d' (bottom centre), 'scores', 'labels', 'mask'."""
    check_bbox_head(cfg)
    _, flat = anchors_of(cfg, outputs['cls_score'].shape[1:3],
                         outputs['cls_score'].device)
    with record_function('voxelnet.predict'):
        return anchor3d_head_get_bboxes(
            (outputs['cls_score'], outputs['bbox_pred'],
             outputs['dir_pred']),
            flat, num_classes=cfg.num_classes, dir_offset=cfg.dir_offset,
            score_thr=cfg.score_thr, nms_thr=cfg.nms_thr,
            nms_pre=cfg.nms_pre, max_num=cfg.max_num)
