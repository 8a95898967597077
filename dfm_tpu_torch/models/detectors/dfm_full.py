"""DfMFull: the DfM student trained beside a 2D ATSS auxiliary head and a
frozen LiDAR teacher it imitates.

Port of `dfm_tpu/models/detectors/dfm_full.py:32-114` and
`dfm_with_teacher.py:66` (`bev_cell_centers`): the reference's whole
`DfM.forward_train` (mmdet3d dfm.py:300-371): the 3D anchor head and the
dense depth loss of `dfm_loss`, an FPN over the stride-4 semantic
features into the ATSS head (dfm.py:330-347), and the imitation of the
teacher's volume and BEV features (dfm.py:358-370). Submodules carry the
JAX names: dfm (the student in float32, the banded form, the keys of
`DfM`), neck_2d, bbox_head_2d, lidar_teacher, imit_bev, imit_vol, so
that the optimizer leaves out the teacher by the prefix
'lidar_teacher'. Inference is the student alone (`dfm_predict` on the
`dfm` outputs).

The teacher runs only when points are given, under `no_grad` (JAX stops
its gradient); in train mode its BatchNorm normalises with the batch
statistics and updates its running statistics, as JAX's does. The loss
skips the 2D terms without 2D targets and the imitation without points
(dfm_full.py:87, 97).
"""

import numpy as np
import torch
import torch.nn as nn

from ..heads.atss2d import ATSS2DConfig, ATSS2DHead, atss2d_loss
from ..necks.fpn import FPN
from .dfm import DfM, DfMConfig, dfm_loss
from .imitation import ImitationAdapter, imitation_loss
from .teacher import LidarTeacher

__all__ = ['DfMFull', 'dfm_full_loss', 'bev_cell_centers']


class DfMFull(nn.Module):
    def __init__(self, cfg: DfMConfig = DfMConfig(),
                 atss_cfg: ATSS2DConfig = ATSS2DConfig(feat_channels=64)):
        super().__init__()
        self.cfg = cfg
        self.atss_cfg = atss_cfg
        self.dfm = DfM(cfg)
        self.neck_2d = FPN(cfg.sem_channels[1], atss_cfg.in_channels)
        self.bbox_head_2d = ATSS2DHead(atss_cfg)
        self.lidar_teacher = LidarTeacher(
            cfg.point_cloud_range, cfg.voxel_size,
            volume_channels=cfg.cv_channels, bev_channels=cfg.bev_channels)
        self.imit_bev = ImitationAdapter(cfg.bev_channels, 2)
        self.imit_vol = ImitationAdapter(cfg.cv_channels, 3)

    @property
    def student(self):
        """The model inference runs: `dfm`."""
        return self.dfm

    def anchors_per_class(self, featmap_size, device):
        return self.dfm.anchors_per_class(featmap_size, device)

    def forward_train(self, img, meta, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass, the teacher fed gt's 'points' and
        'point_mask' where it has them, and `dfm_full_loss` (gt,
        generator and depth_pix_idx as there) -> (total, dict of
        terms)."""
        out = self(img, meta, gt.get('points'), gt.get('point_mask'))
        anchors = self.anchors_per_class(out['cls_score'].shape[1:3],
                                         out['cls_score'].device)
        return dfm_full_loss(out, gt, self.cfg, self.atss_cfg,
                             tuple(img.shape[2:4]), anchors, generator,
                             depth_pix_idx)

    def forward(self, img, meta, points=None, point_mask=None):
        """`DfM.forward`'s outputs, + 'outs_2d' (the ATSS levels) and,
        given points (B, P, 3) and their mask (B, P), 'imitation': the
        adapted student features and the teacher's (bev_pred /
        bev_target (B, Ny, Nx, C2), volume_pred / volume_target (B, Nz',
        Ny, Nx, C))."""
        out = self.dfm(img, meta)
        fpn = self.neck_2d(out['sem_feat'].permute(0, 3, 1, 2))
        out['outs_2d'] = self.bbox_head_2d(fpn)
        if points is not None:
            with torch.no_grad():
                t_vol, t_bev = self.lidar_teacher(points.float(), point_mask)
            out['imitation'] = dict(
                bev_pred=self.imit_bev(out['bev_feat']), bev_target=t_bev,
                volume_pred=self.imit_vol(out['volume_feat']),
                volume_target=t_vol)
        return out


def bev_cell_centers(cfg: DfMConfig):
    """(Ny * Nx, 2) points of the in-box imitation masks: a linspace
    over the first anchor range, ends included (the reference takes the
    first anchor's centres, dfm.py:480-487), numpy float32."""
    nz, ny, nx = cfg.voxel_grid_size()
    r = cfg.anchor_ranges[0]
    xs = np.linspace(r[0], r[3], nx, dtype=np.float32)
    ys = np.linspace(r[1], r[4], ny, dtype=np.float32)
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    return np.stack([xx, yy], -1).reshape(-1, 2)


def dfm_full_loss(outputs, gt, cfg: DfMConfig, atss_cfg: ATSS2DConfig,
                  img_hw, anchors_per_class, generator=None,
                  depth_pix_idx=None):
    """Every training term of the reference's forward_train: `dfm_loss`'s,
    the ATSS terms where `gt` has 'gt_bboxes2d' and 'centers2d' (the
    projected 3D centres, the reference's append_3d_centers), and
    'loss_imitation' (BEV + volume) where the outputs hold 'imitation'.

    Args as `dfm_loss`, + atss_cfg and img_hw (the input's (H, W)); the
    normalisers are those of the global batch of a process group where
    `cfg.dist_norm` (`dfm_loss`).

    Returns:
        (total, dict of scalar terms).
    """
    dist_norm = cfg.dist_norm
    total, losses = dfm_loss(outputs, gt, cfg, anchors_per_class, generator,
                             depth_pix_idx)
    if 'outs_2d' in outputs and gt.get('gt_bboxes2d') is not None:
        l2d = atss2d_loss(outputs['outs_2d'], img_hw, gt, atss_cfg,
                          dist_norm)
        losses.update(l2d)
        total = total + sum(l2d.values())
    if 'imitation' in outputs:
        im = outputs['imitation']
        centers = torch.as_tensor(bev_cell_centers(cfg),
                                  device=im['bev_pred'].device)
        terms = [imitation_loss(im[f'{k}_pred'], im[f'{k}_target'], centers,
                                gt['gt_boxes'], gt['gt_mask'],
                                cfg.normalizer_clamp_value, dist_norm)
                 for k in ('bev', 'volume')]
        losses['loss_imitation'] = terms[0] + terms[1]
        total = total + losses['loss_imitation']
    return total, losses
