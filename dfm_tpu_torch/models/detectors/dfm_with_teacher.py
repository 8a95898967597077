"""DfMWithTeacher: the DfM student, a frozen LiDAR teacher and the
imitation adapters (the training composite without DfMFull's 2D head).

Port of `dfm_tpu/models/detectors/dfm_with_teacher.py:24-97` (the pieces
the reference wires into `DfM` when `lidar_model` / `imitation_cfgs` are
set, detectors/dfm.py:72-109, 358-370). `teacher_encoder` picks the
teacher: 'dense' (`LidarTeacher`, the 0.2 m substitute) or 'sparse'
(`SparseLidarTeacher`, the reference's 0.05 m sparse encoder, whose
weights the SECOND converter writes,
`tools/model_converters/convert_second_checkpoints.py`; its dense
output, (5, 304, 288), is the full DfMConfig's imitation grid). Module
names are JAX's: dfm (float32), lidar_teacher, imit_bev, imit_vol
(`utils/weights.py:dfm_with_teacher_key_map`).

The teacher runs with the model's mode (JAX passes it `train`: in train
mode its BatchNorms normalise with the batch's moments and update their
running statistics) under `no_grad` (JAX's stop_gradient on its
outputs). It is frozen as JAX's `make_optimizer(frozen_prefixes=
('lidar_teacher',))` freezes it: `runtime/train.py:make_optimizer` with
that prefix leaves its parameters out of the update and the decay, and
`TrainStep` reports the gradient norm over all of them (the teacher's
are 0), as optax does.
"""

import torch
import torch.nn as nn

from .dfm import DfM, DfMConfig, dfm_loss
from .dfm_full import bev_cell_centers
from .imitation import ImitationAdapter, imitation_loss
from .teacher import LidarTeacher, SparseLidarTeacher

__all__ = ['DfMWithTeacher', 'bev_cell_centers', 'dfm_loss_with_imitation',
           'TEACHER_ENCODERS']

TEACHER_ENCODERS = ('dense', 'sparse')


class DfMWithTeacher(nn.Module):
    def __init__(self, cfg: DfMConfig = DfMConfig(), teacher_encoder='dense',
                 dtype=torch.float32):
        super().__init__()
        if teacher_encoder not in TEACHER_ENCODERS:
            raise ValueError(f'teacher_encoder {teacher_encoder!r}: one of '
                             f'{TEACHER_ENCODERS}')
        self.cfg = cfg
        self.teacher_encoder = teacher_encoder
        self.dfm = DfM(cfg, dtype=dtype)
        if teacher_encoder == 'sparse':
            self.lidar_teacher = SparseLidarTeacher(
                cfg.point_cloud_range, bev_channels=cfg.bev_channels,
                dtype=dtype)
        else:
            self.lidar_teacher = LidarTeacher(
                cfg.point_cloud_range, cfg.voxel_size,
                volume_channels=cfg.cv_channels,
                bev_channels=cfg.bev_channels, dtype=dtype)
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
        'point_mask' where it has them, and `dfm_loss_with_imitation` ->
        (total, dict of terms)."""
        out = self(img, meta, gt.get('points'), gt.get('point_mask'))
        anchors = self.anchors_per_class(out['cls_score'].shape[1:3],
                                         out['cls_score'].device)
        return dfm_loss_with_imitation(out, gt, self.cfg, anchors, generator,
                                       depth_pix_idx)

    def forward(self, img, meta, points=None, point_mask=None):
        """`DfM.forward`'s outputs and, given points (B, P, 3) and their
        mask (B, P), 'imitation': the adapted student features and the
        teacher's (bev_pred / bev_target (B, Ny, Nx, C2), volume_pred /
        volume_target (B, Nz', Ny, Nx, C))."""
        out = self.dfm(img, meta)
        if points is not None:
            with torch.no_grad():
                t_vol, t_bev = self.lidar_teacher(points.float(), point_mask)
            out['imitation'] = dict(
                bev_pred=self.imit_bev(out['bev_feat']), bev_target=t_bev,
                volume_pred=self.imit_vol(out['volume_feat']),
                volume_target=t_vol)
        return out


def dfm_loss_with_imitation(outputs, gt, cfg: DfMConfig, anchors_per_class,
                            generator=None, depth_pix_idx=None,
                            imitation_weight=1.0):
    """`dfm_loss`'s terms + 'loss_imitation' (the BEV and the volume
    pairs, each `imitation_loss`, times `imitation_weight`) where the
    outputs hold 'imitation'; normalisers over the global batch of a
    process group where `cfg.dist_norm` -> (total, dict of terms)."""
    total, losses = dfm_loss(outputs, gt, cfg, anchors_per_class, generator,
                             depth_pix_idx)
    if 'imitation' in outputs:
        im = outputs['imitation']
        centers = torch.as_tensor(bev_cell_centers(cfg),
                                  device=im['bev_pred'].device)
        terms = [imitation_loss(im[f'{k}_pred'], im[f'{k}_target'], centers,
                                gt['gt_boxes'], gt['gt_mask'],
                                cfg.normalizer_clamp_value, cfg.dist_norm)
                 for k in ('bev', 'volume')]
        losses['loss_imitation'] = imitation_weight * (terms[0] + terms[1])
        total = total + losses['loss_imitation']
    return total, losses
