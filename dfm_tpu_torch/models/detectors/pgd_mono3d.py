"""PGD monocular detector: ResNet + FPN + `PGDHead`.

Port of `dfm_tpu/models/detectors/pgd_mono3d.py` (the reference's PGD
configuration of `SingleStageMono3DDetector`); the decode is FCOS3D's on
the fused depth. Keys: backbone.*, neck.*, bbox_head.fcos3d.*,
bbox_head.* (the PGD branches).
"""

import torch

from ..heads.pgd import PGDConfig, PGDHead, pgd_loss
from .fcos_mono3d import (MonoDetector, fcos_mono3d_predict,
                          mono_level_points)

__all__ = ['PGDMono3D', 'pgd_mono3d_loss', 'pgd_mono3d_predict']


def pgd_mono3d_loss(level_outs, img_hw, batch, cfg, cam2img=None):
    """(total, dict of terms); `cam2img` (B, 3|4, 4) enables the
    keypoint and consistency terms."""
    losses = pgd_loss(level_outs, mono_level_points(img_hw, cfg), cfg,
                      batch, cam2img=cam2img)
    return sum(losses.values()), losses


pgd_mono3d_predict = fcos_mono3d_predict


class PGDMono3D(MonoDetector):
    head_class = PGDHead

    def __init__(self, cfg=None, backbone_depth=101, dtype=torch.float32):
        super().__init__(cfg or PGDConfig(), backbone_depth, dtype)

    def loss(self, outs, img_hw, gt, cam2img):
        return pgd_mono3d_loss(outs, img_hw, gt, self.cfg, cam2img)
