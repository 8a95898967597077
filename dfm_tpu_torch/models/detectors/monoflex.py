"""MonoFlex monocular detector: DLA-34 + DLANeck (DCNv2) + MonoFlexHead.

Port of `dfm_tpu/models/detectors/monoflex.py` (`MonoFlex`,
`monoflex_predict`). `monoflex_predict` gives the padded camera-frame
dict of the other mono types ('boxes3d', 'scores', 'labels', 'mask':
score above `score_thr`) of `heads/monoflex.py:monoflex_decode`, which
holds JAX's per-sample decode.
"""

import torch
from torch.profiler import record_function

from ..heads.monoflex import (MonoFlexConfig, MonoFlexHead, monoflex_decode,
                              monoflex_loss)
from .smoke import DLAMonoDetector

__all__ = ['MonoFlex', 'MonoFlexConfig', 'monoflex_loss', 'monoflex_predict']


def monoflex_predict(outs, cam2img, cfg):
    """Padded camera-frame detections of every sample; `cam2img` (B, 3|4,
    4)."""
    with record_function('mono.predict'):
        det = monoflex_decode(outs, cam2img, cfg)
        return dict(boxes3d=det['boxes_3d'], scores=det['scores_3d'],
                    labels=det['labels_3d'],
                    mask=det['scores_3d'] > cfg.score_thr)


class MonoFlex(DLAMonoDetector):
    head_class = MonoFlexHead

    def __init__(self, cfg=None, backbone_depth=34, dtype=torch.float32):
        super().__init__(cfg or MonoFlexConfig(), backbone_depth, dtype, True)

    def loss(self, outs, gt, cam2img):
        return monoflex_loss(outs, gt, self.cfg, cam2img)

    def predict(self, outs, img_hw, cam2img):
        return monoflex_predict(outs, cam2img, self.cfg)
