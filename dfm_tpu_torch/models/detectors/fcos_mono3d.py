"""FCOS3D single-stage monocular detector.

Port of `dfm_tpu/models/detectors/fcos_mono3d.py` (the reference's
`FCOSMono3D` over `SingleStageMono3DDetector`): ResNet (BatchNorm) ->
FPN from stage 1 (strides 8-32 in, five levels out: two stride-2 extra
convs, a ReLU before the second) -> `FCOSMono3DHead`; the loss and the
decode are the head's functions on the level points of the input size.
Keys: backbone.*, neck.*, bbox_head.*.
"""

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..backbones.resnet import ResNet, stage_channels
from ..heads.fcos_mono3d import (FCOS3DConfig, FCOSMono3DHead,
                                 fcos3d_get_bboxes, fcos3d_loss,
                                 level_points)
from ..necks.fpn import FPN

__all__ = ['FCOSMono3D', 'MonoDetector', 'mono_level_points',
           'fcos_mono3d_loss', 'fcos_mono3d_predict']


def mono_level_points(img_hw, cfg):
    """Per level the (P_l, 2) numpy points of an (H, W) input."""
    h, w = img_hw
    return [level_points(((h + s - 1) // s, (w + s - 1) // s), s)
            for s in cfg.strides]


def fcos_mono3d_loss(level_outs, img_hw, batch, cfg):
    """(total, dict of terms) of a batch dict of gt tensors."""
    losses = fcos3d_loss(level_outs, mono_level_points(img_hw, cfg), cfg,
                         batch)
    return sum(losses.values()), losses


def fcos_mono3d_predict(level_outs, img_hw, cam2img, cfg):
    """Padded camera-frame detections of the head's outputs."""
    with record_function('mono.predict'):
        return fcos3d_get_bboxes(level_outs, mono_level_points(img_hw, cfg),
                                 cam2img, cfg)


class MonoDetector(nn.Module):
    """ResNet -> FPN -> a mono head; `forward(img)` takes (B, H, W, 3)
    normalised images (channels last, as the JAX package) and returns the
    head's per-level dicts; `forward_train(img, cam2img, gt)` the loss
    (the train step's (inputs, cond, gt)); `predict(outs, img_hw,
    cam2img)` the padded detections."""

    head_class = None

    def __init__(self, cfg, backbone_depth=101, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = ResNet(backbone_depth)
        self.neck = FPN(stage_channels(backbone_depth), cfg.in_channels,
                        num_outs=5, start_level=1)
        self.bbox_head = self.head_class(cfg)

    def features(self, img):
        """(B, H, W, 3) -> the five FPN levels (B, C, H_l, W_l)."""
        with record_function('mono.trunk'):
            return self.neck(self.backbone(
                img.permute(0, 3, 1, 2).to(self.dtype)))

    def forward(self, img):
        feats = self.features(img)
        with record_function('mono.head'):
            return self.bbox_head(feats)

    def loss(self, outs, img_hw, gt, cam2img):
        return fcos_mono3d_loss(outs, img_hw, gt, self.cfg)

    def predict(self, outs, img_hw, cam2img):
        """The padded camera-frame detections of the head's outputs."""
        return fcos_mono3d_predict(outs, img_hw, cam2img, self.cfg)

    def forward_train(self, img, cam2img, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and the loss on gt's 'gt_bboxes2d',
        'centers2d', 'gt_depths', 'gt_boxes_cam', 'gt_labels', 'gt_mask'
        -> (total, dict of terms); `generator` / `depth_pix_idx`
        (`TrainStep`'s) are not used."""
        return self.loss(self(img), tuple(img.shape[1:3]), gt, cam2img)


class FCOSMono3D(MonoDetector):
    head_class = FCOSMono3DHead

    def __init__(self, cfg=None, backbone_depth=101, dtype=torch.float32):
        super().__init__(cfg or FCOS3DConfig(), backbone_depth, dtype)
