"""LiDAR-feature imitation: the student's adapters and the loss.

Port of `dfm_tpu/models/detectors/imitation.py:28-93` (the reference's
`_init_imitation_layers`, `get_imitation_reg_layer_loss`, cw_scale
`NormalizeLayer` and `WeightedL2WithSigmaLoss`, dfm.py:213-262,
:468-540): a learnable 1x1 conv on the student's features, the
teacher's features scaled per channel, and a weighted L2 inside the gt
boxes (a BEV point-in-rotated-box test at the cells) where the teacher
has support, over a clamped normaliser. Features are channels-last, as
the JAX package's.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.boxes import points_in_rotated_boxes_bev
from ..heads.anchor3d_head import _dist_mean

__all__ = ['ImitationAdapter', 'cw_scale_normalize', 'imitation_mask',
           'imitation_loss']


class ImitationAdapter(nn.Module):
    """1x1 (ndim 2) or 1x1x1 (ndim 3) conv with a bias on channels-last
    (B, ..., C) features; the weight in the conv layout (O, I, 1...)."""

    def __init__(self, channels, ndim=2):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((channels, channels) +
                                               (1,) * ndim))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return F.linear(x, self.weight.flatten(1).to(x.dtype),
                        self.bias.to(x.dtype))


def cw_scale_normalize(feat, eps=1e-6):
    """Each channel of each sample divided by its mean absolute value
    over the spatial axes (reference NormalizeLayer('cw_scale'))."""
    dims = tuple(range(1, feat.dim() - 1))
    scale = feat.abs().mean(dims, keepdim=True)
    return feat / torch.clamp(scale, min=eps)


def imitation_mask(teacher_feat, centers_xy, gt_boxes, gt_mask):
    """(B, ...) bool: the cells (every z of a volume) whose BEV point lies
    in a valid gt box and where the teacher has support (reference:
    any(features != 0))."""
    b = teacher_feat.shape[0]
    spatial = teacher_feat.shape[1:-1]
    inside = torch.stack([
        (points_in_rotated_boxes_bev(centers_xy, gb) & gm.bool()[None]).any(-1)
        for gb, gm in zip(gt_boxes, gt_mask)])               # (B, Ny*Nx)
    if len(spatial) == 3:               # a volume: the same mask at every z
        pos = inside[:, None].expand(b, spatial[0], -1).reshape(
            (b,) + spatial)
    else:
        pos = inside.reshape((b,) + spatial)
    return pos & (teacher_feat != 0).any(-1)


def imitation_loss(student_feat, teacher_feat, centers_xy, gt_boxes, gt_mask,
                   normalizer_clamp_value=10.0, dist_norm=False):
    """In-box masked weighted-L2 feature distillation.

    Args:
        student_feat: (B, Ny, Nx, C) or (B, Nz, Ny, Nx, C) adapter output.
        teacher_feat: the same shape, no gradient.
        centers_xy: (Ny * Nx, 2) BEV cell centres (`bev_cell_centers`).
        gt_boxes: (B, G, 7); gt_mask: (B, G).
        dist_norm: average the normaliser over the process group.

    Returns:
        the scalar loss.
    """
    teacher_feat = teacher_feat.detach()
    b = student_feat.shape[0]
    teacher_n = cw_scale_normalize(teacher_feat)
    weights = imitation_mask(teacher_feat, centers_xy, gt_boxes,
                             gt_mask).float()
    normalizer = weights.sum() / b
    if dist_norm:
        normalizer = _dist_mean(normalizer)
    weights = weights / torch.clamp(normalizer, min=normalizer_clamp_value)
    diff = student_feat.float() - teacher_n.float()
    loss = 0.5 * (diff * diff).mean(-1) * weights
    return loss.sum() / b
