"""Detection losses. Port of `dfm_tpu/core/losses.py:18-129`: plain
vectorised math with explicit weights and avg_factor, so batched,
masked (static-shape) training works."""

import torch
import torch.nn.functional as F

from .iou import _at_least, paired_iou_3d

__all__ = ['sigmoid_focal_loss', 'smooth_l1_loss', 'softmax_cross_entropy',
           'binary_cross_entropy', 'iou3d_loss', 'giou_loss_2d']


def _reduce(loss, weights, avg_factor):
    if weights is not None:
        loss = loss * weights
    total = loss.sum()
    return total if avg_factor is None else total / avg_factor


def sigmoid_focal_loss(logits, labels, weights=None, alpha=0.25, gamma=2.0,
                       avg_factor=None):
    """Multi-class sigmoid focal loss; logits (..., C), integer labels
    (...,) in [0, C] where C means background."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes] \
        .to(logits.dtype) > 0
    p = torch.sigmoid(logits)
    pt = torch.where(onehot, p, 1 - p)
    alpha_t = torch.where(onehot, torch.full_like(p, alpha),
                          torch.full_like(p, 1 - alpha))
    ce = -torch.where(onehot, F.logsigmoid(logits), F.logsigmoid(-logits))
    loss = (alpha_t * (1 - pt) ** gamma * ce).sum(-1)
    return _reduce(loss, weights, avg_factor)


def smooth_l1_loss(pred, target, weights=None, beta=1.0 / 9.0,
                   avg_factor=None):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    return _reduce(loss, weights, avg_factor)


def softmax_cross_entropy(logits, labels, weights=None, avg_factor=None):
    """Cross entropy with integer labels over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return _reduce(nll, weights, avg_factor)


def binary_cross_entropy(logits, targets, weights=None, avg_factor=None):
    """Sigmoid cross entropy with soft targets, in JAX's stable form
    max(x, 0) - x * t + log1p(exp(-|x|))."""
    loss = _at_least(logits, 0.0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    return _reduce(loss, weights, avg_factor)


def iou3d_loss(pred_boxes, target_boxes, weights=None, avg_factor=None):
    """1 - rotated 3D IoU of matched (N, 7) pairs. Weights select with a
    hard where, not a multiply: the rotated clip can emit inf / NaN on
    degenerate pairs and 0 * inf would poison the sum."""
    loss = 1.0 - paired_iou_3d(pred_boxes, target_boxes)
    if weights is not None:
        loss = torch.where(weights > 0, loss * weights,
                           torch.zeros_like(loss))
    total = loss.sum()
    return total if avg_factor is None else total / avg_factor


def giou_loss_2d(pred, target, weights=None, avg_factor=None):
    """1 - GIoU of matched (..., 4) xyxy boxes (the 2D auxiliary head)."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = _at_least(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    ap = _at_least(pred[..., 2] - pred[..., 0], 0.0) * \
        _at_least(pred[..., 3] - pred[..., 1], 0.0)
    at = _at_least(target[..., 2] - target[..., 0], 0.0) * \
        _at_least(target[..., 3] - target[..., 1], 0.0)
    union = ap + at - inter
    iou = inter / _at_least(union, 1e-7)
    # smallest enclosing box
    elt = torch.minimum(pred[..., :2], target[..., :2])
    erb = torch.maximum(pred[..., 2:], target[..., 2:])
    ewh = _at_least(erb - elt, 0.0)
    enclose = _at_least(ewh[..., 0] * ewh[..., 1], 1e-7)
    giou = iou - (enclose - union) / enclose
    return _reduce(1.0 - giou, weights, avg_factor)
