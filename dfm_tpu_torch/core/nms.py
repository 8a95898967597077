"""Fixed-shape rotated-BEV NMS and multi-class 3D box post-processing.

Port of `dfm_tpu/core/nms.py:22-145`: candidates are pre-trimmed by
top-k, greedy suppression runs on the score-sorted pairwise IoU matrix
(as whole-matrix fixed-point steps, see `_greedy_suppress`), and outputs
are padded to `max_num` with a validity mask. All classes are suppressed
together.
"""

import torch

from .iou import rotated_iou_bev

__all__ = ['nms_bev', 'box3d_multiclass_nms']


def _greedy_suppress(iou, scores, iou_threshold):
    """Greedy NMS on an (N, N) IoU matrix for (..., N) scores (dead
    candidates -inf). Returns the (..., N) bool keep mask.

    In score order, box i survives iff it is live and no earlier kept box
    overlaps it: keep[i] = live[i] & ~any_{j<i}(keep[j] & over[j, i]).
    The whole vector is updated at once from keep = live until it stops
    changing. After t updates the first t entries equal the greedy
    result, and a fixed point satisfies the recurrence at every i, which
    determines it: the result is exactly the sequential greedy one, in a
    few whole-matrix steps instead of one step per candidate."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    s = scores.reshape(-1, n)
    order = torch.argsort(-s, dim=-1, stable=True)
    earlier = torch.ones(n, n, dtype=torch.bool,
                         device=s.device).triu(1)          # [j, i]: j < i
    over = (iou[order[:, :, None], order[:, None, :]] > iou_threshold) \
        & earlier                                          # (K, N, N)
    live = torch.isfinite(torch.gather(s, 1, order))       # sorted order

    def step(keep):
        return live & ~(over & keep[:, :, None]).any(1)

    keep = live
    while True:
        for _ in range(3):          # a few updates per convergence check
            keep = step(keep)
        nxt = step(keep)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out.reshape(lead + (n,))


def nms_bev(boxes_bev, scores, iou_threshold, valid_mask=None):
    """Rotated-BEV NMS over (N, 5) boxes; returns an (N,) keep mask."""
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores,
                             torch.full_like(scores, -torch.inf))
    keep = _greedy_suppress(rotated_iou_bev(boxes_bev, boxes_bev), scores,
                            iou_threshold)
    return keep if valid_mask is None else keep & valid_mask


def box3d_multiclass_nms(boxes3d, boxes_for_nms, scores, score_thr, nms_thr,
                         max_num, dir_scores=None):
    """Per-class rotated NMS, then the global top `max_num` by score.

    Args:
        boxes3d: (N, 7) decoded boxes; boxes_for_nms: (N, 5) BEV boxes.
        scores: (N, C) per-class sigmoid scores.
        dir_scores: optional (N,) direction bins to gather.

    Returns:
        dict of 'boxes3d' (max_num, 7), 'scores', 'labels' (-1 when
        empty), 'mask' and 'dir_scores' (if given), all (max_num,).
    """
    num_classes = scores.shape[1]
    iou = rotated_iou_bev(boxes_for_nms, boxes_for_nms)
    mask = scores > score_thr
    neg_inf = torch.full_like(scores, -torch.inf)
    keep = _greedy_suppress(iou, torch.where(mask, scores, neg_inf).t(),
                            nms_thr).t() & mask
    flat = torch.where(keep, scores, neg_inf).reshape(-1)
    top_scores, top_idx = torch.topk(flat, max_num)
    box_idx = top_idx // num_classes
    labels = top_idx % num_classes
    out_mask = torch.isfinite(top_scores)
    out = {
        'boxes3d': torch.where(out_mask[:, None], boxes3d[box_idx],
                               torch.zeros_like(boxes3d[box_idx])),
        'scores': torch.where(out_mask, top_scores,
                              torch.zeros_like(top_scores)),
        'labels': torch.where(out_mask, labels, torch.full_like(labels, -1)),
        'mask': out_mask,
    }
    if dir_scores is not None:
        d = dir_scores[box_idx]
        out['dir_scores'] = torch.where(out_mask, d, torch.zeros_like(d))
    return out
