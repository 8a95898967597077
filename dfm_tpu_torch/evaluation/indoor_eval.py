"""Indoor (SUN RGB-D / ScanNet) detection evaluation (pure numpy).

A copy of `dfm_tpu/evaluation/indoor_eval.py` (`depth_box3d_overlap:25`,
`average_precision:55`, `_eval_det_cls:83`, `indoor_eval:136`), the
equivalent of the reference's `indoor_eval`
(mmdet3d/core/evaluation/indoor_eval.py): per-class VOC-style greedy
matching at several 3D-IoU thresholds with area-mode average precision.
Boxes are depth-frame arrays `(x, y, z_bottom, dx, dy, dz, yaw)`;
ScanNet's yaw-free boxes pass yaw = 0. The BEV intersection is the KITTI
evaluator's rotated-polygon kernel (`kitti_eval._bev_corners`,
`_rect_poly_area2`).

The matching is the reference's: detections in global confidence order;
each matches its max-IoU ground truth (one jmax shared across
thresholds), a second hit on a claimed GT is a false positive, and AP is
the area under the (0-extended) precision-recall curve with the
monotone-precision envelope.
"""

import numpy as np

from .kitti_eval import _bev_corners, _rect_poly_area2

__all__ = ['depth_box3d_overlap', 'average_precision', 'indoor_eval']


def depth_box3d_overlap(boxes1, boxes2):
    """3D IoU of depth-frame boxes (x, y, z_bottom, dx, dy, dz, yaw).

    Rotated BEV polygon intersection (z-up yaw) x vertical interval
    overlap / union.
    """
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    if boxes1.shape[-1] == 6:
        boxes1 = np.concatenate(
            [boxes1, np.zeros_like(boxes1[..., :1])], axis=-1)
    if boxes2.shape[-1] == 6:
        boxes2 = np.concatenate(
            [boxes2, np.zeros_like(boxes2[..., :1])], axis=-1)
    # BEV: (cx, cy, dx, dy, yaw) — the polygon kernel is frame-agnostic
    inter_bev = _rect_poly_area2(
        _bev_corners(boxes1[:, [0, 1, 3, 4, 6]]),
        _bev_corners(boxes2[:, [0, 1, 3, 4, 6]]))
    z1lo, z1hi = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    z2lo, z2hi = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    zo = np.maximum(
        np.minimum(z1hi[:, None], z2hi[None]) -
        np.maximum(z1lo[:, None], z2lo[None]), 0.0)
    inter = inter_bev * zo
    vol1 = np.prod(boxes1[:, 3:6], axis=1)
    vol2 = np.prod(boxes2[:, 3:6], axis=1)
    union = vol1[:, None] + vol2[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(recalls, precisions, mode='area'):
    """AP from a PR curve (reference indoor_eval.py:8-53 semantics)."""
    recalls = np.atleast_2d(recalls)
    precisions = np.atleast_2d(precisions)
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == 'area':
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum(
                (mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == '11points':
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i] >= thr]
                ap[i] += precs.max() if precs.size else 0.0
            ap[i] /= 11
    else:
        raise ValueError(mode)
    return ap


def _eval_det_cls(pred, gt, iou_thrs):
    """Single-class PR/AP. pred: {img: [(box7, score)]},
    gt: {img: (M, 7) array}."""
    npos = sum(len(g) for g in gt.values())
    det_flags = {img: [np.zeros(len(g), bool) for _ in iou_thrs]
                 for img, g in gt.items()}

    image_ids, confidence, ious = [], [], []
    for img, dets in pred.items():
        if not dets:
            continue
        boxes = np.stack([b for b, _ in dets])
        gt_img = gt.get(img, np.zeros((0, 7), np.float32))
        iou = depth_box3d_overlap(boxes, gt_img) if len(gt_img) else \
            np.zeros((len(boxes), 1))
        for i, (_, score) in enumerate(dets):
            image_ids.append(img)
            confidence.append(score)
            ious.append(iou[i])

    order = np.argsort(-np.asarray(confidence)) if confidence else []
    nd = len(order)
    tp = [np.zeros(nd) for _ in iou_thrs]
    fp = [np.zeros(nd) for _ in iou_thrs]
    for d, oi in enumerate(order):
        img = image_ids[oi]
        cur_iou = ious[oi]
        gt_img = gt.get(img, ())
        jmax, iou_max = -1, -np.inf
        if len(gt_img):
            jmax = int(np.argmax(cur_iou))
            iou_max = cur_iou[jmax]
        for ti, thr in enumerate(iou_thrs):
            if iou_max > thr:
                if not det_flags[img][ti][jmax]:
                    tp[ti][d] = 1.0
                    det_flags[img][ti][jmax] = True
                else:
                    fp[ti][d] = 1.0
            else:
                fp[ti][d] = 1.0

    out = []
    for ti in range(len(iou_thrs)):
        cfp = np.cumsum(fp[ti])
        ctp = np.cumsum(tp[ti])
        recall = ctp / max(float(npos), 1e-12)
        precision = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
        out.append((recall, precision,
                    float(average_precision(recall, precision)[0])))
    return out


def indoor_eval(gt_annos, dt_annos, metric, label2cat):
    """Evaluate indoor detections.

    Args:
        gt_annos: list of per-scene dicts with 'gt_boxes' ((M, 6|7)
            depth-frame, bottom-center z) and 'gt_labels' (M,).
        dt_annos: list of per-scene dicts with 'boxes3d' ((N, 7)),
            'scores' (N,), 'labels' (N,) (padded entries label -1 or
            use 'mask').
        metric: iterable of IoU thresholds, e.g. (0.25, 0.5).
        label2cat: {label: class name}.

    Returns:
        dict of '<cat>_AP_0.25' / 'mAP_0.25' / '<cat>_rec_0.25' /
        'mAR_0.25' style floats (reference indoor_eval.py:258-300).
    """
    metric = list(metric)
    pred = {}
    gt = {}
    for img_id, (g, d) in enumerate(zip(gt_annos, dt_annos)):
        mask = np.asarray(d.get('mask', np.asarray(d['labels']) >= 0))
        boxes = np.asarray(d['boxes3d'], np.float32)[mask]
        scores = np.asarray(d['scores'], np.float32)[mask]
        labels = np.asarray(d['labels'], np.int64)[mask]
        for b, s, lab in zip(boxes, scores, labels):
            pred.setdefault(int(lab), {}).setdefault(img_id, []).append(
                (b, float(s)))
            gt.setdefault(int(lab), {}).setdefault(img_id, [])
        gboxes = np.asarray(g['gt_boxes'], np.float32)
        if gboxes.shape[-1] == 6:
            gboxes = np.concatenate(
                [gboxes, np.zeros_like(gboxes[:, :1])], axis=-1)
        glabels = np.asarray(g['gt_labels'], np.int64)
        for lab in np.unique(glabels):
            sel = gboxes[glabels == lab]
            gt.setdefault(int(lab), {})[img_id] = sel
            pred.setdefault(int(lab), {}).setdefault(img_id, [])
        for lab in pred:
            gt.setdefault(lab, {}).setdefault(
                img_id, np.zeros((0, 7), np.float32))

    ret = {}
    ap_all = [[] for _ in metric]
    rec_all = [[] for _ in metric]
    for lab in sorted(gt):
        res = _eval_det_cls(pred.get(lab, {}), gt[lab], metric)
        cat = label2cat.get(lab, str(lab))
        for ti, thr in enumerate(metric):
            recall, _, ap = res[ti]
            ret[f'{cat}_AP_{thr:.2f}'] = ap
            ret[f'{cat}_rec_{thr:.2f}'] = \
                float(recall[-1]) if len(recall) else 0.0
            ap_all[ti].append(ap)
            rec_all[ti].append(ret[f'{cat}_rec_{thr:.2f}'])
    for ti, thr in enumerate(metric):
        ret[f'mAP_{thr:.2f}'] = float(np.mean(ap_all[ti])) if ap_all[ti] \
            else 0.0
        ret[f'mAR_{thr:.2f}'] = float(np.mean(rec_all[ti])) if rec_all[ti] \
            else 0.0
    return ret
