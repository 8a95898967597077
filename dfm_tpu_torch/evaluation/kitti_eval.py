"""KITTI 3D detection AP evaluation (pure numpy, offline).

A copy of `dfm_tpu/evaluation/kitti_eval.py`, the equivalent of the
reference's numba-accelerated evaluator
(mmdet3d/core/evaluation/kitti_utils/eval.py: `kitti_eval`,
`eval_class`, 40-point AP, difficulty rules; rotated IoU from
rotate_iou.py numba-CUDA): same metric semantics, vectorized numpy
instead of CUDA/numba (evaluation is offline; the hot path is the
per-image rotated IoU which is vectorized here).

Implements:
  * difficulty buckets (height / occlusion / truncation thresholds);
  * "don't care" handling (ignored gt, DontCare regions);
  * 41-point interpolated AP (R40) on precision-recall;
  * metrics: bbox (2D IoU), bev (rotated BEV IoU), 3d (rotated 3D IoU).
"""

import numpy as np

__all__ = ['kitti_eval', 'eval_class', 'clean_data', 'd3_box_overlap',
           'bev_box_overlap', 'image_box_overlap']

# official difficulty thresholds (eval.py clean_data)
MIN_HEIGHT = (40, 25, 25)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)

CLASS_NAMES = ('Car', 'Pedestrian', 'Cyclist')
# overlap thresholds per class (moderate setting, eval.py overlap_0_7)
OVERLAP_07 = {'Car': 0.7, 'Pedestrian': 0.5, 'Cyclist': 0.5}
OVERLAP_05 = {'Car': 0.5, 'Pedestrian': 0.25, 'Cyclist': 0.25}


def _rect_poly_area2(corners1, corners2):
    """Pairwise rotated-rectangle intersection area in 2D (numpy).

    Args:
        corners1: (N, 4, 2), corners2: (M, 4, 2), both CCW.

    Returns:
        (N, M) intersection areas (Sutherland-Hodgman via candidate
        points + angular sort, vectorized).
    """
    n, m = len(corners1), len(corners2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    # edge-edge intersections
    p = corners1[:, None, :, None, :]                   # (N,1,4,1,2)
    r = (np.roll(corners1, -1, 1) - corners1)[:, None, :, None, :]
    q = corners2[None, :, None, :, :]                   # (1,M,1,4,2)
    s = (np.roll(corners2, -1, 1) - corners2)[None, :, None, :, :]
    def cross2(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    qp = q - p
    rxs = cross2(r, s)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = cross2(qp, s) / rxs
        u = cross2(qp, r) / rxs
    valid = (np.abs(rxs) > 1e-10) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    t_safe = np.clip(np.nan_to_num(t, posinf=0.0, neginf=0.0), 0.0, 1.0)
    inter_pts = p + t_safe[..., None] * r               # (N,M,4,4,2)
    inter_pts = np.where(valid[..., None], inter_pts, 0.0)
    inter_pts = inter_pts.reshape(n, m, 16, 2)
    valid = valid.reshape(n, m, 16)

    def inside(pts, corners):
        # pts (N,M,K,2) in convex quad corners (N or M,4,2) -> mask
        a = corners[..., None, :, :]                    # (...,1,4,2)
        b = np.roll(corners, -1, axis=-2)[..., None, :, :]
        rel = pts[..., :, None, :] - a
        edge = b - a
        cr = edge[..., 0] * rel[..., 1] - edge[..., 1] * rel[..., 0]
        return np.all(cr >= -1e-8, axis=-1) | np.all(cr <= 1e-8, axis=-1)

    c1_in = inside(np.broadcast_to(corners1[:, None], (n, m, 4, 2)),
                   corners2[None, :])
    c2_in = inside(np.broadcast_to(corners2[None, :], (n, m, 4, 2)),
                   corners1[:, None])
    pts = np.concatenate(
        [inter_pts,
         np.broadcast_to(corners1[:, None], (n, m, 4, 2)),
         np.broadcast_to(corners2[None, :], (n, m, 4, 2))], axis=2)
    val = np.concatenate([valid, c1_in, c2_in], axis=2)  # (N,M,24)

    cnt = val.sum(-1, keepdims=True)
    centroid = (pts * val[..., None]).sum(2, keepdims=True) / \
        np.maximum(cnt[..., None], 1)
    rel = pts - centroid
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(val, ang, -10.0)
    order = np.argsort(ang, axis=-1)
    pts_s = np.take_along_axis(pts, order[..., None], axis=2)
    val_s = np.take_along_axis(val, order, axis=2)
    last = pts_s[:, :, -1:, :]
    pts_s = np.where(val_s[..., None], pts_s, last)
    rel = pts_s - centroid
    nxt = np.roll(rel, -1, axis=2)
    area = 0.5 * np.abs(
        (rel[..., 0] * nxt[..., 1] - rel[..., 1] * nxt[..., 0]).sum(-1))
    return np.where(cnt[..., 0] >= 3, area, 0.0)


def _bev_corners(boxes):
    """(N, 5) (x, y, dx, dy, yaw) -> (N, 4, 2) CCW corners."""
    template = np.array(
        [[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]], np.float64)
    c = template[None] * boxes[:, None, 2:4]
    cos, sin = np.cos(boxes[:, 4])[:, None], np.sin(boxes[:, 4])[:, None]
    x = c[..., 0] * cos - c[..., 1] * sin + boxes[:, None, 0]
    y = c[..., 0] * sin + c[..., 1] * cos + boxes[:, None, 1]
    return np.stack([x, y], axis=-1)


def bev_box_overlap(boxes1, boxes2):
    """Rotated BEV IoU over camera-frame boxes (x, z, dx, dz, yaw)."""
    inter = _rect_poly_area2(_bev_corners(boxes1), _bev_corners(boxes2))
    a1 = boxes1[:, 2] * boxes1[:, 3]
    a2 = boxes2[:, 2] * boxes2[:, 3]
    union = a1[:, None] + a2[None] - inter
    return inter / np.maximum(union, 1e-8)


def d3_box_overlap(boxes1, boxes2):
    """Rotated 3D IoU of camera-frame boxes (x,y,z,l,h,w,ry): BEV (x,z)
    intersection x y-extent overlap (y down: box spans [y-h, y])."""
    bev1 = boxes1[:, [0, 2, 3, 5, 6]]
    bev2 = boxes2[:, [0, 2, 3, 5, 6]]
    inter_bev = _rect_poly_area2(_bev_corners(bev1), _bev_corners(bev2))
    ymax1, ymin1 = boxes1[:, 1], boxes1[:, 1] - boxes1[:, 4]
    ymax2, ymin2 = boxes2[:, 1], boxes2[:, 1] - boxes2[:, 4]
    yo = np.maximum(
        np.minimum(ymax1[:, None], ymax2[None]) -
        np.maximum(ymin1[:, None], ymin2[None]), 0)
    inter = inter_bev * yo
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    return inter / np.maximum(v1[:, None] + v2[None] - inter, 1e-8)


def image_box_overlap(boxes1, boxes2, criterion=-1):
    """2D xyxy overlap. criterion=-1: IoU; 0: intersection / area(boxes1)
    (IoF w.r.t. the first argument, used for DontCare matching —
    reference eval.py image_box_overlap)."""
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    if criterion == 0:
        denom = np.broadcast_to(a1[:, None], inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(a2[None, :], inter.shape)
    else:
        denom = a1[:, None] + a2[None] - inter
    return inter / np.maximum(denom, 1e-8)


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Classify gt/dt into care / ignore / don't-care per official rules
    (eval.py `clean_data`)."""
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    current_cls_name = current_class.lower()
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty] or
                  gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty] or
                  height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(bbox)
    for i in range(num_dt):
        height = dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1]
        if dt_anno['name'][i].lower() == current_cls_name:
            valid_class = 1
        else:
            valid_class = -1
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def _compute_statistics(overlaps, gt_anno, dt_anno, ignored_gt, ignored_dt,
                        dc_bboxes, min_overlap, thresh=0.0,
                        compute_fp=False, metric='bbox',
                        compute_aos=False):
    """TP/FP/FN + matched thresholds (+ AOS similarity) for one image
    (eval.py `compute_statistics_jit` semantics)."""
    dt_scores = dt_anno['score']
    num_gt, num_dt = len(ignored_gt), len(ignored_dt)
    assigned = np.zeros(num_dt, bool)
    ignored_threshold = np.zeros(num_dt, bool)
    if compute_fp:
        ignored_threshold = dt_scores < thresh
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(num_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = -np.inf
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(num_dt):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[i, j]
            score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and \
                    score > valid_detection:
                det_idx = j
                valid_detection = score
            elif compute_fp and overlap > min_overlap and \
                    (overlap > max_overlap or assigned_ignored_det) and \
                    ignored_dt[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif compute_fp and overlap > min_overlap and \
                    valid_detection == -np.inf and ignored_dt[j] == 1:
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == -np.inf and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != -np.inf and \
                (ignored_gt[i] == 1 or ignored_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != -np.inf:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_anno['alpha'][i] - dt_anno['alpha'][det_idx])
            assigned[det_idx] = True
    if compute_fp:
        for j in range(num_dt):
            if not (assigned[j] or ignored_dt[j] in (-1, 1) or
                    ignored_threshold[j]):
                fp += 1
        # subtract detections matched to DontCare regions — ONLY for the
        # bbox metric and with intersection/detection-area overlap
        # (reference compute_statistics_jit: `if metric == 0`,
        # image_box_overlap criterion=0)
        nstuff = 0
        if metric == 'bbox' and len(dc_bboxes) > 0:
            dc = np.asarray(dc_bboxes, np.float64).reshape(-1, 4)
            ov = image_box_overlap(
                np.asarray(dt_anno['bbox'], np.float64).reshape(-1, 4),
                dc, criterion=0)
            for j in range(num_dt):
                if assigned[j] or ignored_dt[j] in (-1, 1) or \
                        ignored_threshold[j]:
                    continue
                if (ov[j] > min_overlap).any():
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            # fp detections contribute similarity 0; tps (1+cos d)/2
            sims = (1.0 + np.cos(np.asarray(delta))) / 2.0
            similarity = float(sims.sum()) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.asarray(thresholds)


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds at evenly-spaced recall points (eval.py
    `get_thresholds`)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and \
                i < len(scores) - 1:
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.asarray(thresholds)


def eval_class(gt_annos, dt_annos, current_class, difficulty, metric,
               min_overlap, num_sample_pts=41, compute_aos=False):
    """AP (and optionally AOS) for one (class, difficulty, metric).

    Args:
        gt_annos/dt_annos: lists of KITTI-format anno dicts per image:
            name, truncated, occluded, bbox (N,4), location (N,3),
            dimensions (N,3 l,h,w), rotation_y (N,), [alpha], [score].
        metric: 'bbox' | 'bev' | '3d'.
        compute_aos: also return average orientation similarity
            (only meaningful with metric='bbox').

    Returns:
        AP (R40, percent); or (AP, AOS) if compute_aos.
    """
    stats = []
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ign_gt, ign_dt, dc = clean_data(
            gt, dt, current_class, difficulty)
        if metric == 'bbox':
            ov = image_box_overlap(
                np.asarray(gt['bbox'], np.float64).reshape(-1, 4),
                np.asarray(dt['bbox'], np.float64).reshape(-1, 4))
        elif metric == 'bev':
            gb = np.concatenate(
                [gt['location'][:, [0, 2]],
                 gt['dimensions'][:, [0, 2]],
                 gt['rotation_y'][:, None]], 1) \
                if len(gt['name']) else np.zeros((0, 5))
            db = np.concatenate(
                [dt['location'][:, [0, 2]],
                 dt['dimensions'][:, [0, 2]],
                 dt['rotation_y'][:, None]], 1) \
                if len(dt['name']) else np.zeros((0, 5))
            ov = bev_box_overlap(gb, db)
        elif metric == '3d':
            gb = np.concatenate(
                [gt['location'], gt['dimensions'],
                 gt['rotation_y'][:, None]], 1) \
                if len(gt['name']) else np.zeros((0, 7))
            db = np.concatenate(
                [dt['location'], dt['dimensions'],
                 dt['rotation_y'][:, None]], 1) \
                if len(dt['name']) else np.zeros((0, 7))
            ov = d3_box_overlap(gb, db)
        else:
            raise ValueError(metric)
        stats.append((ov, gt, dt, ign_gt, ign_dt, dc, num_valid_gt))

    total_valid_gt = sum(s[6] for s in stats)
    if total_valid_gt == 0:
        return (0.0, 0.0) if compute_aos else 0.0
    # pass 1: matched scores at min_overlap -> thresholds
    all_thresh = []
    for ov, gt, dt, ign_gt, ign_dt, dc, nv in stats:
        _, _, _, _, th = _compute_statistics(
            ov, gt, dt, ign_gt, ign_dt, dc, min_overlap, compute_fp=False,
            metric=metric)
        all_thresh.append(th)
    thresholds = get_thresholds(
        np.concatenate(all_thresh) if all_thresh else np.zeros(0),
        total_valid_gt, num_sample_pts)
    # pass 2: pr curve over a FIXED num_sample_pts grid; unreached recall
    # points keep precision 0 (reference eval_class + get_mAP40: the
    # precision array is (.., num_sample_pts) zero-initialized, summed
    # over indices 1..40 and divided by 40 — AP is NOT the mean over
    # only the achieved thresholds).
    pr = np.zeros((len(thresholds), 4))
    for t, thresh in enumerate(thresholds):
        for ov, gt, dt, ign_gt, ign_dt, dc, nv in stats:
            tp, fp, fn, sim, _ = _compute_statistics(
                ov, gt, dt, ign_gt, ign_dt, dc, min_overlap,
                thresh=thresh, compute_fp=True, metric=metric,
                compute_aos=compute_aos)
            pr[t, :3] += (tp, fp, fn)
            if compute_aos and sim != -1:
                pr[t, 3] += sim
    precisions = np.zeros(num_sample_pts)
    aos = np.zeros(num_sample_pts)
    denom = np.maximum(pr[:, 0] + pr[:, 1], 1e-8)
    precisions[:len(thresholds)] = pr[:, 0] / denom
    if compute_aos:
        aos[:len(thresholds)] = pr[:, 3] / denom
    # max-interpolate (zero padding is unaffected: suffix max of 0s = 0)
    for i in range(num_sample_pts):
        precisions[i] = precisions[i:].max()
        aos[i] = aos[i:].max()
    ap = float(precisions[1:].sum() / (num_sample_pts - 1) * 100)
    if compute_aos:
        return ap, float(aos[1:].sum() / (num_sample_pts - 1) * 100)
    return ap


# per-metric min-overlap tables (reference kitti_eval overlap_0_7 /
# overlap_0_5 arrays: rows bbox/bev/3d x columns per class). Note the
# 2D-bbox threshold does NOT relax at the loose setting.
MIN_OVERLAPS = {
    'strict': {'bbox': OVERLAP_07, 'bev': OVERLAP_07, '3d': OVERLAP_07},
    'loose': {'bbox': OVERLAP_07, 'bev': OVERLAP_05, '3d': OVERLAP_05},
}


def kitti_eval(gt_annos, dt_annos, classes=CLASS_NAMES,
               metrics=('bbox', 'bev', '3d'), eval_aos=True):
    """Full evaluation: AP per class x difficulty x metric at both
    overlap settings (+ AOS alongside bbox when alpha present)."""
    have_alpha = eval_aos and all(
        'alpha' in a and len(np.atleast_1d(a.get('alpha', []))) ==
        len(a['name']) for a in dt_annos) and all(
        'alpha' in a for a in gt_annos)
    results = {}
    for cls in classes:
        for metric in metrics:
            for diff, diff_name in enumerate(('easy', 'moderate', 'hard')):
                for tag in ('strict', 'loose'):
                    min_ov = MIN_OVERLAPS[tag][metric][cls]
                    want_aos = have_alpha and metric == 'bbox'
                    ap = eval_class(gt_annos, dt_annos, cls, diff, metric,
                                    min_ov, compute_aos=want_aos)
                    if want_aos:
                        ap, aos = ap
                        results[f'{cls}_aos_{diff_name}_{tag}'] = aos
                    results[f'{cls}_{metric}_{diff_name}_{tag}'] = ap
    return results
