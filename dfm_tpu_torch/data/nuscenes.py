"""nuScenes monocular dataset and detection metrics, in numpy.

Port of `dfm_tpu/data/nuscenes.py:1-118` (`NUS_CLASSES`, `NUS_ATTRS`,
the thresholds, `NuScenesMonoDataset`) and `:242-361` (`_ap_from_matches`,
`_greedy_match`, `_angle_diff`, `nuscenes_detection_metrics`), the
hermetic form of the nuscenes-devkit detection metrics that the
reference's `NuScenesMonoDataset.evaluate` calls: centre-distance
matching at {0.5, 1, 2, 4} m, class-wise AP averaged over the
thresholds, the five TP errors (ATE, ASE, AOE, AVE, AAE) at 2 m and the
NDS composite.

Info layout (one dict per image):
    token, img_path, cam2img (3x3 or 4x4), width, height,
    gt_boxes (G, 9) [x, y, z, w, l, h, yaw, vx, vy] global-frame
    gravity-centre boxes, gt_names (G,), gt_attrs (G,) int.

`get_sample` reads the image with the port's reader (`data/jpeg.py:
read_image`, PNG or JPEG by its first bytes: the raw BGR bytes
`cv2.imread` gives, None for a missing file), as JAX's does with
`cv2.imread`: not normalised, not resized. The GT boxes stay in the
global frame while the mono models predict camera-frame boxes; the port
keeps both as JAX has them (ROADMAP.md §3).
"""

import os
import pickle

import numpy as np

from .jpeg import read_image

__all__ = ['NUS_CLASSES', 'NUS_ATTRS', 'NuScenesMonoDataset',
           'nuscenes_detection_metrics']

NUS_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')
NUS_ATTRS = ('cycle.with_rider', 'cycle.without_rider',
             'pedestrian.moving', 'pedestrian.standing',
             'pedestrian.sitting_lying_down', 'vehicle.moving',
             'vehicle.parked', 'vehicle.stopped', 'None')

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0          # the TP errors use the 2 m matches
MIN_RECALL = 0.1
MIN_PRECISION = 0.1


class NuScenesMonoDataset:
    """An info-pickle mono dataset: `get_sample` gives the raw image, the
    intrinsics and the padded GT arrays (+ the info), `evaluate` the NDS
    metrics of per-image detections."""

    def __init__(self, data_root, ann_file='nuscenes_infos_mono.pkl',
                 classes=NUS_CLASSES, max_gt=48):
        self.data_root = data_root
        self.classes = list(classes)
        self.max_gt = max_gt
        with open(os.path.join(data_root, ann_file), 'rb') as f:
            self.infos = pickle.load(f)

    def __len__(self):
        return len(self.infos)

    def get_cat_ids(self, idx):
        """The class ids present in sample `idx` (the CBGS sampler's
        hook)."""
        return set(self.classes.index(n)
                   for n in self.infos[idx]['gt_names']
                   if n in self.classes)

    def _labels(self, info):
        return np.asarray([self.classes.index(n) if n in self.classes
                           else -1 for n in info['gt_names']], np.int64)

    def evaluate(self, results):
        """Per-image detections -> the NDS metric dict.

        `results[i]`: dict with 'boxes' (N, 9) [x, y, z, w, l, h, yaw, vx,
        vy], 'scores' (N,), 'labels' (N,), optional 'attrs' and optional
        'mask' to drop padding rows."""
        preds, gts = [], []
        for info, det in zip(self.infos, results):
            m = np.asarray(det.get(
                'mask', np.ones(len(det['scores']), bool))).astype(bool)
            preds.append(dict(
                boxes=np.asarray(det['boxes'])[m],
                scores=np.asarray(det['scores'])[m],
                labels=np.asarray(det['labels'])[m],
                attrs=np.asarray(det['attrs'])[m]
                if det.get('attrs') is not None else None))
            labels = self._labels(info)
            keep = labels >= 0
            gt = dict(boxes=np.asarray(info['gt_boxes'], np.float32).reshape(
                -1, 9)[keep], labels=labels[keep])
            if 'gt_attrs' in info:
                gt['attrs'] = np.asarray(info['gt_attrs'])[keep]
            gts.append(gt)
        return nuscenes_detection_metrics(preds, gts, classes=self.classes)

    def get_sample(self, idx, rng=None):
        info = self.infos[idx]
        img = read_image(os.path.join(self.data_root, info['img_path']))
        boxes = np.asarray(info['gt_boxes'], np.float32).reshape(-1, 9)
        labels = self._labels(info)
        keep = labels >= 0
        g = int(keep.sum())
        out_boxes = np.zeros((self.max_gt, 9), np.float32)
        out_labels = np.zeros((self.max_gt,), np.int64)
        out_attrs = np.full((self.max_gt,), len(NUS_ATTRS) - 1, np.int64)
        out_boxes[:g] = boxes[keep][:self.max_gt]
        out_labels[:g] = labels[keep][:self.max_gt]
        attrs = np.asarray(info.get('gt_attrs', np.zeros(len(labels))),
                           np.int64)
        out_attrs[:g] = attrs[keep][:self.max_gt]
        mask = np.arange(self.max_gt) < g
        return dict(img=img, cam2img=np.asarray(info['cam2img'], np.float32),
                    gt_boxes=out_boxes, gt_labels=out_labels,
                    gt_attrs=out_attrs, gt_mask=mask, info=info)


def _ap_from_matches(scores, matched, num_gt):
    """nuScenes AP: normalized area of the P-R curve above the
    (0.1, 0.1) operating floor (devkit average_precision)."""
    if num_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matched, np.float64)[order]
    fp = 1.0 - tp
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recall = tp_c / num_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    # 101-point interpolation on the recall grid (devkit)
    r_grid = np.linspace(0, 1, 101)
    p_interp = np.zeros_like(r_grid)
    for i, r in enumerate(r_grid):
        sel = recall >= r
        p_interp[i] = precision[sel].max() if sel.any() else 0.0
    p = p_interp[r_grid >= MIN_RECALL]
    p = np.clip(p - MIN_PRECISION, 0, 1)
    return float(p.sum() / ((1 - MIN_RECALL - MIN_PRECISION) * 101))


def _greedy_match(pred_xy, pred_scores, gt_xy, thr):
    """Score-descending greedy center-distance matching (devkit
    accumulate): returns matched flags + matched gt index (-1)."""
    order = np.argsort(-pred_scores)
    taken = np.zeros(len(gt_xy), bool)
    matched = np.zeros(len(pred_xy), bool)
    match_idx = np.full(len(pred_xy), -1, np.int64)
    for i in order:
        if len(gt_xy) == 0:
            break
        d = np.linalg.norm(gt_xy - pred_xy[i], axis=1)
        d[taken] = np.inf
        j = int(np.argmin(d))
        if d[j] <= thr:
            taken[j] = True
            matched[i] = True
            match_idx[i] = j
    return matched, match_idx


def _angle_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return np.abs(np.where(d > period / 2, d - period, d))


def nuscenes_detection_metrics(predictions, ground_truths,
                               classes=NUS_CLASSES):
    """Hermetic devkit-style metrics.

    Args:
        predictions: per-sample list of dicts with 'boxes' (N, 9)
            [x,y,z,w,l,h,yaw,vx,vy], 'scores' (N,), 'labels' (N,),
            optional 'attrs' (N,).
        ground_truths: per-sample list of dicts with 'boxes' (G, 9),
            'labels' (G,), optional 'attrs' (G,).

    Returns:
        dict with per-class AP, mAP, TP errors, and NDS.
    """
    results = {}
    aps = []
    tp_errs = {k: [] for k in ('trans_err', 'scale_err', 'orient_err',
                               'vel_err', 'attr_err')}
    for ci, cname in enumerate(classes):
        cls_aps = []
        for thr in DIST_THRESHOLDS:
            scores_all, match_all, num_gt = [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                pm = np.asarray(pred['labels']) == ci
                gm = np.asarray(gt['labels']) == ci
                num_gt += int(gm.sum())
                p_boxes = np.asarray(pred['boxes'])[pm]
                p_scores = np.asarray(pred['scores'])[pm]
                g_boxes = np.asarray(gt['boxes'])[gm]
                matched, midx = _greedy_match(
                    p_boxes[:, :2], p_scores, g_boxes[:, :2], thr)
                scores_all.extend(p_scores.tolist())
                match_all.extend(matched.tolist())
                if thr == TP_THRESHOLD and matched.any():
                    mi = midx[matched]
                    pb, gb = p_boxes[matched], g_boxes[mi]
                    tp_errs['trans_err'].extend(
                        np.linalg.norm(pb[:, :2] - gb[:, :2], axis=1))
                    # scale: 1 - 3D IoU of aligned boxes
                    inter = np.prod(np.minimum(pb[:, 3:6], gb[:, 3:6]),
                                    axis=1)
                    union = np.prod(pb[:, 3:6], 1) + \
                        np.prod(gb[:, 3:6], 1) - inter
                    tp_errs['scale_err'].extend(1 - inter / union)
                    period = np.pi if cname == 'barrier' else 2 * np.pi
                    tp_errs['orient_err'].extend(
                        _angle_diff(pb[:, 6], gb[:, 6], period))
                    if pb.shape[1] >= 9 and gb.shape[1] >= 9:
                        tp_errs['vel_err'].extend(np.linalg.norm(
                            pb[:, 7:9] - gb[:, 7:9], axis=1))
                    if 'attrs' in pred and 'attrs' in gt:
                        pa = np.asarray(pred['attrs'])[pm][matched]
                        ga = np.asarray(gt['attrs'])[gm][mi]
                        tp_errs['attr_err'].extend(
                            (pa != ga).astype(np.float64))
            cls_aps.append(_ap_from_matches(scores_all, match_all,
                                            num_gt))
        ap = float(np.mean(cls_aps))
        results[f'{cname}_AP'] = ap
        aps.append(ap)
    results['mAP'] = float(np.mean(aps))
    # TP scores: 1 - min(1, err / norm) (devkit: ATE/AVE raw meters,
    # ASE/AAE in [0,1], AOE radians; NDS normalizers)
    tp_scores = []
    for k, norm in (('trans_err', 1.0), ('scale_err', 1.0),
                    ('orient_err', np.pi), ('vel_err', 1.0),
                    ('attr_err', 1.0)):
        err = float(np.mean(tp_errs[k])) if tp_errs[k] else 1.0
        results[f'm{k.upper()}'] = err
        tp_scores.append(max(0.0, 1.0 - min(1.0, err / norm)))
    results['NDS'] = float((5 * results['mAP'] + sum(tp_scores)) / 10)
    return results
