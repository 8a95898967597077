"""KITTI monocular dataset and COCO-protocol 2D mAP, host-side numpy.

Port of `dfm_tpu/data/kitti_mono.py` (the reference's `KittiMonoDataset`,
mmdet3d/datasets/kitti_mono_dataset.py): per-image mono samples with 2D
boxes, projected 3D centres and camera-frame 3D boxes (the FCOS3D / PGD
training interface), and the hermetic COCO 2D mAP evaluator. The image
is read by `data/png.py:read_png` (cv2.imread's BGR bytes) and resized by
`data/pipeline.py:resize_linear_cv2` (cv2.resize INTER_LINEAR of the
float32 image) where the JAX package calls cv2; the size of an image
without `image_shape` in its info comes from its PNG header.
"""

import os
import pickle

import numpy as np

from .pipeline import normalize_image, resize_linear_cv2
from .png import png_shape, read_png

__all__ = ['KittiMonoDataset', 'coco_map_2d', 'mono_info_from_native',
           'load_mono_image']


def mono_info_from_native(info, data_root, img_hw=None):
    """A native KITTI info (`data/kitti.py:build_kitti_infos`' schema:
    image / calib / annos_eval) -> the per-image mono info, with P2 and
    the 2D boxes rescaled for an `img_hw` resize of the original image
    (the 3D annotations, camera frame, do not change)."""
    path = os.path.join(data_root, info['image']['image_path'])
    a = info.get('annos_eval') or info['annos']
    p2 = np.asarray(info['calib']['P2'], np.float32)[:3].copy()
    bbox = np.asarray(a['bbox'], np.float32).reshape(-1, 4).copy()
    if img_hw is not None:
        shape = info.get('image', {}).get('image_shape')
        if shape is None:
            shape = png_shape(path)
        h0, w0 = shape[:2]
        sy, sx = img_hw[0] / h0, img_hw[1] / w0
        p2[0] *= sx
        p2[1] *= sy
        bbox *= np.array([sx, sy, sx, sy], np.float32)
    return dict(
        image_path=path,
        calib={'P2': p2},
        annos=dict(name=np.asarray(a['name']),
                   bbox=bbox,
                   location=np.asarray(a['location'], np.float32),
                   dimensions=np.asarray(a['dimensions'], np.float32),
                   rotation_y=np.asarray(a['rotation_y'], np.float32)))


def load_mono_image(path, img_hw=None):
    """Read (BGR, float32), resize to `img_hw` (H, W) where it differs
    and normalise one image -> (H, W, 3) float32."""
    img = read_png(path)
    if img is None:
        raise FileNotFoundError(f'no readable PNG image at {path}')
    img = img.astype(np.float32)
    if img_hw is not None and img.shape[:2] != tuple(img_hw):
        img = resize_linear_cv2(img, img_hw[1], img_hw[0])
    return normalize_image(img)


class KittiMonoDataset:
    """The KITTI mono infos (a list, or the path of a pickle of one) as
    per-image samples: 'img_path', 'cam2img' (3, 4), the gt padded to
    `max_gt` ('gt_bboxes2d', 'centers2d' of the gravity centres,
    'gt_depths', 'gt_boxes_cam', 'gt_labels', 'gt_mask')."""

    def __init__(self, infos, classes=('Car', 'Pedestrian', 'Cyclist'),
                 max_gt=32):
        self.infos = infos if isinstance(infos, list) else \
            _load_pkl(infos)
        self.classes = list(classes)
        self.max_gt = max_gt

    def __len__(self):
        return len(self.infos)

    def get_sample(self, idx):
        info = self.infos[idx]
        annos = info['annos']
        names = np.asarray(annos['name'])
        keep = np.isin(names, self.classes)
        g = min(int(keep.sum()), self.max_gt)

        cam2img = np.asarray(info['calib']['P2'], np.float32)
        loc = np.asarray(annos['location'], np.float32)[keep][:g]
        dims = np.asarray(annos['dimensions'], np.float32)[keep][:g]
        ry = np.asarray(annos['rotation_y'], np.float32)[keep][:g]
        boxes_cam = np.concatenate([loc, dims, ry[:, None]], -1) \
            if g else np.zeros((0, 7), np.float32)

        # projected 3D centers (gravity center, reference centers2d)
        centers3d = loc[:g].copy()
        centers3d[:, 1] -= dims[:g, 1] / 2
        ext = np.concatenate([centers3d,
                              np.ones((g, 1), np.float32)], -1)
        proj = ext @ cam2img[:3].T if g else np.zeros((0, 3))
        centers2d = proj[:, :2] / np.maximum(proj[:, 2:3], 1e-6)

        out = dict(
            img_path=info.get('image_path'),
            cam2img=cam2img,
            gt_bboxes2d=_pad(np.asarray(annos['bbox'],
                                        np.float32)[keep][:g],
                             (self.max_gt, 4)),
            centers2d=_pad(centers2d.astype(np.float32),
                           (self.max_gt, 2)),
            gt_depths=_pad(loc[:g, 2:3], (self.max_gt, 1))[:, 0],
            gt_boxes_cam=_pad(boxes_cam, (self.max_gt, 7)),
            gt_labels=_pad(np.asarray(
                [self.classes.index(n) for n in names[keep][:g]],
                np.int64), (self.max_gt,)),
            gt_mask=np.arange(self.max_gt) < g,
        )
        return out


def _load_pkl(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def _pad(a, shape):
    out = np.zeros(shape, a.dtype if a.size else np.float32)
    if a.size:
        out[:len(a)] = a
    return out


def _iou_2d(a, b):
    """(N, 4) xyxy vs (M, 4) -> (N, M)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), -1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter,
                              1e-9)


def coco_map_2d(predictions, ground_truths, num_classes,
                iou_thrs=None):
    """COCO-protocol 2D mAP (hermetic numpy).

    Args:
        predictions: per-image dicts with 'bboxes' (N, 4) xyxy,
            'scores' (N,), 'labels' (N,).
        ground_truths: per-image dicts with 'bboxes' (G, 4),
            'labels' (G,).

    Returns:
        dict with 'mAP' (IoU .5:.95), 'mAP_50', 'mAP_75', per-class AP.
    """
    iou_thrs = iou_thrs if iou_thrs is not None else \
        np.arange(0.5, 1.0, 0.05)
    ap_table = np.zeros((len(iou_thrs), num_classes))
    for ci in range(num_classes):
        for ti, thr in enumerate(iou_thrs):
            scores, matched, num_gt = [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                pm = np.asarray(pred['labels']) == ci
                gm = np.asarray(gt['labels']) == ci
                num_gt += int(gm.sum())
                pb = np.asarray(pred['bboxes'], np.float64)[pm]
                ps = np.asarray(pred['scores'], np.float64)[pm]
                gb = np.asarray(gt['bboxes'], np.float64)[gm]
                order = np.argsort(-ps)
                taken = np.zeros(len(gb), bool)
                m = np.zeros(len(pb), bool)
                if len(gb):
                    iou = _iou_2d(pb, gb)
                    for i in order:
                        j = int(np.argmax(
                            np.where(taken, -1.0, iou[i])))
                        if iou[i, j] >= thr and not taken[j]:
                            taken[j] = True
                            m[i] = True
                scores.extend(ps.tolist())
                matched.extend(m.tolist())
            ap_table[ti, ci] = _ap_101(scores, matched, num_gt)
    per_class = ap_table.mean(0)
    out = {f'class{c}_AP': float(per_class[c])
           for c in range(num_classes)}
    out['mAP'] = float(per_class.mean())
    out['mAP_50'] = float(ap_table[0].mean())
    i75 = int(np.argmin(np.abs(iou_thrs - 0.75)))
    out['mAP_75'] = float(ap_table[i75].mean())
    return out


def _ap_101(scores, matched, num_gt):
    """COCO 101-point interpolated AP."""
    if num_gt == 0 or not scores:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matched, np.float64)[order]
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(1 - tp)
    recall = tp_c / num_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
    # monotone envelope + 101-point sampling
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, grid, side='left')
    p = np.where(idx < len(precision), precision[np.clip(
        idx, 0, len(precision) - 1)], 0.0)
    return float(p.mean())
