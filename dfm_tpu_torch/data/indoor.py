"""SUN RGB-D and ScanNet indoor detection datasets.

A copy of `dfm_tpu/data/indoor.py` (`_IndoorDataset`, `SUNRGBDDataset`,
`ScanNetDataset`; reference mmdet3d sunrgbd_dataset.py /
scannet_dataset.py), reading the `*_infos_{split}.pkl` files that
`tools/data_converter/indoor_converter.py` writes:

* each sample static-shape: the points sampled to `num_points`
  (`np.random.RandomState(seed)`, with replacement where the scene has
  fewer), the gt boxes padded to `max_gt` with a mask;
* train-time augmentation in numpy, in JAX's draw order from the same
  RandomState (flips, then a rotation, then a scale; SUN RGB-D: a
  horizontal flip at 0.5, rotation +-0.523599, scale [0.85, 1.15];
  ScanNet: both flips at 0.5, rotation +-0.087266), so that one seed
  gives both packages the same samples;
* the height above the 0.99th percentile of z as a fourth point feature
  (JAX's `shift_height`, which every config keeps on);
* ScanNet's points aligned by the scene's `axis_align_matrix` (its gt
  boxes are aligned already);
* `evaluate`: `evaluation/indoor_eval.py`'s AP at 0.25 and 0.5.

Boxes are depth-frame (x, y, z_bottom, dx, dy, dz, yaw), z up: the infos'
`gt_boxes_upright_depth` hold the gravity centre's z, turned here into
the bottom centre.
"""

import os
import pickle

import numpy as np

from ..evaluation.indoor_eval import indoor_eval

__all__ = ['SUNRGBDDataset', 'ScanNetDataset', 'INDOOR_DATASETS',
           'indoor_split']


def _rotz(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], points.dtype)
    out = points.copy()
    out[:, :2] = points[:, :2] @ rot.T
    return out


class _IndoorDataset:
    CLASSES = ()
    num_points = 20000
    rot_range = (0.0, 0.0)
    scale_range = (1.0, 1.0)
    flip_horizontal = 0.0
    flip_vertical = 0.0

    def __init__(self, data_root, info_path, train=True, num_points=None,
                 max_gt=64, seed=0):
        self.data_root = data_root
        self.train = train
        self.max_gt = max_gt
        if num_points is not None:
            self.num_points = num_points
        with open(info_path, 'rb') as f:
            self.infos = pickle.load(f)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    # -- per-dataset hooks -------------------------------------------------
    def _load_points(self, info):
        path = os.path.join(self.data_root, info['pts_path'])
        nfeat = info['point_cloud'].get('num_features', 6)
        pts = np.fromfile(path, np.float32).reshape(-1, nfeat)
        return pts[:, :3]                        # use_dim=[0, 1, 2]

    def _align(self, info, points):
        return points

    def _annotations(self, info):
        annos = info['annos']
        n = int(annos.get('gt_num', 0))
        if n == 0:
            return (np.zeros((0, 7), np.float32),
                    np.zeros((0,), np.int64))
        boxes = np.asarray(annos['gt_boxes_upright_depth'], np.float32)
        if boxes.shape[-1] == 6:
            boxes = np.concatenate(
                [boxes, np.zeros_like(boxes[:, :1])], axis=-1)
        # gravity-center z -> bottom-center z (reference constructs
        # DepthInstance3DBoxes with origin=(0.5, 0.5, 0.5))
        boxes = boxes.copy()
        boxes[:, 2] -= boxes[:, 5] / 2
        labels = np.asarray(annos['class'], np.int64)
        return boxes, labels

    # -- pipeline ----------------------------------------------------------
    def _sample_points(self, points):
        n = points.shape[0]
        replace = n < self.num_points
        idx = self.rng.choice(n, self.num_points, replace=replace)
        return points[idx]

    def _augment(self, points, boxes):
        if self.flip_horizontal and self.rng.rand() < self.flip_horizontal:
            points[:, 0] = -points[:, 0]
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.pi - boxes[:, 6]
        if self.flip_vertical and self.rng.rand() < self.flip_vertical:
            points[:, 1] = -points[:, 1]
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        rot = self.rng.uniform(*self.rot_range)
        if rot:
            points[:] = _rotz(points, rot)
            boxes[:, :3] = _rotz(boxes[:, :3], rot)
            boxes[:, 6] += rot
        scale = self.rng.uniform(*self.scale_range)
        if scale != 1.0:
            points[:, :3] *= scale
            boxes[:, :6] *= scale
        return points, boxes

    def get_sample(self, index):
        """One static-shape sample dict."""
        info = self.infos[index]
        points = self._load_points(info).astype(np.float32)
        points = self._align(info, points)
        boxes, labels = self._annotations(info)
        boxes = boxes.copy()
        if self.train:
            points, boxes = self._augment(points, boxes)
        points = self._sample_points(points)
        floor = np.percentile(points[:, 2], 0.99)
        points = np.concatenate([points, (points[:, 2:3] - floor)], axis=1)
        g = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 7), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int64)
        gt_mask = np.zeros((self.max_gt,), bool)
        gt_boxes[:g] = boxes[:g]
        gt_labels[:g] = labels[:g]
        gt_mask[:g] = True
        return dict(points=points, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_mask=gt_mask)

    def gt_annos(self):
        """Ground truths for `evaluate` (full, unpadded)."""
        out = []
        for info in self.infos:
            boxes, labels = self._annotations(info)
            pts = self._align(info, np.zeros((1, 3), np.float32))
            del pts
            out.append(dict(gt_boxes=boxes, gt_labels=labels))
        return out

    def evaluate(self, results, metric=(0.25, 0.5)):
        """results: list of per-scene dicts with boxes3d/scores/labels
        (+mask) in the depth frame, bottom-center z."""
        label2cat = {i: c for i, c in enumerate(self.CLASSES)}
        return indoor_eval(self.gt_annos(), results, metric, label2cat)


class SUNRGBDDataset(_IndoorDataset):
    """SUN RGB-D 10-class (reference sunrgbd_dataset.py:16-283)."""
    CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
               'dresser', 'night_stand', 'bookshelf', 'bathtub')
    num_points = 20000
    rot_range = (-0.523599, 0.523599)
    scale_range = (0.85, 1.15)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.flip_horizontal = 0.5 if self.train else 0.0


class ScanNetDataset(_IndoorDataset):
    """ScanNet V2 18-class (reference scannet_dataset.py:21-277)."""
    CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door',
               'window', 'bookshelf', 'picture', 'counter', 'desk',
               'curtain', 'refrigerator', 'showercurtrain', 'toilet',
               'sink', 'bathtub', 'garbagebin')
    num_points = 40000
    rot_range = (-0.087266, 0.087266)
    scale_range = (1.0, 1.0)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self.train:
            self.flip_horizontal = 0.5
            self.flip_vertical = 0.5

    def _align(self, info, points):
        """GlobalAlignment: apply the scene's axis_align_matrix
        (reference transforms_3d.py GlobalAlignment; gt boxes in the
        infos are already aligned)."""
        mat = info['annos'].get('axis_align_matrix')
        if mat is None:
            return points
        mat = np.asarray(mat, np.float32)
        return points @ mat[:3, :3].T + mat[:3, 3]


# data type -> (info file stem, dataset class)
INDOOR_DATASETS = {'ScanNetDataset': ('scannet', ScanNetDataset),
                   'SUNRGBDDataset': ('sunrgbd', SUNRGBDDataset)}


def indoor_split(data, split):
    """The dataset of the config's `data` (its `type` a key of
    INDOOR_DATASETS) on `{stem}_infos_{split}.pkl` under `data_root`:
    `data.num_points` points, `data.max_gt` boxes, augmented on the
    train split."""
    stem, cls = INDOOR_DATASETS[data.type]
    return cls(data.data_root,
               os.path.join(data.data_root, f'{stem}_infos_{split}.pkl'),
               train=split == 'train', num_points=data.get('num_points', None),
               max_gt=data.get('max_gt', 64))
