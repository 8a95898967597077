"""The GT database and ObjectSample cut-and-paste augmentation.

Port of `dfm_tpu/data/dbsampler.py:33-218` (reference
create_gt_database.py:110-245, datasets/pipelines/dbsampler.py:14-340,
transforms_3d.py:382-470), numpy on the host:

* `create_gt_database`: each annotated object's points, moved to its
  box's origin, in a .bin file of its own, and a pickle of the entries by
  class;
* `BatchSampler`: a class's entries in a shuffled cycle;
* `DataBaseSampler`: per class up to the group's count less the scene's,
  after the difficulty and min-points filters, each candidate kept when
  its rotated BEV box meets neither the scene's nor an accepted one;
* `paste_objects`: the scene's points inside a pasted box removed, the
  sampled points first (the reference's concat order).

The sampler draws from its own `np.random.RandomState(seed)`, not from
the data source's generator, as JAX's does.
"""

import os
import pickle

import numpy as np

from ..evaluation.kitti_eval import _bev_corners, _rect_poly_area2

__all__ = ['points_in_rbbox', 'create_gt_database', 'BatchSampler',
           'DataBaseSampler', 'paste_objects']


def points_in_rbbox(points, boxes, origin=(0.5, 0.5, 0.0)):
    """(P, N) bool: point inside rotated 3D box (x, y, z, dx, dy, dz, yaw),
    z at the box's `origin` fraction of its height (bottom centre), by the
    box-frame transform (`dfm_tpu/core/box_np_ops.py:53-67`)."""
    points = np.asarray(points, np.float32)[:, :3]
    boxes = np.asarray(boxes, np.float32)
    local = points[:, None, :] - boxes[None, :, :3]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = local[..., 0] * c - local[..., 1] * s
    ly = local[..., 0] * s + local[..., 1] * c
    lz = local[..., 2]
    dx, dy, dz = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    return ((np.abs(lx) <= dx / 2) & (np.abs(ly) <= dy / 2) &
            (lz >= -dz * origin[2]) & (lz <= dz * (1 - origin[2])))


def _bev_collision(boxes1, boxes2):
    """(N, M) bool: rotated BEV rectangles that overlap (area > 0)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)), bool)
    inter = _rect_poly_area2(
        _bev_corners(np.asarray(boxes1, np.float64)[:, [0, 1, 3, 4, 6]]),
        _bev_corners(np.asarray(boxes2, np.float64)[:, [0, 1, 3, 4, 6]]))
    return inter > 1e-8


def create_gt_database(infos, data_root, out_dir, load_points_fn,
                       db_prefix='dfm_gt_database'):
    """Write `out_dir`/`db_prefix`/{sample}_{name}_{i}.bin (each object's
    float32 points less its box centre) and `out_dir`/`db_prefix`_infos.pkl
    ({class: [dict(name, path, gt_idx, box3d_lidar, num_points_in_gt,
    difficulty)]}) from infos with 'annos' ('names', 'gt_boxes_pl' (G,
    7), optional 'difficulty'); `load_points_fn(info)` gives the points
    in the boxes' frame (None skips the frame). Returns the pickle's
    path."""
    db_dir = os.path.join(out_dir, db_prefix)
    os.makedirs(db_dir, exist_ok=True)
    db_infos = {}
    for info in infos:
        pts = load_points_fn(info)
        if pts is None:
            continue
        annos = info['annos']
        boxes = np.asarray(annos['gt_boxes_pl'], np.float32)
        names = list(annos['names'])
        if len(boxes) == 0:
            continue
        sid = str(info.get('sample_idx',
                           info.get('image_idx', len(db_infos))))
        inside = points_in_rbbox(pts, boxes)
        diffs = np.asarray(annos.get('difficulty',
                                     np.zeros(len(boxes), np.int32)))
        for gi, name in enumerate(names):
            obj_pts = pts[inside[:, gi]].astype(np.float32).copy()
            obj_pts[:, :3] -= boxes[gi, :3]
            fname = f'{sid}_{name}_{gi}.bin'
            obj_pts.tofile(os.path.join(db_dir, fname))
            db_infos.setdefault(name, []).append(dict(
                name=name, path=os.path.join(db_prefix, fname), gt_idx=gi,
                box3d_lidar=boxes[gi].copy(),
                num_points_in_gt=int(inside[:, gi].sum()),
                difficulty=int(diffs[gi] if gi < len(diffs) else 0)))
    info_path = os.path.join(out_dir, f'{db_prefix}_infos.pkl')
    with open(info_path, 'wb') as f:
        pickle.dump(db_infos, f)
    return info_path


class BatchSampler:
    """A class's entries in a shuffled cycle (reference dbsampler.py:
    14-78): `sample(num)` takes the next `num`, or the rest of the cycle
    and reshuffles when fewer than `num` + 1 are left."""

    def __init__(self, sampled_list, rng=None):
        self._list = sampled_list
        self._rng = rng or np.random.RandomState(0)
        self._indices = self._rng.permutation(len(sampled_list))
        self._idx = 0

    def sample(self, num):
        if self._idx + num >= len(self._list):
            out = self._indices[self._idx:].copy()
            self._indices = self._rng.permutation(len(self._list))
            self._idx = 0
        else:
            out = self._indices[self._idx:self._idx + num]
            self._idx += num
        return [self._list[i] for i in out]


class DataBaseSampler:
    """Per-class GT sampler with the difficulty and min-points filters and
    the collision test; its classes' samplers share one RandomState."""

    def __init__(self, info_path, data_root, sample_groups, classes,
                 rate=1.0, filter_by_difficulty=(-1,),
                 filter_by_min_points=None, num_point_features=3, seed=0):
        self.data_root = data_root
        self.rate = rate
        self.classes = list(classes)
        self.cat2label = {n: i for i, n in enumerate(self.classes)}
        self.num_point_features = num_point_features
        with open(info_path, 'rb') as f:
            db_infos = pickle.load(f)
        if filter_by_difficulty:
            drop = set(filter_by_difficulty)
            db_infos = {k: [i for i in v if i['difficulty'] not in drop]
                        for k, v in db_infos.items()}
        for name, min_num in (filter_by_min_points or {}).items():
            if name in db_infos and min_num > 0:
                db_infos[name] = [i for i in db_infos[name]
                                  if i['num_points_in_gt'] >= min_num]
        self.db_infos = db_infos
        rng = np.random.RandomState(seed)
        self.samplers = {k: BatchSampler(v, rng)
                         for k, v in db_infos.items() if v}
        self.sample_groups = dict(sample_groups)

    def sample_all(self, gt_bboxes, gt_labels):
        """None, or dict(gt_boxes (S, 7), gt_labels (S,), points (P, F))
        of the accepted objects, their points at their boxes."""
        sampled, sampled_boxes = [], []
        avoid = np.asarray(gt_bboxes, np.float32).reshape(-1, 7)
        for name, max_num in self.sample_groups.items():
            label = self.cat2label[name]
            num = int(max_num) - int(np.sum(gt_labels == label))
            num = int(np.round(self.rate * num))
            if num <= 0 or name not in self.samplers:
                continue
            cands = self.samplers[name].sample(num)
            if not cands:
                continue
            for c in cands:
                box = c['box3d_lidar']
                if _bev_collision(box[None], avoid).any():
                    continue
                sampled.append(c)
                sampled_boxes.append(box)
                avoid = np.concatenate([avoid, box[None]], axis=0)
        if not sampled:
            return None
        boxes = np.stack(sampled_boxes)
        pts_list = []
        for c, box in zip(sampled, boxes):
            p = np.fromfile(os.path.join(self.data_root, c['path']),
                            np.float32).reshape(-1, self.num_point_features)
            p = p.copy()
            p[:, :3] += box[:3]
            pts_list.append(p)
        labels = np.asarray([self.cat2label[c['name']] for c in sampled],
                            np.int64)
        return dict(gt_boxes=boxes, gt_labels=labels,
                    points=np.concatenate(pts_list, axis=0))


def paste_objects(points, gt_boxes, gt_labels, sampler):
    """ObjectSample: (points', gt_boxes', gt_labels') with the sampler's
    objects pasted: the scene's points inside their boxes removed, their
    points first, their boxes and labels after the scene's."""
    res = sampler.sample_all(np.asarray(gt_boxes, np.float32),
                             np.asarray(gt_labels))
    if res is None:
        return points, np.asarray(gt_boxes), np.asarray(gt_labels)
    inside = points_in_rbbox(points, res['gt_boxes'])
    points = points[~inside.any(axis=1)]
    spts = res['points']
    if spts.shape[1] < points.shape[1]:
        spts = np.concatenate(
            [spts, np.zeros((len(spts), points.shape[1] - spts.shape[1]),
                            points.dtype)], axis=1)
    points = np.concatenate([spts[:, :points.shape[1]], points], axis=0)
    gt_boxes = np.concatenate(
        [np.asarray(gt_boxes, np.float32).reshape(-1, 7), res['gt_boxes']],
        axis=0)
    gt_labels = np.concatenate([np.asarray(gt_labels), res['gt_labels']],
                               axis=0)
    return points, gt_boxes, gt_labels
