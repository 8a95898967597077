"""KITTI raw-file parsing + info building + dataset wrapper.

A copy of `dfm_tpu/data/kitti.py` (numpy, no cv2), the equivalent of the
reference's data machinery
(tools/create_data.py kitti path, tools/data_converter/kitti_data_utils.py,
mmdet3d/datasets/kitti_dataset.py) with a framework-native info schema:

  info = {
    'image': {'image_path', 'image_shape'},
    'calib': {'P2' (4,4), 'R0_rect' (3,3), 'Tr_velo_to_cam' (3,4)},
    'cam2global': (4, 4),            # from raw-sequence poses
    'sweeps': [{'data_path', 'cam2global'}, ...],   # temporal prev frames
    'annos': {'names', 'gt_boxes_pl' (G,7 pseudo-lidar), 'labels',
              'truncated', 'occluded', 'bbox2d'},
    'velodyne_path': str,
  }

GT boxes are converted to the pseudo-LiDAR frame at info-build time
(reference KittiDataset pseudo_lidar=True, kitti_dataset.py:235-240):
camera-frame label boxes -> (z, -x, -y) with the CAM->LIDAR dim/yaw swap.
"""

import os
import pickle

import numpy as np

from ..evaluation.kitti_eval import kitti_eval
from ..evaluation.results import detections_to_kitti_annos
from .calibration import Calibration
from .pipeline import _pad44, load_video_sample

__all__ = ['parse_calib_file', 'parse_label_file', 'build_kitti_infos',
           'infos_from_reference_pkl', 'KittiDataset', 'CLASS_NAMES']

CLASS_NAMES = ('Car', 'Pedestrian', 'Cyclist')
SIMILAR_CLS = {'Van': 'Car', 'Person_sitting': 'Pedestrian'}


def parse_calib_file(path):
    """Parse a KITTI calib .txt into matrices."""
    out = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            key, vals = line.split(':', 1)
            out[key.strip()] = np.fromstring(vals, sep=' ')
    calib = {
        'P2': _pad44(out['P2'].reshape(3, 4)),
        'R0_rect': out.get('R0_rect', np.eye(3).reshape(-1)).reshape(3, 3),
        'Tr_velo_to_cam': out.get(
            'Tr_velo_to_cam', np.eye(4)[:3].reshape(-1)).reshape(3, 4),
    }
    return calib


def parse_label_file(path):
    """Parse a KITTI label .txt -> list of dicts (camera-frame boxes)."""
    objs = []
    with open(path) as f:
        for line in f:
            p = line.strip().split(' ')
            if len(p) < 15:
                continue
            objs.append(dict(
                name=p[0],
                truncated=float(p[1]),
                occluded=int(float(p[2])),
                alpha=float(p[3]),
                bbox2d=np.array([float(x) for x in p[4:8]], np.float32),
                dims=np.array([float(p[10]), float(p[8]), float(p[9])],
                              np.float32),  # (l, h, w) -> store as l,h,w
                loc=np.array([float(x) for x in p[11:14]], np.float32),
                yaw=float(p[14])))
    return objs


def cam_label_to_pseudo_lidar(loc, dims_lhw, yaw):
    """KITTI camera label -> pseudo-lidar (N, 7) box.

    KITTI labels: location = bottom center in rect cam frame, dims
    (l, h, w), rotation_y around cam y. Camera box (x, y, z, l, h, w, ry)
    -> pseudo-lidar (z, -x, -y, l, w, h, -ry - pi/2) per Box3DMode
    CAM->LIDAR (reference box_3d_mode.py:132-146).
    """
    x, y, z = loc[:, 0], loc[:, 1], loc[:, 2]
    l, h, w = dims_lhw[:, 0], dims_lhw[:, 1], dims_lhw[:, 2]
    yaw_pl = -yaw - np.pi / 2
    yaw_pl = yaw_pl - np.floor(yaw_pl / (2 * np.pi) + 0.5) * (2 * np.pi)
    return np.stack([z, -x, -y, l, w, h, yaw_pl], axis=1).astype(np.float32)


def build_kitti_infos(data_root, split_ids, split='training',
                      with_sweeps=True, use_similar_cls=True):
    """Build info dicts for the given frame ids.

    Temporal sweeps follow the reference's layout (kitti_data_utils.py:
    80-128): prev frames under `prev_2/<id>_01.png` etc with poses in
    `poses/<id>.txt` (one 3x4 or 4x4 cam2global per line: cur first,
    then prevs). Missing sweeps degrade to a static pair.
    """
    infos = []
    for idx in split_ids:
        sid = f'{int(idx):06d}'
        base = os.path.join(data_root, split)
        info = {'sample_idx': int(idx)}
        img_path = os.path.join(split, 'image_2', sid + '.png')
        info['image'] = {'image_path': img_path}
        calib = parse_calib_file(os.path.join(base, 'calib', sid + '.txt'))
        info['calib'] = calib
        info['velodyne_path'] = os.path.join(split, 'velodyne', sid + '.bin')

        # poses + temporal sweeps
        pose_file = os.path.join(base, 'poses', sid + '.txt')
        cam2global = np.eye(4)
        sweeps = []
        if with_sweeps and os.path.exists(pose_file):
            poses = np.loadtxt(pose_file).reshape(-1, 4, 4) \
                if os.path.getsize(pose_file) else []
            if len(poses):
                cam2global = poses[0]
            for k in range(1, len(poses)):
                prev_path = os.path.join(
                    split, 'prev_2', f'{sid}_{k:02d}.png')
                if os.path.exists(os.path.join(data_root, prev_path)):
                    sweeps.append({'data_path': prev_path,
                                   'cam2global': poses[k]})
        info['cam2global'] = cam2global
        info['sweeps'] = sweeps

        # annotations
        label_file = os.path.join(base, 'label_2', sid + '.txt')
        if os.path.exists(label_file):
            all_objs = parse_label_file(label_file)
            info['annos_eval'], info['annos'] = _annos_from_objs(
                all_objs, use_similar_cls)
        infos.append(info)
    return infos


def _annos_from_objs(all_objs, use_similar_cls=True):
    """(annos_eval, annos) from a list of camera-frame object dicts.

    EVAL annotations keep every object with its ORIGINAL name:
    kitti_eval.clean_data classifies Van/Person_sitting as ignore-class
    for Car/Pedestrian and uses DontCare regions to discount FPs
    (reference eval protocol). Remapping or dropping them here would
    corrupt AP (ADVICE r1). TRAINING GT drops DontCare, remaps similar
    classes, and converts boxes to the pseudo-lidar frame.
    """
    annos_eval = {
        'name': np.array([o['name'] for o in all_objs]),
        'truncated': np.array(
            [o['truncated'] for o in all_objs], np.float32),
        'occluded': np.array(
            [o['occluded'] for o in all_objs], np.int64),
        'alpha': np.array(
            [o['alpha'] for o in all_objs], np.float32),
        'bbox': (np.stack([o['bbox2d'] for o in all_objs])
                 if all_objs else np.zeros((0, 4), np.float32)),
        'dimensions': (np.stack([o['dims'] for o in all_objs])
                       if all_objs else np.zeros((0, 3), np.float32)),
        'location': (np.stack([o['loc'] for o in all_objs])
                     if all_objs else np.zeros((0, 3), np.float32)),
        'rotation_y': np.array(
            [o['yaw'] for o in all_objs], np.float32),
    }
    objs = [o for o in all_objs if o['name'] != 'DontCare']
    names = []
    for o in objs:
        n = o['name']
        if use_similar_cls and n in SIMILAR_CLS:
            n = SIMILAR_CLS[n]
        names.append(n)
    keep = [i for i, n in enumerate(names) if n in CLASS_NAMES]
    objs = [objs[i] for i in keep]
    names = [names[i] for i in keep]
    if objs:
        loc = np.stack([o['loc'] for o in objs])
        dims = np.stack([o['dims'] for o in objs])
        yaw = np.array([o['yaw'] for o in objs], np.float32)
        boxes_pl = cam_label_to_pseudo_lidar(loc, dims, yaw)
    else:
        boxes_pl = np.zeros((0, 7), np.float32)
    annos = {
        'names': names,
        'gt_boxes_pl': boxes_pl,
        'labels': np.array(
            [CLASS_NAMES.index(n) for n in names], np.int64),
        'truncated': np.array(
            [o['truncated'] for o in objs], np.float32),
        'occluded': np.array(
            [o['occluded'] for o in objs], np.int64),
        'bbox2d': (np.stack([o['bbox2d'] for o in objs])
                   if objs else np.zeros((0, 4), np.float32)),
    }
    return annos_eval, annos


def infos_from_reference_pkl(pkl_path):
    """Convert a reference-format (mmdet3d 1.0.0rc3) KITTI info pkl into
    the framework-native schema — no raw calib/label txts needed.

    The reference stores per-frame dicts with keys image/point_cloud/
    calib/annos (tools/data_converter/kitti_data_utils.py; consumed by
    mmdet3d/datasets/kitti_dataset.py:22). Its `annos['dimensions']`
    rows are camera-frame (l, h, w) — the same order `parse_label_file`
    produces — and `location`/`rotation_y` are the raw label values, so
    the objects route through the shared `_annos_from_objs` builder.
    Frames come back without temporal sweeps (`cam2global=I`, the
    static-pair fallback of the video pipeline).
    """
    with open(pkl_path, 'rb') as f:
        ref = pickle.load(f)
    infos = []
    for r in ref:
        calib = {
            'P2': _pad44(np.asarray(r['calib']['P2'], np.float64)[:3, :4]),
            'R0_rect': np.asarray(
                r['calib']['R0_rect'], np.float64)[:3, :3],
            'Tr_velo_to_cam': np.asarray(
                r['calib']['Tr_velo_to_cam'], np.float64)[:3, :4],
        }
        info = {
            'sample_idx': int(r['image']['image_idx']),
            'image': {'image_path': str(r['image']['image_path'])},
            'calib': calib,
            'velodyne_path': str(
                r['point_cloud'].get('velodyne_path', '')),
            'cam2global': np.eye(4),
            'sweeps': [],
        }
        a = r.get('annos')
        if a is not None:
            objs = []
            for i in range(len(a['name'])):
                objs.append(dict(
                    name=str(a['name'][i]),
                    truncated=float(a['truncated'][i]),
                    occluded=int(a['occluded'][i]),
                    alpha=float(a['alpha'][i]),
                    bbox2d=np.asarray(a['bbox'][i], np.float32),
                    dims=np.asarray(a['dimensions'][i], np.float32),
                    loc=np.asarray(a['location'][i], np.float32),
                    yaw=float(a['rotation_y'][i])))
            info['annos_eval'], info['annos'] = _annos_from_objs(objs)
        infos.append(info)
    return infos


class KittiDataset:
    """Info-file-backed dataset producing network-ready samples."""

    def __init__(self, data_root, info_path_or_list, train=True,
                 pipeline_kwargs=None, load_points=True):
        self.data_root = data_root
        if isinstance(info_path_or_list, str):
            with open(info_path_or_list, 'rb') as f:
                self.infos = pickle.load(f)
        else:
            self.infos = info_path_or_list
        self.train = train
        self.pipeline_kwargs = pipeline_kwargs or {}
        self.load_points = load_points

    def __len__(self):
        return len(self.infos)

    def _load_points_pl(self, info):
        path = os.path.join(self.data_root, info['velodyne_path'])
        if not os.path.exists(path):
            return None
        pts = np.fromfile(path, np.float32).reshape(-1, 4)[:, :3]
        calib = Calibration(np.asarray(info['calib']['P2'])[:3],
                            info['calib'].get('R0_rect'),
                            info['calib'].get('Tr_velo_to_cam'))
        rect = calib.lidar_to_rect(pts)
        return calib.rect_to_lidar_pseudo(rect).astype(np.float32)

    def get_sample(self, idx, rng):
        info = dict(self.infos[idx])
        if self.load_points:
            pts = self._load_points_pl(info)
            if pts is not None:
                info['points_pl'] = pts
        return load_video_sample(info, self.data_root, rng,
                                 train=self.train, **self.pipeline_kwargs)

    def get_cat_ids(self, idx):
        """Category ids present in frame `idx` (CBGSDataset hook)."""
        labels = np.asarray(self.infos[idx]['annos']['labels'])
        return set(int(c) for c in labels[labels >= 0])

    def gt_annos(self):
        """Official-protocol GT annos for `kitti_eval` — the
        `annos_eval` view when present (original names so clean_data
        applies the DontCare/Van ignore rules), else rebuilt from the
        pseudo-lidar boxes."""
        out = []
        for info in self.infos:
            if 'annos_eval' in info:
                out.append(dict(info['annos_eval']))
                continue
            a = info['annos']
            pl = np.asarray(a['gt_boxes_pl']).reshape(-1, 7)
            out.append(dict(
                name=np.asarray(a['names']), truncated=a['truncated'],
                occluded=a['occluded'], bbox=a['bbox2d'],
                dimensions=np.stack([pl[:, 3], pl[:, 5], pl[:, 4]], 1),
                location=np.stack([-pl[:, 1], -pl[:, 2], pl[:, 0]], 1),
                rotation_y=-pl[:, 6] - np.pi / 2))
        return out

    def evaluate(self, results):
        """Detections -> official KITTI AP dict (reference
        KittiDataset.evaluate, datasets/kitti_dataset.py:392-476 ->
        kitti_eval). `results[i]`: dict with 'boxes3d' (M, 7)
        pseudo-lidar, 'scores', 'labels', 'mask' for frame i."""
        dt_annos = []
        for info, det in zip(self.infos, results):
            dt_annos.append(detections_to_kitti_annos(
                det, np.asarray(info['calib']['P2'])[:3],
                info.get('image', {}).get('image_shape', (375, 1242))))
        return kitti_eval(self.gt_annos()[:len(dt_annos)], dt_annos)

