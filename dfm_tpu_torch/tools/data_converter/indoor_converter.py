"""Indoor info converters: SUN RGB-D and ScanNet.

A copy of `dfm_tpu/data/indoor_converter.py` (`build_sunrgbd_infos:80`,
`build_scannet_infos:135`, `write_infos:229`; reference mmdet3d
tools/data_converter/indoor_converter.py + sunrgbd_data_utils.py /
scannet_data_utils.py). Each builder reads the dataset's standard
extracted layout and writes `points/` bins and infos in the schema that
`data/indoor.py` reads:

* SUN RGB-D (`sunrgbd_trainval/{image,calib,depth,label}` and
  `{split}_data_idx.txt`): the depth `.mat` point cloud (`scipy.io`),
  `num_sample` points drawn from `np.random.RandomState(seed)` in JAX's
  order, the calib txt (column-major Rt, K), the label txt -> annos
  {name, bbox, location, dimensions, rotation_y, index, class,
  gt_boxes_upright_depth}; the image's shape from the port's own reader
  (`data/jpeg.py:read_image`: cv2.imread's bytes without cv2), (0, 0)
  where it is missing or unreadable;
* ScanNet (`scannet_instance_data/{scene}_{vert,ins_label,sem_label,
  aligned_bbox,unaligned_bbox,axis_align_matrix}.npy` and
  `meta_data/scannetv2_{split}.txt`): points, instance and semantic mask
  bins, the aligned and unaligned boxes and the axis_align_matrix (no
  annos for the test split).

S3DIS (`build_s3dis_infos`) comes with the segmentation slice.
"""

import os
import pickle

import numpy as np
import scipy.io as sio

from ...data.jpeg import read_image

__all__ = ['build_sunrgbd_infos', 'build_scannet_infos', 'write_infos',
           'SUNRGBD_CLASSES', 'SCANNET_CLASSES']

SUNRGBD_CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
                   'dresser', 'night_stand', 'bookshelf', 'bathtub')
SCANNET_CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door',
                   'window', 'bookshelf', 'picture', 'counter', 'desk',
                   'curtain', 'refrigerator', 'showercurtrain',
                   'toilet', 'sink', 'bathtub', 'garbagebin')
SCANNET_NYU40_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                     33, 34, 36, 39)


def _tofile(arr, root, sub, name):
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    path = os.path.join(sub, name)
    arr.tofile(os.path.join(root, path))
    return path


def _parse_sunrgbd_label(path):
    """label txt line -> (name, box2d, box3d upright-depth)
    (reference SUNRGBDInstance, sunrgbd_data_utils.py:33-59)."""
    objs = []
    if not os.path.exists(path):
        return objs
    with open(path) as f:
        for line in f:
            data = line.strip().split(' ')
            if len(data) < 13:
                continue
            name = data[0]
            v = [float(x) for x in data[1:]]
            box2d = np.array([v[0], v[1], v[0] + v[2], v[1] + v[3]])
            centroid = np.array(v[4:7])
            # (w=data[8], l=data[9], h=data[10]) halves -> full sizes
            # in (l, w, h) = x/y/z order
            size = np.array([v[8], v[7], v[9]]) * 2
            heading = float(np.arctan2(v[11], v[10]))
            box3d = np.concatenate([centroid, size, [heading]])
            objs.append((name, box2d, box3d))
    return objs


def build_sunrgbd_infos(root, split='train', num_sample=50000, seed=0):
    split_file = os.path.join(root, 'sunrgbd_trainval',
                              f'{split}_data_idx.txt')
    with open(split_file) as f:
        ids = [int(x) for x in f.read().split()]
    cat2label = {c: i for i, c in enumerate(SUNRGBD_CLASSES)}
    rng = np.random.RandomState(seed)
    tv = os.path.join(root, 'sunrgbd_trainval')
    infos = []
    for idx in ids:
        pc = sio.loadmat(
            os.path.join(tv, 'depth', f'{idx:06d}.mat'))['instance']
        pc = np.asarray(pc, np.float32)
        replace = pc.shape[0] < num_sample
        pc = pc[rng.choice(pc.shape[0], num_sample, replace=replace)]
        info = {'point_cloud': {'num_features': 6, 'lidar_idx': idx},
                'pts_path': _tofile(pc.astype(np.float32), root,
                                    'points', f'{idx:06d}.bin')}
        img = os.path.join('sunrgbd_trainval', 'image', f'{idx:06d}.jpg')
        im = read_image(os.path.join(root, img))
        shape = im.shape[:2] if im is not None else (0, 0)
        info['image'] = {'image_idx': idx, 'image_shape': shape,
                         'image_path': os.path.join('image',
                                                    f'{idx:06d}.jpg')}
        lines = open(os.path.join(tv, 'calib', f'{idx:06d}.txt')
                     ).read().splitlines()
        rt = np.reshape([float(x) for x in lines[0].split(' ')],
                        (3, 3), order='F').astype(np.float32)
        k = np.reshape([float(x) for x in lines[1].split(' ')],
                       (3, 3), order='F').astype(np.float32)
        info['calib'] = {'K': k, 'Rt': rt}
        objs = _parse_sunrgbd_label(
            os.path.join(tv, 'label', f'{idx:06d}.txt'))
        keep = [o for o in objs if o[0] in cat2label]
        annos = {'gt_num': len(keep)}
        if keep:
            annos['name'] = np.array([o[0] for o in keep])
            annos['bbox'] = np.stack([o[1] for o in keep])
            annos['location'] = np.stack([o[2][:3] for o in keep])
            annos['dimensions'] = np.stack([o[2][3:6] for o in keep])
            annos['rotation_y'] = np.array([o[2][6] for o in keep])
            annos['index'] = np.arange(len(objs), dtype=np.int32)
            annos['class'] = np.array([cat2label[o[0]] for o in keep])
            annos['gt_boxes_upright_depth'] = np.stack(
                [o[2] for o in keep])
        info['annos'] = annos
        infos.append(info)
    return infos


def build_scannet_infos(root, split='train'):
    split_file = os.path.join(root, 'meta_data',
                              f'scannetv2_{split}.txt')
    with open(split_file) as f:
        ids = [x.strip() for x in f if x.strip()]
    cat_ids2class = {nyu: i for i, nyu in enumerate(SCANNET_NYU40_IDS)}
    label2cat = dict(enumerate(SCANNET_CLASSES))
    inst = os.path.join(root, 'scannet_instance_data')
    test = split == 'test'
    infos = []
    for sid in ids:
        pts = np.load(os.path.join(inst, f'{sid}_vert.npy')
                      ).astype(np.float32)
        info = {'point_cloud': {'num_features': 6, 'lidar_idx': sid},
                'pts_path': _tofile(pts, root, 'points', f'{sid}.bin')}
        if not test:
            ins = np.load(os.path.join(
                inst, f'{sid}_ins_label.npy')).astype(np.int64)
            sem = np.load(os.path.join(
                inst, f'{sid}_sem_label.npy')).astype(np.int64)
            info['pts_instance_mask_path'] = _tofile(
                ins, root, 'instance_mask', f'{sid}.bin')
            info['pts_semantic_mask_path'] = _tofile(
                sem, root, 'semantic_mask', f'{sid}.bin')
            aligned = np.load(os.path.join(
                inst, f'{sid}_aligned_bbox.npy')).reshape(-1, 7)
            unaligned = np.load(os.path.join(
                inst, f'{sid}_unaligned_bbox.npy')).reshape(-1, 7)
            axis_align = np.load(os.path.join(
                inst, f'{sid}_axis_align_matrix.npy'))
            annos = {'gt_num': aligned.shape[0]}
            if annos['gt_num']:
                classes = aligned[:, -1].astype(int)
                annos['name'] = np.array(
                    [label2cat[cat_ids2class[c]] for c in classes])
                annos['location'] = aligned[:, :3]
                annos['dimensions'] = aligned[:, 3:6]
                annos['gt_boxes_upright_depth'] = aligned[:, :6]
                annos['unaligned_location'] = unaligned[:, :3]
                annos['unaligned_dimensions'] = unaligned[:, 3:6]
                annos['unaligned_gt_boxes_upright_depth'] = \
                    unaligned[:, :6]
                annos['index'] = np.arange(annos['gt_num'],
                                           dtype=np.int32)
                annos['class'] = np.array(
                    [cat_ids2class[c] for c in classes])
            annos['axis_align_matrix'] = axis_align
            info['annos'] = annos
        infos.append(info)
    return infos


def write_infos(infos, out_path):
    with open(out_path, 'wb') as f:
        pickle.dump(infos, f)
    return out_path
