"""Waymo TFRecord segments -> a kitti_format tree and the port's infos.

    python -m dfm_tpu_torch.tools.data_converter.waymo_converter \
        --tfrecord-dir DIR --out ROOT [--split validation] [--prefix P]

Port of `tools/data_converter/waymo_converter.py:51-158` on the port's
own wire-format parser (`waymo_raw.py`); no devkit. It writes:

    ROOT/training/image_{0..4}/{name}.jpg   each camera's JPEG bytes
    ROOT/training/calib/{name}.txt          P0..P4, Tr_velo_to_cam_0..4
    ROOT/training/pose/{name}.txt           4x4 ego2global
    ROOT/waymo_infos_{train,val,test}.pkl   one info a frame

with `name` = prefix, segment (3 digits), frame (3 digits), as JAX names
them. The infos are in the schema the port's `data/waymo.py` reads (JAX's
converter writes another one, which its own `WaymoDataset` cannot read):

    info = {
      'sample_idx', 'token' (= name), 'context_name', 'timestamp_micros',
      'ego2global' (4, 4), 'pose' (4, 4), 'calib' {P{i}, Tr_velo_to_cam_{i}},
      'images': [{'image_path', 'lidar2img' = P @ Tr, 'cam2img' = P,
                  'height', 'width', 'camera_name'}, ...],  # camera order
      'sweeps': [{'images', 'ego2global'}],   # the previous frame, if any
      'annos': {'gt_boxes' (G, 7), 'labels', 'names', 'camera_names',
                'num_lidar_points', 'camera_synced_boxes_3d', 'track_ids'},
      'cam_sync_annos': {... the labels some camera sees},
    }

`gt_boxes` are the vehicle-frame boxes at their bottom centre (JAX's
`box3d`: z - h / 2) in the port's (x, y, z, length, width, height,
heading) order, which `data/waymo.py` and `evaluation/waymo_eval.py` read
(JAX's `box3d` lists width before length); Car, Pedestrian and Cyclist
(types 1, 2, 4) as labels 0, 1, 2, other types left out.
`camera_names[i]` is the label's `most_visible_camera_name` where the
record has one, else the first camera (in calibration order) whose image
holds the box's centre in front of it, else ''.
`camera_synced_boxes_3d` is the label's `camera_synced_box` (bottom
centre) where the record has one, else its box. The info file's split is
named as `tools.test` reads it: training -> train, validation -> val,
testing -> test (JAX writes `waymo_infos_validation.pkl`).
"""

import argparse
import glob
import os
import pickle
import sys

import numpy as np

from .waymo_raw import camera_projection, parse_frame, read_tfrecord

__all__ = ['CAMERAS', 'CLASS_MAP', 'convert_segment', 'box7',
           'visible_camera', 'main']

CAMERAS = ('FRONT', 'FRONT_LEFT', 'FRONT_RIGHT', 'SIDE_LEFT',
           'SIDE_RIGHT')
CLASS_MAP = {1: 'Car', 2: 'Pedestrian', 4: 'Cyclist'}
LABELS = {'Car': 0, 'Pedestrian': 1, 'Cyclist': 2}
SPLIT_FILE = {'training': 'train', 'validation': 'val', 'testing': 'test'}


def box7(b):
    """A Label.Box dict -> (x, y, z bottom, length, width, height,
    heading)."""
    return [b['center_x'], b['center_y'], b['center_z'] - b['height'] / 2,
            b['length'], b['width'], b['height'], b['heading']]


def visible_camera(center, images):
    """The name of the first camera whose image holds the vehicle-frame
    point `center` in front of it, else ''."""
    p = np.append(np.asarray(center, np.float64), 1.0)
    for cam in images:
        x, y, z = (cam['lidar2img'] @ p)[:3]
        if z > 0 and 0 <= x / z < cam['width'] and 0 <= y / z < cam['height']:
            return cam['camera_name']
    return ''


def _write_txt(root, sub, name, vals):
    d = os.path.join(root, 'training', sub)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name + '.txt'), 'w') as f:
        f.write(' '.join(f'{v:.12e}' for v in vals) + '\n')


def _write_calib(root, name, calib):
    d = os.path.join(root, 'training', 'calib')
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name + '.txt'), 'w') as f:
        for k, v in calib.items():
            f.write(k + ': ' + ' '.join(
                f'{x:.12e}' for x in np.asarray(v).reshape(-1)) + '\n')


def _annos(labels, images, synced_only=False):
    boxes, synced, names, cams, npts, ids = [], [], [], [], [], []
    for label in labels:
        if label['type'] not in CLASS_MAP or label['box'] is None:
            continue
        b = box7(label['box'])
        cam = label['most_visible_camera'] or visible_camera(
            [label['box']['center_x'], label['box']['center_y'],
             label['box']['center_z']], images)
        if synced_only and not cam:
            continue
        sb = label['camera_synced_box']
        boxes.append(b)
        synced.append(box7(sb) if sb else b)
        names.append(CLASS_MAP[label['type']])
        cams.append(cam)
        npts.append(label['num_points'])
        ids.append(label['id'])
    if synced_only:
        boxes = synced
    return dict(
        gt_boxes=np.asarray(boxes, np.float32).reshape(-1, 7),
        labels=np.asarray([LABELS[n] for n in names], np.int64),
        names=np.asarray(names, dtype='<U10'), camera_names=cams,
        num_lidar_points=np.asarray(npts, np.int64),
        camera_synced_boxes_3d=np.asarray(synced, np.float32).reshape(-1, 7),
        track_ids=ids)


def convert_segment(record_path, out_root, seq_id, prefix='0',
                    save_images=True):
    """One .tfrecord segment -> its kitti_format files under `out_root`
    and one info dict a frame (the schema above)."""
    infos = []
    for fi, rec in enumerate(read_tfrecord(record_path)):
        frame = parse_frame(rec)
        name = f'{prefix}{seq_id:03d}{fi:03d}'
        pose = np.asarray(frame['pose'], np.float64)
        _write_txt(out_root, 'pose', name, pose.reshape(-1))
        calib, images = {}, []
        for cc in sorted(frame['cameras'], key=lambda c: c['name']):
            idx = cc['name'] - 1
            p, tr = camera_projection(cc)
            calib[f'P{idx}'] = p[:3]
            calib[f'Tr_velo_to_cam_{idx}'] = tr
            path = f'training/image_{idx}/{name}.jpg'
            images.append(dict(
                image_path=path, lidar2img=p @ tr, cam2img=p,
                height=int(cc['height']), width=int(cc['width']),
                camera_name=CAMERAS[idx] if 0 <= idx < len(CAMERAS)
                else str(cc['name'])))
            if save_images and cc['name'] in frame['images']:
                d = os.path.join(out_root, 'training', f'image_{idx}')
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(out_root, path), 'wb') as f:
                    f.write(frame['images'][cc['name']])
        _write_calib(out_root, name, calib)
        info = dict(sample_idx=len(infos), token=name,
                    context_name=frame['context_name'],
                    timestamp_micros=int(frame['timestamp']),
                    ego2global=pose, pose=pose, calib=calib, images=images,
                    annos=_annos(frame['labels'], images),
                    cam_sync_annos=_annos(frame['labels'], images, True))
        if infos:
            info['sweeps'] = [dict(images=infos[-1]['images'],
                                   ego2global=infos[-1]['ego2global'])]
        infos.append(info)
    return infos


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--tfrecord-dir', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--split', default='validation',
                   choices=sorted(SPLIT_FILE))
    p.add_argument('--prefix', default=None,
                   help='file name prefix digit (default by split)')
    p.add_argument('--no-images', action='store_true')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    prefix = args.prefix or {'training': '0', 'validation': '1',
                             'testing': '2'}[args.split]
    records = sorted(glob.glob(os.path.join(args.tfrecord_dir,
                                            '*.tfrecord')))
    if not records:
        print(f'no .tfrecord under {args.tfrecord_dir}', file=sys.stderr)
        return 2
    infos = []
    for si, rec in enumerate(records):
        for info in convert_segment(rec, args.out, si, prefix,
                                    save_images=not args.no_images):
            info['sample_idx'] = len(infos)
            infos.append(info)
        print(f'[{si + 1}/{len(records)}] {os.path.basename(rec)}')
    out = os.path.join(args.out, f'waymo_infos_{SPLIT_FILE[args.split]}.pkl')
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'wrote {len(infos)} frame infos -> {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
