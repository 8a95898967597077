"""Waymo evaluation: Objects .bin files -> LET-mAP / mAPH / mAPL.

Port of `dfm_tpu/evaluation/waymo_eval.py:40-112` (`kitti_result_to_objects`,
`results_to_bin`: KITTI-format camera-frame results -> vehicle-frame
Objects), `:115-190` (`gt_annos_to_bin`, `run_let_binary`,
`parse_let_text`, `evaluate_waymo`) and of `tools/create_waymo_gt_bin.py:
38-75` (`gt_objects_from_infos`, the GT from converted info dicts). `evaluate_waymo` runs the official
`compute_detection_let_metrics_main` binary when the environment
variable WAYMO_METRICS_BIN names one, and the port's pure-Python metric
(`evaluation/waymo_let.py`) otherwise; the result's '_source' says which
ran ('official_binary' or 'python_fallback').
"""

import os
import re
import subprocess

import numpy as np

from .waymo_let import let_detection_metrics
from .waymo_proto import (KITTI_NAME_TO_TYPE, Box, ObjectPred,
                          decode_objects, encode_objects)

__all__ = ['WAYMO_TYPE_BY_LABEL', 'T_REF_TO_FRONT_CAM',
           'kitti_result_to_objects', 'results_to_bin',
           'gt_objects_from_infos', 'gt_annos_to_bin', 'find_let_binary',
           'run_let_binary', 'parse_let_text', 'evaluate_waymo']

WAYMO_TYPE_BY_LABEL = (1, 2, 4)  # Car, Pedestrian, Cyclist

# KITTI reference camera -> Waymo front camera axes (reference
# prediction_kitti_to_waymo.py:74-77)
T_REF_TO_FRONT_CAM = np.array([[0.0, 0.0, 1.0, 0.0],
                               [-1.0, 0.0, 0.0, 0.0],
                               [0.0, -1.0, 0.0, 0.0],
                               [0.0, 0.0, 0.0, 1.0]])


def _heading_cam_to_waymo(rotation_y):
    h = -(rotation_y + np.pi / 2)
    while h < -np.pi:
        h += 2 * np.pi
    while h > np.pi:
        h -= 2 * np.pi
    return h


def kitti_result_to_objects(kitti_result, t_k2w, context_name,
                            frame_timestamp_micros, score_round=4):
    """One frame's KITTI-format detections ('name', 'dimensions' (l, h,
    w), 'location' (bottom centre, KITTI camera frame), 'rotation_y',
    'score') -> ObjectPred list in the vehicle frame through `t_k2w` (4,
    4): each value rounded to `score_round` decimals, y raised by h / 2 to
    the box centre, heading -(ry + pi / 2) wrapped into [-pi, pi]; names
    outside Car / Pedestrian / Cyclist left out."""
    out = []
    for i in range(len(kitti_result['name'])):
        cls = str(kitti_result['name'][i])
        if cls not in KITTI_NAME_TO_TYPE:
            continue
        le, he, wi = (round(float(kitti_result['dimensions'][i, k]),
                            score_round) for k in range(3))
        x, y, z = (round(float(kitti_result['location'][i, k]), score_round)
                   for k in range(3))
        ry = round(float(kitti_result['rotation_y'][i]), score_round)
        score = round(float(kitti_result['score'][i]), score_round)
        y -= he / 2
        xyz = t_k2w @ np.array([x, y, z, 1.0])
        out.append(ObjectPred(
            box=Box(center_x=float(xyz[0]), center_y=float(xyz[1]),
                    center_z=float(xyz[2]), length=le, width=wi, height=he,
                    heading=float(_heading_cam_to_waymo(ry))),
            type=KITTI_NAME_TO_TYPE[cls], score=score,
            context_name=context_name,
            frame_timestamp_micros=int(frame_timestamp_micros)))
    return out


def results_to_bin(kitti_results, frame_infos, path):
    """Write the predictions .bin of a list of frames' KITTI-format results
    (each with 'sample_idx'; empty frames skipped); `frame_infos` maps
    str(sample_idx) -> 'T_front_cam_to_vehicle' (4, 4), 'context_name',
    'timestamp_micros'. Returns the number of objects written."""
    objs = []
    for res in kitti_results:
        if len(res.get('sample_idx', [])) == 0:
            continue
        info = frame_infos[str(res['sample_idx'][0])]
        t_k2w = np.asarray(info['T_front_cam_to_vehicle']) @ \
            T_REF_TO_FRONT_CAM
        objs.extend(kitti_result_to_objects(
            res, t_k2w, info['context_name'], info['timestamp_micros']))
    with open(path, 'wb') as f:
        f.write(encode_objects(objs))
    return len(objs)


def _box7_to_proto(b):
    """A bottom-centre (x, y, z, l, w, h, yaw) box -> a centred Box."""
    return Box(center_x=float(b[0]), center_y=float(b[1]),
               center_z=float(b[2] + b[5] / 2), length=float(b[3]),
               width=float(b[4]), height=float(b[5]), heading=float(b[6]))


def gt_objects_from_infos(infos, cam_sync=True, min_points=1):
    """Camera-only GT Objects from info dicts (`context_name`,
    `timestamp_micros`, and an 'annos' dict with vehicle-frame
    'gt_boxes_3d' (N, 7 bottom centre; where an info has none, its
    'gt_boxes', the key the port's converter writes, are read),
    'labels', 'camera_names' (most
    visible camera, '' = none), optional 'camera_synced_boxes_3d' and
    'num_lidar_points'): labels outside the three classes and boxes with
    fewer than `min_points` points are left out, and with `cam_sync` so
    is every box that no camera sees; score 0.5."""
    objs = []
    for info in infos:
        annos = info.get('annos', {})
        boxes = np.asarray(annos.get('gt_boxes_3d', annos.get(
            'gt_boxes', np.zeros((0, 7))))).reshape(-1, 7)
        labels = np.asarray(annos.get('labels',
                                      np.zeros((len(boxes),), int)))
        cams = annos.get('camera_names', [''] * len(boxes))
        synced = np.asarray(annos.get('camera_synced_boxes_3d',
                                      boxes)).reshape(-1, 7)
        npts = np.asarray(annos.get('num_lidar_points',
                                    np.full((len(boxes),), min_points)))
        for i in range(len(boxes)):
            if not 0 <= int(labels[i]) < len(WAYMO_TYPE_BY_LABEL):
                continue
            if npts[i] < min_points or (cam_sync and not cams[i]):
                continue
            objs.append(ObjectPred(
                box=_box7_to_proto(synced[i] if cam_sync else boxes[i]),
                type=WAYMO_TYPE_BY_LABEL[int(labels[i])], score=0.5,
                context_name=info['context_name'],
                frame_timestamp_micros=int(info['timestamp_micros']),
                num_lidar_points_in_box=int(npts[i]),
                most_visible_camera_name=cams[i] or '',
                camera_synced_box=_box7_to_proto(synced[i])))
    return objs


def gt_annos_to_bin(gt_objects, path):
    """Write a GT .bin of ObjectPred entries that carry
    `camera_synced_box` and `most_visible_camera_name` (the LET metric
    drops GT without them); returns their number."""
    with open(path, 'wb') as f:
        f.write(encode_objects(gt_objects))
    return len(gt_objects)


def find_let_binary():
    """The official LET binary named by WAYMO_METRICS_BIN, or None."""
    path = os.environ.get('WAYMO_METRICS_BIN')
    return path if path and os.path.exists(path) else None


def run_let_binary(pred_bin, gt_bin, binary=None):
    """The official LET binary's stdout on the two .bin files, or None
    when there is no binary."""
    binary = binary or find_let_binary()
    if binary is None:
        return None
    out = subprocess.run([binary, pred_bin, gt_bin], capture_output=True,
                         text=True, check=True)
    return out.stdout


def parse_let_text(text):
    """The binary's output -> the reference's ap_dict layout
    (waymo_dataset.py:640-706)."""
    ap = {}
    cls_map = {'VEHICLE': 'Vehicle', 'PEDESTRIAN': 'Pedestrian',
               'SIGN': 'Sign', 'CYCLIST': 'Cyclist'}
    for line in text.splitlines():
        m = re.match(
            r'OBJECT_TYPE_TYPE_(\w+)_LEVEL_2: \[LET-mAPL ([\d.e+-]+)\] '
            r'\[LET-mAP ([\d.e+-]+)\] \[LET-mAPH ([\d.e+-]+)\]', line)
        if m and m.group(1) in cls_map:
            cls = cls_map[m.group(1)]
            ap[f'{cls} mAPL'] = float(m.group(2))
            ap[f'{cls} mAP'] = float(m.group(3))
            ap[f'{cls} mAPH'] = float(m.group(4))
    for suffix in ('mAPL', 'mAP', 'mAPH'):
        if all(f'{c} {suffix}' in ap
               for c in ('Vehicle', 'Pedestrian', 'Cyclist')):
            ap[f'Overall {suffix}'] = (
                ap[f'Vehicle {suffix}'] + ap[f'Pedestrian {suffix}'] +
                ap[f'Cyclist {suffix}']) / 3
    return ap


def evaluate_waymo(pred_bin, gt_bin, binary=None):
    """LET evaluation of two .bin files: the official binary when one is
    given or named by WAYMO_METRICS_BIN, else `let_detection_metrics`."""
    text = run_let_binary(pred_bin, gt_bin, binary)
    if text is not None:
        ap = parse_let_text(text)
        ap['_source'] = 'official_binary'
        return ap
    with open(pred_bin, 'rb') as f:
        preds = decode_objects(f.read())
    with open(gt_bin, 'rb') as f:
        gts = decode_objects(f.read())
    ap = let_detection_metrics(preds, gts)
    ap['_source'] = 'python_fallback'
    return ap
