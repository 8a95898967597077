"""Waymo multi-view dataset (kitti_format layout), for MultiViewDfM.

Port of `dfm_tpu/data/waymo.py:43-105` (`assemble_multiview_sample`),
`:106-222` (`WaymoDataset`: its three load modes, `cam_sync`,
`merge_multi_view_boxes`) and `:224-275` (`format_results`,
`evaluate`). Info schema:

  info = {
    'sample_idx': int, 'context_name': str, 'timestamp_micros': int,
    'images': [{'image_path', 'lidar2img' (4, 4), 'cam2img'}, ...],  # views
    'ego2global': (4, 4),
    'sweeps': [{'images': [...], 'ego2global'}, ...],   # previous frames
    'annos': {'gt_boxes' (G, 7) vehicle frame, 'labels', 'names', ...},
    'cam_sync_annos': {...},           # the camera-synchronised set
  }

Images are read by the port's PNG / JPEG reader (`data/jpeg.py:
read_image`, by the file's first bytes; BGR as `cv2.imread` gives them)
and resized by `data/pipeline.py:resize_linear_cv2`, rounded to 8 bits
as `cv2.resize` of the uint8 image rounds them (exactly where a view
halves, as Waymo's do at the camsync config's 640x960; within one level
elsewhere).

The per-camera modes of PGD-Waymo (`:106-222`): 'cam_frame' gives one
sample per (frame, camera), 'cam_mono' one per frame from camera 0; each
sample is that camera's image alone (F, 1, H, W, 3) with its lidar2img,
and the GT boxes whose centres project inside it.
`merge_multi_view_boxes` merges one frame's per-camera detections by a
rotated BEV NMS (`core/nms.py:nms_bev`).
"""

import os
import pickle

import numpy as np
import torch

from ..core.nms import nms_bev
from ..evaluation.waymo_eval import evaluate_waymo
from ..evaluation.waymo_proto import Box, ObjectPred, encode_objects
from .jpeg import read_image
from .pipeline import IMG_MEAN, IMG_STD, resize_linear_cv2

__all__ = ['WaymoDataset', 'assemble_multiview_sample', 'frames_per_sample']


def frames_per_sample(data_cfg, model_cfg=None):
    """The frames a sample stacks, as the reference config means them:
    1 + `num_ref_frames` where the data config gives it (the 10-sweeps
    config: the current frame and one sweep), else its `num_frames`, else
    the model's `num_frames` (1 without a model config). The
    reference-frame count comes first because a config that inherits the
    camsync base's data dict also inherits its `num_frames=1`."""
    if data_cfg.get('num_ref_frames') is not None:
        return 1 + int(data_cfg['num_ref_frames'])
    if data_cfg.get('num_frames') is not None:
        return int(data_cfg['num_frames'])
    return getattr(model_cfg, 'num_frames', 1)


def _pad44(m):
    m = np.asarray(m)
    out = np.eye(4)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def assemble_multiview_sample(info, data_root, num_frames=1,
                              target_hw=(640, 960), num_views=5, max_gt=64):
    """The (F, V, H, W, 3) float32 image stack (BGR, normalised) and the
    (F, V, 4, 4) lidar2img of one frame info, plus its padded gt.

    Each view is scaled to fit inside `target_hw` (one factor, the top
    left corner kept, zeros around it) and its lidar2img scaled with it.
    Previous frames' lidar2img are rewritten by ego-motion so that all
    frames project from the CURRENT vehicle frame (reference
    loading.py:122-142): l2i_prev' = l2i_prev @ inv(prev_e2g) @ cur_e2g.
    A missing image leaves its view zero with an identity lidar2img.
    """
    cur_e2g = _pad44(info.get('ego2global', np.eye(4)))
    frames = [dict(images=info['images'], ego2global=cur_e2g)]
    for sweep in info.get('sweeps', [])[:max(num_frames - 1, 0)]:
        frames.append(dict(images=sweep['images'],
                           ego2global=_pad44(sweep['ego2global'])))
    while len(frames) < num_frames:          # static-scene fallback
        frames.append(frames[-1])

    h_t, w_t = target_hw
    imgs = np.zeros((num_frames, num_views, h_t, w_t, 3), np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (num_frames, num_views, 1, 1))
    for fi, frame in enumerate(frames):
        rel = np.linalg.inv(frame['ego2global']) @ cur_e2g
        for vi, cam in enumerate(frame['images'][:num_views]):
            img = read_image(os.path.join(data_root, cam['image_path']))
            if img is None:
                continue
            scale = min(h_t / img.shape[0], w_t / img.shape[1])
            nh, nw = int(img.shape[0] * scale), int(img.shape[1] * scale)
            img = np.clip(np.floor(resize_linear_cv2(img, nw, nh) + 0.5),
                          0, 255)
            imgs[fi, vi, :nh, :nw] = (img - IMG_MEAN) / IMG_STD
            m = _pad44(np.asarray(cam['lidar2img'], np.float64))
            l2i[fi, vi] = (np.diag([scale, scale, 1.0, 1.0]) @ m @ rel
                           ).astype(np.float32)

    annos = info.get('annos', {})
    g = min(len(annos.get('labels', [])), max_gt)
    gt = np.zeros((max_gt, 7), np.float32)
    gl = np.zeros((max_gt,), np.int64)
    gm = np.zeros((max_gt,), bool)
    if g:
        gt[:g] = np.asarray(annos['gt_boxes'], np.float32)[:g]
        gl[:g] = np.asarray(annos['labels'], np.int64)[:g]
        gm[:g] = True
    return dict(imgs=imgs, lidar2img=l2i, gt_boxes=gt, gt_labels=gl,
                gt_mask=gm)


class WaymoDataset:
    """Info-file-backed multi-view dataset (the reference's
    waymo_dataset.py:88-180). `load_mode`:

    * 'lidar_frame': one sample per frame with all its views;
    * 'cam_frame': one sample per (frame, camera), `num_views` cameras a
      frame (the reference's convert_info_frame2img, :117-138), each with
      that camera's image and lidar2img and the GT boxes whose centres
      project inside its image (PGD-Waymo multi-view);
    * 'cam_mono': as 'cam_frame', camera 0 alone.

    `cam_sync=True` swaps each info's annotations for its
    camera-synchronised set (:145-147)."""

    # class index -> Waymo type id (Car, Pedestrian, Cyclist)
    CLASS_TO_WAYMO_TYPE = (1, 2, 4)

    def __init__(self, data_root, info_path_or_list, num_frames=1,
                 target_hw=(640, 960), num_views=5, max_gt=64,
                 load_mode='lidar_frame', cam_sync=False):
        if load_mode not in ('lidar_frame', 'cam_frame', 'cam_mono'):
            raise ValueError(f'WaymoDataset load_mode {load_mode!r}: one of '
                             "'lidar_frame', 'cam_frame', 'cam_mono'")
        self.data_root = data_root
        if isinstance(info_path_or_list, str):
            with open(info_path_or_list, 'rb') as f:
                self.infos = pickle.load(f)
        else:
            self.infos = info_path_or_list
        if cam_sync:
            for info in self.infos:
                if 'cam_sync_annos' in info:
                    info['annos'] = info['cam_sync_annos']
        self.load_mode = load_mode
        self.num_frames = num_frames
        self.target_hw = tuple(target_hw)
        self.num_views = num_views if load_mode == 'lidar_frame' else 1
        self.max_gt = max_gt
        if load_mode == 'cam_frame':
            self.cam_index = [(i, v) for i in range(len(self.infos))
                              for v in range(num_views)]
        elif load_mode == 'cam_mono':
            self.cam_index = [(i, 0) for i in range(len(self.infos))]
        else:
            self.cam_index = None

    def __len__(self):
        if self.cam_index is not None:
            return len(self.cam_index)
        return len(self.infos)

    def _cam_info(self, idx):
        """The info of sample `idx` of a camera mode: the frame's info
        with that camera's image alone, its GT boxes those whose centres
        lie in front of the camera and inside its image (the camera's
        'height' / 'width', else `target_hw`)."""
        fi, vi = self.cam_index[idx]
        info = dict(self.infos[fi])
        cams = info.get('images', [])
        if vi < len(cams):
            info = dict(info, images=[cams[vi]])
        annos = dict(info.get('annos', {}))
        if annos.get('gt_boxes') is not None and vi < len(cams) and \
                len(np.asarray(annos['gt_boxes'])):
            boxes = np.asarray(annos['gt_boxes'], np.float32)
            l2i = _pad44(np.asarray(cams[vi]['lidar2img'], np.float64))
            ctr = np.concatenate(
                [boxes[:, :3], np.ones((len(boxes), 1))], axis=1)
            proj = ctr @ l2i.T
            z = proj[:, 2]
            uv = proj[:, :2] / np.maximum(z[:, None], 1e-5)
            h = cams[vi].get('height', self.target_hw[0])
            w = cams[vi].get('width', self.target_hw[1])
            vis = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
                (uv[:, 1] >= 0) & (uv[:, 1] < h)
            annos['gt_boxes'] = boxes[vis]
            annos['labels'] = np.asarray(annos['labels'])[vis]
            info['annos'] = annos
        return info

    def get_sample(self, idx):
        if self.cam_index is not None:
            return assemble_multiview_sample(
                self._cam_info(idx), self.data_root, self.num_frames,
                self.target_hw, 1, self.max_gt)
        return assemble_multiview_sample(
            self.infos[idx], self.data_root, self.num_frames,
            self.target_hw, self.num_views, self.max_gt)

    def merge_multi_view_boxes(self, per_cam_results, nms_thr=0.05,
                               max_per_frame=100, score_thr=0.001):
        """One frame's per-camera detections ('boxes3d' (N, 7), 'scores',
        'labels' each) -> one set: the boxes above `score_thr` through a
        rotated BEV NMS at `nms_thr` (float32, as JAX's), the kept ones in
        descending score order, at most `max_per_frame` (reference
        waymo_dataset.py:951-1000)."""
        boxes = np.concatenate(
            [np.asarray(r['boxes3d']).reshape(-1, 7)
             for r in per_cam_results], axis=0)
        scores = np.concatenate(
            [np.asarray(r['scores']).reshape(-1) for r in per_cam_results],
            axis=0)
        labels = np.concatenate(
            [np.asarray(r['labels']).reshape(-1) for r in per_cam_results],
            axis=0)
        valid = scores > score_thr
        scores = np.where(valid, scores, 0.0)
        keep = nms_bev(
            torch.as_tensor(boxes[:, [0, 1, 3, 4, 6]], dtype=torch.float32),
            torch.as_tensor(np.where(valid, scores, -np.inf),
                            dtype=torch.float32), nms_thr).numpy()
        keep = keep & valid
        order = np.argsort(-np.where(keep, scores, -np.inf))
        sel = order[:max_per_frame]
        sel = sel[keep[sel]]
        return dict(boxes3d=boxes[sel], scores=scores[sel],
                    labels=labels[sel])

    def format_results(self, results, out_bin):
        """Vehicle-frame detections -> a Waymo Objects .bin (no KITTI
        detour: the model predicts in the vehicle frame). `results`: one
        dict a frame (in the order of `infos`) with 'boxes_3d' (N, 7)
        bottom-centre boxes, 'labels_3d' (N,), 'scores_3d' (N,). Returns
        the number of objects written."""
        objs = []
        for info, res in zip(self.infos, results):
            ctx = info.get('context_name', '')
            ts = int(info.get('timestamp_micros', info.get('timestamp', 0)))
            boxes = np.asarray(res['boxes_3d']).reshape(-1, 7)
            labels = np.asarray(res['labels_3d']).astype(int)
            scores = np.asarray(res['scores_3d'])
            for b, lb, s in zip(boxes, labels, scores):
                if not 0 <= lb < len(self.CLASS_TO_WAYMO_TYPE):
                    continue
                objs.append(ObjectPred(
                    box=Box(center_x=float(b[0]), center_y=float(b[1]),
                            center_z=float(b[2] + b[5] / 2),
                            length=float(b[3]), width=float(b[4]),
                            height=float(b[5]), heading=float(b[6])),
                    type=self.CLASS_TO_WAYMO_TYPE[lb], score=float(s),
                    context_name=ctx, frame_timestamp_micros=ts))
        with open(out_bin, 'wb') as f:
            f.write(encode_objects(objs))
        return len(objs)

    def evaluate(self, results, gt_bin, work_dir):
        """`format_results` into `work_dir`/results_waymo.bin, then
        `evaluate_waymo` against `gt_bin` (the reference's cam_sync LET
        key layout, '_source' naming the metric that ran)."""
        pred_bin = os.path.join(work_dir, 'results_waymo.bin')
        self.format_results(results, pred_bin)
        return evaluate_waymo(pred_bin, gt_bin)
