"""KITTI-DfM data pipeline, evaluation half (host-side numpy).

Port of `dfm_tpu/data/pipeline.py` for `train=False`: the reference's
test chain (configs/dfm/dfm_r34_1x8_kitti-3d-3class.py)

  VideoPipeline( LoadImage -> RandomCrop3D((320,1280), h from bottom,
                 w centered) -> Normalize -> Pad )
  -> PointsFoVFilter -> PointsRangeFilter -> GenerateDepthMap(fg mask)
  -> Collect

with the JAX package's semantics kept as they are: images padded to
the fixed crop size, GT padded to `max_gt`, the crop drawn from the
caller's `np.random.Generator` even where its range holds one value
(the same draws in the same order as the JAX pipeline, so a dataset
gives the same samples), and `normalize_image` subtracting the
RGB-ordered means from the BGR image, as `dfm_tpu` does. Images are
read by `png.read_png` (no cv2). The training half (flip, resize,
photometric distortion, object range filter) comes with training.
"""

import dataclasses
import os
from typing import Optional

import numpy as np

from .calibration import Calibration
from .png import read_png

__all__ = ['Sample', 'load_video_sample', 'crop_frame', 'normalize_image',
           'pad_to_fixed', 'points_fov_filter', 'points_range_filter',
           'generate_depth_map', 'IMG_MEAN', 'IMG_STD']

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclasses.dataclass
class Sample:
    """Mutable pipeline state for one temporal pair."""
    imgs: list                        # [cur, prev] HxWx3 float32 (aug'd)
    calib: Calibration                # augmented calibration (cur frame)
    ori_calib: Calibration            # pre-augmentation calibration
    cur2prevs: np.ndarray             # (N-1, 4, 4)
    ori_shape: tuple                  # (H, W) pre-aug
    flip: bool = False
    scale_factor: float = 1.0
    crop_offset: tuple = (0, 0)
    pad_shape: tuple = None
    gt_boxes: Optional[np.ndarray] = None     # (G, 7) pseudo-lidar
    gt_labels: Optional[np.ndarray] = None    # (G,)
    points: Optional[np.ndarray] = None       # (P, 3+) pseudo-lidar
    depth_img: Optional[np.ndarray] = None
    depth_fgmask_img: Optional[np.ndarray] = None


def crop_frame(sample: Sample, img, crop_size, rel_offset_h, rel_offset_w,
               rng, is_cur, offsets=None):
    """RandomCrop3D; DfM uses rel_offset_h=(1,1) (bottom crop) and
    rel_offset_w=(0.5,0.5) (center). Returns cropped img."""
    margin_h = max(img.shape[0] - crop_size[0], 0)
    margin_w = max(img.shape[1] - crop_size[1], 0)
    if offsets is None:
        off_h = rng.integers(int(rel_offset_h[0] * margin_h),
                             int(rel_offset_h[1] * margin_h) + 1)
        off_w = rng.integers(int(rel_offset_w[0] * margin_w),
                             int(rel_offset_w[1] * margin_w) + 1)
    else:
        off_h, off_w = offsets
    ch = min(crop_size[0], img.shape[0])
    cw = min(crop_size[1], img.shape[1])
    img = img[off_h:off_h + ch, off_w:off_w + cw]
    if is_cur:
        sample.calib.offset(off_w, off_h)
        sample.crop_offset = (off_w, off_h)
    return img, (off_h, off_w)


def normalize_image(img, mean=IMG_MEAN, std=IMG_STD):
    return (img.astype(np.float32) - mean) / std


def pad_to_fixed(img, target_hw):
    """Zero-pad bottom/right to a FIXED shape (the reference pads to /32,
    which varies per image, transforms_3d Pad)."""
    h, w = img.shape[:2]
    th, tw = target_hw
    out = np.zeros((th, tw) + img.shape[2:], img.dtype)
    out[:min(h, th), :min(w, tw)] = img[:th, :tw]
    return out


def points_fov_filter(points, ori_calib, ori_shape):
    """Keep pseudo-lidar points projecting inside the original image
    (reference PointsFoVFilter)."""
    rect = ori_calib.lidar_pseudo_to_rect(points[:, :3])
    uv, depth = ori_calib.rect_to_img(rect)
    h, w = ori_shape[:2]
    keep = ((uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) &
            (uv[:, 1] < h) & (depth > 0))
    return points[keep]


def points_range_filter(points, pcr):
    keep = ((points[:, 0] >= pcr[0]) & (points[:, 0] <= pcr[3]) &
            (points[:, 1] >= pcr[1]) & (points[:, 1] <= pcr[4]))
    return points[keep]


def _points_in_boxes_bev(pts_xy, boxes):
    """(P,2) x (G,7) -> (P,) box index or -1 (first match wins)."""
    out = np.full(len(pts_xy), -1, np.int64)
    for g in range(len(boxes) - 1, -1, -1):
        cx, cy, dx, dy, yaw = boxes[g, 0], boxes[g, 1], boxes[g, 3], \
            boxes[g, 4], boxes[g, 6]
        rel = pts_xy - np.array([cx, cy])
        c, s = np.cos(-yaw), np.sin(-yaw)
        lx = rel[:, 0] * c - rel[:, 1] * s
        ly = rel[:, 0] * s + rel[:, 1] * c
        inside = (np.abs(lx) <= dx / 2) & (np.abs(ly) <= dy / 2)
        out[inside] = g
    return out


def generate_depth_map(sample: Sample, generate_fgmask=True):
    """Project pseudo-lidar points into the augmented image -> sparse
    depth map (+ foreground box-id mask), reference `GenerateDepthMap`
    (transforms_3d.py:55-118). Uses the *augmented* calibration so depth
    pixels align with the network input."""
    h, w = sample.pad_shape
    depth = np.zeros((h, w), np.float32)
    fg = np.zeros((h, w), np.int32)
    pts = sample.points
    if pts is None or len(pts) == 0:
        sample.depth_img = depth
        sample.depth_fgmask_img = fg
        return sample
    rect = sample.calib.lidar_pseudo_to_rect(pts[:, :3])
    uv, d = sample.calib.rect_to_img(rect)
    u = np.round(uv[:, 0]).astype(np.int64)
    v = np.round(uv[:, 1]).astype(np.int64)
    keep = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (d > 0)
    u, v, d = u[keep], v[keep], d[keep]
    # nearest point wins: sort descending depth so closer overwrites
    order = np.argsort(-d)
    depth[v[order], u[order]] = d[order]
    if generate_fgmask and sample.gt_boxes is not None and \
            len(sample.gt_boxes):
        box_id = _points_in_boxes_bev(pts[keep][:, :2], sample.gt_boxes)
        fg[v[order], u[order]] = (box_id[order] + 1)
    sample.depth_img = depth
    sample.depth_fgmask_img = fg
    return sample


def _read_image(path):
    img = read_png(path)
    if img is None:
        raise FileNotFoundError(f'no readable PNG image at {path}')
    return img


def load_video_sample(info,
                      data_root,
                      rng,
                      train=True,
                      crop_size=(320, 1280),
                      scale_range=(0.95, 1.05),
                      flip_ratio=0.5,
                      num_ref_imgs=1,
                      pcr=(2, -30.4, -3, 59.6, 30.4, 1),
                      max_gt=32,
                      with_depth=True):
    """The DfM-KITTI evaluation sample: network-ready arrays.

    Args:
        info: dict from the info file (see `data/kitti.py`): image paths,
            calib (P2/R0/V2C), annos (pseudo-lidar boxes + labels),
            sweeps (prev frames w/ cam2global), optional 'points_pl'.
        rng: np.random.Generator (the crop draws from it).
        train: must be False (True, the JAX default, raises until the
            training half is ported); `scale_range` and `flip_ratio`
            configure that half and are not used.

    Returns:
        dict of static-shape arrays: img (2,H,W,3), meta fields, padded
        gt + mask, depth maps.
    """
    if train:
        raise NotImplementedError(
            'the training pipeline (flip, resize, photometric distortion, '
            'object range filter) is not ported: it comes with Slice B, '
            'DfM training')

    # --- frame selection (VideoPipeline, loading.py:432-440)
    sweeps = info.get('sweeps', [])
    ids = np.arange(len(sweeps))[-num_ref_imgs:] if len(sweeps) else []

    img_cur = _read_image(os.path.join(
        data_root, info['image']['image_path'])).astype(np.float32)
    prev_imgs = []
    prev_c2g = []
    for i in ids:
        im = read_png(os.path.join(data_root, sweeps[i]['data_path']))
        prev_imgs.append((im if im is not None else
                          img_cur.copy()).astype(np.float32))
        prev_c2g.append(np.asarray(sweeps[i]['cam2global'], np.float64))
    if not prev_imgs:  # static scene fallback: reuse cur frame
        prev_imgs = [img_cur.copy()]
        prev_c2g = [np.asarray(info['cam2global'], np.float64)]

    cur_c2g = np.asarray(info['cam2global'], np.float64)
    cur2prevs = np.stack(
        [np.linalg.inv(_pad44(p)) @ _pad44(cur_c2g) for p in prev_c2g])

    calib = Calibration(np.asarray(info['calib']['P2'], np.float64)[:3],
                        info['calib'].get('R0_rect', None),
                        info['calib'].get('Tr_velo_to_cam', None))
    ori_calib = Calibration(calib.P2.copy(), calib.R0.copy(),
                            calib.V2C.copy())

    sample = Sample(
        imgs=[img_cur] + prev_imgs, calib=calib, ori_calib=ori_calib,
        cur2prevs=cur2prevs, ori_shape=img_cur.shape[:2])

    annos = info.get('annos', {})
    sample.gt_boxes = np.asarray(
        annos.get('gt_boxes_pl', np.zeros((0, 7))), np.float32).copy()
    sample.gt_labels = np.asarray(
        annos.get('labels', np.zeros((0,))), np.int64).copy()
    if with_depth and 'points_pl' in info:
        sample.points = np.asarray(info['points_pl'], np.float32).copy()

    # --- per-frame transforms with a matched crop
    out_imgs = []
    offsets = None
    for fi, img in enumerate(sample.imgs):
        img, offs = crop_frame(sample, img, crop_size, (1.0, 1.0),
                               (0.5, 0.5), rng, is_cur=(fi == 0),
                               offsets=offsets)
        offsets = offs  # matched crop across frames
        img = normalize_image(img)
        img = pad_to_fixed(img, crop_size)
        out_imgs.append(img)
    sample.pad_shape = out_imgs[0].shape[:2]

    # --- point filtering + depth map (cur frame)
    if sample.points is not None:
        sample.points = points_fov_filter(sample.points, sample.ori_calib,
                                          sample.ori_shape)
        sample.points = points_range_filter(sample.points, pcr)
        generate_depth_map(sample)

    # --- static-shape packing
    g = len(sample.gt_boxes) if sample.gt_boxes is not None else 0
    g = min(g, max_gt)
    gt_boxes = np.zeros((max_gt, 7), np.float32)
    gt_labels = np.zeros((max_gt,), np.int64)
    gt_mask = np.zeros((max_gt,), bool)
    if g:
        gt_boxes[:g] = sample.gt_boxes[:g]
        gt_labels[:g] = sample.gt_labels[:g]
        gt_mask[:g] = True

    return dict(
        img=np.stack(out_imgs[:2], axis=0),
        ori_cam2img=np.asarray(ori_calib.cam2img, np.float32),
        cam2img=np.asarray(sample.calib.cam2img, np.float32),
        cur2prev=sample.cur2prevs[0].astype(np.float32),
        org_w=np.float32(sample.ori_shape[1]),
        flip=np.float32(sample.flip),
        crop_offset=np.asarray(sample.crop_offset, np.float32),
        scale_factor=np.float32(sample.scale_factor),
        gt_boxes=gt_boxes, gt_labels=gt_labels, gt_mask=gt_mask,
        depth_img=(sample.depth_img if sample.depth_img is not None else
                   np.zeros(sample.pad_shape, np.float32)),
        depth_fgmask_img=(sample.depth_fgmask_img
                          if sample.depth_fgmask_img is not None else
                          np.zeros(sample.pad_shape, np.int32)))


def _pad44(m):
    out = np.eye(4)
    out[:m.shape[0], :m.shape[1]] = m
    return out
