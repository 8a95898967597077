"""KITTI-DfM data pipeline (host-side numpy).

Port of `dfm_tpu/data/pipeline.py:60-150, 232-253, 283-427`: the
reference's train and test chains (configs/dfm/dfm_r34_1x8_kitti-3d-3class.py)

  VideoPipeline( LoadImage -> RandomFlip3D(with_baseline_offset)
                 -> Resize3D(0.95-1.05, cam2img_keep_ratio)
                 -> RandomCrop3D((320,1280), h from bottom, w centered)
                 -> PhotoMetricDistortion -> Normalize -> Pad )
  -> PointsFoVFilter -> PointsRangeFilter -> GenerateDepthMap(fg mask)
  -> ObjectRangeFilter(corner) -> Collect

(the test chain: no flip, resize, photometric distortion or object
filter), with the JAX package's semantics kept as they are: images
padded to the fixed crop size, GT padded to `max_gt`, every random draw
from the caller's `np.random.Generator` in the JAX pipeline's order
(the crop drawn even where its range holds one value), so a dataset
gives the same samples, and `normalize_image` subtracting the
RGB-ordered means from the BGR image, as `dfm_tpu` does. No cv2: images
are read by `png.read_png`, `resize_frame` is cv2's float32
INTER_LINEAR and `bgr_to_hsv` / `hsv_to_bgr` its float colour
conversions, in numpy.
"""

import dataclasses
import os
from typing import Optional

import numpy as np

from .calibration import Calibration
from .png import read_png

__all__ = ['Sample', 'load_video_sample', 'flip_sample_geometry',
           'resize_linear_cv2', 'resize_frame', 'crop_frame', 'bgr_to_hsv',
           'hsv_to_bgr', 'apply_photometric', 'normalize_image',
           'pad_to_fixed', 'points_fov_filter', 'points_range_filter',
           'generate_depth_map', 'object_range_filter_corner',
           'truncated_object_filter', 'ignored_object_filter', 'IMG_MEAN',
           'IMG_STD']

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


def _limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def flip_sample_geometry(sample: Sample):
    """Flip pseudo-lidar boxes / points (y -> -y, yaw -> -yaw) and the
    calibrations (reference RandomFlip3D.random_flip_data_3d +
    calib.fliplr); the images are flipped frame by frame."""
    if sample.gt_boxes is not None and len(sample.gt_boxes):
        b = sample.gt_boxes
        b[:, 1] = -b[:, 1]
        b[:, 6] = -b[:, 6]
    if sample.points is not None and len(sample.points):
        sample.points[:, 1] = -sample.points[:, 1]
    w = sample.ori_shape[1]
    sample.calib.fliplr(w)
    sample.ori_calib.fliplr(w)
    sample.flip = True


def _linear_taps(n_src, n_dst):
    """cv2's INTER_LINEAR taps along one axis: source index and weight of
    each destination index, x = (i + 0.5) * scale - 0.5 with scale =
    1 / (n_dst / n_src) in float64, rounded to float32; clamped to the
    edge pixel (weight 0 on the second tap) outside [0, n_src - 1)."""
    scale = 1.0 / (n_dst / n_src)
    x = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    i0 = np.floor(x).astype(np.int64)
    f = (x - i0.astype(np.float32)).astype(np.float32)
    lo = i0 < 0
    hi = i0 >= n_src - 1
    i0 = np.where(lo, 0, np.where(hi, n_src - 1, i0))
    f = np.where(lo | hi, np.float32(0), f).astype(np.float32)
    return i0, np.minimum(i0 + 1, n_src - 1), f


def resize_linear_cv2(img, new_w, new_h):
    """`cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)`
    of a float32 (H, W[, C]) image: half-pixel centres, edge clamp, no
    antialias; rows first resampled along x, then blended along y, in
    float32."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    x0, x1, fx = _linear_taps(w, new_w)
    y0, y1, fy = _linear_taps(h, new_h)
    fx = fx.reshape((-1,) + (1,) * (img.ndim - 2))
    rows = img[:, x0] * (np.float32(1) - fx) + img[:, x1] * fx
    fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    return (rows[y0] * (np.float32(1) - fy) + rows[y1] * fy).astype(
        np.float32)


def resize_frame(sample: Sample, img, scale_factor, is_cur):
    """Resize3D with keep_ratio + cam2img_keep_ratio: one factor."""
    h, w = img.shape[:2]
    new_w = int(w * scale_factor + 0.5)
    new_h = int(h * scale_factor + 0.5)
    img = resize_linear_cv2(img, new_w, new_h)
    if is_cur:
        sample.calib.scale(scale_factor)
        sample.scale_factor = scale_factor
    return img


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


_EPS32 = np.float32(np.finfo(np.float32).eps)
# HSV -> BGR: the (b, g, r) entries of [v, v(1-s), v(1-s h), v(1-s(1-h))]
# for each 60-degree sector (cv2's HSV2RGB_f table)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def bgr_to_hsv(img):
    """cv2.cvtColor(img, COLOR_BGR2HSV) of a float32 BGR image in [0, 1]:
    H in [0, 360), S and V in [0, 1] (cv2's RGB2HSV_f; its FLT_EPSILON
    terms make V = 0 and max = min give S = H = 0)."""
    img = np.asarray(img, np.float32)
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS32)
    k = np.float32(60) / (diff + _EPS32)
    h = np.where(v == r, (g - b) * k,
                 np.where(v == g, (b - r) * k + np.float32(120),
                          (r - g) * k + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_bgr(hsv):
    """cv2.cvtColor(hsv, COLOR_HSV2BGR) of float32 HSV (H in degrees, S, V
    in [0, 1]) -> BGR in [0, 1] (cv2's HSV2RGB_f)."""
    hsv = np.asarray(hsv, np.float32)
    h = hsv[..., 0] * np.float32(6.0 / 360.0)
    s, v = hsv[..., 1], hsv[..., 2]
    h = h - np.floor(h / np.float32(6)) * np.float32(6)   # into [0, 6)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    gray = (s == 0)[..., None]
    return np.where(gray, v[..., None], bgr).astype(np.float32)


def apply_photometric(img, rng, brightness_delta=32,
                      contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                      hue_delta=18):
    """PhotoMetricDistortion (mmdet semantics: random brightness, contrast
    before or after, saturation, hue, channel swap), with the JAX
    package's draws in its order: brightness, mode, contrast (mode 1),
    saturation, hue, contrast (mode 0), channel permutation."""
    img = img.astype(np.float32)
    if rng.integers(2):
        img += rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.integers(2)
    if mode == 1 and rng.integers(2):
        img *= rng.uniform(*contrast_range)
    # saturation / hue in float32 HSV (H in [0, 360), S / V in [0, 1])
    hsv = bgr_to_hsv(np.clip(img, 0, 255).astype(np.float32) / 255.0)
    if rng.integers(2):
        hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation_range),
                              0, 1)
    if rng.integers(2):
        hsv[..., 0] += rng.uniform(-hue_delta, hue_delta)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    img = hsv_to_bgr(hsv) * 255.0
    if mode == 0 and rng.integers(2):
        img *= rng.uniform(*contrast_range)
    if rng.integers(2):
        img = img[..., rng.permutation(3)]
    return img


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


def object_range_filter_corner(gt_boxes, gt_labels, pcr, min_num_corners=1):
    """Keep boxes with >= min_num_corners BEV corners inside the range
    (reference ObjectRangeFilter(filter_scheme='corner')); the kept
    yaws limited to [-pi, pi)."""
    if len(gt_boxes) == 0:
        return gt_boxes, gt_labels
    cx, cy = gt_boxes[:, 0], gt_boxes[:, 1]
    dx, dy, yaw = gt_boxes[:, 3], gt_boxes[:, 4], gt_boxes[:, 6]
    template = np.array([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]])
    corners = template[None] * np.stack([dx, dy], -1)[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    rx = corners[..., 0] * c - corners[..., 1] * s + cx[:, None]
    ry = corners[..., 0] * s + corners[..., 1] * c + cy[:, None]
    inside = ((rx >= pcr[0]) & (rx <= pcr[3]) &
              (ry >= pcr[1]) & (ry <= pcr[4]))
    keep = inside.sum(axis=1) >= min_num_corners
    gt_boxes = gt_boxes[keep]
    gt_labels = gt_labels[keep]
    gt_boxes[:, 6] = _limit_period(gt_boxes[:, 6], 0.5, 2 * np.pi)
    return gt_boxes, gt_labels


def _filter_annos(annos, valid):
    out = {}
    for k, v in annos.items():
        if k == 'plane' or np.ndim(v) == 0 or len(v) != len(valid):
            out[k] = v
        else:
            out[k] = np.asarray(v)[valid]
    return out


def truncated_object_filter(annos, truncated_threshold=0.98):
    """Drop heavily truncated objects from an annotation dict (reference
    TruncatedObjectFilter, transforms_3d.py:915-957); 'plane' passes."""
    return _filter_annos(annos, np.asarray(annos['truncated']) <
                         truncated_threshold)


def ignored_object_filter(annos):
    """Drop label == -1 objects (reference IgnoredObjectFilter,
    transforms_3d.py:970-995)."""
    return _filter_annos(annos, np.asarray(annos['labels']) > -1)


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
    """The DfM-KITTI sample: network-ready arrays.

    Args:
        info: dict from the info file (see `data/kitti.py`): image paths,
            calib (P2/R0/V2C), annos (pseudo-lidar boxes + labels),
            sweeps (prev frames w/ cam2global), optional 'points_pl'.
        rng: np.random.Generator; the draws, in order: the sweep
            (train), the flip, the scale (train), then per frame the
            crop's two offsets (first frame only; later frames reuse
            them) and `apply_photometric`'s draws (train).

    Returns:
        dict of static-shape arrays: img (2,H,W,3), meta fields, padded
        gt + mask, depth maps.
    """
    # --- frame selection (VideoPipeline, loading.py:432-440)
    sweeps = info.get('sweeps', [])
    if len(sweeps):
        if train:
            ids = rng.choice(len(sweeps), num_ref_imgs,
                             replace=num_ref_imgs > len(sweeps))
        else:
            ids = np.arange(len(sweeps))[-num_ref_imgs:]
    else:
        ids = []

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

    # --- per-frame transforms with matched flip / scale / crop
    do_flip = train and (rng.random() < flip_ratio)
    scale = rng.uniform(*scale_range) if train else 1.0
    if do_flip:
        flip_sample_geometry(sample)

    out_imgs = []
    offsets = None
    for fi, img in enumerate(sample.imgs):
        if do_flip:
            img = img[:, ::-1].copy()
        if train:
            img = resize_frame(sample, img, scale, is_cur=(fi == 0))
        img, offs = crop_frame(sample, img, crop_size, (1.0, 1.0),
                               (0.5, 0.5), rng, is_cur=(fi == 0),
                               offsets=offsets)
        offsets = offs  # matched crop across frames
        if train:
            img = apply_photometric(img, rng)
        img = normalize_image(img)
        img = pad_to_fixed(img, crop_size)
        out_imgs.append(img)
    sample.pad_shape = out_imgs[0].shape[:2]

    # --- point / gt filtering + depth map (cur frame)
    if sample.points is not None:
        sample.points = points_fov_filter(sample.points, sample.ori_calib,
                                          sample.ori_shape)
        sample.points = points_range_filter(sample.points, pcr)
        generate_depth_map(sample)
    if train and sample.gt_boxes is not None:
        sample.gt_boxes, sample.gt_labels = object_range_filter_corner(
            sample.gt_boxes, sample.gt_labels, pcr)

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
