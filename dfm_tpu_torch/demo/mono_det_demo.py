"""Monocular 3D detection demo: one image and its intrinsics -> 3D boxes
printed and drawn.

    python -m dfm_tpu_torch.demo.mono_det_demo IMAGE [--fx 721.5] \\
        [--fy F] [--cx X] [--cy Y] [--score-thr 0.1] [--out vis.png] \\
        [--checkpoint X.pth] [--device cpu]

Port of `demo/mono_det_demo.py`: the image (PNG or JPEG, read by its
first bytes with `data/jpeg.py:read_image`, BGR as `cv2.imread` reads it)
and the camera [[fx, 0, cx], [0, fy, cy], [0, 0, 1]] (fy = fx, cx, cy the
image's centre unless given) go through an FCOS3D (`FCOS3DConfig` with
`--score-thr`, ResNet-101 in bfloat16, as JAX's demo builds it) by
`apis.inference_mono_3d` on the card (the CPU with `--device cpu`), with
seeded random weights unless `--checkpoint` gives a state dict in the
port's layout (`utils/weights.py:mono_key_map` of a JAX tree). It prints
the number of detections and one line per box, as JAX's demo does:
class, score, camera-frame bottom centre, sizes and yaw. With `--out`
the 12 edges of each box, projected by the camera (pixel coordinates
truncated to integers, as JAX's demo does), are drawn 2 px wide in
green on the image and written as a PNG (`data/png.py:write_png`): a
pixel is drawn where its centre lies within 1 px of an edge, the
segment clipped to the image first.
"""

import argparse
import sys

import numpy as np

from ..apis import inference_mono_3d, init_mono_model
from ..data.jpeg import read_image
from ..data.png import write_png
from ..evaluation.results import _corners_cam
from ..models.heads.fcos_mono3d import FCOS3DConfig

__all__ = ['main', 'camera', 'detection_lines', 'box_edges_uv',
           'draw_segments']

EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7))
GREEN = (0, 255, 0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('image')
    p.add_argument('--fx', type=float, default=721.5)
    p.add_argument('--fy', type=float, default=None)
    p.add_argument('--cx', type=float, default=None)
    p.add_argument('--cy', type=float, default=None)
    p.add_argument('--score-thr', type=float, default=0.1)
    p.add_argument('--out', default=None, help='PNG to draw the boxes in')
    p.add_argument('--checkpoint', default=None,
                   help="state dict in the port's layout; seeded random "
                        'weights if omitted')
    p.add_argument('--device', default=None,
                   help="torch device; the CUDA card if omitted")
    return p.parse_args(argv)


def camera(args, h, w):
    """The (3, 4) camera of the demo's flags for an (h, w) image (JAX's
    `args.cx or w / 2`: a zero cx or cy also takes the centre)."""
    return np.array([[args.fx, 0, args.cx or w / 2, 0],
                     [0, args.fy or args.fx, args.cy or h / 2, 0],
                     [0, 0, 1, 0]], np.float32)


def detection_lines(boxes, scores, labels):
    """JAX's demo lines: the count, then one line a box."""
    lines = [f'{len(boxes)} detections']
    for b, s, lb in zip(boxes, scores, labels):
        lines.append(f'  cls={int(lb)} score={s:.3f} xyz=({b[0]:.1f},'
                     f'{b[1]:.1f},{b[2]:.1f}) lhw=({b[3]:.1f},{b[4]:.1f},'
                     f'{b[5]:.1f}) ry={b[6]:.2f}')
    return lines


def box_edges_uv(boxes, cam):
    """(N, 7) camera-frame boxes -> (N, 8, 2) integer pixel corners, as
    JAX's demo projects them (depth floored at 1e-3, truncated)."""
    corners = _corners_cam(boxes[:, :3], boxes[:, 3:6][:, [0, 2, 1]],
                           boxes[:, 6])
    homo = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    uvw = homo @ np.vstack([cam, [0, 0, 0, 1]]).T
    return (uvw[..., :2] / np.maximum(uvw[..., 2:3], 1e-3)).astype(int)


def _clip(p0, p1, w, h):
    """Liang-Barsky: the part of segment p0-p1 inside [-1, w] x [-1, h]
    (None if none)."""
    t0, t1 = 0.0, 1.0
    d = p1 - p0
    for pk, qk in ((-d[0], p0[0] + 1), (d[0], w - p0[0]),
                   (-d[1], p0[1] + 1), (d[1], h - p0[1])):
        if pk == 0:
            if qk < 0:
                return None
            continue
        t = qk / pk
        if pk < 0:
            t0 = max(t0, t)
        else:
            t1 = min(t1, t)
        if t0 > t1:
            return None
    return p0 + t0 * d, p0 + t1 * d


def draw_segments(img, segments, color=GREEN, radius=1.0):
    """Draw each (p0, p1) segment into `img` (H, W, 3) in place: every
    pixel whose centre lies within `radius` of the segment."""
    h, w = img.shape[:2]
    for p0, p1 in segments:
        seg = _clip(np.asarray(p0, np.float64), np.asarray(p1, np.float64),
                    w, h)
        if seg is None:
            continue
        a, b = seg
        x0 = max(int(np.floor(min(a[0], b[0]) - radius)), 0)
        x1 = min(int(np.ceil(max(a[0], b[0]) + radius)), w - 1)
        y0 = max(int(np.floor(min(a[1], b[1]) - radius)), 0)
        y1 = min(int(np.ceil(max(a[1], b[1]) + radius)), h - 1)
        if x0 > x1 or y0 > y1:
            continue
        ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        d = b - a
        n2 = float(d @ d)
        t = np.zeros(xs.shape) if n2 == 0 else np.clip(
            ((xs - a[0]) * d[0] + (ys - a[1]) * d[1]) / n2, 0, 1)
        dist2 = (xs - a[0] - t * d[0]) ** 2 + (ys - a[1] - t * d[1]) ** 2
        hit = dist2 <= radius * radius
        img[ys[hit], xs[hit]] = color
    return img


def main(argv=None):
    args = parse_args(argv)
    img = read_image(args.image)
    if img is None:
        print(f'{args.image}: no PNG or JPEG image', file=sys.stderr)
        return 1
    h, w = img.shape[:2]
    cam = camera(args, h, w)
    handle = init_mono_model(FCOS3DConfig(score_thr=args.score_thr),
                             device=args.device)
    if args.checkpoint:
        handle['load_checkpoint'](args.checkpoint)
    det = {k: v[0].float().cpu().numpy() if v.is_floating_point()
           else v[0].cpu().numpy()
           for k, v in inference_mono_3d(handle, img, cam).items()}
    mask = det['mask'].astype(bool)
    boxes, scores = det['boxes3d'][mask], det['scores'][mask]
    print('\n'.join(detection_lines(boxes, scores, det['labels'][mask])))
    if args.out:
        uv = box_edges_uv(boxes, cam)
        draw_segments(img, [(box[a], box[b]) for box in uv
                            for a, b in EDGES])
        write_png(args.out, img)
        print('wrote', args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
