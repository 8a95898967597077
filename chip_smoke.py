#!/usr/bin/env python3
"""Drive the PyTorch port (dfm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and no result is printed:
  1. device   card name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc for every kernel source, all at once
  3. kernels  K1 warp_prev (the sweep, its points computed in the
              kernel, at the KITTI meta and a flip + crop + scale meta, its
              points also held against plane_sweep_grids, 2e-3 px), K3
              attention_sample, K2 frustum_stereo_sample (fused: stereo +
              sem samples x K3's attention + concat, the two halves held
              apart, the sem half, ~1/288 of the stereo half's size, to
              one bf16 rounding of its own size) at the DfM-KITTI
              main-path shapes; K8a pack_vol, K8b
              unpack_vol, K4 conv_p2p (with and without the residual),
              K7a unpack_affine_res (stem exit and pred exit), K7b
              gn_affine_res_packed (with and without residual and relu),
              K5 conv_s2_p2d and K6 pack_parity8 at both volumes the main
              path gives them, the stereo trunk's 72 depth slices and the
              reduced mono trunk's 44: each kernel against its plain
              PyTorch version on the same inputs (stated tolerance), the
              zero border of every chain tensor a kernel writes, K4, K5
              and K6 run twice and compared bit for bit, kernel / plain /
              one-call library times (CUDA events, median of 20 after
              warmup), and the bound: the bytes the function needs (rows
              of a gathered table it touches, coordinates, volumes in
              and out) over 3.35 TB/s, against its operations over the
              peak for their type (f32 67 TFLOP/s; K4's and K5's bf16
              products on the tensor cores 989 TFLOP/s, dense); K4's
              achieved TFLOP/s and share of that peak, K3's time over
              `F.grid_sample`'s; for K1, K2, K3, K4, K5 (both depths) and
              K9a, K9b also the device time of the kernels of one call
              (torch.profiler), without the host time around them (K9a:
              also of its conv kernel alone, without the fold of its
              partials). Then
              the K9 block: K9a conv3d_zpack (with its GroupNorm finish
              kernel) and K9b conv3d_pallas, on no model path, at the DfM
              trunk width (72, 80, 320, 32) bf16, in float32 at a smaller
              shape, K9b 16 -> 8 (bf16, f32) and 42 -> 42 and K9a 8 -> 32
              and 16 -> 24 (bf16, the `wgmma` code), each against its
              plain version, K9a's partials, its finish against the
              plain apply step (bit for bit) and `conv3d_gn` with
              residual and relu, twice bit for bit, with times, bound and
              the `F.conv3d` time (K9a, K9b: the ratio to it, the share
              of the bf16 peak, the device code each case ran); then
              their own path: the entry points
              `convgn.conv3d_zpack`, `convgn.conv3d_gn` and
              `cuda.conv3d.conv3d` once each with the launch counts set to 0
              just before and read just after
  4. main     full DfMConfig, 1x2x320x1280, bf16, seeded random weights,
              the default form (banded stems, reduced-depth mono trunk,
              both trunks on the conv chain from the cost volume to the
              pred exit): `init_dfm_model` (3 requests) and
              `init_dfm_stream` (first frame + 2 stream steps), each run
              with the launch counts set to 0 just before and read just
              after, all ten main-path kernels launched on both (K9a,
              K9b on neither), the counts of each request checked;
              then the form with only the stereo
              stem and pred ConvNorm on the chain (`packed='stem'`) and
              the dense form (`use_band=False, packed=False`), 2 timed
              requests after a warm-up each, so that the three forms'
              ms/frame and peak memory come from one run; plus decode +
              NMS on full-shape head outputs with live scores
  5. parity   tiny config in float32 with TF32 off, dense form: the same
              weights on the CPU (plain versions) and on the card
              (K1-K3); and bf16 on the card, default form against the
              dense form and against the `packed='stem'` form from the
              same weights and inputs, at the tiny config and at full
              width, the form that ran checked by its launch counts
  6. eval     a synthetic KITTI tree in a temporary directory (4 frames
              of 375x1242 and 370x1224 PNGs written with the five row
              filters in turn, KITTI's own P2 of two drives, poses with
              0.8 m of forward motion, labels with Car, Pedestrian,
              Cyclist, Van and DontCare rows, velodyne points; frame 2
              without a prev image): `dfm_tpu_torch.tools.create_data`
              and then the CLI `dfm_tpu_torch.tools.test` on
              configs/dfm_r34_kitti_3class.py with a seeded checkpoint
              (mmcv layout, with teacher and BatchNorm-counter keys), in
              processes of their own, to 36 finite AP lines; in process
              `dataset_inference` on the default form from that
              checkpoint, with the launch counts set to 0 just before and
              read just after (each main-path kernel at its per-request
              count per frame, K9a / K9b none), the checkpoint round trip
              (the loaded model's detections equal the saved model's bit
              for bit, cuDNN deterministic), the GT echo (Car 3d easy AP
              above 99), the tiny config's annos on the card against
              the CPU's plain versions (f32, TF32 off, a 192x384 crop,
              the same seeded live weights on both, names equal, scores
              within 1e-3, boxes 2e-3, 2D boxes 0.1 px), and the
              ms per frame split into PNG decode, pipeline, model
              (synchronised) and annos, kitti_eval's ms and the peak
              memory
  7. train    (a) the tiny config in float32, TF32 off, seeded live
              weights, one training sample of the synthetic tree (flip,
              scale, photometric distortion) and the same depth-loss
              pixels on both: forward + backward on the card (K1, K2
              forward and backward, K3 forward: launches checked) against
              the CPU's plain versions, every loss term (rtol 1e-3) and
              every parameter's gradient and the whole gradient by
              relative L2 within 3x their own movement on the CPU under
              one ulp of seeded weight noise (at least 1e-3), no
              parameter with a CPU gradient left without one on the
              card; (b) the backward kernels K1-bwd
              (`warp_prev_sweep_bwd`) and K2-bwd
              (`frustum_voxel_features_bwd`) at the full-width training
              shapes in float32 against `torch.autograd.grad` of the plain
              forwards, with times, bound and `F.grid_sample`'s backward
              on the same taps; (c) the train CLI
              `dfm_tpu_torch.tools.train` on configs/dfm_r34_kitti_3class.py
              with `model.type=DfM` at full width on the tree (train and
              val infos from `create_data`) in processes of their own: 4
              steps (finite loss terms and grad_norm logged, a checkpoint
              and the KITTI eval at the end of the epoch), a resume to
              step 6 from the saved optimizer state (its sha1 checked),
              `tools.test` on the step-6 checkpoint, and the DfMFull
              config refused; (d) full-width training steps in process:
              two warm-up steps, then three with the launch counts set
              to 0 just before and read just after (a step: K1, K2 one
              forward and one backward each, K3 one forward, no other
              kernel), each split into data, forward, backward and
              optimizer (synchronised), and the peak memory; (e) 30 steps at lr 1e-3 on one frame at the
              tiny config (no augmentation): the mean loss of the last 5
              below that of the first 5
Then the kernels JSON line, the card line, and the result line.
Exits non-zero without a result when there is no CUDA device or the
package is not beside the script.
"""

import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM published peak
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12    # H100 SXM bf16 on the tensor cores, dense
REPS = 20
IMG_HW = (320, 1280)
MONO_DEPTH = 44               # slices of the reduced mono volume of 72 planes

# kernel launches of one request (one backbone pass) at full width, by form
SAMPLING = dict(warp_prev=1, frustum_stereo_sample=1, attention_sample=1)
NO_CHAIN = dict(pack_vol=0, conv_p2p=0, unpack_affine_res=0, conv_s2_p2d=0,
                pack_parity8=0, gn_affine_res_packed=0, unpack_vol=0)
# K9a (with its GroupNorm finish), K9b: on no model path (their path is
# their own entry points); the backward kernels of K1 and K2 run in
# training only (phase 7)
OFF_PATH = dict(conv3d_zpack=0, conv3d_gn_finish=0, conv3d_pallas=0,
                warp_prev_bwd=0, frustum_stereo_sample_bwd=0)
LAUNCHES_OF = {
    'dense': {**SAMPLING, **NO_CHAIN, **OFF_PATH},
    # K8a prev + pred, K4 dres0 + dres1 + pred, K7a stem + pred exit
    'stem': {**SAMPLING, **NO_CHAIN, **OFF_PATH, 'pack_vol': 2,
             'conv_p2p': 3, 'unpack_affine_res': 2},
    # stereo: K8a, K4 x3, K5, K6, K7b x2 (stem + hourglass exit), K7a, K8b;
    # mono: K8a, K5, K6, K7b (hourglass exit), K4, K7a, K8b
    'chain': {**SAMPLING, **OFF_PATH, 'pack_vol': 2, 'conv_p2p': 4,
              'unpack_affine_res': 2, 'conv_s2_p2d': 2, 'pack_parity8': 2,
              'gn_affine_res_packed': 3, 'unpack_vol': 2},
    # 12 depth planes have no reduced-depth plan: the mono trunk is dense
    'chain, stereo trunk only': {
        **SAMPLING, **OFF_PATH, 'pack_vol': 1, 'conv_p2p': 3,
        'unpack_affine_res': 1, 'conv_s2_p2d': 1, 'pack_parity8': 1,
        'gn_affine_res_packed': 2, 'unpack_vol': 1},
}
# one training step (float32, the banded form): K1 and K2 forward and
# backward, K3 forward, nothing of the conv chain or of K9
LAUNCHES_OF['train'] = {**LAUNCHES_OF['dense'], 'warp_prev_bwd': 1,
                        'frustum_stereo_sample_bwd': 1}
# the ten kernels of the main path
MAIN_PATH = [k for k, n in LAUNCHES_OF['chain'].items() if n]
TRAIN_PATH = [k for k, n in LAUNCHES_OF['train'].items() if n]
BWD_KERNELS = ('warp_prev_bwd', 'frustum_stereo_sample_bwd')
# K9's path: conv3d_zpack and conv3d_gn (K9a, + the finish), conv3d
# (K9b), once each
K9_PATH = {**dict.fromkeys(LAUNCHES_OF['chain'], 0), 'conv3d_zpack': 2,
           'conv3d_gn_finish': 1, 'conv3d_pallas': 1}
FORM_ARGS = {'chain': {}, 'stem': dict(packed='stem'),
             'dense': dict(use_band=False, packed=False)}


def check_launches(got, form, requests, what):
    want = {k: n * requests for k, n in LAUNCHES_OF[form].items()}
    check(dict(got) == want, f'{what}: launched {dict(got)}, the {form} '
          f'form launches {want} in {requests} request(s)')


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def cuda_ms(fn, reps=REPS, warmup=3):
    """Median milliseconds of `fn` over `reps` launches, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=5, kernel=None):
    """Device time of the kernels one call of `fn` launches (their sum,
    torch.profiler; of those whose name holds `kernel`, if given),
    without the host time around them that `cuda_ms` also sees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and (kernel is None or kernel in e.name)) / 1e3 / reps


def card_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f'nvidia-smi failed: {res.stderr}')
    return res.stdout.strip().splitlines()[0]


def kitti_meta(batch, device):
    """KITTI-like intrinsics (f = 721.5 px) and 0.8 m forward
    ego-motion."""
    from dfm_tpu_torch.models.detectors.dfm import BatchMeta
    h, w = IMG_HW
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 721.5
    cam[0, 2], cam[1, 2] = w / 2, h / 2
    meta = BatchMeta.identity(batch, np.repeat(cam[None], batch, 0), device)
    c2p = torch.eye(4, device=device).repeat(batch, 1, 1)
    c2p[:, 2, 3] = 0.8
    meta.cur2prev = c2p
    return meta


# --- a synthetic KITTI raw tree (phase 6; the port's tests use it too)

# KITTI's P2 of two drives (a non-zero translation column), its R0_rect and
# Tr_velo_to_cam (frame 000000 of the object split)
KITTI_P2 = (
    ((7.215377e+02, 0, 6.095593e+02, 4.485728e+01),
     (0, 7.215377e+02, 1.728540e+02, 2.163791e-01),
     (0, 0, 1, 2.745884e-03)),
    ((7.070493e+02, 0, 6.040814e+02, 4.575831e+01),
     (0, 7.070493e+02, 1.805066e+02, -3.454157e-01),
     (0, 0, 1, 4.981016e-03)))
KITTI_R0 = (9.999239e-01, 9.837760e-03, -7.445048e-03, -9.869795e-03,
            9.999421e-01, -4.278459e-03, 7.402527e-03, 4.351614e-03,
            9.999631e-01)
KITTI_V2C = (7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03,
             1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02,
             9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01)
# (id, (H, W), P2, prev image): two widths, two intrinsics, one frame
# whose prev image is absent (the pipeline then pairs the frame with
# itself)
KITTI_FRAMES = ((0, (375, 1242), 0, True), (1, (370, 1224), 1, True),
                (2, (375, 1242), 0, False), (3, (370, 1224), 1, True))
# camera-frame objects: name, (h, w, l), bottom centre (x, y, z), ry;
# 11 cars a frame, so that four frames hold the 41 easy cars that the
# 40-point AP needs to reach 100 on a perfect echo (n ground truths give
# at most (n - 1) / 40 below that)
KITTI_OBJECTS = tuple(
    [('Car', (1.5, 1.6, 3.9), (x, 1.65, z), -1.57 + 0.05 * k)
     for k, (x, z) in enumerate(((-3, 9), (3, 9), (-7, 14), (-3.5, 14),
                                 (0, 14), (3.5, 14), (7, 14), (-8, 20),
                                 (-4, 20), (4, 20), (8, 20)))]
    + [('Pedestrian', (1.75, 0.6, 0.8), (0.0, 1.7, 9.0), -1.2),
       ('Pedestrian', (1.75, 0.6, 0.8), (0.0, 1.7, 20.0), 0.4),
       ('Cyclist', (1.7, 0.6, 1.8), (-1.5, 1.7, 24.0), 1.5),
       ('Cyclist', (1.7, 0.6, 1.8), (6.0, 1.7, 24.0), -1.5),
       ('Van', (2.1, 1.9, 4.8), (10.0, 1.7, 26.0), 0.3)])
FORWARD_M = 0.8               # ego-motion from the prev frame to the frame


def png_bytes(img_bgr):
    """An 8-bit RGB PNG of (H, W, 3) uint8 BGR, row r stored with filter
    r % 5 (None, Sub, Up, Average, Paeth), so a reader's five branches
    all run."""
    import zlib
    h, w, _ = img_bgr.shape
    raw = np.ascontiguousarray(img_bgr[..., ::-1]).reshape(h, w * 3)
    raw = raw.astype(np.int16)
    a = np.zeros_like(raw)
    a[:, 3:] = raw[:, :-3]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, 3:] = raw[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kind = (np.arange(h) % 5)[:, None]
    filtered = (raw - np.choose(kind, (0, a, b, (a + b) >> 1, paeth))) & 0xFF
    data = np.concatenate([kind, filtered], 1).astype(np.uint8).tobytes()

    def chunk(tag, body):
        return (len(body).to_bytes(4, 'big') + tag + body
                + zlib.crc32(tag + body).to_bytes(4, 'big'))
    ihdr = w.to_bytes(4, 'big') + h.to_bytes(4, 'big') + bytes((8, 2, 0, 0, 0))
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
            + chunk(b'IDAT', zlib.compress(data, 6)) + chunk(b'IEND', b''))


def _box_corners(dims, loc, ry):
    """(8, 3) camera-frame corners of a KITTI box (bottom centre)."""
    h, w, l = dims
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    y = np.array([0, 0, 0, 0, -1, -1, -1, -1]) * h
    z = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([c * x + s * z + loc[0], y + loc[1],
                     -s * x + c * z + loc[2]], 1)


def write_kitti_tree(root, seed=0, frames=KITTI_FRAMES):
    """A KITTI object-split tree under `root`: training/{image_2,
    prev_2, calib, poses, label_2, velodyne} and ImageSets/{train,val}.txt
    (the same frames), the images random from `seed`; returns the frame
    ids."""
    import os
    rng = np.random.default_rng(seed)
    base = os.path.join(root, 'training')
    for sub in ('image_2', 'prev_2', 'calib', 'poses', 'label_2',
                'velodyne'):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, 'ImageSets'), exist_ok=True)
    fmt = lambda v: ' '.join(f'{x:.12e}' for x in np.ravel(v))  # noqa: E731
    for idx, (h, w), pi, with_prev in frames:
        sid = f'{idx:06d}'
        yy, xx = np.mgrid[0:h + 8, 0:w + 8]
        scene = (np.sin(xx / 23.0 + idx)[..., None] * 60
                 + np.cos(yy / 13.0)[..., None] * 40 + [90, 110, 130]
                 + rng.normal(0, 12, (h + 8, w + 8, 3)))
        scene = np.clip(scene, 0, 255).astype(np.uint8)
        with open(os.path.join(base, 'image_2', sid + '.png'), 'wb') as f:
            f.write(png_bytes(scene[4:4 + h, 4:4 + w]))
        if with_prev:
            with open(os.path.join(base, 'prev_2', sid + '_01.png'),
                      'wb') as f:
                f.write(png_bytes(scene[6:6 + h, 2:2 + w]))
        p2 = np.asarray(KITTI_P2[pi])
        with open(os.path.join(base, 'calib', sid + '.txt'), 'w') as f:
            for k in range(4):
                f.write(f'P{k}: {fmt(p2)}\n')
            f.write(f'R0_rect: {fmt(KITTI_R0)}\nTr_velo_to_cam: '
                    f'{fmt(KITTI_V2C)}\nTr_imu_to_velo: {fmt(np.eye(4)[:3])}\n')
        cur = np.eye(4)
        cur[:3, 3] = (0.3 * idx, 0.0, 5.0 * idx)
        prev = cur.copy()
        prev[2, 3] -= FORWARD_M
        np.savetxt(os.path.join(base, 'poses', sid + '.txt'),
                   np.stack([cur.ravel(), prev.ravel()]))
        lines = []
        for name, dims, loc, ry in KITTI_OBJECTS:
            corners = _box_corners(dims, loc, ry)
            uvw = np.concatenate([corners, np.ones((8, 1))], 1) @ p2.T
            uv = uvw[:, :2] / uvw[:, 2:]
            box = (max(uv[:, 0].min(), 0), max(uv[:, 1].min(), 0),
                   min(uv[:, 0].max(), w - 1), min(uv[:, 1].max(), h - 1))
            alpha = ry - np.arctan2(loc[0], loc[2])
            lines.append(f'{name} 0.00 0 {alpha:.2f} {fmt(box)} '
                         f'{fmt(dims)} {fmt(loc)} {ry:.2f}')
        lines.append('DontCare -1 -1 -10 500.0 160.0 560.0 200.0 -1 -1 -1 '
                     '-1000 -1000 -1000 -10')
        with open(os.path.join(base, 'label_2', sid + '.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')
        n = 4000          # velodyne points ahead of the car (x forward)
        pts = np.stack([rng.uniform(4, 45, n), rng.uniform(-12, 12, n),
                        rng.uniform(-1.7, 0.8, n), rng.uniform(0, 1, n)], 1)
        pts.astype(np.float32).tofile(
            os.path.join(base, 'velodyne', sid + '.bin'))
    ids = [f[0] for f in frames]
    for split in ('train', 'val'):
        with open(os.path.join(root, 'ImageSets', f'{split}.txt'), 'w') as f:
            f.write('\n'.join(f'{i:06d}' for i in ids) + '\n')
    return ids


def needed_bytes(plain, table, row_elems, *args):
    """Bytes of the rows of `table` (`row_elems` elements each) that the
    function needs: rows with a nonzero gradient through the plain
    version (every tap weight is >= 0, so nothing cancels)."""
    t = table.float().requires_grad_()
    with torch.enable_grad():
        out = plain(t, *args)
        out = out[0] if isinstance(out, tuple) else out
        out.sum().backward()
    rows = t.grad.reshape(-1, row_elems)
    return int((rows != 0).any(1).sum()) * row_elems * table.element_size()


def reporter(results):
    """The (agree, report) pair of the kernel checks: agree holds a
    kernel's result against its plain version's, report prints a
    kernel's line and keeps its entry of the kernels JSON in
    `results`."""
    def agree(name, got, want, tol):
        """Max abs err of kernel against plain, within atol + rtol."""
        err = (got.float() - want.float()).abs()
        limit = tol[0] + tol[1] * want.float().abs()
        check(bool((err <= limit).all()),
              f'{name}: kernel disagrees with its plain version '
              f'(max abs err {float(err.max())})')
        return float(err.max())

    def report(name, src, replaces, err, tol, ms, plain_ms, lib_ms, nbytes,
               flops, peak=F32_FLOPS, **extra):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        results[name] = dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            library_ms=lib_ms, **extra)
        lib = 'none' if lib_ms is None else f'{lib_ms:.4f}'
        more = ''.join(f' {k} {v:.3g}' if k.startswith('max_abs_err') else
                       f' {k} {v:.4f}' if isinstance(v, float) else
                       f' {k} {v}' for k, v in extra.items())
        print(f'kernel {name}: max_abs_err {err:.3g} '
              f'(tol atol {tol[0]} + rtol {tol[1]}) ms {ms:.4f} '
              f'plain_ms {plain_ms:.4f} library_ms {lib}{more} '
              f'bytes {nbytes} flops {flops} '
              f'bound_ms {max(t_bytes, t_ops):.4f}', flush=True)

    return agree, report


def kernel_phase(cfg, dev):
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import cost_volume as CV
    from dfm_tpu_torch.ops import frustum_separable as FS
    from dfm_tpu_torch.ops.cuda import sampling as K
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    h, w = IMG_HW
    meta = kitti_meta(1, dev)
    depths = torch.as_tensor(cfg.downsampled_depths(), device=dev)
    d = len(depths)
    hq, wq = h // cfg.cost_sample_factor, w // cfg.cost_sample_factor
    coors = cfg.coordinates_3d()
    xs, ys, zs = coors[0, 0, :, 0], coors[0, :, 0, 1], coors[:, 0, 0, 2]
    u, v = FS.slab_uv(meta.cam2img, xs, ys, zs)
    nz, ny, nx = cfg.voxel_grid_size()
    results = {}
    agree, report = reporter(results)

    # K1 at (1, 320, 1280, 32) -> (1, 72, 80, 320, 32): the sweep (grid
    # computed in the kernel) at the KITTI meta and at a flip + crop +
    # scale meta
    prev = torch.randn(1, h, w, cfg.stereo_channels[1], generator=gen,
                       device=dev).to(bf)
    step = cfg.cost_sample_factor

    def sweep_inputs(m):
        return CV.sweep_params(m.ori_cam2img, m.cur2prev, m.org_w, m.flip,
                               m.crop_offset, m.scale_factor, 1)

    params = sweep_inputs(meta)
    aug = kitti_meta(1, dev)
    aug.flip = torch.ones(1, device=dev)
    aug.crop_offset = torch.tensor([[24.0, 8.0]], device=dev)
    aug.scale_factor = torch.full((1,), 1.1, device=dev)
    tol1 = (1e-2, 1e-2)
    err1 = 0.0
    for m in (meta, aug):
        pm = sweep_inputs(m)
        got = K.warp_prev_sweep(prev, pm, depths, hq, wq, step)
        want = CV.warp_prev_plain(prev, *CV.sweep_coords_plain(
            pm, depths, hq, wq, step))
        err1 = max(err1, agree('warp_prev_sweep', got, want, tol1))
        # the sweep's points against the grids of plane_sweep_grids
        _, grid = CV.plane_sweep_grids(
            depths, m.ori_cam2img, m.cur2prev, (h, w), step, 1, m.org_w,
            m.flip, m.crop_offset, m.scale_factor)
        pu, pv = CV.sweep_coords_plain(pm, depths, hq, wq, step)
        gap = max(float((pu - grid[..., 0]).abs().max()),
                  float((pv - grid[..., 1]).abs().max()))
        check(gap <= 2e-3, f'sweep points {gap} px from plane_sweep_grids')
    _, grid = CV.plane_sweep_grids(
        depths, meta.ori_cam2img, meta.cur2prev, (h, w), step, 1,
        meta.org_w, meta.flip, meta.crop_offset, meta.scale_factor)
    gu, gv = grid[..., 0].contiguous(), grid[..., 1].contiguous()
    prev_nchw = prev.permute(0, 3, 1, 2).contiguous()
    norm = torch.stack([gu / (w - 1) * 2 - 1, gv / (h - 1) * 2 - 1],
                       -1).reshape(1, d * hq, wq, 2).to(bf)
    sweep = lambda: K.warp_prev_sweep(prev, params, depths, hq, wq,  # noqa
                                      step)
    report('warp_prev', 'dfm_tpu_torch/csrc/warp_prev.cu',
           'dfm_tpu/ops/pallas/cost_warp.py:142', err1, tol1,
           cuda_ms(sweep),
           cuda_ms(lambda: CV.warp_prev_plain(prev, *CV.sweep_coords_plain(
               params, depths, hq, wq, step))),
           cuda_ms(lambda: F.grid_sample(prev_nchw, norm,
                                         align_corners=True)),
           needed_bytes(CV.warp_prev_plain, prev, prev.shape[-1], gu, gv)
           + params.numel() * 4 + d * 4 + got.numel() * got.element_size(),
           8 * got.numel(), device_ms=device_ms(sweep),
           ms_sweep_params=cuda_ms(lambda: sweep_inputs(meta)),
           ms_plane_sweep_grids=cuda_ms(lambda: CV.plane_sweep_grids(
               depths, meta.ori_cam2img, meta.cur2prev, (h, w), step, 1,
               meta.org_w, meta.flip, meta.crop_offset, meta.scale_factor)),
           library_device_ms=device_ms(
               lambda: F.grid_sample(prev_nchw, norm, align_corners=True)))

    def lib_grid(depth_bins, hh, ww):
        """grid_sample coords (x, y, z) in [-1, 1] of every voxel."""
        zi = (torch.as_tensor(xs, device=dev) - cfg.depth_min) / (
            cfg.depth_max - cfg.depth_min) * (depth_bins - 1)
        gx = (u / (IMG_HW[1] - 1) * (ww - 1)).transpose(1, 2)[:, None]
        gy = (v / (IMG_HW[0] - 1) * (hh - 1)).transpose(1, 2)[:, :, None]
        g = torch.stack(torch.broadcast_tensors(
            gx / (ww - 1) * 2 - 1, gy / (hh - 1) * 2 - 1,
            (zi / (depth_bins - 1) * 2 - 1).view(1, 1, 1, -1)), -1)
        return g.reshape(1, nz, ny, nx, 3)

    # K3 at (1, 288, 320, 1280) -> (1, 20, 304, 288) f32; its output is
    # the attention the fused K2 takes
    cost = torch.randn(1, d, hq, wq, generator=gen, device=dev)
    sm = FS.build_fine_softmax_volume(cost, cfg.depth_downsample, IMG_HW,
                                      bf)
    df = d * cfg.depth_downsample
    dsf = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, df)
    tabf = FS.depth_tables(dsf, dev)
    att = K.attention_sample(sm, u, v, dsf, IMG_HW)
    want = FS.attention_sample_plain(sm, u, v, *tabf, IMG_HW)
    sm_ncdhw = sm[:, None]
    g3 = lib_grid(df, h, w).to(bf)
    k3_ms = cuda_ms(lambda: K.attention_sample(sm, u, v, dsf, IMG_HW))
    k3_lib = cuda_ms(lambda: F.grid_sample(sm_ncdhw, g3, align_corners=True))
    report('attention_sample', 'dfm_tpu_torch/csrc/frustum_sample.cu',
           'dfm_tpu/ops/pallas/frustum_sample.py:233',
           agree('attention_sample', att, want, (1e-5, 1e-5)), (1e-5, 1e-5),
           k3_ms,
           cuda_ms(lambda: FS.attention_sample_plain(sm, u, v, *tabf,
                                                     IMG_HW)),
           k3_lib,
           needed_bytes(FS.attention_sample_plain, sm, 1, u, v, *tabf,
                        IMG_HW)
           + (u.numel() + v.numel()) * 4 + att.numel() * 4,
           16 * att.numel(), ratio_to_grid_sample=k3_ms / k3_lib,
           device_ms=device_ms(
               lambda: K.attention_sample(sm, u, v, dsf, IMG_HW)),
           library_device_ms=device_ms(
               lambda: F.grid_sample(sm_ncdhw, g3, align_corners=True)))
    del sm, sm_ncdhw, g3

    # K2 fused at (1, 72, 80, 320, 32) + sem (1, 80, 320, 32) + K3's
    # attention -> (1, 20, 304, 288, 64)
    vol = torch.randn(1, d, hq, wq, cfg.cv_channels, generator=gen,
                      device=dev).to(bf)
    sem = torch.randn(1, hq, wq, cfg.sem_channels[1], generator=gen,
                      device=dev).to(bf)
    ds = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, d)
    tabs = FS.depth_tables(ds, dev)
    fused = lambda: K.frustum_voxel_features(vol, sem, att, u, v,  # noqa
                                             ds, IMG_HW)
    got = fused()
    want = FS.frustum_voxel_features_plain(vol, sem, att, u, v, *tabs,
                                           IMG_HW)
    check(got.shape == (1, nz, ny, nx, vol.shape[-1] + sem.shape[-1]),
          f'frustum_voxel_features: shape {tuple(got.shape)}')
    # the halves apart: the sem half is the sem sample times K3's
    # attention (~1/288 here), so the stereo half's bound would not see it
    c = vol.shape[-1]
    sem_tol = (1e-5, 2.0 ** -8)       # one bf16 rounding of its own size
    err_stereo = agree('frustum_voxel_features stereo half', got[..., :c],
                       want[..., :c], (1e-2, 1e-2))
    err_sem = agree('frustum_voxel_features sem half', got[..., c:],
                    want[..., c:], sem_tol)
    check(bool((want[..., c:] != 0).any()),
          'frustum_voxel_features: the sem half is all zero')
    vol_ncdhw = vol.permute(0, 4, 1, 2, 3).contiguous()
    g2 = lib_grid(d, hq, wq).to(bf)
    sem_rows = needed_bytes(
        lambda s, *a: FS.frustum_voxel_features_plain(vol.float(), s, att,
                                                      *a),
        sem, sem.shape[-1], u, v, *tabs, IMG_HW)
    vol_rows = needed_bytes(FS.stereo_sample_plain, vol, vol.shape[-1], u,
                            v, *tabs, IMG_HW)
    report('frustum_stereo_sample', 'dfm_tpu_torch/csrc/frustum_sample.cu',
           'dfm_tpu/ops/pallas/frustum_sample.py:92',
           max(err_stereo, err_sem), (1e-2, 1e-2),
           cuda_ms(fused),
           cuda_ms(lambda: FS.frustum_voxel_features_plain(
               vol, sem, att, u, v, *tabs, IMG_HW)),
           cuda_ms(lambda: F.grid_sample(vol_ncdhw, g2,
                                         align_corners=True)),
           vol_rows + sem_rows + att.numel() * 4
           + (u.numel() + v.numel()) * 4 + got.numel() * 2,
           16 * got[..., :c].numel() + 9 * got[..., c:].numel(),
           max_abs_err_stereo=err_stereo, max_abs_err_sem=err_sem,
           sem_tol=f'atol {sem_tol[0]} + rtol {sem_tol[1]}',
           device_ms=device_ms(fused),
           library_device_ms=device_ms(
               lambda: F.grid_sample(vol_ncdhw, g2, align_corners=True)))
    del g2, vol_ncdhw
    chain_kernel_phase(vol[0], gen, agree, report)
    for name, n in conv3d_kernel_phase(vol[0], gen, agree, report).items():
        if name in results:     # the backward kernels report in phase 7
            results[name]['launches'] = n
    return results


def moments_agree(name, ps, want_ps, n):
    """Per-slice moments (summed over tiles) against the plain version's:
    sums of squares rtol 1e-4; sums rtol 1e-4 + atol 1e-6 * sqrt(n * sum
    of squares), n values per sum."""
    got_z, want_z = ps.sum(1).double(), want_ps.sum(1).double()
    lim = 1e-4 * want_z.abs()
    lim[:, 0] += 1e-6 * (n * want_z[:, 1]).sqrt()
    check(bool(((got_z - want_z).abs() <= lim).all()),
          f'{name}: moments disagree')


def chain_kernel_phase(x, gen, agree, report):
    """K8a, K8b, K4, K7a, K7b, K5, K6 at the two volumes the main path
    gives them: the stereo trunk's (72, 80, 320, 32) bf16 and the reduced
    mono trunk's (44, 80, 320, 32), where K4 splits the depth in other
    chunks and K7a's scale and bias come from moments weighted by the
    slice multiplicities. The copies (K8a, K8b, K6) and K7b against their
    plain versions' bits (K7a within a rounding); the convs agree with
    the plain versions to one bf16 rounding (atol 1e-2 + rtol 1e-2: the
    f32 sums of 864 products are taken in another order, so a result near
    a rounding boundary may round the other way). Moments: sums of
    squares rtol 1e-4; sums rtol 1e-4 + atol 1e-6 * sqrt(N * sum of
    squares), N values per sum (a sum of signed terms cancels, so its
    error scales with the terms, not with the sum). The plain K4 and K5
    convolve in f32 with cuDNN's TF32 off (bf16-valued operands are exact
    either way). Kernel times at both depths; plain and library times,
    and the bound, at depth 72."""
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import conv_chain as CC
    from dfm_tpu_torch.ops.cuda import conv_chain as KC
    from dfm_tpu_torch.ops.reduced_depth import make_reduced_plan
    src = 'dfm_tpu_torch/csrc/conv_chain.cu'
    src_p2p = 'dfm_tpu_torch/csrc/conv_p2p.cuh'
    src_hg = 'dfm_tpu_torch/csrc/hourglass_chain.cu'
    jax_src = 'dfm_tpu/ops/pallas/conv_chain.py'
    tol = (1e-2, 1e-2)
    dev = x.device
    d, h, w, c = x.shape
    plan = make_reduced_plan(d)
    check(plan is not None and plan.dr == MONO_DEPTH,
          f'the reduced mono depth of {d} planes is not {MONO_DEPTH}')
    weight = torch.randn(c, c, 3, 3, 3, generator=gen, device=dev) \
        / (27 * c) ** 0.5
    w64 = torch.randn(2 * c, c, 3, 3, 3, generator=gen, device=dev) \
        / (27 * c) ** 0.5
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    beta = torch.randn(c, generator=gen, device=dev)

    def at_depth(depth):
        """Every check of the seven kernels on `depth` slices; the kernel
        times, and what the depth-72 report needs besides."""
        xd = x if depth == d else x[:depth].contiguous()
        zw = None if depth == d else plan.mult(0)
        at = f'(D={depth})'
        m = dict(err={}, ms={})

        # K8a
        cv = KC.pack_vol(xd)
        check(torch.equal(cv.data, CC.pack_vol_plain(xd).data),
              f'pack_vol: kernel differs from its plain version {at}')
        check(cv.border_is_zero(), f'pack_vol: border not zero {at}')
        m['ms']['pack_vol'] = cuda_ms(lambda: KC.pack_vol(xd))

        # K8b: bit for bit the copy of the interior, which is also the
        # one PyTorch call of the same function
        got = KC.unpack_vol(cv)
        check(torch.equal(got, CC.unpack_vol_plain(cv)),
              f'unpack_vol: kernel differs from its plain version {at}')
        check(torch.equal(got, xd), f'pack_vol, unpack_vol: round trip {at}')
        m['ms']['unpack_vol'] = cuda_ms(lambda: KC.unpack_vol(cv))

        # K4, both residual modes, and K5
        flag = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            errs = []
            for residual in (False, True):
                out, ps = KC.conv_p2p(cv, weight, residual)
                out2, ps2 = KC.conv_p2p(cv, weight, residual)
                check(torch.equal(out.data, out2.data)
                      and torch.equal(ps, ps2),
                      f'conv_p2p: two runs differ {at}')
                check(out.border_is_zero(), f'conv_p2p: border not zero {at}')
                want, wps = CC.conv_p2p_plain(cv, weight, residual)
                errs.append(agree('conv_p2p', out.data, want.data, tol))
                moments_agree(f'conv_p2p (residual={residual}) {at}', ps,
                              wps, h * w)
                if not residual:
                    u, ups = out, ps
            m['err']['conv_p2p'] = max(errs)

            y, ps = KC.conv_s2_p2d(cv, w64)
            y2, ps2 = KC.conv_s2_p2d(cv, w64)
            check(torch.equal(y, y2) and torch.equal(ps, ps2),
                  f'conv_s2_p2d: two runs differ {at}')
            check(tuple(y.shape) == (depth // 2, h // 2, w // 2, 2 * c),
                  f'conv_s2_p2d: shape {tuple(y.shape)}')
            want, wps = CC.conv_s2_plain(cv, w64)
            m['err']['conv_s2_p2d'] = agree('conv_s2_p2d', y, want, tol)
            moments_agree(f'conv_s2_p2d {at}', ps, wps, h * w // 4)
            m['s2_bytes'] = (cv.data.numel() * 2 + y.numel() * 2
                             + w64.numel() * 2 + ps.numel() * 4)
            if depth == d:
                m['p2p_plain_ms'] = cuda_ms(
                    lambda: CC.conv_p2p_plain(cv, weight))
                m['s2_plain_ms'] = cuda_ms(lambda: CC.conv_s2_plain(cv, w64))
        finally:
            torch.backends.cudnn.allow_tf32 = flag
        m['ms']['conv_p2p'] = cuda_ms(lambda: KC.conv_p2p(cv, weight))
        m['ms']['conv_p2p residual'] = cuda_ms(
            lambda: KC.conv_p2p(cv, weight, True))
        m['ms']['conv_s2_p2d'] = cuda_ms(lambda: KC.conv_s2_p2d(cv, w64))
        m['s2_device_ms'] = device_ms(lambda: KC.conv_s2_p2d(cv, w64))

        # the scale and bias as the main path makes them: GroupNorm of
        # K4's result from its moments, the slices of the reduced volume
        # weighted by their multiplicities
        sc, bs = CC.gn_scale_bias(ups, u.shape, gamma, beta, c, zw)

        # K7a: stem exit (residual, no relu) and pred exit (relu)
        m['err']['unpack_affine_res'] = max(
            agree('unpack_affine_res', KC.unpack_affine(u, sc, bs, res, relu),
                  CC.unpack_affine_plain(u, sc, bs, res, relu), tol)
            for res, relu in ((cv, False), (None, True)))
        m['ms']['unpack_affine_res'] = cuda_ms(
            lambda: KC.unpack_affine(u, sc, bs, cv, False))
        m['ms']['unpack_affine_res relu'] = cuda_ms(
            lambda: KC.unpack_affine(u, sc, bs, None, True))

        # K7b: the stem and hourglass exits (residual, no relu) and the
        # other three modes, bit for bit (separate f32 multiply and add
        # in both)
        for res, relu in ((cv, False), (None, True), (cv, True),
                          (None, False)):
            got = KC.affine_chain(u, sc, bs, res, relu)
            check(torch.equal(got.data,
                              CC.affine_mask(u, sc, bs, relu, res).data),
                  f'gn_affine_res_packed: kernel differs from its plain '
                  f'version (residual={res is not None}, relu={relu}) {at}')
            check(got.border_is_zero(),
                  f'gn_affine_res_packed: border not zero {at}')
        m['ms']['gn_affine_res_packed'] = cuda_ms(
            lambda: KC.affine_chain(u, sc, bs, cv, False))
        m['ms']['gn_affine_res_packed relu'] = cuda_ms(
            lambda: KC.affine_chain(u, sc, bs, None, True))

        # K6 on sub-volumes laid out as `convt1_parity` leaves them (a
        # strided view, the eight parities of a voxel side by side) and
        # contiguous: the interleave bit for bit, the moments of the
        # stored values, twice
        buf = torch.randn(depth // 2 + 1, h // 2 + 1, w // 2 + 1, 8, c,
                          generator=gen, device=dev).to(x.dtype)
        par = buf[:depth // 2, :h // 2, :w // 2].permute(3, 0, 1, 2, 4)
        got, ps = KC.pack_parity8(par)
        for again in (par, par.contiguous()):
            got2, ps2 = KC.pack_parity8(again)
            check(torch.equal(got.data, got2.data) and torch.equal(ps, ps2),
                  f'pack_parity8: two runs differ {at}')
        want, wps = CC.pack_parity8_plain(par)
        check(torch.equal(got.data, want.data),
              f'pack_parity8: kernel differs from its plain version {at}')
        check(got.border_is_zero(), f'pack_parity8: border not zero {at}')
        moments_agree(f'pack_parity8 {at}', ps, wps, h * w)
        m['ms']['pack_parity8'] = cuda_ms(lambda: KC.pack_parity8(par))
        m['p8_bytes'] = (par.numel() * 2 + got.data.numel() * 2
                         + ps.numel() * 4)
        if depth == d:
            m['p8_plain_ms'] = cuda_ms(lambda: CC.pack_parity8_plain(par))
            m['ps_bytes'] = ups.numel() * 4
            m['tensors'] = (cv, u, sc, bs)
        return m

    mono, full = at_depth(MONO_DEPTH), at_depth(d)
    cv, u, sc, bs = full['tensors']
    nvox = d * h * w
    dense_bytes, chain_bytes = x.numel() * 2, cv.data.numel() * 2
    x5 = x.permute(3, 0, 1, 2)[None]               # NCDHW view, NDHWC memory
    w5, x64 = weight.to(x.dtype), w64.to(x.dtype)

    def lib_moments(wt, stride):
        y = F.conv3d(x5, wt, stride=stride, padding=1).float()
        return y.sum((0, 2, 3, 4)), (y * y).sum((0, 2, 3, 4))

    def rep(name, source, line, plain_ms, lib_ms, nbytes, flops, modes=(),
            **kw):
        """One kernel's line: exact copies have tolerance 0; `modes` are
        the kernel's other timed modes."""
        exact = name not in full['err']
        extra = {f'ms_{mode}': full['ms'][f'{name} {mode}'] for mode in modes}
        extra[f'ms_depth{MONO_DEPTH}'] = mono['ms'][name]
        for mode in modes:
            extra[f'ms_{mode}_depth{MONO_DEPTH}'] = mono['ms'][f'{name} {mode}']
        extra.update(kw.pop('extra', {}))
        report(name, source, jax_src + line,
               0.0 if exact else max(full['err'][name], mono['err'][name]),
               (0, 0) if exact else tol, full['ms'][name], plain_ms, lib_ms,
               nbytes, flops, **kw, **extra)

    rep('pack_vol', src, ':444', cuda_ms(lambda: CC.pack_vol_plain(x)),
        cuda_ms(lambda: F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))),
        dense_bytes + chain_bytes, 0)
    rep('unpack_vol', src, ':515', cuda_ms(lambda: CC.unpack_vol_plain(cv)),
        cuda_ms(lambda: cv.interior().contiguous()),
        dense_bytes + chain_bytes, 0)
    p2p_flops = 2 * 27 * c * c * nvox
    p2p_tflops = p2p_flops / full['ms']['conv_p2p'] / 1e9
    rep('conv_p2p', src_p2p, ':233', full['p2p_plain_ms'],
        cuda_ms(lambda: F.conv3d(x5, w5, padding=1)),
        2 * chain_bytes + weight.numel() * 2 + full['ps_bytes'],
        p2p_flops, modes=('residual',), peak=BF16_TENSOR_FLOPS,
        extra=dict(library_with_moments_ms=cuda_ms(
            lambda: lib_moments(w5, 1)), tflops=p2p_tflops,
            bf16_peak_share=p2p_tflops * 1e12 / BF16_TENSOR_FLOPS,
            device_ms=device_ms(lambda: KC.conv_p2p(cv, weight))))
    # no single PyTorch call computes K7a, K7b or K6: no library time
    rep('unpack_affine_res', src, ':624',
        cuda_ms(lambda: CC.unpack_affine_plain(u, sc, bs, cv, False)), None,
        3 * dense_bytes + 2 * c * 4, 3 * x.numel(), modes=('relu',))
    rep('gn_affine_res_packed', src, ':935',
        cuda_ms(lambda: CC.affine_mask(u, sc, bs, False, cv)), None,
        3 * chain_bytes + 2 * c * 4, 3 * x.numel(), modes=('relu',))
    rep('conv_s2_p2d', src_hg, ':814', full['s2_plain_ms'],
        cuda_ms(lambda: F.conv3d(x5, x64, stride=2, padding=1)),
        full['s2_bytes'], 2 * 27 * c * 2 * c * nvox // 8,
        peak=BF16_TENSOR_FLOPS,
        extra=dict(library_with_moments_ms=cuda_ms(
            lambda: lib_moments(x64, 2)), device_ms=full['s2_device_ms'],
            **{f'device_ms_depth{MONO_DEPTH}': mono['s2_device_ms']}))
    rep('pack_parity8', src_hg, ':1033', full['p8_plain_ms'], None,
        full['p8_bytes'], 3 * x.numel())

    # the tap products that feed K6 (plain matrix products, no kernel of
    # the port): with K6 they are the transposed conv, to one bf16 rounding
    post = torch.randn(d // 2, h // 2, w // 2, 2 * c, generator=gen,
                       device=dev).to(x.dtype)
    wt = torch.randn(2 * c, c, 3, 3, 3, generator=gen, device=dev) \
        / (8 * c) ** 0.5
    post5, wt5 = post.permute(3, 0, 1, 2)[None], wt.to(x.dtype)
    up = KC.pack_parity8(CC.convt1_parity(post, wt))[0].interior()
    ref = F.conv_transpose3d(post5, wt5, None, 2, 1, 1)[0].permute(1, 2, 3, 0)
    err = agree('convt1_parity + pack_parity8', up, ref, tol)
    print(f'convt1_parity + pack_parity8 vs F.conv_transpose3d: max_abs_err '
          f'{err:.3g} (tol atol {tol[0]} + rtol {tol[1]}) convt1_parity ms '
          f'{cuda_ms(lambda: CC.convt1_parity(post, wt)):.4f} '
          f'conv_transpose3d ms '
          f'{cuda_ms(lambda: F.conv_transpose3d(post5, wt5, None, 2, 1, 1)):.4f}',
          flush=True)


def conv3d_kernel_phase(x, gen, agree, report):
    """K9a (`ops/cuda/conv3d.py:conv3d_stats`: the moment instance of the
    `wgmma` code for bf16 with C, C_out % 8 == 0, the direct kernel
    elsewhere; and its finish `gn_finish`) and K9b (`conv3d`: the `wgmma`
    code for bf16 with C, C_out % 8 == 0, the direct kernel elsewhere) at
    the DfM trunk width (72, 80, 320, 32) bf16, in float32 at (16, 40, 96,
    32), K9b 16 -> 8 (bf16, f32) and 42 -> 42 (f32: weights chunked over
    C_out), K9a 8 -> 32 and 16 -> 24 (bf16, two chunks): outputs against
    the plain versions, bf16 to one rounding (atol 1e-2 + rtol 1e-2), f32
    atol 1e-4 + rtol 1e-4 (the same f32 products summed in another order;
    cuDNN's TF32 off for the plain convs); K9a's partials in the JAX layout
    as the chain's moments (sums of squares rtol 1e-4, sums rtol 1e-4 +
    atol 1e-6 * sqrt(n * sum of squares)); the finish kernel bit for bit
    its plain apply step on the same inputs; `conv3d_gn` with residual and
    relu to one rounding more; every kernel run twice, bit for bit. Times
    at the DfM width. Then K9's own path, the entry points once each with
    the launch counts set to 0 just before; returns those counts."""
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import conv3d as C3
    from dfm_tpu_torch.ops import convgn as G
    from dfm_tpu_torch.ops.cuda import conv3d as KC3
    from dfm_tpu_torch.ops.cuda import sampling as K
    src = 'dfm_tpu_torch/csrc/conv3d.cu'
    dev = x.device
    d, h, w, c = x.shape
    th = 8

    def weights(c_in, c_out):
        return torch.randn(c_out, c_in, 3, 3, 3, generator=gen,
                           device=dev) / (27 * c_in) ** 0.5

    def volume(shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def partials_agree(name, ps, want, n):
        got, want = ps.double(), want.double()
        lim = 1e-4 * want.abs()
        lim[..., 0, :] += 1e-6 * (n * want[..., 1, :]).sqrt()
        check(bool(((got - want).abs() <= lim).all()),
              f'{name}: partials disagree')

    def code(xx, ww, route):
        return (f'{tuple(xx.shape)} -> {ww.shape[0]} {xx.dtype}: '
                + ('direct' if route is None else f'wgmma {route}'))

    w32 = weights(c, c)
    small = (16, 40, 96)
    # (volume, weights, tolerance) of each case; the DfM width first
    cases = [(x, w32, (1e-2, 1e-2)),
             (volume(small + (c,), torch.float32), w32, (1e-4, 1e-4))]
    zpack_cases = cases + [
        (volume(small + (8,), x.dtype), weights(8, c), (1e-2, 1e-2)),
        (volume(small + (16,), x.dtype), weights(16, 24), (1e-2, 1e-2))]
    conv_cases = cases + [
        (volume(small + (16,), x.dtype), weights(16, 8), (1e-2, 1e-2)),
        (volume(small + (16,), torch.float32), weights(16, 8), (1e-4, 1e-4)),
        (volume((8,) + small[1:] + (42,), torch.float32), weights(42, 42),
         (1e-4, 1e-4))]
    err = {'conv3d_zpack': 0.0, 'conv3d_pallas': 0.0}
    codes = {'conv3d_zpack': [], 'conv3d_pallas': []}
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for xx, ww, tol in zpack_cases:
            at = f'{tuple(xx.shape)} -> {ww.shape[0]} {xx.dtype}'
            out, ps = KC3.conv3d_stats(xx, ww, th)
            out2, ps2 = KC3.conv3d_stats(xx, ww, th)
            check(torch.equal(out, out2) and torch.equal(ps, ps2),
                  f'conv3d_zpack: two runs differ {at}')
            want, wps = G.conv3d_zpack_plain(xx, ww, th)
            err['conv3d_zpack'] = max(err['conv3d_zpack'],
                                      agree('conv3d_zpack', out, want, tol))
            partials_agree(f'conv3d_zpack {at}', ps, wps, th * xx.shape[2])
            co = ww.shape[0]
            gamma = torch.rand(co, generator=gen, device=dev) + 0.5
            beta = torch.randn(co, generator=gen, device=dev)
            res = volume(xx.shape[:3] + (co,), xx.dtype)
            sc, bs = G.gn_partials_affine(ps, out.shape, gamma, beta, 8)
            for r, relu in ((res, True), (None, False)):
                check(torch.equal(KC3.gn_finish(out, sc, bs, r, relu),
                                  G.gn_finish_plain(out, sc, bs, r, relu)),
                      f'conv3d_gn_finish: kernel differs from its plain '
                      f'version {at} (residual={r is not None}, '
                      f'relu={relu})')
            gn = [f(xx, ww, gamma, beta, 8, residual=res, relu=True, th=th)
                  for f in (G.conv3d_gn, G.conv3d_gn_plain)]
            agree(f'conv3d_gn {at}', *gn, tuple(2 * t for t in tol))
            check(bool((gn[0] >= 0).all()), f'conv3d_gn: relu {at}')
            codes['conv3d_zpack'].append(code(xx, ww, KC3.stats_route(
                xx.dtype, xx.shape[-1], co)[0]))
        for xx, ww, tol in conv_cases:
            at = f'{tuple(xx.shape)} -> {ww.shape[0]} {xx.dtype}'
            out = KC3.conv3d(xx, ww)
            check(torch.equal(out, KC3.conv3d(xx, ww)),
                  f'conv3d_pallas: two runs differ {at}')
            err['conv3d_pallas'] = max(
                err['conv3d_pallas'],
                agree('conv3d_pallas', out, C3.conv3d_plain(xx, ww), tol))
            codes['conv3d_pallas'].append(code(xx, ww, KC3.tensor_core_chunks(
                xx.dtype, xx.shape[-1], ww.shape[0])))
        plain_ms = {'conv3d_zpack': cuda_ms(
                        lambda: G.conv3d_zpack_plain(x, w32, th)),
                    'conv3d_pallas': cuda_ms(
                        lambda: C3.conv3d_plain(x, w32))}
    finally:
        torch.backends.cudnn.allow_tf32 = flag

    x5, w5 = x.permute(3, 0, 1, 2)[None], w32.to(x.dtype)

    def lib_moments():
        y = F.conv3d(x5, w5, padding=1).float()
        return y.sum((0, 2, 3, 4)), (y * y).sum((0, 2, 3, 4))

    xf = cases[1][0]
    (cb, wb), (cf, wf) = (case[:2] for case in conv_cases[2:4])
    lib_ms = cuda_ms(lambda: F.conv3d(x5, w5, padding=1))
    lib_dev = device_ms(lambda: F.conv3d(x5, w5, padding=1))
    flops = 2 * 27 * c * c * d * h * w
    vol_bytes = 2 * x.numel() * x.element_size() + w32.numel() * 4
    gamma, beta = torch.rand(c, device=dev) + 0.5, torch.randn(c, device=dev)

    # the finish at the DfM width: GroupNorm of K9a's result with the
    # residual x and relu, as conv3d_gn applies it
    out, ps = KC3.conv3d_stats(x, w32, th)
    sc, bs = G.gn_partials_affine(ps, out.shape, gamma, beta, 8)
    fin = lambda: KC3.gn_finish(out, sc, bs, x, True)       # noqa: E731
    fin_bytes = 3 * out.numel() * out.element_size() + 2 * c * 4
    fin_dev = device_ms(fin)
    report('conv3d_gn_finish', src, 'dfm_tpu/ops/pallas/convgn.py:216',
           agree('conv3d_gn_finish', fin(),
                 G.gn_finish_plain(out, sc, bs, x, True), (0, 0)), (0, 0),
           cuda_ms(fin),
           cuda_ms(lambda: G.gn_finish_plain(out, sc, bs, x, True)), None,
           fin_bytes, 4 * out.numel(), device_ms=fin_dev)

    stats = lambda: KC3.conv3d_stats(x, w32, th)              # noqa: E731
    gn = lambda: G.conv3d_gn(x, w32, gamma, beta, 8,          # noqa: E731
                             residual=x, relu=True, th=th)
    k9a_ms, k9a_dev = cuda_ms(stats), device_ms(stats)
    report('conv3d_zpack', 'dfm_tpu_torch/csrc/conv_dense.cuh (its moment '
           'instance, from conv3d.cu; the direct kernel of conv3d.cu for '
           'other routes)', 'dfm_tpu/ops/pallas/convgn.py:162',
           err['conv3d_zpack'], (1e-2, 1e-2), k9a_ms,
           plain_ms['conv3d_zpack'], lib_ms,
           vol_bytes + (d // 4) * (h // th) * 2 * 4 * c * 4, flops,
           peak=BF16_TENSOR_FLOPS, device_ms=k9a_dev,
           kernel_device_ms=device_ms(stats, kernel='conv_dense_kernel'),
           library_device_ms=lib_dev, ratio_to_conv3d=k9a_ms / lib_ms,
           bf16_peak_share=flops / k9a_ms * 1e3 / BF16_TENSOR_FLOPS,
           device_bf16_peak_share=flops / k9a_dev * 1e3 / BF16_TENSOR_FLOPS,
           library_with_moments_ms=cuda_ms(lib_moments),
           ms_conv3d_gn_residual_relu=cuda_ms(gn),
           device_ms_conv3d_gn_residual_relu=device_ms(gn),
           finish_device_ms=fin_dev,
           finish_bound_ms=fin_bytes / HBM_BYTES_PER_S * 1e3,
           ms_f32_16x40x96=cuda_ms(lambda: KC3.conv3d_stats(xf, w32, th)),
           codes=codes['conv3d_zpack'])
    del out, ps
    k9b_ms = cuda_ms(lambda: KC3.conv3d(x, w32))
    k9b_dev = device_ms(lambda: KC3.conv3d(x, w32))
    report('conv3d_pallas', 'dfm_tpu_torch/csrc/conv_dense.cuh (from '
           'conv3d.cu; the direct kernel of conv3d.cu for other routes)',
           'dfm_tpu/ops/pallas/conv3d.py:119',
           err['conv3d_pallas'], (1e-2, 1e-2), k9b_ms,
           plain_ms['conv3d_pallas'], lib_ms, vol_bytes, flops,
           peak=BF16_TENSOR_FLOPS, device_ms=k9b_dev,
           library_device_ms=lib_dev, ratio_to_conv3d=k9b_ms / lib_ms,
           bf16_peak_share=flops / k9b_ms * 1e3 / BF16_TENSOR_FLOPS,
           device_bf16_peak_share=flops / k9b_dev * 1e3 / BF16_TENSOR_FLOPS,
           ms_f32_16x40x96=cuda_ms(lambda: KC3.conv3d(xf, w32)),
           ms_f32_16x40x96_c16_to_8=cuda_ms(lambda: KC3.conv3d(cf, wf)),
           ms_bf16_16x40x96_c16_to_8=cuda_ms(lambda: KC3.conv3d(cb, wb)),
           codes=codes['conv3d_pallas'])

    # K9's path: the entry points a caller uses, at the DfM width
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out, ps = G.conv3d_zpack(x, G.pack_weights(w32), th)
    y = G.conv3d_gn(x, w32, gamma, beta, 8, residual=x, relu=True, th=th)
    z = KC3.conv3d(x, w32)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    check(counts == K9_PATH, f'K9 path: launched {counts}, want {K9_PATH}')
    for t in (out, ps, y, z):
        check(bool(torch.isfinite(t).all()), 'K9 path: non-finite output')
    check(tuple(ps.shape) == (d // 4, h // th, 2, 4 * c)
          and y.shape == z.shape == out.shape == x.shape,
          f'K9 path: shapes {tuple(out.shape)} {tuple(ps.shape)}')
    print(f'K9 path (conv3d_zpack, conv3d_gn, conv3d at {tuple(x.shape)}): '
          f'launches {counts}', flush=True)
    return {k: counts[k] for k in OFF_PATH}


def _finite_dets(det, what):
    for k in ('boxes3d', 'scores'):
        check(bool(torch.isfinite(det[k]).all()), f'{what}: non-finite {k}')
    return int(det['mask'].sum())


def main_phase(cfg, dev):
    from dfm_tpu_torch.apis import init_dfm_model, init_dfm_stream
    from dfm_tpu_torch.models.detectors.dfm import dfm_predict
    from dfm_tpu_torch.ops.cuda import sampling as K
    h, w = IMG_HW
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randn(4, h, w, 3).astype(np.float32)).to(dev)
    meta = kitti_meta(1, dev)
    counts = {}

    def requests(handle, idx, what):
        """Two-frame requests on frames[i:i+2]; ms of each."""
        ms = []
        for i in idx:
            t0 = time.perf_counter()
            det = handle['infer'](frames[None, i:i + 2], meta)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            kept = _finite_dets(det, what)
        return ms, kept

    # the default form: bf16 on the card, banded + the full conv chain
    handle = init_dfm_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ms, kept = requests(handle, range(3), 'init_dfm_model')
    counts['model'] = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f'main init_dfm_model: ms/frame {[round(x, 3) for x in ms]} '
          f'kept {kept} peak_mem_bytes {peak} launches {counts["model"]}',
          flush=True)

    stream = init_dfm_stream(cfg)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ms = []
    t0 = time.perf_counter()
    det, cache = stream['infer_first'](frames[None, 1:3], meta)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    _finite_dets(det, 'infer_first')
    for i in (0, 3):
        t0 = time.perf_counter()
        det, cache = stream['infer_stream'](frames[None, i], meta, cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        _finite_dets(det, 'infer_stream')
    counts['stream'] = dict(K.LAUNCHES)
    print(f'main init_dfm_stream: ms/frame {[round(x, 3) for x in ms]} '
          f'launches {counts["stream"]}', flush=True)
    for path, c in counts.items():
        for name in MAIN_PATH:
            check(c[name] > 0, f'{name} never launched on the {path} path')
        check_launches(c, 'chain', 3, f'the {path} path')
    del stream, cache

    # the two earlier forms in the same run, for comparison, and the
    # default form once more after them (the first requests above also
    # pay the warm-up of cuDNN and of the allocator)
    for form in ('stem', 'dense'):
        other = init_dfm_model(cfg, **FORM_ARGS[form])
        requests(other, [0], f'{form} warm-up')
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        ms, _ = requests(other, (1, 2), f'{form} form')
        check_launches(K.LAUNCHES, form, 2, f'the {form} form')
        print(f'main {form} form ({FORM_ARGS[form]}): ms/frame '
              f'{[round(x, 3) for x in ms]} peak_mem_bytes '
              f'{torch.cuda.max_memory_allocated()}', flush=True)
        del other
    ms, _ = requests(handle, (1, 2), 'default form again')
    print(f'main default form again, after the other forms: ms/frame '
          f'{[round(x, 3) for x in ms]}', flush=True)
    del handle

    # decode + rotated NMS at the full head shape with live scores
    _, ny, nx = cfg.voxel_grid_size()
    g = torch.Generator(device=dev).manual_seed(1)
    heads = dict(cls_score=torch.randn(1, ny, nx, 18, generator=g,
                                       device=dev) * 1.5 - 2.0,
                 bbox_pred=torch.randn(1, ny, nx, 42, generator=g,
                                       device=dev) * 0.3,
                 dir_pred=torch.randn(1, ny, nx, 12, generator=g,
                                      device=dev))
    t0 = time.perf_counter()
    det = dfm_predict(heads, cfg)
    torch.cuda.synchronize()
    kept = _finite_dets(det, 'dfm_predict')
    check(kept > 0, 'dfm_predict kept no box of live scores')
    print(f'main dfm_predict full-shape heads: kept {kept} ms '
          f'{(time.perf_counter() - t0) * 1e3:.3f}', flush=True)
    return counts['model']


def _tiny_inputs():
    from dfm_tpu_torch.models.detectors.dfm import BatchMeta, DfMConfig
    cfg = DfMConfig(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5),
                    nms_pre=128, max_num=8)
    h, w = 64, 128
    img = torch.from_numpy(np.random.RandomState(2).randn(
        1, 2, h, w, 3).astype(np.float32))
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 200.0
    cam[0, 2], cam[1, 2] = w / 2, h / 2
    meta = BatchMeta.identity(1, cam[None])
    meta.org_w = torch.full((1,), float(w))
    meta.cur2prev = meta.cur2prev.clone()
    meta.cur2prev[:, 2, 3] = 0.6
    return cfg, img, meta


OUT_KEYS = ('depth_cost', 'volume_feat', 'bev_feat', 'cls_score',
            'bbox_pred', 'dir_pred')


def parity_phase(full_cfg, dev):
    from dfm_tpu_torch.apis import init_dfm_model
    from dfm_tpu_torch.ops.cuda import sampling as K
    cfg, img, meta = _tiny_inputs()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        K.reset_launch_counts()
        for d in ('cpu', dev):
            model = init_dfm_model(cfg, torch.float32, d, use_band=False,
                                   packed=False)['model']
            with torch.inference_mode():
                outs[d] = model(img.to(d), meta.to(d))
        check_launches(K.LAUNCHES, 'dense', 1, 'f32 dense parity run')
        tol = 2e-3
        worst = 0.0
        for key in OUT_KEYS:
            a, b = outs['cpu'][key], outs[dev][key].cpu()
            err = float((a - b).abs().max())
            worst = max(worst, err)
            check(torch.allclose(a, b, atol=tol, rtol=tol),
                  f'CPU vs CUDA {key}: max abs err {err}')
        print(f'parity tiny f32 (TF32 off) dense form cpu vs cuda: max abs '
              f'err {worst:.3g} (tol atol {tol} + rtol {tol})', flush=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags

    # bf16 on the card: the default form (banded + the full conv chain, all
    # ten kernels) against the dense form and against the form with only
    # the stem and pred ConvNorm on the chain, same weights (seed 0) and
    # inputs. They compute the same function with bf16 roundings at other
    # places, so they are held together by the error's size against the
    # output's: ||a - b|| <= 0.05 ||b|| for every output (bf16 keeps 3
    # digits; dozens of layers lie between the trunks and the heads), and
    # for the trunk's own output, depth_cost, also elementwise within
    # atol 0.15 + rtol 0.15 (the JAX package's bf16 tolerance for it).
    # The tiny config's 12 depth planes have no reduced-depth plan, so
    # only the full-width run takes the mono trunk through the chain: the
    # launch counts show which form each run took.
    rng = np.random.RandomState(0)
    full_img = torch.from_numpy(rng.randn(1, 2, *IMG_HW, 3).astype(
        np.float32))
    for name, c, im, mt, chain_runs in (
            ('tiny', cfg, img, meta, 'chain, stereo trunk only'),
            ('full width', full_cfg, full_img, kitti_meta(1, dev), 'chain')):
        outs = {}
        for form, kw in FORM_ARGS.items():
            model = init_dfm_model(c, **kw)['model']
            K.reset_launch_counts()
            with torch.inference_mode():
                outs[form] = model(im.to(dev), mt.to(dev))
            check_launches(K.LAUNCHES, chain_runs if form == 'chain'
                           else form, 1, f'bf16 parity {name}, {form} form')
            del model
        for other in ('dense', 'stem'):
            worst = 0.0
            for key in OUT_KEYS:
                a, b = outs['chain'][key].float(), outs[other][key].float()
                check(bool(torch.isfinite(a).all()),
                      f'{name} {key} not finite')
                rel = float((a - b).norm() / b.norm().clamp(min=1e-6))
                worst = max(worst, rel)
                check(rel <= 0.05, f'bf16 default vs {other} form, {name} '
                      f'{key}: relative L2 error {rel}')
            a, b = (outs[f]['depth_cost'].float() for f in ('chain', other))
            err = float((a - b).abs().max())
            check(bool(((a - b).abs() <= 0.15 + 0.15 * b.abs()).all()),
                  f'bf16 default vs {other} form, {name} depth_cost: max '
                  f'abs err {err}')
            print(f'parity {name} bf16 on the card, default form vs {other} '
                  f'form: worst relative L2 error {worst:.3g} (tol 0.05), '
                  f'depth_cost max abs err {err:.3g} (tol atol 0.15 + rtol '
                  f'0.15)', flush=True)


EVAL_EXTRA_KEYS = ('lidar_model.backbone.compress_conv.conv.weight',
                   'backbone.bn1.num_batches_tracked')
AP_LINE = re.compile(r'^(Car|Pedestrian|Cyclist)_\w+: (\S+)$', re.M)


def _live_weights(model, seed, cls_bias):
    """Seeded noise (a CPU generator, so that every device gets the same
    values) on every tensor of `model` (5 % of its mean magnitude, at
    least 5e-4) and on every bias (std 0.1), and `cls_bias` added to the
    classification bias: detections that depend on the image and pass
    the score threshold."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g) * 0.05 * float(
                t.float().abs().mean().clamp(min=0.01))
            if name.endswith('.bias'):
                noise += torch.randn(t.shape, generator=g) * 0.1
            if name.endswith('conv_cls.bias'):
                noise += cls_bias
            t.add_(noise.to(t.device, t.dtype))
    return model


def _ref_checkpoint(cfg, path):
    """A model of `init_dfm_model(cfg)` with `_live_weights(seed 1, +3)`,
    saved as an mmcv checkpoint beside a DfMFull teacher key and a
    BatchNorm counter; returns its handle."""
    from dfm_tpu_torch.apis import init_dfm_model
    handle = init_dfm_model(cfg)
    _live_weights(handle['model'], 1, 3.0)
    sd = {k: v.cpu() for k, v in handle['model'].state_dict().items()}
    sd[EVAL_EXTRA_KEYS[0]] = torch.zeros(8, 4, 3, 3)
    sd[EVAL_EXTRA_KEYS[1]] = torch.tensor(7)
    torch.save({'meta': {'epoch': 60, 'CLASSES': ('Car', 'Pedestrian',
                                                  'Cyclist')},
                'state_dict': sd}, path)
    return handle


def _annos_agree(what, got, want, tol):
    """Annos of two runs: names and counts equal; scores within tol[0],
    location / dimensions / rotation_y / alpha within tol[1], 2D boxes
    within tol[2] px. Returns the live annos and the worst errors."""
    check(len(got) == len(want), f'{what}: {len(got)} vs {len(want)} frames')
    worst = dict(score=0.0, box=0.0, bbox=0.0)
    live = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(list(g['name']) == list(w['name']),
              f'{what}, frame {i}: names {list(g["name"])} vs '
              f'{list(w["name"])}')
        live += len(w['name'])
        if not len(w['name']):
            continue
        err = {k: float(np.abs(np.asarray(g[k], np.float64)
                               - np.asarray(w[k], np.float64)).max())
               for k in ('score', 'location', 'dimensions', 'rotation_y',
                         'alpha', 'bbox')}
        worst['score'] = max(worst['score'], err['score'])
        worst['box'] = max(worst['box'], err['location'], err['dimensions'],
                           err['rotation_y'], err['alpha'])
        worst['bbox'] = max(worst['bbox'], err['bbox'])
    for (k, v), t in zip(worst.items(), tol):
        check(v <= t, f'{what}: {k} max abs err {v} over {t}')
    return live, worst


def eval_phase(cfg, dev):
    """6. eval: a synthetic KITTI tree -> info pickle -> the CLI from a
    config and a checkpoint to AP; in process `dataset_inference` with
    its launches per frame, the checkpoint round trip, the GT echo, the
    card's annos against the CPU's, and the per-frame time split."""
    import os
    import tempfile
    from dfm_tpu_torch.apis import (dataset_inference, detect_sample,
                                    init_dfm_model)
    from dfm_tpu_torch.data import pipeline as PL
    from dfm_tpu_torch.data.kitti import KittiDataset
    from dfm_tpu_torch.data.png import read_png
    from dfm_tpu_torch.evaluation.kitti_eval import kitti_eval
    from dfm_tpu_torch.evaluation.results import detections_to_kitti_annos
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.ops.cuda import sampling as K
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    with tempfile.TemporaryDirectory() as root:
        ids = write_kitti_tree(root)
        first = os.path.join(root, 'training', 'image_2', '000000.png')
        png_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_png(first)
            png_ms.append((time.perf_counter() - t0) * 1e3)
        check(img is not None and img.shape == (375, 1242, 3),
              'read_png of a 375x1242 frame')
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
             'kitti', '--root', root, '--splits', 'val'], cwd=here, env=env,
            capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f'create_data failed: {res.stderr}')
        pkl = os.path.join(root, 'kitti_infos_val.pkl')
        ckpt = os.path.join(root, 'ref.pth')
        saved = _ref_checkpoint(cfg, ckpt)

        # (b) the CLI, from the config and the checkpoint to AP
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.test',
             os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py'),
             '--checkpoint', ckpt, '--cfg-options',
             f'data.data_root={root}'], cwd=here, env=env,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f'tools.test failed: {res.stderr[-3000:]}')
        aps = [float(m.group(2)) for m in AP_LINE.finditer(res.stdout)]
        check(len(aps) == 36 and all(np.isfinite(aps)),
              f'tools.test printed {len(aps)} AP lines: {res.stdout[-2000:]}')
        car = re.search(r'^Car_3d_moderate_strict: (\S+)$', res.stdout, re.M)
        print(f'eval cli: {len(ids)} frames, {len(aps)} finite AP lines, '
              f'Car_3d_moderate_strict {car.group(1)}, {cli_s:.1f} s in its '
              'own process', flush=True)

        # (c) in process: the default form from the checkpoint, launches
        ds = KittiDataset(root, pkl, train=False, pipeline_kwargs=dict(
            crop_size=IMG_HW, max_gt=32))
        handle = init_dfm_model(cfg)
        rest = handle['load_checkpoint'](ckpt)
        check(rest == sorted(EVAL_EXTRA_KEYS), f'keys not taken: {rest}')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        annos = dataset_inference(handle, ds)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(counts, 'chain', len(ids), 'dataset_inference')
        live = sum(len(a['name']) for a in annos)
        check(live > 0, 'dataset_inference: no live box from the checkpoint')
        print(f'eval dataset_inference: {len(annos)} frames, {live} annos, '
              f'peak_mem_bytes {peak}, launches per frame '
              f'{ {k: n / len(ids) for k, n in counts.items() if n} }',
              flush=True)

        # the checkpoint round trip: the loaded model's detections are the
        # saved model's, bit for bit (cuDNN deterministic for both runs)
        sample = ds.get_sample(0, np.random.default_rng(0))
        det_flag = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            a, b = detect_sample(saved, sample), detect_sample(handle, sample)
        finally:
            torch.backends.cudnn.deterministic = det_flag
        check(all(np.array_equal(a[k], b[k]) for k in a) and a.keys() ==
              b.keys(), 'the checkpoint round trip changed the detections')
        check(int(a['mask'].sum()) > 0, 'round trip: no live detection')
        del saved

        # the GT echo: the labels' own boxes through converter + evaluator
        echo = []
        for info in ds.infos:
            gt = info['annos']
            n = len(gt['labels'])
            echo.append(detections_to_kitti_annos(
                dict(boxes3d=gt['gt_boxes_pl'], labels=gt['labels'],
                     scores=np.full(n, 0.9, np.float32),
                     mask=np.ones(n, bool)),
                np.asarray(info['calib']['P2'])[:3], (375, 1242)))
        ap = kitti_eval(ds.gt_annos(), echo)['Car_3d_easy_strict']
        check(ap > 99, f'GT echo: Car 3d easy AP {ap}')
        print(f'eval gt echo: Car_3d_easy_strict {ap:.4f} (> 99)', flush=True)

        # (d) the per-frame split: decode, pipeline, model (synchronised),
        # annos; then kitti_eval on the frames' annos
        decode = [0.0]

        def timed_read(path):
            t = time.perf_counter()
            try:
                return read_png(path)
            finally:
                decode[0] += time.perf_counter() - t

        split = []
        rng = np.random.default_rng(0)
        PL.read_png = timed_read
        try:
            for i in range(len(ds)):
                decode[0] = 0.0
                t0 = time.perf_counter()
                s = ds.get_sample(i, rng)
                t1 = time.perf_counter()
                det = detect_sample(handle, s)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                annos[i] = detections_to_kitti_annos(
                    det, np.asarray(ds.infos[i]['calib']['P2'])[:3],
                    (375, 1242))
                t3 = time.perf_counter()
                split.append((decode[0], t1 - t0 - decode[0], t2 - t1,
                              t3 - t2))
        finally:
            PL.read_png = read_png
        t0 = time.perf_counter()
        kitti_eval(ds.gt_annos(), annos)
        eval_ms = (time.perf_counter() - t0) * 1e3
        ms = np.asarray(split) * 1e3
        print('eval per frame ms (decode, pipeline, model, annos): '
              + ' | '.join(', '.join(f'{x:.3f}' for x in row) for row in ms)
              + f'; mean {", ".join(f"{x:.3f}" for x in ms.mean(0))}; '
              f'kitti_eval {eval_ms:.3f} ms for {len(ds)} frames; png '
              f'decode of one 375x1242 frame {min(png_ms):.3f} ms (best of '
              f'3); peak_mem_bytes {peak}', flush=True)
        del handle

        # the card's annos against the CPU's plain versions: tiny config,
        # float32, TF32 off, the same live weights on both sides, a crop
        # of 192 x 384 that holds the horizon and the objects
        tiny = DfMConfig(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5),
                         nms_pre=128, max_num=8)
        small = KittiDataset(root, pkl, train=False,
                             pipeline_kwargs=dict(crop_size=(192, 384)))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            outs = {}
            for d in ('cpu', dev):
                h = init_dfm_model(tiny, torch.float32, d)
                _live_weights(h['model'], 2, 4.0)
                outs[d] = dataset_inference(h, small)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        tol = (1e-3, 2e-3, 0.1)
        live, worst = _annos_agree('tiny f32 annos, card vs CPU',
                                   outs[dev], outs['cpu'], tol)
        check(live > 0, 'tiny f32 annos: no live box')
        check(len({tuple(np.round(a['score'], 5)) for a in outs['cpu']}) > 1,
              'tiny f32 annos: the same in every frame')
        print(f'eval tiny f32 annos card vs cpu: {live} annos, names equal, '
              f'max abs err score {worst["score"]:.3g} box '
              f'{worst["box"]:.3g} bbox {worst["bbox"]:.3g} px (tol score '
              f'{tol[0]}, box {tol[1]}, bbox {tol[2]} px)', flush=True)
    return counts


def _rel_l2(got, want):
    """Relative L2 distance of each parameter's gradient and of the whole
    gradient (name -> tensor of both, want's names)."""
    rel, num, den = {}, 0.0, 0.0
    for n, w in want.items():
        d = float((got[n].cpu().double() - w.double()).norm())
        nw = float(w.double().norm())
        rel[n] = d / nw if nw > 0 else d
        num += d * d
        den += nw * nw
    return rel, (num / den) ** 0.5


def _grad_compare(what, got, want, noisy):
    """Gradients of the card against the CPU's (name -> tensor or None),
    held to the CPU's own rounding: `noisy` are the CPU's gradients with
    one ulp of seeded relative noise on every weight. Every parameter
    with a nonzero CPU gradient has a nonzero card one; each parameter's
    relative L2 is within max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR x that
    parameter's under the noise), the whole gradient's likewise. Returns
    (worst relative L2, its parameter, whole, whole under the noise)."""
    missing = [n for n, w in want.items() if w is not None and
               bool(w.abs().sum() > 0) and (got[n] is None or
                                            not bool(got[n].abs().sum() > 0))]
    check(not missing, f'{what}: no gradient on the card for {missing}')
    for n, w in want.items():
        if w is None:
            check(got[n] is None or not bool(got[n].abs().sum() > 0),
                  f'{what}: {n} has a card gradient and no CPU one')
    want = {n: w for n, w in want.items() if w is not None}
    rel, whole = _rel_l2(got, want)
    noise, whole_noise = _rel_l2(noisy, want)
    bad = {n: (r, noise[n]) for n, r in rel.items()
           if r > max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR * noise[n])}
    check(not bad, f'{what}: gradients off beyond the rounding noise '
          f'(relative L2, noise): {bad}')
    check(whole <= max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR * whole_noise),
          f'{what}: whole gradient relative L2 {whole}, under one ulp of '
          f'weight noise {whole_noise}')
    worst = max(rel, key=rel.get)
    return rel[worst], worst, whole, whole_noise


# phase 7 (a): the card's float32 gradients against the CPU's at the tiny
# config, TF32 off. The float32 gradients of the 2D trunk and the depth
# predictors are ill-conditioned at this size (BatchNorm and GroupNorm
# statistics over a few pixels): one ulp of relative noise on the
# weights moves the CPU's own gradient of some parameters by 2e-2 and the
# whole gradient by 1e-2 (relative L2). So each gradient is held to
# TRAIN_GRAD_FACTOR times its own movement under that noise (measured in
# the run, on the CPU), and at least to TRAIN_GRAD_FLOOR
TRAIN_GRAD_FACTOR = 3.0
TRAIN_GRAD_FLOOR = 1e-3
TRAIN_LOSS_RTOL = 1e-3
TRAIN_TINY = dict(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5), nms_pre=128,
                  max_num=8, num_depth_sample_pixels=2048)
TRAIN_TINY_CROP = (192, 384)
# phase 7 (b): the backward kernels against torch.autograd.grad of the
# plain forwards; atomics sum each gradient in another order (float32)
BWD_TOL = (1e-3, 1e-4)
TRAIN_TIMED_STEPS = 3         # phase 7 (d)
def train_phase(cfg, dev, results):
    """7. train: (a) the card's gradients against the CPU's, (b) the
    backward kernels against their plain versions at full width, (c)
    the train CLI at full width with a resume and an eval of its
    checkpoint, (d) one full-width step in process with its launches,
    time split and peak memory, (e) an overfit of one frame."""
    import os
    import tempfile
    import torch.nn.functional as F
    from dfm_tpu_torch.data.collate import build_batch
    from dfm_tpu_torch.data.kitti import KittiDataset, build_kitti_infos
    from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
    from dfm_tpu_torch.models.heads.depth_head import sample_depth_pixels
    from dfm_tpu_torch.ops import cost_volume as CV
    from dfm_tpu_torch.ops import frustum_separable as FS
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.schedule import liga_schedule, step_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.tools.train import optimizer_digest
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    config = os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py')
    agree, report = reporter(results)
    with tempfile.TemporaryDirectory() as root:
        ids = write_kitti_tree(root)
        infos = build_kitti_infos(root, ids)

        # (a) gradients, card against CPU: the same live weights, one
        # training sample (flip, scale, photometric) and the same depth
        # pixels on both
        tiny = DfMConfig(**TRAIN_TINY)
        ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
            crop_size=TRAIN_TINY_CROP, flip_ratio=0.5, max_gt=32))
        sample = ds.get_sample(0, np.random.default_rng(3))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            side = {}
            pix = None
            for d, noise in (('cpu', False), ('cpu', True), (dev, False)):
                model = _live_weights(init_weights(DfM(tiny)), 4, 0.0)
                if noise:         # one ulp of relative noise, seeded
                    g = torch.Generator().manual_seed(1)
                    with torch.no_grad():
                        for p in model.parameters():
                            p.mul_(1 + 1.2e-7 * torch.randn(p.shape,
                                                            generator=g))
                model = model.to(d)
                img, meta, gt = build_batch([sample], d)
                if pix is None:
                    pix = sample_depth_pixels(
                        gt['depth_img'], tiny.num_depth_sample_pixels,
                        torch.Generator().manual_seed(0))
                step = TrainStep(model, make_optimizer(model),
                                 liga_schedule(1e-3))
                K.reset_launch_counts()
                total, losses = step.forward(img, meta, gt,
                                             depth_pix_idx=pix.to(d))
                step.backward(total)
                if d != 'cpu':
                    torch.cuda.synchronize()
                side['cpu, ulp noise' if noise else d] = dict(
                    losses={k: float(v.detach()) for k, v in
                            dict(loss=total, **losses).items()},
                    grads={n: (None if p.grad is None else
                               p.grad.detach().cpu())
                           for n, p in model.named_parameters()},
                    launches=dict(K.LAUNCHES))
                del model, step, total, losses
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        for k, want in side['cpu']['losses'].items():
            got = side[dev]['losses'][k]
            check(np.isfinite(got) and abs(got - want) <= TRAIN_LOSS_RTOL * (
                abs(want) + 1e-6), f'train tiny {k}: card {got} vs cpu {want}')
        worst, name, whole, whole_noise = _grad_compare(
            'train tiny', side[dev]['grads'], side['cpu']['grads'],
            side['cpu, ulp noise']['grads'])
        check_launches(side[dev]['launches'], 'train', 1, 'train tiny step')
        print(f'train (a) tiny f32 card vs cpu: losses '
              f'{ {k: round(v, 6) for k, v in side[dev]["losses"].items()} } '
              f'(cpu { {k: round(v, 6) for k, v in side["cpu"]["losses"].items()} }, '
              f'rtol {TRAIN_LOSS_RTOL}); gradients of '
              f'{len(side["cpu"]["grads"])} parameters, worst relative L2 '
              f'{worst:.3g} ({name}), whole {whole:.3g}; under one ulp of '
              f'weight noise the CPU\'s whole gradient moves {whole_noise:.3g} '
              f'(tol {TRAIN_GRAD_FACTOR} x each parameter\'s movement, at '
              f'least {TRAIN_GRAD_FLOOR}); none missing; launches '
              f'{ {k: n for k, n in side[dev]["launches"].items() if n} }',
              flush=True)
        del side

        # (b) the backward kernels at the full-width training shapes
        # (float32): K1's gradient of prev, K2's of vol and sem
        gen = torch.Generator(device=dev).manual_seed(5)
        h, w = IMG_HW
        meta = kitti_meta(1, dev)
        depths = torch.as_tensor(cfg.downsampled_depths(), device=dev)
        d = len(depths)
        step_px = cfg.cost_sample_factor
        hq, wq = h // step_px, w // step_px
        c = cfg.stereo_channels[1]
        params = CV.sweep_params(meta.ori_cam2img, meta.cur2prev, meta.org_w,
                                 meta.flip, meta.crop_offset,
                                 meta.scale_factor, 1)
        prev_shape = (1, h, w, c)
        gout1 = torch.randn(1, d, hq, wq, c, generator=gen, device=dev)
        bwd1 = lambda: K.warp_prev_sweep_bwd(  # noqa: E731
            gout1, params, depths, prev_shape, step_px)
        plain1 = lambda: K.warp_prev_sweep_bwd_plain(  # noqa: E731
            gout1, params, depths, prev_shape, step_px)
        got, want = bwd1(), plain1()
        check(bool((want != 0).any()), 'warp_prev_bwd: the gradient is zero')
        err1 = agree('warp_prev_sweep_bwd', got, want, BWD_TOL)
        _, grid = CV.plane_sweep_grids(
            depths, meta.ori_cam2img, meta.cur2prev, (h, w), step_px, 1,
            meta.org_w, meta.flip, meta.crop_offset, meta.scale_factor)
        norm = torch.stack([grid[..., 0] / (w - 1) * 2 - 1,
                            grid[..., 1] / (h - 1) * 2 - 1],
                           -1).reshape(1, d * hq, wq, 2)
        lib_in = torch.zeros(1, c, h, w, device=dev, requires_grad=True)
        lib_out = F.grid_sample(lib_in, norm, align_corners=True)
        lib_g = torch.randn(lib_out.shape, generator=gen, device=dev)
        lib1 = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_in, lib_g, retain_graph=True)
        report('warp_prev_bwd', 'dfm_tpu_torch/csrc/warp_prev.cu',
               'dfm_tpu/ops/pallas/cost_warp.py:142', err1, BWD_TOL, cuda_ms(bwd1), cuda_ms(plain1, reps=5),
               cuda_ms(lib1), (gout1.numel() + got.numel()) * 4
               + params.numel() * 4 + d * 4, 8 * gout1.numel(),
               device_ms=device_ms(bwd1), library_device_ms=device_ms(lib1),
               note='backward of K1 (JAX: XLA autodiff of its f32 path)')
        del got, want, lib_in, lib_out, lib_g, norm, grid, gout1

        coors = cfg.coordinates_3d()
        xs, ys, zs = coors[0, 0, :, 0], coors[0, :, 0, 1], coors[:, 0, 0, 2]
        u, v = FS.slab_uv(meta.cam2img, xs, ys, zs)
        nz, ny, nx = cfg.voxel_grid_size()
        cost = torch.randn(1, d, hq, wq, generator=gen, device=dev)
        df = d * cfg.depth_downsample
        sm = FS.build_fine_softmax_volume(cost, cfg.depth_downsample, IMG_HW,
                                          torch.float32)
        dsf = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, df)
        att = K.attention_sample(sm, u, v, dsf, IMG_HW)
        del sm
        ds2 = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, d)
        cs = cfg.sem_channels[1]
        vol_shape = (1, d, hq, wq, c)
        sem_shape = (1, hq, wq, cs)
        gout2 = torch.randn(1, nz, ny, nx, c + cs, generator=gen, device=dev)
        bwd2 = lambda: K.frustum_voxel_features_bwd(  # noqa: E731
            gout2, att, u, v, ds2, IMG_HW, vol_shape, sem_shape)
        plain2 = lambda: K.frustum_voxel_features_bwd_plain(  # noqa: E731
            gout2, att, u, v, ds2, IMG_HW, vol_shape, sem_shape)
        (gv, gs), (wv, ws) = bwd2(), plain2()
        check(bool((wv != 0).any()) and bool((ws != 0).any()),
              'frustum_voxel_features_bwd: a gradient is zero')
        err_vol = agree('frustum_voxel_features_bwd vol', gv, wv, BWD_TOL)
        err_sem = agree('frustum_voxel_features_bwd sem', gs, ws, BWD_TOL)
        zi = (torch.as_tensor(xs, device=dev) - cfg.depth_min) / (
            cfg.depth_max - cfg.depth_min) * (d - 1)
        gx = (u / (w - 1) * (wq - 1)).transpose(1, 2)[:, None]
        gy = (v / (h - 1) * (hq - 1)).transpose(1, 2)[:, :, None]
        g3 = torch.stack(torch.broadcast_tensors(
            gx / (wq - 1) * 2 - 1, gy / (hq - 1) * 2 - 1,
            (zi / (d - 1) * 2 - 1).view(1, 1, 1, -1)), -1).reshape(
                1, nz, ny, nx, 3)
        lib_in = torch.zeros(1, c, d, hq, wq, device=dev, requires_grad=True)
        lib_out = F.grid_sample(lib_in, g3, align_corners=True)
        lib_g = torch.randn(lib_out.shape, generator=gen, device=dev)
        lib2 = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_in, lib_g, retain_graph=True)
        report('frustum_stereo_sample_bwd',
               'dfm_tpu_torch/csrc/frustum_sample.cu',
               'dfm_tpu/ops/pallas/frustum_sample.py:92',
               max(err_vol, err_sem), BWD_TOL, cuda_ms(bwd2),
               cuda_ms(plain2, reps=5), cuda_ms(lib2),
               (gout2.numel() + att.numel() + u.numel() + v.numel()
                + gv.numel() + gs.numel()) * 4,
               2 * 8 * gout2[..., :c].numel() + 3 * 4 * gout2[..., c:].numel(),
               max_abs_err_vol=err_vol, max_abs_err_sem=err_sem,
               device_ms=device_ms(bwd2), library_device_ms=device_ms(lib2),
               note='backward of K2 (JAX: XLA autodiff of its f32 path)')
        del gv, gs, wv, ws, lib_in, lib_out, lib_g, g3, gout2, att, cost
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the train CLI at full width in processes of its own: 4 steps
        # (one epoch of the 4 frames: a checkpoint and the KITTI eval),
        # a resume to 6, the eval CLI on the last checkpoint, and the
        # DfMFull config refused
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
             'kitti', '--root', root, '--splits', 'train', 'val'], cwd=here,
            env=env, capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f'create_data failed: {res.stderr}')
        work = os.path.join(root, 'w')
        base = [sys.executable, '-m', 'dfm_tpu_torch.tools.train', config,
                '--cfg-options', 'model.type=DfM', f'data.data_root={root}',
                '--work-dir', work]
        t0 = time.perf_counter()
        res = subprocess.run(base + ['--max-steps', '4'], cwd=here, env=env,
                             capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f'tools.train failed: {res.stderr[-3000:]}')
        with open(os.path.join(work, 'metrics.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        keys = ('loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
                'loss_dense_depth', 'grad_norm')
        check([r['step'] for r in recs] == [1, 4], f'logged steps '
              f'{[r["step"] for r in recs]}')
        check(all(np.isfinite(r[f'train/{k}']) for r in recs for k in keys),
              f'tools.train logged a non-finite term: {recs}')
        evals = re.findall(r'^\[eval\] (\S+): (\S+)$', res.stdout, re.M)
        check(len(evals) == 6 and all(np.isfinite(float(x)) for _, x in
                                     evals), f'tools.train eval: {evals}')
        ckpt4 = os.path.join(work, 'ckpts', 'step_4.pth')
        digest = optimizer_digest(torch.load(
            ckpt4, map_location='cpu', weights_only=True)['optimizer'])
        print(f'train (c) cli: 4 steps at full width in {cli_s:.1f} s in its '
              f'own process; logged '
              + '; '.join(f'step {r["step"]} ' + ', '.join(
                  f'{k} {r[f"train/{k}"]:.5g}' for k in keys) for r in recs)
              + f'; eval {len(evals)} finite 3d-moderate APs', flush=True)
        res = subprocess.run(base + ['--max-steps', '6', '--auto-resume'],
                             cwd=here, env=env, capture_output=True,
                             text=True, timeout=900)
        check(res.returncode == 0, f'tools.train --auto-resume failed: '
              f'{res.stderr[-3000:]}')
        check(f'resumed from step 4 (optimizer state sha1 {digest})'
              in res.stdout, f'resume: {res.stdout[-2000:]}')
        with open(os.path.join(work, 'metrics.jsonl')) as f:
            logged = [json.loads(line)['step'] for line in f]
        check(logged == [1, 4, 6] and re.search(r'^step 6/6 ', res.stdout,
                                                re.M) is not None,
              f'resume did not end at step 6: logged {logged}')
        last = os.path.join(work, 'ckpts', 'step_6.pth')
        check(os.path.exists(last), 'no checkpoint at step 6')
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.test', config,
             '--checkpoint', last, '--cfg-options',
             f'data.data_root={root}'], cwd=here, env=env,
            capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f'tools.test of the trained checkpoint '
              f'failed: {res.stderr[-3000:]}')
        aps = [float(m.group(2)) for m in AP_LINE.finditer(res.stdout)]
        check(len(aps) == 36 and all(np.isfinite(aps)),
              f'tools.test printed {len(aps)} AP lines')
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.train', config,
             '--cfg-options', f'data.data_root={root}', '--work-dir',
             os.path.join(root, 'full')], cwd=here, env=env,
            capture_output=True, text=True, timeout=300)
        check(res.returncode != 0 and 'not ported yet' in res.stderr,
              f'the DfMFull config: rc {res.returncode} {res.stderr[-500:]}')
        print(f'train (c) resume: from step 4 with the saved optimizer '
              f'state (sha1 {digest}) to step 6; tools.test on step_6.pth: '
              f'{len(aps)} finite AP lines; DfMFull refused (rc '
              f'{res.returncode})', flush=True)

        # (d) full-width training steps in process: two warm-up steps
        # (cuDNN's and the allocator's first calls), then three steps
        # with the launch counts set to 0 just before and read just
        # after, each split into data, forward, backward and optimizer
        full = DfMConfig()
        model = init_weights(DfM(full)).to(dev)
        step = TrainStep(model, make_optimizer(model), liga_schedule(1e-3))
        train_ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
            crop_size=IMG_HW, flip_ratio=0.5, max_gt=32))
        rng = np.random.default_rng(0)
        for i in range(2):
            img, meta, gt = build_batch([train_ds.get_sample(i, rng)], dev)
            step(img, meta, gt, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        splits = []
        for i in range(TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            img, meta, gt = build_batch(
                [train_ds.get_sample((i + 2) % len(ids), rng)], dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            total, losses = step.forward(
                img, meta, gt, torch.Generator(device=dev).manual_seed(i))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step.backward(total)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            norm = step.update()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            splits.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                           (t4 - t3) * 1e3])
            vals = {k: float(v.detach())
                    for k, v in dict(loss=total, **losses).items()}
            check(all(np.isfinite(x) for x in vals.values())
                  and np.isfinite(float(norm)), f'full-width step: {vals}')
        counts = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(counts, 'train', TRAIN_TIMED_STEPS,
                       'the full-width train steps')
        for name in TRAIN_PATH:
            check(counts[name] > 0, f'{name} never launched in the steps')
        for name in BWD_KERNELS:
            results[name]['launches'] = counts[name] // TRAIN_TIMED_STEPS
        med = np.median(np.asarray(splits), axis=0)
        print(f'train (d) full-width steps, f32, B = 1, after 2 warm-up '
              f'steps, ms (data, forward, backward, optimizer): '
              + ' | '.join(', '.join(f'{x:.3f}' for x in row)
                           for row in splits)
              + f'; median {", ".join(f"{x:.3f}" for x in med)}, total '
              f'{float(np.median(np.sum(splits, 1))):.3f}; peak_mem_bytes '
              f'{peak}; last losses { {k: round(x, 5) for k, x in vals.items()} }'
              f' grad_norm {float(norm):.5g}; launches per step '
              f'{ {k: n // TRAIN_TIMED_STEPS for k, n in counts.items() if n} }',
              flush=True)
        del model, step, total, losses, img, meta, gt
        gc.collect()
        torch.cuda.empty_cache()

        # (e) overfit one frame at the tiny config: no flip, scale or
        # photometric distortion (the evaluation pipeline), 30 steps at a
        # constant lr 1e-3
        frame = KittiDataset(root, infos, train=False, pipeline_kwargs=dict(
            crop_size=TRAIN_TINY_CROP, max_gt=32)).get_sample(
                0, np.random.default_rng(0))
        model = init_weights(DfM(tiny)).to(dev)
        step = TrainStep(model, make_optimizer(model), step_schedule(1e-3))
        img, meta, gt = build_batch([frame], dev)
        curve = []
        for i in range(30):
            m = step(img, meta, gt,
                     torch.Generator(device=dev).manual_seed(i))
            curve.append(float(m['loss']))
        first, last = float(np.mean(curve[:5])), float(np.mean(curve[-5:]))
        check(np.isfinite(curve).all() and last < first,
              f'overfit: mean loss of the last 5 steps {last} not below the '
              f'first 5 {first}: {curve}')
        print(f'train (e) overfit one frame, tiny, 30 steps at lr 1e-3: mean '
              f'loss first 5 {first:.5f}, last 5 {last:.5f}', flush=True)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.ops.cuda import build

    card = card_line()
    print(f'device: {card} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | {torch.cuda.get_device_name(0)}',
          flush=True)
    secs = build.build_all()
    print(f'build: {secs:.1f} s for {len(build.SOURCES)} sources', flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line \
                    or 'Performance' in line:
                print(f'build {name}: {line.strip()}')

    dev = 'cuda'
    cfg = DfMConfig()
    results = kernel_phase(cfg, dev)
    from dfm_tpu_torch.ops.cuda import conv_chain as KC
    gc.collect()
    check(not KC._WGMMA_WEIGHTS, f'{len(KC._WGMMA_WEIGHTS)} weight layouts '
          'outlived the kernel phase (the table keeps no weight alive)')
    launches = main_phase(cfg, dev)
    for name, n in launches.items():
        if name in results:
            results[name]['main_path_launches' if name in OFF_PATH
                          else 'launches'] = n
    parity_phase(cfg, dev)
    eval_phase(cfg, dev)
    train_phase(cfg, dev, results)

    print(json.dumps({'kernels': list(results.values())}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
