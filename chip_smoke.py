#!/usr/bin/env python3
"""Drive the PyTorch port (dfm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and no result is printed:
  1. device   card name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc for every kernel source, all at once
  3. kernels  K1 warp_prev, K2 frustum_stereo_sample, K3 attention_sample,
              K8a pack_vol, K4 conv_p2p (with and without the residual),
              K7a unpack_affine_res (stem exit and pred exit) at the
              DfM-KITTI main-path shapes: each kernel against its plain
              PyTorch version on the same inputs (stated tolerance), the
              zero border of every chain tensor a kernel writes, K4 run
              twice and compared bit for bit, kernel / plain / one-call
              library times (CUDA events, median of 20 after warmup),
              and the bound: the bytes the function needs (rows of a
              gathered table it touches, coordinates, volumes in and
              out) over 3.35 TB/s, against its operations over the peak
              for their type (f32 67 TFLOP/s; K4's bf16 products on the
              tensor cores 989 TFLOP/s, dense)
  4. main     full DfMConfig, 1x2x320x1280, bf16, seeded random weights,
              the default form (banded stems, reduced-depth mono trunk,
              stereo stem and pred ConvNorm on the conv chain):
              `init_dfm_model` (3 requests) and `init_dfm_stream` (first
              frame + 2 stream steps), each run with the launch counts
              set to 0 just before and read just after, every kernel
              launched on both; then the dense form (`use_band=False,
              packed=False`) for 2 timed requests after a warm-up, so
              that both forms' ms/frame and peak memory come from one
              run; plus decode + NMS on full-shape head outputs with
              live scores
  5. parity   tiny config in float32 with TF32 off, dense form: the same
              weights on the CPU (plain versions) and on the card
              (K1-K3); and bf16 on the card, default form against dense
              form from the same weights and inputs, at the tiny config
              and at full width
Then the kernels JSON line, the card line, and the result line.
Exits non-zero without a result when there is no CUDA device or the
package is not beside the script.
"""

import json
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
        more = ''.join(f' {k} {v:.4f}' for k, v in extra.items())
        print(f'kernel {name}: max_abs_err {err:.3g} '
              f'(tol atol {tol[0]} + rtol {tol[1]}) ms {ms:.4f} '
              f'plain_ms {plain_ms:.4f} library_ms {lib}{more} '
              f'bytes {nbytes} flops {flops} '
              f'bound_ms {max(t_bytes, t_ops):.4f}', flush=True)

    # K1 at (1, 320, 1280, 32) -> (1, 72, 80, 320, 32)
    prev = torch.randn(1, h, w, cfg.stereo_channels[1], generator=gen,
                       device=dev).to(bf)
    _, grid = CV.plane_sweep_grids(
        depths, meta.ori_cam2img, meta.cur2prev, (h, w),
        cfg.cost_sample_factor, 1, meta.org_w, meta.flip, meta.crop_offset,
        meta.scale_factor)
    gu, gv = grid[..., 0].contiguous(), grid[..., 1].contiguous()
    got = K.warp_prev(prev, gu, gv)
    want = CV.warp_prev_plain(prev, gu, gv)
    prev_nchw = prev.permute(0, 3, 1, 2).contiguous()
    norm = torch.stack([gu / (w - 1) * 2 - 1, gv / (h - 1) * 2 - 1],
                       -1).reshape(1, d * hq, wq, 2).to(bf)
    report('warp_prev', 'dfm_tpu_torch/csrc/warp_prev.cu',
           'dfm_tpu/ops/pallas/cost_warp.py:142',
           agree('warp_prev', got, want, (1e-2, 1e-2)), (1e-2, 1e-2),
           cuda_ms(lambda: K.warp_prev(prev, gu, gv)),
           cuda_ms(lambda: CV.warp_prev_plain(prev, gu, gv)),
           cuda_ms(lambda: F.grid_sample(prev_nchw, norm,
                                         align_corners=True)),
           needed_bytes(CV.warp_prev_plain, prev, prev.shape[-1], gu, gv)
           + 2 * gu.numel() * 4 + got.numel() * got.element_size(),
           8 * got.numel())

    # K2 at (1, 72, 80, 320, 32) -> (1, 20, 304, 288, 32) + mask
    vol = torch.randn(1, d, hq, wq, cfg.cv_channels, generator=gen,
                      device=dev).to(bf)
    ds = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, d)
    got, valid = K.frustum_stereo_sample(vol, u, v, ds, IMG_HW)
    tabs = FS.depth_tables(ds, dev)
    want, valid_w = FS.stereo_sample_plain(vol, u, v, *tabs, IMG_HW)
    check(torch.equal(valid, valid_w), 'frustum_stereo_sample: valid2d')

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

    vol_ncdhw = vol.permute(0, 4, 1, 2, 3).contiguous()
    g2 = lib_grid(d, hq, wq).to(bf)
    report('frustum_stereo_sample', 'dfm_tpu_torch/csrc/frustum_sample.cu',
           'dfm_tpu/ops/pallas/frustum_sample.py:92',
           agree('frustum_stereo_sample', got, want, (1e-2, 1e-2)),
           (1e-2, 1e-2),
           cuda_ms(lambda: K.frustum_stereo_sample(vol, u, v, ds, IMG_HW)),
           cuda_ms(lambda: FS.stereo_sample_plain(vol, u, v, *tabs,
                                                  IMG_HW)),
           cuda_ms(lambda: F.grid_sample(vol_ncdhw, g2,
                                         align_corners=True)),
           needed_bytes(FS.stereo_sample_plain, vol, vol.shape[-1], u, v,
                        *tabs, IMG_HW)
           + (u.numel() + v.numel()) * 4 + got.numel() * 2 + valid.numel(),
           16 * got.numel())

    # K3 at (1, 288, 320, 1280) -> (1, 20, 304, 288) f32
    cost = torch.randn(1, d, hq, wq, generator=gen, device=dev)
    sm = FS.build_fine_softmax_volume(cost, cfg.depth_downsample, IMG_HW,
                                      bf)
    df = d * cfg.depth_downsample
    dsf = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, df)
    tabf = FS.depth_tables(dsf, dev)
    got = K.attention_sample(sm, u, v, dsf, IMG_HW)
    want = FS.attention_sample_plain(sm, u, v, *tabf, IMG_HW)
    sm_ncdhw = sm[:, None]
    g3 = lib_grid(df, h, w).to(bf)
    report('attention_sample', 'dfm_tpu_torch/csrc/frustum_sample.cu',
           'dfm_tpu/ops/pallas/frustum_sample.py:233',
           agree('attention_sample', got, want, (1e-5, 1e-5)), (1e-5, 1e-5),
           cuda_ms(lambda: K.attention_sample(sm, u, v, dsf, IMG_HW)),
           cuda_ms(lambda: FS.attention_sample_plain(sm, u, v, *tabf,
                                                     IMG_HW)),
           cuda_ms(lambda: F.grid_sample(sm_ncdhw, g3, align_corners=True)),
           needed_bytes(FS.attention_sample_plain, sm, 1, u, v, *tabf,
                        IMG_HW)
           + (u.numel() + v.numel()) * 4 + got.numel() * 4,
           16 * got.numel())
    chain_kernel_phase(vol[0], gen, agree, report)
    return results


def chain_kernel_phase(x, gen, agree, report):
    """K8a, K4, K7a at (72, 80, 320, 32) bf16. Outputs agree with the
    plain versions to one bf16 rounding (atol 1e-2 + rtol 1e-2: the f32
    sums of 864 products are taken in another order, so a result near a
    rounding boundary may round the other way). Moments: sums of squares
    rtol 1e-4; sums rtol 1e-4 + atol 1e-6 * sqrt(N * sum of squares), N
    values per sum (a sum of signed terms cancels, so its error scales
    with the terms, not with the sum). The plain K4 convolves in f32
    with cuDNN's TF32 off (bf16-valued operands are exact either way)."""
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import conv_chain as CC
    from dfm_tpu_torch.ops.cuda import conv_chain as KC
    src = 'dfm_tpu_torch/csrc/conv_chain.cu'
    jax_src = 'dfm_tpu/ops/pallas/conv_chain.py'
    tol = (1e-2, 1e-2)
    dev = x.device
    d, h, w, c = x.shape
    nvox = d * h * w
    dense_bytes = x.numel() * 2
    weight = torch.randn(c, c, 3, 3, 3, generator=gen, device=dev) \
        / (27 * c) ** 0.5
    sc = torch.rand(c, generator=gen, device=dev) + 0.5
    bs = torch.randn(c, generator=gen, device=dev)

    # K8a
    cv = KC.pack_vol(x)
    check(torch.equal(cv.data, CC.pack_vol_plain(x).data),
          'pack_vol: kernel differs from its plain version')
    check(cv.border_is_zero(), 'pack_vol: border not zero')
    check(torch.equal(CC.unpack_vol(cv), x), 'pack_vol: round trip')
    chain_bytes = cv.data.numel() * 2
    report('pack_vol', src, jax_src + ':444', 0.0, (0, 0),
           cuda_ms(lambda: KC.pack_vol(x)),
           cuda_ms(lambda: CC.pack_vol_plain(x)),
           cuda_ms(lambda: F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))),
           dense_bytes + chain_bytes, 0)

    # K4, both residual modes
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        errs, outs = [], {}
        for residual in (False, True):
            out, ps = KC.conv_p2p(cv, weight, residual)
            out2, ps2 = KC.conv_p2p(cv, weight, residual)
            check(torch.equal(out.data, out2.data) and torch.equal(ps, ps2),
                  'conv_p2p: two runs differ')
            check(out.border_is_zero(), 'conv_p2p: border not zero')
            want, wps = CC.conv_p2p_plain(cv, weight, residual)
            errs.append(agree('conv_p2p', out.data, want.data, tol))
            got_z, want_z = ps.sum(1).double(), wps.sum(1).double()
            n = h * w
            lim = 1e-4 * want_z.abs()
            lim[:, 0] += 1e-6 * (n * want_z[:, 1]).sqrt()
            check(bool(((got_z - want_z).abs() <= lim).all()),
                  f'conv_p2p: moments disagree (residual={residual})')
            outs[residual] = out
            ps_bytes = ps.numel() * 4
        plain_ms = cuda_ms(lambda: CC.conv_p2p_plain(cv, weight))
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    x5 = x.permute(3, 0, 1, 2)[None]               # NCDHW view, NDHWC memory
    w5 = weight.to(x.dtype)

    def lib_moments():
        y = F.conv3d(x5, w5, padding=1).float()
        return y.sum((0, 2, 3, 4)), (y * y).sum((0, 2, 3, 4))

    out = outs[False]
    report('conv_p2p', src, jax_src + ':233', max(errs), tol,
           cuda_ms(lambda: KC.conv_p2p(cv, weight)), plain_ms,
           cuda_ms(lambda: F.conv3d(x5, w5, padding=1)),
           2 * chain_bytes + weight.numel() * 2 + ps_bytes,
           2 * 27 * c * c * nvox, peak=BF16_TENSOR_FLOPS,
           ms_residual=cuda_ms(lambda: KC.conv_p2p(cv, weight, True)),
           library_with_moments_ms=cuda_ms(lib_moments))

    # K7a: stem exit (residual, no relu) and pred exit (relu)
    errs = []
    for res, relu in ((cv, False), (None, True)):
        got = KC.unpack_affine(out, sc, bs, res, relu)
        errs.append(agree('unpack_affine_res', got,
                          CC.unpack_affine_plain(out, sc, bs, res, relu),
                          tol))
    # no single PyTorch call computes it: no library time
    report('unpack_affine_res', src, jax_src + ':624', max(errs), tol,
           cuda_ms(lambda: KC.unpack_affine(out, sc, bs, cv, False)),
           cuda_ms(lambda: CC.unpack_affine_plain(out, sc, bs, cv, False)),
           None, 3 * dense_bytes + 2 * c * 4, 3 * x.numel(),
           ms_relu=cuda_ms(lambda: KC.unpack_affine(out, sc, bs, None, True)))


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

    # the default form: bf16 on the card, banded + conv chain
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
        for name, n in c.items():
            check(n > 0, f'{name} never launched on the {path} path')
    del stream, cache

    # the dense form in the same run, for comparison, and the default
    # form once more after it (the first requests above also pay the
    # warm-up of cuDNN and of the allocator)
    dense = init_dfm_model(cfg, use_band=False, packed=False)
    requests(dense, [0], 'dense warm-up')
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ms, _ = requests(dense, (1, 2), 'dense form')
    check(K.LAUNCHES['conv_p2p'] == 0 and K.LAUNCHES['warp_prev'] == 2,
          f'dense form launched {K.LAUNCHES}')
    print(f'main dense form (use_band=False, packed=False): ms/frame '
          f'{[round(x, 3) for x in ms]} peak_mem_bytes '
          f'{torch.cuda.max_memory_allocated()}', flush=True)
    del dense
    ms, _ = requests(handle, (1, 2), 'default form again')
    print(f'main default form again, after the dense form: ms/frame '
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
        want = dict(warp_prev=1, frustum_stereo_sample=1, attention_sample=1,
                    pack_vol=0, conv_p2p=0, unpack_affine_res=0)
        check(K.LAUNCHES == want, f'f32 dense parity run launched '
              f'{K.LAUNCHES}, expected {want}')
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

    # bf16 on the card: the default form (banded + conv chain, all six
    # kernels) against the dense form, same weights (seed 0) and inputs.
    # The two compute the same function with bf16 roundings at other
    # places, so they are held together by the error's size against the
    # output's: ||a - b|| <= 0.05 ||b|| for every output (bf16 keeps 3
    # digits; dozens of layers lie between the trunks and the heads), and
    # for the trunk's own output, depth_cost, also elementwise within
    # atol 0.15 + rtol 0.15 (the JAX package's bf16 tolerance for it).
    rng = np.random.RandomState(0)
    full_img = torch.from_numpy(rng.randn(1, 2, *IMG_HW, 3).astype(
        np.float32))
    for name, c, im, mt in (('tiny', cfg, img, meta),
                            ('full width', full_cfg, full_img,
                             kitti_meta(1, dev))):
        outs = {}
        K.reset_launch_counts()
        for form, kw in (('chain', {}),
                         ('dense', dict(use_band=False, packed=False))):
            model = init_dfm_model(c, **kw)['model']
            with torch.inference_mode():
                outs[form] = model(im.to(dev), mt.to(dev))
            del model
        check(K.LAUNCHES['conv_p2p'] == 3 and K.LAUNCHES['pack_vol'] == 2
              and K.LAUNCHES['unpack_affine_res'] == 2,
              f'bf16 parity {name}: chain form launched {K.LAUNCHES}')
        worst = 0.0
        for key in OUT_KEYS:
            a, b = outs['chain'][key].float(), outs['dense'][key].float()
            check(bool(torch.isfinite(a).all()), f'{name} {key} not finite')
            rel = float((a - b).norm() / b.norm().clamp(min=1e-6))
            worst = max(worst, rel)
            check(rel <= 0.05, f'bf16 chain vs dense form, {name} {key}: '
                  f'relative L2 error {rel}')
        a, b = (outs[f]['depth_cost'].float() for f in ('chain', 'dense'))
        err = float((a - b).abs().max())
        check(bool(((a - b).abs() <= 0.15 + 0.15 * b.abs()).all()),
              f'bf16 chain vs dense form, {name} depth_cost: max abs err '
              f'{err}')
        print(f'parity {name} bf16 on the card, default form vs dense '
              f'form: worst relative L2 error {worst:.3g} (tol 0.05), '
              f'depth_cost max abs err {err:.3g} (tol atol 0.15 + rtol '
              f'0.15)', flush=True)


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
            if 'registers' in line or 'spill' in line:
                print(f'build {name}: {line.strip()}')

    dev = 'cuda'
    cfg = DfMConfig()
    results = kernel_phase(cfg, dev)
    launches = main_phase(cfg, dev)
    for name, n in launches.items():
        results[name]['launches'] = n
    parity_phase(cfg, dev)

    print(json.dumps({'kernels': list(results.values())}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
