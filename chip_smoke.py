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
MONO_DEPTH = 44               # slices of the reduced mono volume of 72 planes

# kernel launches of one request (one backbone pass) at full width, by form
SAMPLING = dict(warp_prev=1, frustum_stereo_sample=1, attention_sample=1)
NO_CHAIN = dict(pack_vol=0, conv_p2p=0, unpack_affine_res=0, conv_s2_p2d=0,
                pack_parity8=0, gn_affine_res_packed=0, unpack_vol=0)
# K9a (with its GroupNorm finish), K9b: on no model path (their path is
# their own entry points)
OFF_PATH = dict(conv3d_zpack=0, conv3d_gn_finish=0, conv3d_pallas=0)
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
# the ten kernels of the main path
MAIN_PATH = [k for k, n in LAUNCHES_OF['chain'].items() if n]
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
        more = ''.join(f' {k} {v:.3g}' if k.startswith('max_abs_err') else
                       f' {k} {v:.4f}' if isinstance(v, float) else
                       f' {k} {v}' for k, v in extra.items())
        print(f'kernel {name}: max_abs_err {err:.3g} '
              f'(tol atol {tol[0]} + rtol {tol[1]}) ms {ms:.4f} '
              f'plain_ms {plain_ms:.4f} library_ms {lib}{more} '
              f'bytes {nbytes} flops {flops} '
              f'bound_ms {max(t_bytes, t_ops):.4f}', flush=True)

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
    launches = main_phase(cfg, dev)
    for name, n in launches.items():
        results[name]['main_path_launches' if name in OFF_PATH
                      else 'launches'] = n
    parity_phase(cfg, dev)

    print(json.dumps({'kernels': list(results.values())}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
