"""Where the time goes on the main path, from a torch.profiler trace.

    python -m dfm_tpu_torch.trace_main [--requests 3] [--out build/trace]
                                       [--dense | --stem]

Runs DfM-R34 KITTI inference (full DfMConfig, 1x2x320x1280, bf16,
seeded random weights) on the CUDA card, in the default form (banded
stems, reduced-depth mono trunk, both trunks on the conv chain), with
`--stem` in the form that keeps only the stereo stem and pred ConvNorm
on the chain (`packed='stem'`), or with `--dense` in the dense form:
two warm-up requests, then `--requests` two-frame requests
(`init_dfm_model`) and as many stream steps (`init_dfm_stream`) under
the profiler. Prints, per path, the host ms per request, the device busy
time (kernels and copies) per request and the idle share; for each stage
span of `DfM.forward` / `dfm_predict` (and, inside
`dfm.stereo_backbone`, the backbone's cost_volume / stem / hourglass /
mono / pred spans, inside `.cost_volume` its grid / warp spans, and
inside `dfm.frustum_to_voxel` the neck's uv / softmax_volume /
attention / voxel_features / voxel_convnorm / pool spans) its extent on
the device timeline, the kernel time
inside it and its host time; the device time and launches of each of
the port's own kernels; and the kernels that take the most device time.
Writes the same as JSON (`trace_main.json`, `trace_main_stem.json` or
`trace_main_dense.json`), plus a Chrome trace of the two-frame requests, to `--out`. Needs a CUDA
device.
"""

import argparse
import collections
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .apis import init_dfm_model, init_dfm_stream
from .models.detectors.dfm import BatchMeta, DfMConfig

# device functions of the port's hand-written kernels (csrc/*.cu)
PORT_KERNELS = ('warp_prev_kernel', 'voxel_features',
                'attention_sample_kernel', 'unpack_vol_kernel',
                'pack_vol_kernel', 'conv_p2p_kernel', 'unpack_affine_kernel',
                'conv_s2_kernel',
                'pack_parity8_kernel', 'affine_chain_kernel')


def _inputs(dev):
    h, w = 320, 1280
    frames = torch.from_numpy(np.random.RandomState(0).randn(
        6, h, w, 3).astype(np.float32)).to(dev)
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 721.5
    cam[0, 2], cam[1, 2] = w / 2, h / 2
    meta = BatchMeta.identity(1, cam[None], dev)
    meta.cur2prev = torch.eye(4, device=dev)[None].clone()
    meta.cur2prev[:, 2, 3] = 0.8
    return frames, meta


def _summary(prof, n, wall_ms, top):
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in dev if e.name.startswith('dfm.')]   # stage ranges
    kernels = [e for e in dev if not e.name.startswith('dfm.')]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.Counter()
    ours = {k: [0.0, 0.0] for k in PORT_KERNELS}
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        for k in PORT_KERNELS:       # first match: unpack_vol before pack_vol
            if k in e.name:
                ours[k][0] += e.time_range.elapsed_us() / 1e3 / n
                ours[k][1] += 1 / n
                break
    stages = collections.defaultdict(lambda: [0.0, 0.0, 0.0])
    for a in spans:
        r = a.time_range
        inside = sum(k.time_range.elapsed_us() for k in kernels
                     if r.start <= k.time_range.start and
                     k.time_range.end <= r.end)
        stages[a.name][0] += r.elapsed_us() / 1e3 / n
        stages[a.name][1] += inside / 1e3 / n
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith('dfm.'):
            stages[e.name][2] += e.cpu_time_total / 1e3 / n
    # the profiler gives a span with spans inside it no device range that
    # covers them: such a span takes the sum of its direct children (the
    # deepest spans first, so that a child already holds its own sum)
    for name in sorted(stages, key=lambda k: -k.count('.')):
        v = stages[name]
        kids = [c for k, c in stages.items() if k.startswith(name + '.')
                and '.' not in k[len(name) + 1:]]
        if kids and v[0] < sum(c[0] for c in kids):
            v[0], v[1] = (sum(c[i] for c in kids) for i in (0, 1))
    return dict(
        host_ms_per_request=wall_ms / n,
        device_busy_ms_per_request=busy / n,
        device_idle_share=max(0.0, 1 - busy / wall_ms),
        stages_ms_per_request={
            k: dict(device_span=v[0], kernels=v[1], host=v[2])
            for k, v in stages.items()},
        port_kernels_per_request={
            k: dict(ms=v[0], launches=v[1]) for k, v in ours.items()},
        top_kernels_ms_per_request=[
            (name[:90], ms / n) for name, ms in by_name.most_common(top)])


def _profiled(step, n, trace):
    for _ in range(2):
        step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if trace:
        prof.export_chrome_trace(trace)
    return prof, wall


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--top', type=int, default=12)
    ap.add_argument('--out', default='build/trace')
    form = ap.add_mutually_exclusive_group()
    form.add_argument('--dense', action='store_true',
                      help='the dense form (use_band=False, packed=False)')
    form.add_argument('--stem', action='store_true',
                      help="stem and pred ConvNorm on the chain only "
                           "(packed='stem')")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('trace_main: needs a CUDA device')
    dev = 'cuda'
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cfg = DfMConfig()
    frames, meta = _inputs(dev)
    n = args.requests
    if args.dense:
        form, tag, name = dict(use_band=False, packed=False), '_dense', 'dense'
    elif args.stem:
        form, tag, name = dict(packed='stem'), '_stem', 'banded + chain stem'
    else:
        form, tag, name = {}, '', 'banded + full conv chain'
    result = dict(card=card, torch=torch.__version__, form=name)

    model = init_dfm_model(cfg, **form)
    prof, wall = _profiled(
        lambda i: model['infer'](frames[None, i:i + 2], meta), n,
        os.path.join(args.out, f'trace_model{tag}.json'))
    result['model'] = _summary(prof, n, wall, args.top)
    del model, prof

    stream = init_dfm_stream(cfg, **form)
    _, cache = stream['infer_first'](frames[None, 0:2], meta)

    def step(i):
        nonlocal cache
        _, cache = stream['infer_stream'](frames[None, i + 2], meta, cache)

    prof, wall = _profiled(step, n, None)
    result['stream'] = _summary(prof, n, wall, args.top)

    with open(os.path.join(args.out, f'trace_main{tag}.json'), 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))


if __name__ == '__main__':
    main()
