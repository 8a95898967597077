"""Evaluation of a DfM config on KITTI, or of a MultiViewDfM config on
Waymo, with the port.

    python -m dfm_tpu_torch.tools.test CONFIG \\
        [--checkpoint X.pth] [--cfg-options key=value ...] \\
        [--max-samples N] [--out P.pkl] [--eval kitti|waymo|none] \\
        [--waymo-gt-bin GT.bin] [--dtype float32] [--device cpu]

Port of `tools/test.py:163-231` (`kitti_dfm_eval`), `:286-343`
(`waymo_real_eval`) and the branches of its `main` that reach them.

KITTI (DfM, DfMFull): config -> `kitti_infos_val.pkl` under
`data.data_root` (`python -m dfm_tpu_torch.tools.create_data kitti`
writes it) -> `KittiDataset(train=False)` -> the port's model in its
default form (bfloat16; seeded random weights, or a reference-layout
checkpoint, or one the port's train CLI wrote for DfM or DfMFull: the
student's weights, `student_state_dict`) -> KITTI annos per frame ->
`kitti_eval`, printing the AP of every moderate and every 3d entry.

Waymo (MultiViewDfM): config -> `waymo_infos_val.pkl` under
`data.data_root` -> `WaymoDataset` (load_mode 'lidar_frame', `cam_sync`
from the data config; `data/waymo.py:frames_per_sample` frames a sample:
two for the 10-sweeps config, the sweep's lidar2img rewritten by
ego-motion) -> the port's MultiViewDfM (bfloat16; seeded random
weights or a checkpoint in the port's layout) -> the kept detections of
each frame in the vehicle frame -> `format_results` -> a predictions
.bin -> `evaluate_waymo` against the GT .bin: `--waymo-gt-bin`, else
`gt.bin` under the data root, else one built from the infos
(`gt_objects_from_infos`); prints every LET mAP / mAPH / mAPL line and
the metric that computed them (`official_binary` when WAYMO_METRICS_BIN
names the official binary, `python_fallback` otherwise). The .bin files
go to a temporary directory.

Another model type, or a data root without its info file, exits with a
message and code 2. Runs on the CUDA card unless `--device cpu`, in
bfloat16 unless `--dtype float32`.

Under `torchrun --nproc_per_node=N` (`parallel/dist.py`) each rank loads
the weights and infers frames r, r + N, ... on the card LOCAL_RANK (the
CPU with `--device cpu`); the results are gathered in dataset order
(`apis.allgather_pickled`), and rank 0 alone writes `--out`, evaluates
and prints the metric lines, which equal a one-process run's.
"""

import argparse
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

from ..apis import (_sharded, detect_multiview_sample, detect_sample,
                    init_dfm_model, init_mvdfm_model)
from ..data.kitti import KittiDataset
from ..data.waymo import WaymoDataset, frames_per_sample
from ..evaluation.kitti_eval import kitti_eval
from ..evaluation.results import detections_to_kitti_annos
from ..evaluation.waymo_eval import gt_annos_to_bin, gt_objects_from_infos
from ..models.builder import build_detector, unused_keys
from ..parallel import dist as D
from ..runtime.config import load_config, merge_options
from ..utils.weights import load_reference_state_dict, read_checkpoint

INFO_FILE = 'kitti_infos_val.pkl'
WAYMO_INFO_FILE = 'waymo_infos_val.pkl'


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None,
                   help='reference-layout torch checkpoint (.pth), or '
                        "one of the port's train CLI; seeded random weights "
                        'if omitted')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--eval', default=None, choices=['kitti', 'waymo', 'none'],
                   help="the dataset's own metric if omitted")
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--out', default=None,
                   help='pkl of the KITTI annos or the Waymo detections')
    p.add_argument('--waymo-gt-bin', default=None,
                   help='GT Objects .bin; gt.bin under the data root, or '
                        'one built from the infos, if omitted')
    p.add_argument('--dtype', default='bfloat16',
                   choices=['bfloat16', 'float32'])
    p.add_argument('--device', default=None,
                   help="torch device; the CUDA card if omitted, 'cpu' "
                        'to run the plain versions on the CPU')
    return p.parse_args(argv)


def student_state_dict(ckpt):
    """The weights to evaluate of a checkpoint dict: a DfMFull checkpoint
    of the port's train CLI holds its student under 'dfm.', and those
    keys are taken without the prefix (the others stay, to be reported
    as not taken); any other checkpoint as it is."""
    sd = ckpt.get('state_dict', ckpt)
    if not any(k.startswith('dfm.') for k in sd):
        return sd
    return {k[len('dfm.'):] if k.startswith('dfm.') else k: v
            for k, v in sd.items()}


def kitti_dfm_eval(args, cfg):
    """Build -> load -> infer -> KITTI AP on the val split."""
    mcfg = build_detector(cfg.model)
    handle = init_dfm_model(mcfg, getattr(torch, args.dtype), args.device)
    print(f'[model] {cfg.model.type} on {handle["device"]}; config keys '
          f'not used at inference: {unused_keys(cfg.model)}', flush=True)
    if args.checkpoint:
        rest = load_reference_state_dict(
            handle['model'], student_state_dict(read_checkpoint(
                args.checkpoint)))
        print(f'[checkpoint] {args.checkpoint}: {len(rest)} keys not '
              'taken (teacher, ATSS head, num_batches_tracked)', flush=True)

    d = cfg.data
    ds = KittiDataset(
        d.data_root, os.path.join(d.data_root, INFO_FILE), train=False,
        pipeline_kwargs=dict(crop_size=tuple(d.crop_size), max_gt=d.max_gt))
    rng = np.random.default_rng(0)
    n = min(len(ds), args.max_samples or len(ds))

    def infer(i):
        info = ds.infos[i]
        det = detect_sample(handle, ds.get_sample(i, rng))
        anno = detections_to_kitti_annos(
            det, np.asarray(info['calib']['P2'])[:3],
            info.get('image', {}).get('image_shape', (375, 1242)))
        print(f'[{i + 1}/{n}] dets={len(anno["name"])}', flush=True)
        return anno

    dt_annos = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(dt_annos, f)
    if args.eval != 'none':
        res = kitti_eval(ds.gt_annos()[:n], dt_annos)
        for k in sorted(res):
            if 'moderate' in k or '3d' in k:
                print(f'{k}: {res[k]:.4f}')
        return res
    return None


def waymo_mvdfm_eval(args, cfg):
    """Build -> load -> infer -> Objects .bin -> LET metrics."""
    mcfg = build_detector(cfg.model)
    handle = init_mvdfm_model(mcfg, getattr(torch, args.dtype), args.device)
    d = cfg.data
    frames = frames_per_sample(d, mcfg)
    print(f'[model] MultiViewDfM on {handle["device"]}, {frames} frame(s) a '
          'sample', flush=True)
    if args.checkpoint:
        rest = handle['load_checkpoint'](args.checkpoint)
        print(f'[checkpoint] {args.checkpoint}: {len(rest)} keys not taken',
              flush=True)
    ds = WaymoDataset(
        d.data_root, os.path.join(d.data_root, WAYMO_INFO_FILE),
        num_frames=frames,
        target_hw=tuple(d.get('target_hw', (640, 960))),
        num_views=d.get('num_views', 5), max_gt=d.get('max_gt', 64),
        load_mode=d.get('load_mode', 'lidar_frame'),
        cam_sync=d.get('cam_sync', False))
    n = min(len(ds), args.max_samples or len(ds))

    def infer(i):
        res = detect_multiview_sample(handle, ds.get_sample(i))
        print(f'[{i + 1}/{n}] dets={len(res["scores_3d"])}', flush=True)
        return res

    results = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.eval == 'none':
        return None
    ds.infos = ds.infos[:n]
    with tempfile.TemporaryDirectory() as tmp:
        gt_bin = args.waymo_gt_bin or os.path.join(d.data_root, 'gt.bin')
        if not os.path.exists(gt_bin):
            gt_bin = os.path.join(tmp, 'gt.bin')
            n_gt = gt_annos_to_bin(gt_objects_from_infos(
                ds.infos, cam_sync=d.get('cam_sync', False)), gt_bin)
            print(f'[gt] {n_gt} objects from the val infos', flush=True)
        res = ds.evaluate(results, gt_bin, tmp)
    print(f'[metric] {res["_source"]}')
    for k in sorted(res):
        if isinstance(res[k], float):
            print(f'{k}: {res[k]:.4f}')
    return res


def main(argv=None):
    args = parse_args(argv)
    cfg = merge_options(load_config(args.config), args.cfg_options)
    kind = cfg.model.get('type', '')
    try:
        build_detector(cfg.model)
    except (NotImplementedError, ValueError) as e:
        print(f'[model] {e}', file=sys.stderr)
        return 2
    data_type = cfg.data.get('type', '') if 'data' in cfg else ''
    root = cfg.data.get('data_root', '') if 'data' in cfg else ''
    if kind == 'MultiViewDfM':
        want, info, run = 'WaymoDataset', WAYMO_INFO_FILE, waymo_mvdfm_eval
    else:
        want, info, run = 'KittiDataset', INFO_FILE, kitti_dfm_eval
    if data_type != want or not os.path.exists(os.path.join(root, info)):
        print(f'[data] {kind} evaluates on {want} infos: no {info} under '
              f'{root!r} (dataset type {data_type!r})', file=sys.stderr)
        return 2
    args.device = D.init_from_env(args.device)
    try:
        run(args, cfg)
    finally:
        D.destroy()
    return 0


if __name__ == '__main__':
    sys.exit(main())
