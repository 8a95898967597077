"""KITTI evaluation of a DfM config with the port.

    python -m dfm_tpu_torch.tools.test configs/dfm_r34_kitti_3class.py \\
        [--checkpoint X.pth] [--cfg-options key=value ...] \\
        [--max-samples N] [--out P.pkl] [--eval kitti|none] [--device cpu]

Port of `tools/test.py:163-231` (`kitti_dfm_eval`) and the DfM branch of
its `main`: config -> `kitti_infos_val.pkl` under `data.data_root`
(`python -m dfm_tpu_torch.tools.create_data kitti` writes it) ->
`KittiDataset(train=False)` -> the port's model in its default form
(bfloat16; seeded random weights, or a reference-layout checkpoint) ->
KITTI annos per frame -> `kitti_eval`, printing the AP of every
moderate and every 3d entry. It runs DfM and DfMFull on KITTI only;
another model type, or a data root without the info file, exits with a
message and code 2. Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import os
import pickle
import sys

import numpy as np

from ..apis import detect_sample, init_dfm_model
from ..data.kitti import KittiDataset
from ..evaluation.kitti_eval import kitti_eval
from ..evaluation.results import detections_to_kitti_annos
from ..models.builder import build_detector, unused_keys
from ..runtime.config import load_config, merge_options

INFO_FILE = 'kitti_infos_val.pkl'


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None,
                   help='reference-layout torch checkpoint (.pth); seeded '
                        'random weights if omitted')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--eval', default='kitti', choices=['kitti', 'none'])
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--out', default=None, help='pkl of the KITTI annos')
    p.add_argument('--device', default=None,
                   help="torch device; the CUDA card if omitted, 'cpu' "
                        'to run the plain versions on the CPU')
    return p.parse_args(argv)


def kitti_dfm_eval(args, cfg):
    """Build -> load -> infer -> KITTI AP on the val split."""
    mcfg = build_detector(cfg.model)
    handle = init_dfm_model(mcfg, device=args.device)
    print(f'[model] {cfg.model.type} on {handle["device"]}; config keys '
          f'not used at inference: {unused_keys(cfg.model)}', flush=True)
    if args.checkpoint:
        rest = handle['load_checkpoint'](args.checkpoint)
        print(f'[checkpoint] {args.checkpoint}: {len(rest)} keys not '
              'taken (teacher, ATSS head, num_batches_tracked)', flush=True)

    d = cfg.data
    ds = KittiDataset(
        d.data_root, os.path.join(d.data_root, INFO_FILE), train=False,
        pipeline_kwargs=dict(crop_size=tuple(d.crop_size), max_gt=d.max_gt))
    rng = np.random.default_rng(0)
    n = min(len(ds), args.max_samples or len(ds))
    dt_annos = []
    for i in range(n):
        info = ds.infos[i]
        det = detect_sample(handle, ds.get_sample(i, rng))
        dt_annos.append(detections_to_kitti_annos(
            det, np.asarray(info['calib']['P2'])[:3],
            info.get('image', {}).get('image_shape', (375, 1242))))
        print(f'[{i + 1}/{n}] dets={len(dt_annos[-1]["name"])}', flush=True)

    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(dt_annos, f)
    if args.eval == 'kitti':
        res = kitti_eval(ds.gt_annos()[:n], dt_annos)
        for k in sorted(res):
            if 'moderate' in k or '3d' in k:
                print(f'{k}: {res[k]:.4f}')
        return res
    return None


def main(argv=None):
    args = parse_args(argv)
    cfg = merge_options(load_config(args.config), args.cfg_options)
    kind = cfg.model.get('type', '')
    try:
        build_detector(cfg.model)
    except NotImplementedError as e:
        print(f'[model] {e}', file=sys.stderr)
        return 2
    data_type = cfg.data.get('type', '') if 'data' in cfg else ''
    root = cfg.data.get('data_root', '') if 'data' in cfg else ''
    if data_type != 'KittiDataset' or not os.path.exists(
            os.path.join(root, INFO_FILE)):
        print(f'[data] {kind} evaluates on KITTI infos: no {INFO_FILE} '
              f'under {root!r} (dataset type {data_type!r})',
              file=sys.stderr)
        return 2
    kitti_dfm_eval(args, cfg)
    return 0


if __name__ == '__main__':
    sys.exit(main())
