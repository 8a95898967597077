"""Train DfM with the port.

    python -m dfm_tpu_torch.tools.train configs/dfm_r34_kitti_3class.py \\
        --cfg-options model.type=DfM [--work-dir W] [--auto-resume] \\
        [--max-steps N] [--eval-samples N] [--seed S] [--device cpu] \\
        [--tensorboard]

Port of the DfM branch of `tools/train.py:38-83, 159-200, 464-649`: the
config (`runtime/config.py`) -> `kitti_infos_train.pkl` under
`data.data_root` (`python -m dfm_tpu_torch.tools.create_data kitti
--splits train val` writes it) -> `KittiDataset(train=True)` (flip,
scale, crop and photometric distortion from `np.random.default_rng(seed)`)
-> the bare DfM student in float32, seeded random weights, in train mode
(the banded form: the conv chain is inference-only) -> `TrainStep`
(`dfm_loss`, the gradient clip at 35, AdamW under the LIGA schedule; the
depth loss's pixels from a device generator seeded from (seed, step)) ->
`<work_dir>/ckpts/step_<n>.pth` every `checkpoint.interval_epochs` and at
the end, `<work_dir>/metrics.jsonl`, and, where `kitti_infos_val.pkl`
exists, the KITTI eval every `schedule.eval_interval` epochs on a float32
model with the trained weights (`dataset_inference`, `kitti_eval`).
`--auto-resume` continues from the newest checkpoint: weights, optimizer
state and step. Only `model.type='DfM'` trains here; another type
(DfMFull, with its LiDAR teacher and ATSS head, or another family) exits
with a message and code 2, as does a data root without the train infos.
Runs on the CUDA card unless `--device cpu`.
"""

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import torch

from ..apis import _device, dataset_inference, init_dfm_model
from ..data.collate import build_batch
from ..data.kitti import KittiDataset
from ..evaluation.kitti_eval import kitti_eval
from ..models.builder import build_detector
from ..models.detectors.dfm import DfM
from ..runtime.checkpoint import CheckpointManager
from ..runtime.config import load_config, merge_options
from ..runtime.logging import MetricsLogger
from ..runtime.schedule import liga_schedule
from ..runtime.train import TrainStep, make_optimizer
from ..utils.weights import init_weights

TRAINED_TYPES = ('DfM',)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--work-dir', default='work_dirs/default')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--auto-resume', action='store_true')
    p.add_argument('--max-steps', type=int, default=None,
                   help='cap total steps (debug)')
    p.add_argument('--eval-samples', type=int, default=None,
                   help='cap val samples per eval (debug)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None,
                   help="torch device; the CUDA card if omitted, 'cpu' to "
                        'run the plain versions on the CPU')
    p.add_argument('--tensorboard', action='store_true',
                   help='also write TensorBoard event files')
    return p.parse_args(argv)


def optimizer_digest(state_dict):
    """sha1 of an optimizer state dict's tensors and step counts, in
    parameter order: equal digests mean a bit-for-bit equal state."""
    h = hashlib.sha1()
    for idx in sorted(state_dict['state']):
        for k in sorted(state_dict['state'][idx]):
            v = state_dict['state'][idx][k]
            h.update(f'{idx}.{k}'.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes()
                     if torch.is_tensor(v) else repr(v).encode())
    return h.hexdigest()


def step_generator(seed, step, device):
    """The device generator of one step, seeded from (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class KittiDfMSource:
    """KITTI video pipeline -> DfM batches, a fresh permutation of the
    frames each epoch (`tools/train.py:KittiDfMSource`)."""

    def __init__(self, cfg, batch_size, train=True):
        d = cfg.data
        split = 'train' if train else 'val'
        self.ds = KittiDataset(
            d.data_root,
            os.path.join(d.data_root, f'kitti_infos_{split}.pkl'),
            train=train,
            pipeline_kwargs=dict(crop_size=tuple(d.crop_size),
                                 scale_range=tuple(
                                     d.get('scale_range', (1.0, 1.0))),
                                 flip_ratio=d.get('flip_ratio', 0.0),
                                 max_gt=d.max_gt))
        self.batch_size = batch_size
        self.order = None
        self.cursor = 0

    @property
    def steps_per_epoch(self):
        return max(len(self.ds) // self.batch_size, 1)

    def next_batch(self, rng, device):
        idxs = []
        while len(idxs) < self.batch_size:
            if self.order is None or self.cursor >= len(self.order):
                self.order = rng.permutation(len(self.ds))
                self.cursor = 0
            idxs.append(int(self.order[self.cursor]))
            self.cursor += 1
        return build_batch([self.ds.get_sample(i, rng) for i in idxs],
                           device)


def run_eval(cfg, mcfg, model, device, max_samples):
    """The EvalHook: KITTI AP of the trained weights on the val split, a
    float32 model in its eval form; nothing without val infos."""
    d = cfg.data
    val_info = os.path.join(d.data_root, 'kitti_infos_val.pkl')
    if not os.path.exists(val_info):
        return None
    val_ds = KittiDataset(d.data_root, val_info, train=False,
                          pipeline_kwargs=dict(crop_size=tuple(d.crop_size),
                                               max_gt=d.max_gt))
    handle = init_dfm_model(mcfg, dtype=torch.float32, device=device)
    handle['model'].load_state_dict(model.state_dict())
    n = min(len(val_ds), max_samples or len(val_ds))
    dt_annos = dataset_inference(handle, val_ds, max_samples=n)
    gt_annos = []
    for info in val_ds.infos[:n]:
        a = info['annos']
        pl = np.asarray(a['gt_boxes_pl']).reshape(-1, 7)
        gt_annos.append(dict(
            name=np.asarray(a['names']), truncated=a['truncated'],
            occluded=a['occluded'], bbox=a['bbox2d'],
            dimensions=np.stack([pl[:, 3], pl[:, 5], pl[:, 4]], 1),
            location=np.stack([-pl[:, 1], -pl[:, 2], pl[:, 0]], 1),
            rotation_y=-pl[:, 6] - np.pi / 2))
    res = kitti_eval(gt_annos, dt_annos)
    for k in sorted(res):
        if '3d_moderate' in k:
            print(f'[eval] {k}: {res[k]:.4f}', flush=True)
    return res


def main(argv=None):
    args = parse_args(argv)
    cfg = merge_options(load_config(args.config), args.cfg_options)
    kind = cfg.model.get('type', '')
    if kind not in TRAINED_TYPES:
        print(f'[model] training of model type {kind!r} is not ported yet '
              f'to dfm_tpu_torch (trained here: {", ".join(TRAINED_TYPES)}; '
              "pass --cfg-options model.type=DfM for the bare student)",
              file=sys.stderr)
        return 2
    d = cfg.data
    if d.get('type', '') != 'KittiDataset' or not os.path.exists(
            os.path.join(d.get('data_root', ''), 'kitti_infos_train.pkl')):
        print(f'[data] DfM trains on KITTI infos: no kitti_infos_train.pkl '
              f'under {d.get("data_root", "")!r} (dataset type '
              f'{d.get("type", "")!r})', file=sys.stderr)
        return 2
    os.makedirs(args.work_dir, exist_ok=True)
    cfg.dump(os.path.join(args.work_dir, 'config.json'))
    device = _device(args.device)
    mcfg = build_detector(cfg.model)
    model = init_weights(DfM(mcfg, dtype=torch.float32), args.seed).to(
        device)
    print(f'[model] {kind}, float32, on {device}', flush=True)

    source = KittiDfMSource(cfg, d.get('batch_size_per_chip', 1))
    steps_per_epoch = source.steps_per_epoch
    sched_cfg = cfg.get('schedule', {}) or {}
    total_steps = steps_per_epoch * sched_cfg.get('total_epochs', 1)
    log_interval = sched_cfg.get('log_interval', 50)
    opt = cfg.get('optimizer', {}) or {}
    schedule = liga_schedule(
        opt.get('lr', 1e-3), opt.get('warmup_iters', 100),
        opt.get('warmup_ratio', 0.1),
        decay_steps=[e * steps_per_epoch
                     for e in opt.get('decay_epochs', (1000,))],
        gamma=opt.get('gamma', 0.1))
    optimizer = make_optimizer(model, opt.get('weight_decay', 1e-4))

    ck = cfg.get('checkpoint', {}) or {}
    ckpt = CheckpointManager(os.path.join(args.work_dir, 'ckpts'),
                             max_keep=ck.get('max_keep', 10))
    start_step = 0
    if args.auto_resume and ckpt.latest_step() is not None:
        start_step = ckpt.restore(model, optimizer)
        print(f'resumed from step {start_step} (optimizer state sha1 '
              f'{optimizer_digest(optimizer.state_dict())})', flush=True)
    train_step = TrainStep(model, optimizer, schedule,
                           opt.get('grad_clip_norm', 35.0), step=start_step)
    logger = MetricsLogger(args.work_dir, use_tensorboard=args.tensorboard)

    rng = np.random.default_rng(args.seed)
    max_steps = args.max_steps or total_steps
    ck_interval = ck.get('interval_epochs', 1) * steps_per_epoch
    eval_interval = sched_cfg.get('eval_interval', 1) * steps_per_epoch
    step = start_step
    t0 = time.time()
    try:
        while step < max_steps:
            img, meta, gt = source.next_batch(rng, device)
            metrics = train_step(img, meta, gt,
                                 step_generator(args.seed, step, device))
            step += 1
            if step % log_interval == 0 or step == 1 or step == max_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m['s_per_iter'] = (time.time() - t0) / (step - start_step)
                logger.log(step, m)
                print(f'step {step}/{max_steps} ({m["s_per_iter"]:.2f}s/it) '
                      + ' '.join(f'{k}={v:.4f}' for k, v in m.items()),
                      flush=True)
            if step % ck_interval == 0:
                ckpt.save(step, model, optimizer, cfg.to_dict())
                if step % eval_interval == 0:
                    run_eval(cfg, mcfg, model, device, args.eval_samples)
        path = ckpt.save(step, model, optimizer, cfg.to_dict())
    finally:
        logger.close()
    print(f'training done: step {step}, checkpoint {path}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
