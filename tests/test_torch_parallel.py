"""Data parallelism of the port (`dfm_tpu_torch/parallel/`) on the CPU:
two gloo processes against one process and against the JAX package.

JAX's CLI trains on the whole global batch sharded over its devices, so
its loss normalisers are global counts and its BatchNorm moments those of
the global batch (`tests/test_parallel.py:77-162`). The port in a group
of two ranks, each on its half of the same global batch of 2, is held to
that:

* `host_shard_indices` equal to JAX's `dfm_tpu.parallel.multihost.
  host_shard_indices` over a grid of sample counts, epochs, process
  counts and drop_last; `local_batch_size` and `broadcast_seed` without a
  group.
* One spawn of 2 ranks (`tests/torch_parallel_worker.py`, CPU, gloo, one
  torch thread each), which writes its results to a temporary directory:
  - a train-mode `BatchNorm` at B = 1 per rank against one process at
    B = 2: the output and the input's gradient (atol 1e-5 + rtol 1e-5),
    the weight and bias gradients summed over the ranks (rtol 1e-5), the
    running buffers bit-equal on the ranks and within 1e-6 of one
    process's;
  - one step of the tiny DfM (tests/test_torch_train_step.py's batch:
    uneven gt per sample, the augmented meta, a sparse depth map with a
    foreground mask) against JAX's `make_train_step` on the
    concatenated batch of 2, and one of the tiny DfMFull
    (`dfm_synth(full=True)`: teacher points and 2D targets) against the
    port's one-process step on the same batch of 2 (which
    tests/test_torch_dfm_full_train.py holds against JAX's
    `make_train_step` on that batch, weights and key), at the whole-step
    tests' tolerances (tests/test_torch_train_step.py,
    tests/test_torch_dfm_full_train.py): every loss term and grad_norm
    rtol 2e-4 (LOSS_RTOL); every gradient, summed over the ranks, by
    relative L2: 1e-4 for the layers after the voxel lifting and
    DfMFull's new heads, 2e-2 for any parameter, 2e-3 for the whole
    vector; the BatchNorm running statistics atol 1e-5 (+ rtol 1e-5 for
    DfMFull: its teacher's first BatchNorm sees raw coordinates); the
    parameters after the update within what their two gradients explain
    of AdamW's first update + 2e-6 (its first step is close to a sign
    function, which turns reduction-order noise in near-zero gradients
    into whole updates); the two ranks' gradients, statistics and
    parameters bit-equal;
  - DfMFull's own normalisers against JAX's losses on the batch of 2
    (tests/test_torch_dfm_full.py's cases, whose samples have different
    counts): the ATSS terms (the positives) and the imitation on the BEV
    and the volume (in-box weights, batch mean), the ranks' terms summed
    rtol 1e-5, each rank's gradient its rows of JAX's;
  - one step of a tiny PGD (ResNet-18, FPN 64, two channels a GroupNorm
    group; `mono_synth`'s batch of 2 at 160x256, whose samples hold
    different numbers of positives) against the
    port's one-process step on the same batch (which
    tests/test_torch_fcos_mono3d.py holds against `jax.value_and_grad` of
    JAX's loss): every loss term and grad_norm rtol 1e-5, each
    parameter's gradient summed over the ranks by relative L2 1e-4, the
    BatchNorm running statistics atol 1e-5; the ranks bit-equal;
  - `multihost_dataset_inference` of a tiny DfM with live weights on a
    3-frame KITTI tree (uneven shards: 2 + 1 frames) equal on both ranks,
    bit for bit, to `dataset_inference` in this process;
  - `allgather_pickled` of objects whose sizes differ by rank.
* The CLIs under torchrun (2 gloo ranks on the CPU, tiny options):
  - `tools.train` on DfMFull `--synthetic` for 2 steps: one config, one
    metrics.jsonl and one checkpoint set (rank 0's); its logged step-1
    terms equal (rtol 1e-5) to one process's at batch_size_per_chip=2;
    an `--auto-resume` to step 3 restores on both ranks (each prints the
    optimizer state's digest, equal to the checkpoint's);
  - `tools.test` on the KITTI tree: rank 0's AP lines equal the
    one-process run's, character for character.

JAX's DfM step compiles in a thread while the spawned processes run,
which keeps the file's wall time near that one compile's.
"""

import json
import os
import re
import socket
import subprocess
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.models import ATSS2DConfig as JATSS
from dfm_tpu.models import BatchMeta as JMeta
from dfm_tpu.models import DfM as JDfM
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models import DfMFull as JDfMFull
from dfm_tpu.models.detectors.dfm import dfm_loss as jax_dfm_loss
from dfm_tpu.models.detectors.imitation import imitation_loss as j_imitation
from dfm_tpu.models.heads import atss2d as JA
from dfm_tpu.parallel.multihost import host_shard_indices as jax_shard
from dfm_tpu.runtime.adapters import _dfm_synth as jax_synth
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.apis import dataset_inference, init_dfm_model
from dfm_tpu_torch.data.kitti import KittiDataset, build_kitti_infos
from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
from dfm_tpu_torch.models.builder import mono_model
from dfm_tpu_torch.models.detectors.fcos_mono3d import mono_level_points
from dfm_tpu_torch.models.heads.fcos_mono3d import assign
from dfm_tpu_torch.models.layers import BatchNorm
from dfm_tpu_torch.parallel import dist as D
from dfm_tpu_torch.parallel import multihost as M
from dfm_tpu_torch.runtime.adapters import (dfm_synth, mono_synth,
                                            mono_to_device)
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.weights import init_weights

from test_torch_dfm import TINY as DFM_TINY, H, W_, _augmented_meta_b2
from test_torch_dfm_full import ATSS, _atss_gt
from test_torch_dfm_full import IMG_HW as ATSS_HW
from test_torch_dfm_full_train import (FAST_COMPILE, STATS_RTOL,
                                       TINY as FULL_TINY, TINY_OPTS, _atss)
from test_torch_dfm_full_train import LIFTED as FULL_LIFTED
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL,
                                   GRAD_REL_L2_LIFTED, LOSS_RTOL, LR,
                                   PARAM_ATOL, STATS_ATOL, RecordGrads,
                                   depth_maps, gt_on_anchors,
                                   random_variables)
from test_torch_train_step import LIFTED as DFM_LIFTED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic KITTI tree, live weights)
from torch_parallel_worker import step as worker_step  # noqa: E402

CONFIG = os.path.join(ROOT, 'configs', 'dfm_r34_kitti_3class.py')
WORKER = os.path.join(ROOT, 'tests', 'torch_parallel_worker.py')
B = 2
BN_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_KINDS = ('DfM', 'DfMFull')
ATSS_KEYS = ('cls_score', 'bbox_pred', 'centerness')
NORM_TERMS = ('loss_cls2d', 'loss_bbox2d', 'loss_centerness2d',
              'imitation_bev', 'imitation_volume')
EVAL_OPTS = ['model.depth_num_bins=48', 'model.voxel_size=(3.6,3.8,0.5)',
             'model.nms_pre=128', 'model.max_num=8',
             'data.crop_size=(128,256)']
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1',
           MKL_NUM_THREADS='1')


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def torchrun(n, *args):
    return [sys.executable, '-m', 'torch.distributed.run',
            f'--nproc_per_node={n}', '--master_addr=127.0.0.1',
            f'--master_port={free_port()}', *args]


def run(cmd, timeout=300):
    return subprocess.run(cmd, cwd=ROOT, env=ENV, capture_output=True,
                          text=True, timeout=timeout)


def run_workers(d):
    """The worker group: two processes with torchrun's variables."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, WORKER, d], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(
            ENV, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE='2',
            LOCAL_WORLD_SIZE='2', MASTER_ADDR='127.0.0.1', MASTER_PORT=port))
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _fine_f32():
    orig = JFS.build_fine_softmax_volume

    def fine_f32(*a, **kw):
        kw['dtype'] = jnp.float32
        return orig(*a, **kw)

    return mock.patch.object(JFS, 'build_fine_softmax_volume', fine_f32)


def _jax_step(model, loss, variables, batch, key):
    tx = optax.chain(RecordGrads.make(), jax_make_optimizer(
        jax_schedule(**LR)))
    state = create_train_state(variables, tx)
    step = make_train_step(model, loss, donate=False)
    with _fine_f32():
        new_state, metrics = step.lower(state, batch, key).compile(
            compiler_options=FAST_COMPILE)(state, batch, key)
    return new_state, {k: float(v) for k, v in metrics.items()}


def dfm_case():
    """tests/test_torch_train_step.py's batch and weights: (the worker's
    inputs, a closure giving JAX's step)."""
    cfg = JConfig(**DFM_TINY)
    img = np.random.RandomState(5).randn(B, 2, H, W_, 3).astype(np.float32)
    m = _augmented_meta_b2()
    jmeta = JMeta(**{k: jnp.asarray(v) for k, v in m.items()})
    model = JDfM(cfg=cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(img), jmeta, train=False))
    variables = random_variables(shapes, 1)
    boxes, labels, mask = gt_on_anchors(cfg, 16, 16)
    depth, fg = depth_maps(6)
    key = jax.random.PRNGKey(3)
    valid = ((depth > cfg.depth_min) & (depth < cfg.depth_max)).reshape(B, -1)
    keys = jax.random.split(key, B)
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], H * W_, (cfg.num_depth_sample_pixels,), replace=True,
        p=jnp.asarray(valid[i] / valid[i].sum(), jnp.float32)))
        for i in range(B)])
    inputs = dict(cfg=DFM_TINY, lr=LR, sd=W.state_dict_from_jax(variables),
                  pix=pix, batch=dict(img=img, meta=m, gt_boxes=boxes,
                                      gt_labels=labels, gt_mask=mask,
                                      depth_img=depth, depth_fgmask_img=fg))

    def reference():
        batch = dict(img=jnp.asarray(img), meta=jmeta,
                     gt_boxes=jnp.asarray(boxes),
                     gt_labels=jnp.asarray(labels),
                     gt_mask=jnp.asarray(mask), depth_img=jnp.asarray(depth),
                     depth_fgmask_img=jnp.asarray(fg))
        new_state, metrics = _jax_step(
            model, lambda o, b, r: jax_dfm_loss(o, b, cfg, r), variables,
            batch, key)
        return _jax_result(variables, new_state, metrics)

    return inputs, reference


def full_case():
    """tests/test_torch_dfm_full_train.py's batch and weights, the
    reference the port's one-process step on them (that file holds that
    step against JAX's `make_train_step` on the same batch, weights and
    key)."""
    cfg = JConfig(**FULL_TINY)
    acfg = JATSS(**vars(_atss()))
    batch = jax_synth(type('Handle', (), {'cfg': cfg}), B, 7, h=64, w=128,
                      full=True)
    model = JDfMFull(cfg=cfg, atss_cfg=acfg)
    args = (batch['img'], batch['meta'], batch['points'],
            batch['point_mask'])
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               train=False))
    variables = random_variables(shapes, 1)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    n = 64 * 128
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], n, (cfg.num_depth_sample_pixels,), replace=True,
        p=jnp.full((n,), 1.0 / n, jnp.float32))) for i in range(B)])
    key_map = W.dfm_full_key_map(stacked_convs=acfg.stacked_convs)
    inputs = dict(cfg=FULL_TINY, lr=LR, config=CONFIG, pix=pix,
                  sd=W.state_dict_from_jax(variables, key_map),
                  batch=dfm_synth(DfMConfig(**FULL_TINY), B, 7, h=64, w=128,
                                  full=True))

    def reference():
        one = worker_step('DfMFull', inputs)
        return dict(metrics=dict(one['metrics'], grad_norm=one['grad_norm']),
                    grads=one['grads'], after=one['after'])

    return inputs, reference


def norms_case():
    """DfMFull's own normalisers: tests/test_torch_dfm_full.py's
    `atss2d_loss` case (uneven positives: 3 gt boxes in sample 0, 2 in
    sample 1) and its `imitation_loss` case on the BEV and the volume
    (uneven in-box weights), each on the batch of 2: (the worker's
    inputs, a closure giving JAX's values and gradients on the whole
    batch)."""
    rng = np.random.RandomState(5)
    h, w = ATSS_HW
    outs = [dict(cls_score=rng.randn(B, hh, ww, 3).astype(np.float32) - 2,
                 bbox_pred=rng.randn(B, hh, ww, 4).astype(np.float32) * 0.5,
                 centerness=rng.randn(B, hh, ww, 1).astype(np.float32))
            for hh, ww in [((h + s - 1) // s, (w + s - 1) // s)
                           for s in (4, 8, 16, 32, 64)]]
    gt = _atss_gt()
    rng = np.random.RandomState(11)
    ny, nx, c = 12, 10, 8
    xs, ys = np.linspace(0, 18, nx), np.linspace(-10, 10, ny)
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    im = dict(centers=np.stack([xx, yy], -1).reshape(-1, 2).astype(
        np.float32), boxes=np.array(
            [[[6, 0, -1, 8, 5, 1.5, 0.4], [14, -5, -1, 4, 3, 1.5, -1.1]],
             [[9, 3, -1, 10, 6, 1.5, 2.0], [3, 3, -1, 1, 1, 1, 0]]],
            np.float32), gmask=np.array([[True, True], [True, False]]))
    for kind, shape in (('bev', (B, ny, nx, c)), ('volume', (B, 3, ny, nx,
                                                              c))):
        student = rng.randn(*shape).astype(np.float32)
        teacher = np.maximum(rng.randn(*shape), 0).astype(np.float32)
        teacher[..., 2:5, :] = 0.0         # cells without support
        im[kind] = dict(student=student, teacher=teacher)

    def reference():
        acfg = JA.ATSS2DConfig(**ATSS)
        jgt = {k: jnp.asarray(v) for k, v in gt.items()}

        def jloss(o):
            return JA.atss2d_loss(o, ATSS_HW, jgt, acfg)

        got = jax.jit(lambda o: {k: (v, jax.grad(
            lambda o, k=k: jloss(o)[k])(o)) for k, v in jloss(o).items()})(
                outs)
        want = {k: (float(v), [np.asarray(lv[c]) for lv in g
                               for c in ATSS_KEYS])
                for k, (v, g) in got.items()}
        for kind in ('bev', 'volume'):
            v, g = jax.jit(jax.value_and_grad(lambda s: j_imitation(
                s, jnp.asarray(im[kind]['teacher']),
                jnp.asarray(im['centers']), jnp.asarray(im['boxes']),
                jnp.asarray(im['gmask']), normalizer_clamp_value=2.0)))(
                    im[kind]['student'])
            want[f'imitation_{kind}'] = (float(v), [np.asarray(g)])
        return want

    return dict(atss=dict(outs=outs, gt=gt, img_hw=ATSS_HW, cfg=ATSS,
                          keys=ATSS_KEYS), imitation=im), reference


PGD_TINY = dict(backbone_depth=18, in_channels=64, feat_channels=64,
                depth_branch=(16,))
PGD_TERMS = ['loss', 'loss_cls', 'loss_offset', 'loss_depth', 'loss_size',
             'loss_rotsin', 'loss_dir', 'loss_centerness',
             'loss_depth_uncertain', 'loss_bbox2d', 'loss_kpts',
             'loss_consistency']
PGD_RTOL = 1e-5
PGD_GRAD_REL_L2 = 1e-4


def pgd_case():
    """A tiny PGD's seeded weights and `mono_synth`'s batch of 2; the
    reference is the port's one-process step on it."""
    model = init_weights(mono_model(dict(type='PGD', **PGD_TINY)), 4)
    inputs = dict(cfg=PGD_TINY, lr=LR, sd=model.state_dict(),
                  batch=mono_synth(B, 7, h=160, w=256, kpts=True))

    def reference():
        one = worker_step('PGD', inputs)
        return dict(metrics=dict(one['metrics'], grad_norm=one['grad_norm']),
                    grads=one['grads'], stats=one['stats'])

    return inputs, reference


def _jax_result(variables, new_state, metrics):
    return dict(
        metrics=metrics,
        grads=W.state_dict_from_jax({'params': jax.device_get(
            new_state.opt_state[0]), 'batch_stats': variables[
                'batch_stats']}),
        after=W.state_dict_from_jax(jax.device_get(
            {'params': new_state.params,
             'batch_stats': new_state.batch_stats})))


def train_jobs(d, out):
    """tools.train under torchrun, in one process, and the resume under
    torchrun, one after another."""
    train = ['-m', 'dfm_tpu_torch.tools.train', CONFIG, '--synthetic',
             '--device', 'cpu', '--max-steps', '2']
    w2 = os.path.join(d, 'w2')
    out['train2'] = run(torchrun(2, *train, '--work-dir', w2,
                                 '--cfg-options', *TINY_OPTS))
    out['listing'] = (sorted(os.listdir(w2)),
                      sorted(os.listdir(os.path.join(w2, 'ckpts'))))
    out['resume'] = run(torchrun(2, *train[:-1], '3', '--auto-resume',
                                 '--work-dir', w2, '--cfg-options',
                                 *TINY_OPTS))
    out['train1'] = run([sys.executable, *train, '--work-dir',
                         os.path.join(d, 'w1'), '--cfg-options', *TINY_OPTS,
                         'data.batch_size_per_chip=2'])


def eval_jobs(d, root, out):
    """create_data, then tools.test on the tree under torchrun and in one
    process (a checkpoint with live weights)."""
    out['create'] = run([sys.executable, '-m',
                         'dfm_tpu_torch.tools.create_data', 'kitti',
                         '--root', root, '--splits', 'val'])
    test = ['-m', 'dfm_tpu_torch.tools.test', CONFIG, '--device', 'cpu',
            '--dtype', 'float32', '--checkpoint',
            os.path.join(d, 'live.pth'), '--cfg-options',
            f'data.data_root={root}', *EVAL_OPTS]
    out['test2'] = run(torchrun(2, *test))
    out['test1'] = run([sys.executable, *test])


@pytest.fixture(scope='module')
def spawned(tmp_path_factory):
    """Everything the file compares: the inputs, the spawned runs' results
    and the references of this process (JAX's DfM step and DfMFull's
    losses, one process's BatchNorm, DfMFull step and
    dataset_inference)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # small ops; the suite's workers share cores
    d = str(tmp_path_factory.mktemp('group'))
    rng = np.random.RandomState(0)
    c = 6
    bn = dict(x=(rng.randn(B, c, 5, 7) * 3 + 1).astype(np.float32),
              gout=rng.randn(B, c, 5, 7).astype(np.float32),
              sd={'weight': torch.from_numpy(1 + 0.3 * rng.randn(c)).float(),
                  'bias': torch.from_numpy(0.3 * rng.randn(c)).float(),
                  'running_mean': torch.zeros(c),
                  'running_var': torch.ones(c)})
    cases = dict(DfM=dfm_case(), DfMFull=full_case(), norms=norms_case(),
                 PGD=pgd_case())
    root = os.path.join(d, 'kitti')
    ids = chip_smoke.write_kitti_tree(root, frames=chip_smoke.KITTI_FRAMES[:3])
    infos = build_kitti_infos(root, ids)
    live = chip_smoke._live_weights(init_weights(DfM(DfMConfig(**DFM_TINY))),
                                    4, 2.0)
    torch.save(live.state_dict(), os.path.join(d, 'live.pth'))
    infer = dict(cfg=DFM_TINY, sd=live.state_dict(), root=root, infos=infos,
                 crop=(128, 256))
    torch.save(dict(bn=bn, infer=infer,
                    **{k: v[0] for k, v in cases.items()}),
               os.path.join(d, 'inputs.pt'))
    res, ref, errors, cli = {}, {}, {}, {}

    def jobs(name, *fns):
        try:
            for fn in fns:
                fn()
        except Exception as e:            # raised again below
            errors[name] = e

    # the spawned runs and JAX's DfM step at once (XLA's compile releases
    # the GIL); this process's references meanwhile
    threads_ = [threading.Thread(target=jobs, args=(
        'workers', lambda: res.update(workers=run_workers(d)),
        lambda: eval_jobs(d, root, cli))), threading.Thread(
            target=jobs, args=('train', lambda: train_jobs(d, cli))),
        threading.Thread(target=jobs, args=(
            'DfM', lambda: ref.update(DfM=cases['DfM'][1]())))]
    for t in threads_:
        t.start()
    try:
        for kind in ('DfMFull', 'norms', 'PGD'):
            ref[kind] = cases[kind][1]()
        ref['bn_x'], ref['bn_sd0'] = bn['x'], dict(bn['sd'])
        one = BatchNorm(c).train()
        one.load_state_dict(bn['sd'])
        x = torch.from_numpy(bn['x']).requires_grad_(True)
        y = one(x)
        y.backward(torch.from_numpy(bn['gout']))
        ref['bn'] = dict(y=y.detach(), gx=x.grad, gw=one.weight.grad,
                         gb=one.bias.grad, sd=one.state_dict())
        handle = init_dfm_model(DfMConfig(**DFM_TINY), torch.float32, 'cpu')
        handle['model'].load_state_dict(infer['sd'])
        ref['infer'] = dataset_inference(handle, KittiDataset(
            root, infos, train=False, pipeline_kwargs=dict(
                crop_size=(128, 256), max_gt=32)))
    finally:
        for t in threads_:
            t.join()
        torch.set_num_threads(threads)
    for k in ('workers', 'train', 'DfM'):
        if k in errors:
            raise errors[k]
    for rc, out, err in res['workers']:
        assert rc == 0, err[-3000:]
    ranks = [torch.load(os.path.join(d, f'rank{r}.pt'), weights_only=False)
             for r in range(2)]
    return dict(d=d, inputs=cases, ref=ref, ranks=ranks, cli=cli)


def test_group_of_two_gloo_ranks(spawned):
    for r, out in enumerate(spawned['ranks']):
        assert (out['rank'], out['world'], out['backend']) == (r, 2, 'gloo')


def test_batchnorm_moments_over_the_group(spawned):
    want = spawned['ref']['bn']
    r0, r1 = (o['bn'] for o in spawned['ranks'])
    for k in ('y', 'gx'):
        np.testing.assert_allclose(torch.cat([r0[k], r1[k]]).numpy(),
                                   want[k].numpy(), err_msg=k, **BN_TOL)
    for k in ('gw', 'gb'):
        assert torch.equal(r0[k], r1[k]), k
        np.testing.assert_allclose(r0[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k in ('running_mean', 'running_var'):
        assert torch.equal(r0['sd'][k], r1['sd'][k]), k
        np.testing.assert_allclose(r0['sd'][k].numpy(),
                                   want['sd'][k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    # the group's moments are not the rank's own
    own = BatchNorm(6).train()
    own.load_state_dict(spawned['ref']['bn_sd0'])
    alone = own(torch.from_numpy(spawned['ref']['bn_x'][:1])).detach()
    assert not torch.allclose(alone, r0['y'], atol=1e-3)


DFM_TERMS = ['loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
             'loss_dense_depth']
FULL_TERMS = DFM_TERMS + ['loss_cls2d', 'loss_bbox2d', 'loss_centerness2d',
                          'loss_imitation']


@pytest.mark.parametrize('kind,term', [('DfM', t) for t in DFM_TERMS] +
                         [('DfMFull', t) for t in FULL_TERMS] +
                         [(k, 'grad_norm') for k in STEP_KINDS])
def test_step_loss_terms_match_jax(spawned, kind, term):
    r0, r1 = (o[kind] for o in spawned['ranks'])
    get = (lambda o: o['grad_norm']) if term == 'grad_norm' else \
        (lambda o: o['metrics'][term])
    assert get(r0) == get(r1), term
    want = spawned['ref'][kind]['metrics'][term]
    if term in ('loss_bbox', 'loss_dir', 'loss_iou', 'loss_cls2d',
                'loss_imitation'):
        assert want > 0, f'{term}: the batch does not reach it'
    np.testing.assert_allclose(get(r0), want, rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize('kind', STEP_KINDS)
def test_step_gradients_match_jax(spawned, kind):
    r0, r1 = (o[kind] for o in spawned['ranks'])
    ref = spawned['ref'][kind]['grads']
    lifted = DFM_LIFTED if kind == 'DfM' else FULL_LIFTED
    rel, flat_g, flat_w = {}, [], []
    for name, g in r0['grads'].items():
        assert torch.equal(g, r1['grads'][name]), name
        want = ref[name].numpy()
        if name.startswith('lidar_teacher.'):
            assert not g.any() and not want.any(), name
            continue
        g = g.numpy()
        assert np.isfinite(g).all(), name
        rel[name] = np.linalg.norm(g - want) / max(np.linalg.norm(want),
                                                   1e-30)
        flat_g.append(g.ravel())
        flat_w.append(want.ravel())
    bad = {k: v for k, v in rel.items() if v > (
        GRAD_REL_L2_LIFTED if k.startswith(lifted) else GRAD_REL_L2)}
    assert not bad, f'gradients off (relative L2): {bad}'
    flat_g, flat_w = np.concatenate(flat_g), np.concatenate(flat_w)
    assert np.linalg.norm(flat_g - flat_w) <= \
        GRAD_REL_L2_ALL * np.linalg.norm(flat_w)
    # one flat float32 bucket of every parameter's gradient
    assert r0['reduce_bytes'] == 4 * sum(g.numel()
                                         for g in r0['grads'].values())


@pytest.mark.parametrize('kind', STEP_KINDS)
def test_step_batch_stats_and_parameters_match_jax(spawned, kind):
    """The running statistics after the forward against JAX's new
    batch_stats; the parameters after the update as the whole-step
    tests hold them (what the two gradients explain of the first AdamW
    update + PARAM_ATOL, sign flips at most 1e-3 of the elements); both
    ranks bit-equal."""
    r0, r1 = (o[kind] for o in spawned['ranks'])
    ref = spawned['ref'][kind]
    sd = spawned['inputs'][kind][0]['sd']
    stats_rtol = STATS_RTOL if kind == 'DfMFull' else 0.0
    for name, t in r0['stats'].items():
        assert torch.equal(t, r1['stats'][name]), name
        want = ref['after'][name].numpy()
        np.testing.assert_allclose(t.numpy(), want, rtol=stats_rtol,
                                   atol=STATS_ATOL, err_msg=name)
    assert any(n.endswith('running_var') and not torch.allclose(
        t, sd[n]) for n, t in r0['stats'].items())
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / r0['grad_norm'])
    clip_jax = min(1.0, 35.0 / ref['metrics']['grad_norm'])
    flips = total = 0
    for name, t in r0['after'].items():
        assert torch.equal(t, r1['after'][name]), name
        if name.endswith(('running_mean', 'running_var')):
            continue
        want = ref['after'][name].numpy()
        if name.startswith('lidar_teacher.'):
            assert torch.equal(t, sd[name]), name
            continue
        g = r0['grads'][name].numpy().astype(np.float64) * clip
        gw = ref['grads'][name].numpy().astype(np.float64) * clip_jax
        flip = np.sign(g) != np.sign(gw)
        flips += int(flip.sum())
        total += flip.size
        atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                            gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        err = np.abs(t.numpy() - want)
        assert (err <= atol).all(), (name, float(err.max()))
    assert flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize('term', PGD_TERMS + ['grad_norm'])
def test_pgd_step_loss_terms_match_one_process(spawned, term):
    r0, r1 = (o['PGD'] for o in spawned['ranks'])
    get = (lambda o: o['grad_norm']) if term == 'grad_norm' else \
        (lambda o: o['metrics'][term])
    assert get(r0) == get(r1), term
    want = spawned['ref']['PGD']['metrics'][term]
    assert want > 0, term
    np.testing.assert_allclose(get(r0), want, rtol=PGD_RTOL, err_msg=term)


def test_pgd_step_gradients_and_stats_match_one_process(spawned):
    """The gradients summed over the ranks and the running statistics
    against one process's; the samples' positives differ, so a rank's own
    count as the normaliser would miss."""
    batch = spawned['inputs']['PGD'][0]['batch']
    _, _, gt = mono_to_device(batch, 'cpu')
    cfg = mono_model(dict(type='PGD', **PGD_TINY)).cfg
    pos = assign(mono_level_points(batch['img'].shape[1:3], cfg), cfg,
                 gt)[2][3]
    assert pos[0].sum() != pos[1].sum() and pos.sum() > 0
    r0, r1 = (o['PGD'] for o in spawned['ranks'])
    ref = spawned['ref']['PGD']
    bad = {}
    for name, g in r0['grads'].items():
        assert torch.equal(g, r1['grads'][name]), name
        want = ref['grads'][name].double()
        rel = float((g.double() - want).norm() / want.norm().clamp(
            min=1e-30))
        if rel > PGD_GRAD_REL_L2:
            bad[name] = rel
    assert not bad, bad
    for name, t in r0['stats'].items():
        assert torch.equal(t, r1['stats'][name]), name
        np.testing.assert_allclose(t.numpy(), ref['stats'][name].numpy(),
                                   rtol=0, atol=STATS_ATOL, err_msg=name)


@pytest.mark.parametrize('term', NORM_TERMS)
def test_dfm_full_normalisers_match_jax(spawned, term):
    """DfMFull's own normalisers over the group (the ATSS positives, the
    imitation's in-box weights and batch mean): the ranks' terms summed
    equal JAX's on the batch of 2 (rtol 1e-5), and each rank's gradient
    is its rows of JAX's (atol 1e-7 + rtol 1e-4 for ATSS, 1e-9 + 1e-4 for
    the imitation: tests/test_torch_dfm_full.py's tolerances). The
    samples' counts differ, so a rank's own normaliser would miss."""
    want, want_grads = spawned['ref']['norms'][term]
    assert want > 0
    atol = 1e-9 if term.startswith('imitation') else 1e-7
    for r, out in enumerate(spawned['ranks']):
        got, grads = out['norms'][term]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert len(grads) == len(want_grads)
        assert any(np.abs(w[r:r + 1]).max() > 0 for w in want_grads)
        for g, w in zip(grads, want_grads):
            w = w[r:r + 1]
            g = np.zeros_like(w) if g is None else g.numpy()
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4)


def test_multihost_dataset_inference_equals_one_process(spawned):
    want = spawned['ref']['infer']
    assert len(want) == 3 and sum(len(a['name']) for a in want) > 0
    for out in spawned['ranks']:
        got = out['infer']
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_allgather_pickled_uneven(spawned):
    for out in spawned['ranks']:
        got = out['gather']
        assert [g['rank'] for g in got] == [0, 1]
        assert [g['items'] for g in got] == [[0], [0, 1, 2, 3]]
        for r, g in enumerate(got):
            np.testing.assert_array_equal(
                g['array'], np.arange(5 + 1000 * r, dtype=np.float32))


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_two_ranks(spawned):
    """DfMFull --synthetic under torchrun: rank 0 alone writes; step 1 is
    one process's at the same global batch; a resume restores on both
    ranks."""
    cli, d = spawned['cli'], spawned['d']
    for k in ('train2', 'train1'):
        assert cli[k].returncode == 0, cli[k].stderr[-3000:]
    w2 = os.path.join(d, 'w2')
    assert cli['listing'] == (['ckpts', 'config.json', 'metrics.jsonl'],
                              ['step_2.pth'])
    assert 'rank 0 of 2 (gloo)' in cli['train2'].stdout
    got = _metrics(os.path.join(w2, 'metrics.jsonl'))
    want = _metrics(os.path.join(d, 'w1', 'metrics.jsonl'))
    assert [r['step'] for r in got] == [1, 2, 3]      # 3: the resume
    for k in FULL_TERMS + ['grad_norm']:
        np.testing.assert_allclose(got[0][f'train/{k}'],
                                   want[0][f'train/{k}'], rtol=1e-5,
                                   err_msg=k)
    res = cli['resume']
    assert res.returncode == 0, res.stderr[-3000:]
    from dfm_tpu_torch.tools.train import optimizer_digest
    digest = optimizer_digest(torch.load(
        os.path.join(w2, 'ckpts', 'step_2.pth'), map_location='cpu',
        weights_only=True)['optimizer'])
    lines = re.findall(r'^(\[rank 1\] )?resumed from step 2 \(optimizer '
                       r'state sha1 (\w+)\)$', res.stdout, re.M)
    assert sorted(lines) == [('', digest), ('[rank 1] ', digest)], \
        res.stdout[-2000:]
    assert sorted(os.listdir(os.path.join(w2, 'ckpts'))) == [
        'step_2.pth', 'step_3.pth']


def test_kitti_eval_cli_two_ranks_equals_one(spawned):
    cli = spawned['cli']
    for k in ('create', 'test2', 'test1'):
        assert cli[k].returncode == 0, (k, cli[k].stderr[-3000:])
    lines = [re.findall(r'^\w+_\w+: \S+$', cli[k].stdout, re.M)
             for k in ('test2', 'test1')]
    assert len(lines[1]) == 36 and lines[0] == lines[1]
    frames = re.findall(r'^\[(\d)/3\] dets=(\d+)$', cli['test2'].stdout,
                        re.M)
    assert sorted(frames) == sorted(re.findall(
        r'^\[(\d)/3\] dets=(\d+)$', cli['test1'].stdout, re.M))


@pytest.mark.parametrize('pc', [1, 2, 3, 8])
@pytest.mark.parametrize('drop_last', [True, False])
def test_host_shard_indices_match_jax(pc, drop_last):
    for n in (1, 7, 16, 101):
        for epoch in (0, 3):
            for pi in range(pc):
                got = M.host_shard_indices(n, epoch, seed=5,
                                           drop_last=drop_last,
                                           process_index=pi,
                                           process_count=pc)
                want = jax_shard(n, epoch, seed=5, drop_last=drop_last,
                                 process_index=pi, process_count=pc)
                np.testing.assert_array_equal(got, want)


def test_without_a_group_everything_is_one_process():
    assert not D.is_active()
    assert (D.rank(), D.world_size(), D.is_main(), D.backend()) == \
        (0, 1, True, None)
    x = torch.arange(6.0).reshape(3, 2)
    assert D.shard_batch((x, dict(a=x))) == (x, dict(a=x))
    assert D.global_sum(x) is x and D.sum_over_group(x) is x
    assert D.all_reduce_grads([torch.nn.Parameter(x)]) == 0
    assert M.broadcast_seed(17) == 17
    assert M.local_batch_size(4) == 4
    assert M.local_batch_size(8, process_count=4) == 2
    assert M.host_shard_indices(10, 0).tolist() == \
        np.random.RandomState(0).permutation(10).tolist()
    with mock.patch.dict(os.environ, {}, clear=False):
        os.environ.pop('RANK', None)
        assert D.init_from_env('cpu') == torch.device('cpu')
    assert not D.is_active()
    assert D.backend_for(torch.device('cpu'), 1) == 'gloo'
    with mock.patch.object(torch.cuda, 'device_count', return_value=1):
        assert D.backend_for(torch.device('cuda', 0), 1) == 'nccl'
        assert D.backend_for(torch.device('cuda', 0), 2) == 'gloo'
