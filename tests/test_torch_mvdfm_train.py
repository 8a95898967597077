"""MultiViewDfM training with the port against the JAX package, on the CPU,
in one process and data-parallel in two.

* `mv_synth` equal to JAX's `_mv_synth` for two seeds, bit for bit.
* `mvdfm_loss` (the camsync branch: the anchor head's loss without the
  IoU term, weights 1.0 / 2.0 / 0.2) equal to JAX's `mvdfm_loss` on the
  same head outputs and gt at a tiny MultiViewDfM (rtol 1e-5: the same
  float32 sums in another order); a depth cost without a depth map adds
  no term, and 'task_outs' take the CenterHead's branch
  (tests/test_torch_center_head.py and test_torch_mvdfm_temporal.py hold
  those branches to JAX's).
* One whole train step of that tiny model (ResNet-18, FPN width 16, two
  views of 64x96, a (4, 16, 16) grid over +-8 m, `mv_synth`'s batch of 2
  with positives of every term) against JAX's `make_train_step` with
  `mvdfm_loss` on the same batch, seeded flax variables carried over by
  `utils/weights.py:mvdfm_key_map`: in this process at B = 2, and in a
  group of 2 gloo processes at B = 1 each (tests/torch_parallel_worker.py;
  gradients summed over the ranks, BatchNorm moments over the group).
  The whole-step tests' tolerances (tests/test_torch_train_step.py):
  every loss term and grad_norm rtol 2e-4; every gradient by relative
  L2, 1e-4 for the head and the 3D neck (after the view sample), 2e-2 for
  any parameter, 2e-3 for the whole vector; every BatchNorm running
  statistic atol 1e-5; the parameters after the update within what their
  two gradients explain of AdamW's first update + 2e-6; the two ranks
  bit-equal. The step's images are 64x96: at `_mv_synth`'s default
  32x48 the float32 gradients are too ill-conditioned to compare at these
  tolerances (the port's own whole gradient moves by 2.5e-3 relative L2,
  the 3D neck's by 4.8e-3, under one ulp of relative noise on the weights;
  at 64x96 by 4.2e-6 and 8.4e-6, measured on the CPU).
* The train CLI under torchrun (2 gloo ranks, `--synthetic`, the camsync
  config cut to the tiny widths): 2 steps, one checkpoint set in the
  port's layout (the keys `mvdfm_key_map` gives a JAX tree), a resume to
  step 3 on both ranks, and `tools.test` on its checkpoint; `tools.test`
  on a synthetic Waymo tree with a live checkpoint under 2 ranks prints
  the one-process run's LET lines, character for character.
"""

import dataclasses
import os
import re
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfm_tpu.models import MultiViewDfM as JMultiViewDfM
from dfm_tpu.models import MVDfMConfig as JMVDfMConfig
from dfm_tpu.models.detectors.multiview_dfm import mvdfm_loss as jax_loss
from dfm_tpu.runtime.adapters import _mv_synth as jax_mv_synth
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.models.detectors.multiview_dfm import (MultiViewDfM,
                                                          MVDfMConfig,
                                                          mvdfm_loss)
from dfm_tpu_torch.runtime.adapters import mv_synth, mv_to_device
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.utils import weights as W

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_parallel import run, run_workers, torchrun
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL,
                                   GRAD_REL_L2_LIFTED, LOSS_RTOL, LR,
                                   PARAM_ATOL, STATS_ATOL, RecordGrads,
                                   random_variables)

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic Waymo tree)

CONFIG = os.path.join(ROOT, 'configs', 'multiview_dfm_r101_waymo_camsync.py')
B, HW = 2, (64, 96)
TINY = dict(num_views=2, num_frames=1, feat_channels=16,
            voxel_range=(-8, -8, -1, 8, 8, 3), voxel_grid=(4, 16, 16),
            anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3, backbone_depth=18,
            nms_pre=128, max_num=8)
LIFTED = ('neck_3d.', 'bbox_head_3d.')
TERMS = ['loss', 'loss_cls', 'loss_bbox', 'loss_dir']
# the camsync config at the tiny widths (tests/test_torch_waymo.py's)
CLI_OPTS = ['model.backbone_depth=18', 'model.feat_channels=16',
            'model.voxel_grid=(4,24,30)', 'model.max_num=20']


def _handle(cfg):
    return type('Handle', (), {'cfg': cfg, 'type': 'MultiViewDfM'})


@pytest.mark.parametrize('seed', [0, 3])
def test_mv_synth_matches_jax(seed):
    want = jax_mv_synth(_handle(JMVDfMConfig(**TINY)), B, seed)
    got = mv_synth(MVDfMConfig(**TINY), B, seed)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
        assert v.dtype == np.asarray(want[k]).dtype, k


def test_mvdfm_loss_matches_jax():
    cfg, jcfg = MVDfMConfig(**TINY), JMVDfMConfig(**TINY)
    batch = mv_synth(cfg, B, 3)
    rng = np.random.RandomState(2)
    ny, nx = TINY['voxel_grid'][1:]
    outs = {k: (rng.randn(B, ny, nx, 6 * n) * s).astype(np.float32)
            for k, n, s in (('cls_score', 3, 2.0), ('bbox_pred', 7, 0.5),
                            ('dir_pred', 2, 1.0))}
    total, want = jax_loss({k: jnp.asarray(v) for k, v in outs.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jcfg)
    _, _, gt = mv_to_device(batch, 'cpu')
    got_total, got = mvdfm_loss({k: torch.from_numpy(v)
                                 for k, v in outs.items()}, gt, cfg)
    assert sorted(got) == sorted(want) == sorted(TERMS[1:])
    for k in TERMS[1:]:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-5)
    # a depth cost without a depth map or a pixel draw adds no term (JAX's
    # branch needs both); 'task_outs' take the CenterHead's branch
    _, again = mvdfm_loss(dict({k: torch.from_numpy(v) for k, v in
                                outs.items()}, depth_cost=None), gt, cfg)
    assert {k: float(v) for k, v in again.items()} == {
        k: float(v) for k, v in got.items()}
    ny, nx = TINY['voxel_grid'][1:]
    task = {k: torch.zeros(B, ny, nx, c)
            for k, c in (('reg', 2), ('height', 1), ('dim', 3), ('rot', 2))}
    _, center = mvdfm_loss(dict(task_outs=[
        dict(task, heatmap=torch.zeros(B, ny, nx, len(t)))
        for t in cfg.center_tasks]), gt, cfg)
    assert sorted(center) == ['task0_loss_bbox', 'task0_loss_heatmap',
                              'task1_loss_bbox', 'task1_loss_heatmap']


def _mv_case():
    jcfg = JMVDfMConfig(**TINY)
    batch = jax_mv_synth(_handle(jcfg), B, 3, *HW)
    model = JMultiViewDfM(cfg=jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch['img'], batch['lidar2img'], HW,
        train=False))
    variables = random_variables(shapes, 1)
    key_map = W.mvdfm_key_map(TINY['backbone_depth'])
    inputs = dict(cfg=TINY, lr=LR, batch=mv_synth(MVDfMConfig(**TINY), B, 3,
                                                  *HW),
                  sd=W.state_dict_from_jax(variables, key_map))

    def reference():
        tx = optax.chain(RecordGrads.make(),
                         jax_make_optimizer(jax_schedule(**LR)))
        state = create_train_state(variables, tx)
        key = jax.random.PRNGKey(3)
        step = make_train_step(
            model, lambda o, b, r: jax_loss(o, b, jcfg, r), donate=False,
            model_args_fn=lambda b: (b['img'], b['lidar2img'], HW))
        new_state, metrics = step.lower(state, batch, key).compile(
            compiler_options=FAST_COMPILE)(state, batch, key)
        return dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=W.state_dict_from_jax({'params': jax.device_get(
                new_state.opt_state[0]), 'batch_stats': variables[
                    'batch_stats']}, key_map),
            after=W.state_dict_from_jax(jax.device_get(
                {'params': new_state.params,
                 'batch_stats': new_state.batch_stats}), key_map))

    return inputs, reference


def _port_step(inputs):
    """The step in this process at B = 2, as the worker runs it."""
    model = MultiViewDfM(MVDfMConfig(**inputs['cfg']))
    model.load_state_dict(inputs['sd'], strict=True)
    step = TrainStep(model, make_optimizer(model), liga_schedule(**LR))
    imgs, l2i, gt = mv_to_device(inputs['batch'], 'cpu')
    with torch.backends.mkldnn.flags(enabled=False):
        total, losses = step.forward(imgs, l2i, gt)
        step.backward(total)
    step.reduce()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    norm = step.update()
    return dict(metrics=dict(loss=float(total.detach()), **{
        k: float(v) for k, v in losses.items()}), grad_norm=float(norm),
        grads=grads, stats=stats, after=model.state_dict())


def _train_jobs(d, out):
    """The train CLI under torchrun (2 steps, a resume to 3), then
    tools.test on its checkpoint."""
    w = os.path.join(d, 'w')
    train = ['-m', 'dfm_tpu_torch.tools.train', CONFIG, '--synthetic',
             '--device', 'cpu', '--work-dir', w, '--max-steps']
    out['train'] = run(torchrun(2, *train, '2', '--cfg-options', *CLI_OPTS))
    out['listing'] = (sorted(os.listdir(w)),
                      sorted(os.listdir(os.path.join(w, 'ckpts'))))
    out['resume'] = run(torchrun(2, *train, '3', '--auto-resume',
                                 '--cfg-options', *CLI_OPTS))
    out['test_ckpt'] = run([sys.executable, *_test_cmd(d)[:5],
                            '--checkpoint', os.path.join(w, 'ckpts',
                                                         'step_3.pth'),
                            *_test_cmd(d)[5:]])


def _test_cmd(d):
    return ['-m', 'dfm_tpu_torch.tools.test', CONFIG, '--device', 'cpu',
            '--dtype', 'float32', '--cfg-options',
            f'data.data_root={os.path.join(d, "waymo")}',
            'data.target_hw=(32,48)', 'data.cam_sync=True', *CLI_OPTS]


def _eval_jobs(d, out):
    """tools.test on the Waymo tree with a live checkpoint under torchrun
    and in one process."""
    test = _test_cmd(d)
    test[5:5] = ['--checkpoint', os.path.join(d, 'live.pth')]
    out['test2'] = run(torchrun(2, *test))
    out['test1'] = run([sys.executable, *test])


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    """JAX's step, the port's in this process, the 2-rank group's, and the
    CLI runs (threads run the processes while JAX compiles)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp('mv'))
    inputs, reference = _mv_case()
    torch.save(dict(MultiViewDfM=inputs), os.path.join(d, 'inputs.pt'))
    # a live checkpoint of the CLI's tiny model (class bias raised)
    from dfm_tpu_torch.apis import init_mvdfm_model
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    h = init_mvdfm_model(build_detector(merge_options(
        load_config(CONFIG), CLI_OPTS).model), torch.float32, 'cpu')
    with torch.no_grad():
        h['model'].bbox_head_3d.conv_cls.bias.fill_(0.5)
    torch.save(h['model'].state_dict(), os.path.join(d, 'live.pth'))
    res, cli, errors = {}, {}, {}

    def jobs(name, fn):
        try:
            fn()
        except Exception as e:            # raised again below
            errors[name] = e

    chip_smoke.write_waymo_tree(os.path.join(d, 'waymo'), scale=0.05)

    def workers_then_eval():
        res.update(workers=run_workers(d))
        _eval_jobs(d, cli)

    ts = [threading.Thread(target=jobs, args=('workers', workers_then_eval)),
          threading.Thread(target=jobs, args=(
              'cli', lambda: _train_jobs(d, cli)))]
    for t in ts:
        t.start()
    try:
        res['jax'] = reference()
        res['port'] = _port_step(inputs)
    finally:
        for t in ts:
            t.join()
        torch.set_num_threads(threads)
    for k in ('workers', 'cli'):
        if k in errors:
            raise errors[k]
    for rc, out, err in res['workers']:
        assert rc == 0, err[-3000:]
    res['ranks'] = [torch.load(os.path.join(d, f'rank{r}.pt'),
                               weights_only=False)['MultiViewDfM']
                    for r in range(2)]
    res.update(inputs=inputs, cli=cli, d=d)
    return res


def _sides(steps):
    r0, r1 = steps['ranks']
    return dict(one=steps['port'], group=r0), r1


@pytest.mark.parametrize('side', ['one', 'group'])
@pytest.mark.parametrize('term', TERMS + ['grad_norm'])
def test_step_loss_terms_match_jax(steps, side, term):
    sides, r1 = _sides(steps)
    got = sides[side]
    get = (lambda o: o['grad_norm']) if term == 'grad_norm' else \
        (lambda o: o['metrics'][term])
    if side == 'group':
        assert get(got) == get(r1)
    want = steps['jax']['metrics'][term]
    assert want > 0, term
    np.testing.assert_allclose(get(got), want, rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize('side', ['one', 'group'])
def test_step_gradients_match_jax(steps, side):
    sides, r1 = _sides(steps)
    got = sides[side]['grads']
    ref = steps['jax']['grads']
    assert set(got) == {k for k in ref if not k.endswith(
        ('running_mean', 'running_var'))}
    rel, flat_g, flat_w = {}, [], []
    for name, g in got.items():
        if side == 'group':
            assert torch.equal(g, r1['grads'][name]), name
        g, want = g.numpy(), ref[name].numpy()
        assert np.isfinite(g).all(), name
        rel[name] = np.linalg.norm(g - want) / max(np.linalg.norm(want),
                                                   1e-30)
        flat_g.append(g.ravel())
        flat_w.append(want.ravel())
    bad = {k: v for k, v in rel.items() if v > (
        GRAD_REL_L2_LIFTED if k.startswith(LIFTED) else GRAD_REL_L2)}
    assert not bad, f'gradients off (relative L2): {bad}'
    flat_g, flat_w = np.concatenate(flat_g), np.concatenate(flat_w)
    assert np.linalg.norm(flat_g - flat_w) <= \
        GRAD_REL_L2_ALL * np.linalg.norm(flat_w)
    for prefix in ('backbone.', 'neck.', 'neck_3d.', 'bbox_head_3d.'):
        assert any(k.startswith(prefix) and np.linalg.norm(
            ref[k].numpy()) > 0 for k in got), prefix


@pytest.mark.parametrize('side', ['one', 'group'])
def test_step_batch_stats_and_parameters_match_jax(steps, side):
    sides, r1 = _sides(steps)
    got = sides[side]
    ref = steps['jax']
    sd = steps['inputs']['sd']
    assert sum(n.endswith('running_var') for n in got['stats']) == sum(
        kind == 'bn' for _, _, kind in W.mvdfm_key_map(18))
    for name, t in got['stats'].items():
        if side == 'group':
            assert torch.equal(t, r1['stats'][name]), name
        np.testing.assert_allclose(t.numpy(), ref['after'][name].numpy(),
                                   rtol=0, atol=STATS_ATOL, err_msg=name)
    assert all(not torch.allclose(got['stats'][n], sd[n])
               for n in got['stats'] if n.endswith('running_var'))
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / got['grad_norm'])
    clip_jax = min(1.0, 35.0 / ref['metrics']['grad_norm'])
    flips = total = 0
    for name, t in got['after'].items():
        if side == 'group':
            assert torch.equal(t, r1['after'][name]), name
        if name.endswith(('running_mean', 'running_var')):
            continue
        g = got['grads'][name].numpy().astype(np.float64) * clip
        gw = ref['grads'][name].numpy().astype(np.float64) * clip_jax
        flip = np.sign(g) != np.sign(gw)
        flips += int(flip.sum())
        total += flip.size
        atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                            gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        err = np.abs(t.numpy() - ref['after'][name].numpy())
        assert (err <= atol).all(), (name, float(err.max()))
    assert flips <= 1e-3 * total, (flips, total)


def test_train_cli_two_ranks_resume_and_eval(steps):
    cli, d = steps['cli'], steps['d']
    for k in ('train', 'resume', 'test_ckpt'):
        assert cli[k].returncode == 0, (k, cli[k].stderr[-3000:])
    assert 'MultiViewDfM, float32, on cpu, rank 0 of 2 (gloo)' in \
        cli['train'].stdout
    assert re.search(r'^step 2/2 .*loss_cls=\S+ loss_bbox=\S+ loss_dir=\S+ '
                     r'grad_norm=', cli['train'].stdout, re.M)
    assert cli['listing'] == (['ckpts', 'config.json', 'metrics.jsonl'],
                              ['step_2.pth'])
    resumed = re.findall(r'^(\[rank 1\] )?resumed from step 2 ',
                         cli['resume'].stdout, re.M)
    assert sorted(resumed) == ['', '[rank 1] ']
    # the port's layout: the keys mvdfm_key_map gives a JAX tree of the
    # same config
    ckpt = torch.load(os.path.join(d, 'w', 'ckpts', 'step_3.pth'),
                      map_location='cpu', weights_only=True)
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    jcfg = JMVDfMConfig(**dataclasses.asdict(build_detector(merge_options(
        load_config(CONFIG), CLI_OPTS).model)))
    batch = jax_mv_synth(_handle(jcfg), 1, 0, *HW)
    shapes = jax.eval_shape(lambda: JMultiViewDfM(cfg=jcfg).init(
        jax.random.PRNGKey(0), batch['img'], batch['lidar2img'], HW,
        train=False))
    want = W.state_dict_from_jax(random_variables(shapes, 0),
                                 W.mvdfm_key_map(18))
    assert sorted(ckpt['state_dict']) == sorted(want)
    assert all(ckpt['state_dict'][k].shape == want[k].shape for k in want)
    assert '[metric] python_fallback' in cli['test_ckpt'].stdout


def test_waymo_eval_cli_two_ranks_equals_one(steps):
    cli = steps['cli']
    for k in ('test2', 'test1'):
        assert cli[k].returncode == 0, (k, cli[k].stderr[-3000:])
    lines = [re.findall(r'^(?:Vehicle|Pedestrian|Cyclist|Sign|Overall) '
                        r'mAP\w?: \S+$', cli[k].stdout, re.M)
             for k in ('test2', 'test1')]
    assert len(lines[1]) == 15 and lines[0] == lines[1]
    dets = [sorted(re.findall(r'^\[(\d)/2\] dets=(\d+)$', cli[k].stdout,
                              re.M)) for k in ('test2', 'test1')]
    assert len(dets[1]) == 2 and dets[0] == dets[1]
    assert all(int(n) > 0 for _, n in dets[1])
