"""DfMWithTeacher(teacher_encoder='sparse') against the JAX package: one
train step at the tiny DfM config with the teacher frozen, on the CPU.

The sparse teacher is shaped to the tiny imitation grid (a 17 x 64 x 64
sparse grid gives (2, 16, 16)) and fed two clouds past its capacity. It
is held to JAX's in tests/test_torch_sparse_teacher.py; here JAX's
teacher module is stood in for by the port teacher's train-mode outputs
on the same points, so that JAX's step compiles the student alone and
both steps imitate the same targets. Against JAX's `make_train_step`
(`dfm_loss_with_imitation`, `make_optimizer(frozen_prefixes=
('lidar_teacher',))`):

The student's float32 step is ill-conditioned ahead of the lifting on
this batch: one ulp of noise on the weights moves JAX's own gradients of
the 2D trunk, the neck and the stereo trunk by up to 10 % (relative L2),
and the port's by as much (its float32 gradients lie up to 10 % from its
float64 step's, the same with or without the teacher's points). So the
step is judged against that probe, JAX's compiled step rerun with the
noisy weights, as tests/test_torch_smoke.py:check_step judges SMOKE's:

* each loss term and grad_norm within rtol 2e-4 or 3x the probe's
  distance from JAX (measured: 8.3e-5 for grad_norm, 3.7e-5 for
  loss_bbox, the rest below 2.5e-5);
* each gradient within relative L2 2e-2 (1e-3 after the lifting and in
  the adapters) or 3x the probe's distance, the whole vector within
  2e-3 or 3x (measured: 0.105 against the probe's 0.100 for the worst
  trunk parameter); the teacher's 0 on both sides;
* the parameters after the update within what the two gradients explain
  + 2e-6, the student's BatchNorm statistics within 1e-5 or 3x the
  probe's distance (measured up to 1.7e-5 in the neck's upconv);
* the teacher's parameters the loaded ones, bit for bit, on both sides;
  its SparseBN statistics moved in train mode, as its own train-mode
  forward moves them.
"""

import os
import sys
from typing import Any
from unittest import mock

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dfm_tpu.models.detectors.teacher as JT
import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models.detectors.dfm_with_teacher import \
    DfMWithTeacher as JDfMWithTeacher
from dfm_tpu.models.detectors.dfm_with_teacher import \
    dfm_loss_with_imitation as j_loss
from dfm_tpu.runtime.adapters import _dfm_synth as jax_synth
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.models.detectors.dfm import DfMConfig
from dfm_tpu_torch.models.detectors.dfm_with_teacher import DfMWithTeacher
from dfm_tpu_torch.models.detectors.teacher import SparseLidarTeacher
from dfm_tpu_torch.runtime.adapters import dfm_synth, to_device
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.utils import weights as W

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_sparse_teacher import SMALL, rel, teacher_points
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL,
                                   LOSS_RTOL, LR,
                                   PARAM_ATOL, STATS_ATOL, RecordGrads,
                                   random_variables)

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

TINY = chip_smoke.TRAIN_TINY
B, H, W_ = 2, 64, 128
LIFTED = ('dfm.feature_transformation.', 'dfm.backbone_3d.',
          'dfm.bbox_head_3d.', 'imit_bev.', 'imit_vol.')
# the layers after the lifting: measured 3.2e-4 (the regression tower's
# first conv; JAX's own probe moves it 6.7e-5), the rest below 1e-4
LIFTED_REL = 1e-3


def run_teacher(outs):
    """A stand-in for JAX's teacher module in DfMWithTeacher: it returns
    `outs`, the port teacher's train-mode (volume, BEV) features."""
    class FromRun(flax_nn.Module):
        point_cloud_range: Any = None
        bev_channels: int = 64
        dtype: Any = jnp.float32

        def __call__(self, points, point_mask, train=False):
            return jnp.asarray(outs[0]), jnp.asarray(outs[1])
    return FromRun


def port_model(sd=None):
    """The tiny DfMWithTeacher with the small sparse teacher (its dense
    output the tiny imitation grid)."""
    model = DfMWithTeacher(DfMConfig(**TINY), 'sparse')
    model.lidar_teacher = SparseLidarTeacher(
        model.cfg.point_cloud_range, bev_channels=model.cfg.bev_channels,
        **SMALL)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope='module')
def step_pair():
    """JAX's `make_train_step` with the teacher frozen on `dfm_synth`'s
    batch, its points the two clouds; the port's model with the same
    weights (the teacher's seeded here)."""
    torch.set_num_threads(1)
    cfg = JConfig(**TINY)
    handle = type('Handle', (), {'cfg': cfg})
    batch = jax_synth(handle, B, 7, h=H, w=W_, full=True)
    pts, mask = teacher_points()
    batch = {k: v for k, v in batch.items()
             if k not in ('gt_bboxes2d', 'centers2d', 'gt_labels2d',
                          'gt_mask2d')}
    batch.update(points=jnp.asarray(pts), point_mask=jnp.asarray(mask))
    # the teacher's weights, and its train-mode features on the clouds
    teacher = port_model().lidar_teacher
    W.init_weights(teacher, seed=4)
    t_sd = {k: v.clone() for k, v in teacher.state_dict().items()}
    with torch.no_grad():
        outs = [x.numpy() for x in teacher.train()(torch.from_numpy(pts),
                                                   torch.from_numpy(mask))]
    model = JDfMWithTeacher(cfg=cfg, teacher_encoder='sparse')
    args = (batch['img'], batch['meta'], batch['points'],
            batch['point_mask'])
    orig = JFS.build_fine_softmax_volume

    def fine_f32(*a, **kw):
        kw['dtype'] = jnp.float32
        return orig(*a, **kw)

    with mock.patch.object(JT, 'SparseLidarTeacher', run_teacher(outs)), \
            mock.patch.object(JFS, 'build_fine_softmax_volume', fine_f32):
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), *args, train=False))
        variables = random_variables(shapes, 1)
        tx = optax.chain(RecordGrads.make(), jax_make_optimizer(
            jax_schedule(**LR), frozen_prefixes=('lidar_teacher',)))
        state = create_train_state(variables, tx)
        key = jax.random.PRNGKey(3)
        step = make_train_step(
            model, lambda o, b, r: j_loss(o, b, cfg, r), donate=False,
            model_args_fn=lambda b: (b['img'], b['meta'], b['points'],
                                     b['point_mask']))
        compiled = step.lower(state, batch, key).compile(
            compiler_options=FAST_COMPILE)
        new_state, metrics = compiled(state, batch, key)
        # the probe: JAX's own step with one ulp of noise on the weights
        rng = np.random.RandomState(9)
        noisy = jax.tree.map(lambda a: np.asarray(a) * (1 + 2.0 ** -24 *
                             rng.standard_normal(np.shape(a))).astype(
                                 np.float32), variables['params'])
        probe_state, probe_metrics = compiled(
            create_train_state(dict(variables, params=noisy), tx), batch,
            key)
    keys = jax.random.split(key, B)
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], H * W_, (cfg.num_depth_sample_pixels,), replace=True,
        p=jnp.full((H * W_,), 1.0 / (H * W_), jnp.float32)))
        for i in range(B)])
    student = [(p, f, k) for p, f, k in W.dfm_with_teacher_key_map('sparse')
               if f[0] != 'lidar_teacher']
    sd = W.state_dict_from_jax(variables, student)
    sd.update({f'lidar_teacher.{k}': v for k, v in t_sd.items()})
    port_batch = dfm_synth(DfMConfig(**TINY), B, 7, h=H, w=W_, full=True)
    port_batch.update(points=pts, point_mask=mask)
    return dict(
        batch=port_batch, sd=sd, pix=pix, teacher_after=teacher.state_dict(),
        metrics={k: float(v) for k, v in metrics.items()},
        probe_metrics={k: float(v) for k, v in probe_metrics.items()},
        grads=W.state_dict_from_jax({'params': jax.device_get(
            new_state.opt_state[0]), 'batch_stats': variables[
                'batch_stats']}, student),
        probe=W.state_dict_from_jax({'params': jax.device_get(
            probe_state.opt_state[0]), 'batch_stats': variables[
                'batch_stats']}, student),
        after=W.state_dict_from_jax(jax.device_get(
            {'params': new_state.params,
             'batch_stats': new_state.batch_stats}), student),
        probe_after=W.state_dict_from_jax(jax.device_get(
            {'params': probe_state.params,
             'batch_stats': probe_state.batch_stats}), student))


def test_dfm_with_sparse_teacher_step_matches_jax(step_pair):
    pair = step_pair
    model = port_model(pair['sd'])
    step = TrainStep(model, make_optimizer(
        model, frozen_prefixes=('lidar_teacher',)), liga_schedule(**LR))
    img, meta, gt = to_device(pair['batch'], 'cpu')
    gt = {k: v for k, v in gt.items() if k not in ('gt_bboxes2d',
                                                   'centers2d')}
    with torch.backends.mkldnn.flags(enabled=False):
        total, losses = step.forward(
            img, meta, gt, depth_pix_idx=torch.from_numpy(pair['pix']))
        step.backward(total)
    step.reduce()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    norm = float(step.update())
    got = dict(loss=float(total.detach()), grad_norm=norm,
               **{k: float(v.detach()) for k, v in losses.items()})
    assert set(got) == set(pair['metrics'])
    for k, v in got.items():
        if k in ('loss_bbox', 'loss_imitation'):
            assert pair['metrics'][k] > 0, k
        x = pair['metrics'][k]
        assert abs(v - x) <= max(LOSS_RTOL * abs(x), 3 * abs(
            pair['probe_metrics'][k] - x)), (k, v, x)
    bad, flat = {}, {'port': [], 'jax': [], 'probe': []}
    for n, g in grads.items():
        if n.startswith('lidar_teacher.'):
            assert not g.any(), n
            continue
        g, want, q = g.numpy(), pair['grads'][n].numpy(), \
            pair['probe'][n].numpy()
        lim = LIFTED_REL if n.startswith(LIFTED) else GRAD_REL_L2
        if rel(g, want) > max(lim, 3 * rel(q, want)):
            bad[n] = (rel(g, want), rel(q, want))
        for key, x in (('port', g), ('jax', want), ('probe', q)):
            flat[key].append(x.ravel())
    assert not bad, f'gradients off (relative L2, probe): {bad}'
    flat = {k: np.concatenate(x) for k, x in flat.items()}
    assert rel(flat['port'], flat['jax']) <= max(
        GRAD_REL_L2_ALL, 3 * rel(flat['probe'], flat['jax']))
    assert np.linalg.norm(pair['grads']['imit_vol.weight'].numpy()) > 0
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / norm)
    clip_jax = min(1.0, 35.0 / pair['metrics']['grad_norm'])
    for n, x in model.state_dict().items():
        if n.startswith('lidar_teacher.'):
            t = n[len('lidar_teacher.'):]
            if n.endswith(('running_mean', 'running_var')):
                # moved in train mode as the teacher's own forward moves them
                np.testing.assert_allclose(
                    x.numpy(), pair['teacher_after'][t].numpy(), rtol=1e-6,
                    atol=1e-7, err_msg=n)
                assert not np.array_equal(x.numpy(), pair['sd'][n].numpy())
            else:           # frozen: the loaded weights, bit for bit
                np.testing.assert_array_equal(x.numpy(),
                                              pair['sd'][n].numpy())
            continue
        want = pair['after'][n].numpy()
        if n.endswith(('running_mean', 'running_var')):
            atol = np.maximum(STATS_ATOL, 3 * np.abs(
                pair['probe_after'][n].numpy() - want))
        else:
            g = grads[n].numpy().astype(np.float64) * clip
            gw = pair['grads'][n].numpy().astype(np.float64) * clip_jax
            atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                                gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        assert (np.abs(x.numpy() - want) <= atol).all(), n
