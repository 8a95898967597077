"""VoteNet and its PointNet++ SSG backbone against the JAX package, on the
CPU.

* a VoteNet of small heads (16 proposals, 4 classes, 3 heading bins) on
  its fixed backbone (`PointNet2SASSG`: four levels of 2048, 1024, 512,
  256 centres) from the step's scene (below) with the height feature,
  eval mode: the seeds equal, votes, centres and the raw head within 1e-5
  relative L2 (measured 3.6e-7); the key map takes every leaf;
* `votenet_loss` on JAX's outputs with gt boxes near half of the
  proposals (objectness positives and negatives, some beyond 1 m of any
  seed, a padded row): every term within rtol 1e-5 (measured 1.2e-7),
  all > 0;
  `votenet_predict` within 1e-6 (labels equal);
* one training step against JAX's `make_train_step` on 2 x 2,500 points
  in a 2 m cube (about 10 points in each first-level ball, as the
  configs' 20,000-40,000 points a room give them), gt boxes on the
  train-mode forward's centres (`torch_lidar_common.check_step` with
  `f64` and `probe`). JAX's float32 step is not the reference: its
  discrete choices on rounded values (FPS over the votes, ball groups,
  the max over groups of near-equal features) and flax's E[x^2] - E[x]^2
  variance put its gradients 5.4e-2 (whole vector) from its own float64
  step, and its grad norm 0.6 % low. JAX's step runs in float64; the
  port's float64 step agrees with it within 1e-6 (loss terms, gradients,
  BatchNorm statistics); the port's float32 step is held to it by the
  rules of tests/test_torch_train_step.py (each parameter within
  GRAD_REL_L2 2e-2, a zero gradient within ZERO_GRAD, the statistics
  within STATS_ATOL, the parameters after the update), but a loss term
  and the whole vector may lie as far as JAX's own float32 step does
  (measured worst parameter 1.84e-2; whole vector 1.33e-2 against
  GRAD_REL_L2_ALL 2e-3 and JAX's 5.4e-2). JAX's steps are compiled at
  XLA's default optimization level: at level 0 (the other tests' fast option) XLA's CPU backend gives its
  float64 backbone gradients 40 % off (grad norm 190.7 against the 260.6
  of its default level and of the port's float64 step);
* `lidar_synth` equals JAX's VoteNet batch (`indoor_synth`: 256 xyz
  points in a room cube); `tools.test --synthetic` and `tools.train
  --synthetic` in process;
* JAX's indoor route's KeyError: tests/test_torch_indoor.py.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.votenet as JV
from dfm_tpu_torch.models.detectors.votenet import (VoteNet, VoteNetConfig,
                                                    votenet_loss,
                                                    votenet_predict)
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import random_variables
from torch_lidar_common import check_step, jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B, N, G = 2, 2500, 5
OUT_REL = 1e-5
TERM_RTOL = 1e-5
TINY = dict(num_classes=4, num_heading_bins=3, num_proposals=16,
            mean_sizes=((0.8, 0.8, 0.9), (1.8, 1.8, 1.2), (0.6, 0.6, 0.7),
                        (1.4, 1.5, 0.8)), score_thr=0.05)
CONFIG = os.path.join(ROOT, 'configs', 'votenet_scannet.py')
CLI_TINY = ['model.num_proposals=32', 'data.batch_size_per_chip=2']


def scene(seed):
    """(B, N, 4) points in a 2 m cube with a height column: ~10 points in
    each of the first level's 0.2 m balls, as the configs' 20,000-40,000
    points a room give them."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(B, N, 3) * 2
    return np.concatenate([pts, pts[..., 2:] - 0.1], -1).astype(np.float32)


def gt_near(centers, seed):
    """Boxes centred within 0.2 m of proposals 0, 2, 4 and 6 of each sample
    and one 5 m away (gravity-centre z as votenet_loss reads it), the last
    row padded."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 7), np.float32)
    labels = rng.randint(0, 4, (B, G))
    mask = np.ones((B, G), bool)
    mask[:, -1] = False
    for i in range(B):
        for j in range(G - 1):
            ctr = centers[i, 2 * j] + rng.uniform(-0.12, 0.12, 3) \
                if j < G - 2 else np.array([5.0, 5.0, 1.0])
            boxes[i, j] = (*ctr, *rng.uniform(0.5, 1.5, 3),
                           rng.uniform(-np.pi, np.pi))
    return dict(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)


@pytest.fixture(scope='module')
def models():
    jcfg, cfg = JV.VoteNetConfig(**TINY), VoteNetConfig(**TINY)
    pts = scene(0)
    jm = JV.VoteNet(cfg=jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts)), 1)
    key_map = W.votenet_key_map(cfg)
    want, _ = jax_apply(jm, variables, [pts], False)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables, pts=pts,
                key_map=key_map, want=want,
                sd=W.state_dict_from_jax(variables, key_map))


def test_key_map_and_forward_match_jax(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    port = VoteNet(models['cfg'])
    port.load_state_dict(models['sd'], strict=True)
    with torch.no_grad():
        got = port.eval()(t(models['pts']))
    want = models['want']
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['seed_xyz'].numpy(), want['seed_xyz'])
    for k in ('vote_xyz', 'centers', 'raw'):
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].numpy(), want[k]) <= OUT_REL, k


def _ctr(models):
    raw = models['want']['raw']
    return models['want']['centers'] + raw[..., 2:5]


def test_loss_and_predict_match_jax(models):
    out = models['want']
    gt = gt_near(_ctr(models), 2)
    jterms = jax.jit(lambda o, b: JV.votenet_loss(o, b, models['jcfg']))(
        jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, gt))[1]
    _, terms = votenet_loss({k: t(v) for k, v in out.items()},
                            {k: t(v) for k, v in gt.items()}, models['cfg'])
    assert set(terms) == set(jterms)
    for k in terms:
        assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JV.votenet_predict(
        o, models['jcfg']))(jax.tree.map(jnp.asarray, out)))
    got = votenet_predict({k: t(v) for k, v in out.items()}, models['cfg'])
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    assert (want['scores_3d'] > 0).any()


def test_train_step_matches_jax(models):
    jm, variables = models['jm'], models['variables']
    out, _ = jax_apply(jm, variables, [models['pts']], True)
    gt = gt_near(out['centers'] + out['raw'][..., 2:5], 4)
    batch = dict(points=models['pts'], **gt)
    port = VoteNet(models['cfg'])
    port.load_state_dict(models['sd'])

    def inputs64(model):
        pts, mask, g = lidar_to_device(batch, 'cpu')
        return pts.double(), mask, {k: v.double() if v.is_floating_point()
                                    else v for k, v in g.items()}

    metrics, worst, whole = check_step(
        jm, lambda o, bt: JV.votenet_loss(o, bt, models['jcfg']), variables,
        models['key_map'], port, jax.tree.map(jnp.asarray, batch),
        lambda bt: (bt['points'],), lidar_to_device(batch, 'cpu'),
        live=('head_out', 'vote', 'prop', 'backbone.sa0.mlp0.weight'),
        f64=(JV.VoteNet(cfg=models['jcfg'], dtype=jnp.float64), inputs64),
        probe=True,
        compiler_options={'xla_llvm_disable_expensive_passes': True})
    assert metrics['loss_center'] > 0 and metrics['loss_vote'] > 0
    print(f'port float32 step against JAX float64: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    want = get_adapter('VoteNet').synthetic_batch(
        types.SimpleNamespace(cfg=JV.VoteNetConfig(num_classes=18)), 2, 3)
    got = lidar_synth(VoteNetConfig(num_classes=18), 2, 3)
    assert set(got) == set(want) and got['points'].shape == (2, 256, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cli_synthetic(tmp_path, capsys):
    assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + CLI_TINY) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] VoteNet: decoded 3 output arrays, ' \
        'finite=True' in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--synthetic',
                         '--work-dir', str(tmp_path), '--max-steps', '1',
                         '--cfg-options'] + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'loss_objectness=' in out, out
