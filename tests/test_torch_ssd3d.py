"""3DSSD against the JAX package, on the CPU.

* `corners_lidar` against JAX's on seeded boxes: within 1e-6;
* `SAModuleMSG` with given centres (`target_xyz`, no dilation: 3DSSD's
  vote aggregation), eval and train mode: features within 1e-5 relative
  L2, the BatchNorm statistics atol 1e-5;
* a small 3DSSD (fusion sampling of 64, 32 and 16 + 16 centres from 2 x
  300 points with an intensity column, 16 candidates, the fixed head
  widths cut to 16-32), eval mode: the candidates' seeds equal, every
  float output within 1e-5 relative L2 (measured 2.9e-7); the key map
  takes every leaf;
* `ssd3d_loss` on JAX's outputs with gt boxes on half of the candidates
  (positives, centerness, the corner and vote terms live; a padded row):
  every term within rtol 1e-5 (measured 8.4e-8), all > 0; `ssd3d_predict` (the bin decode
  and NMS) within 1e-6 / 1e-5, labels and mask equal;
* one training step against JAX's `make_train_step` with gt boxes on the
  train-mode forward's candidates. JAX's float32 step is not the
  reference: its gradients lie 3.3e-3 (whole vector) from its own
  float64 step, beyond GRAD_REL_L2_ALL. JAX's step runs in float64 (at
  XLA's default optimization level, as VoteNet's must); the port's
  float64 step agrees with it within 1e-6, and the port's float32 step
  is held to it by the rules of tests/test_torch_train_step.py, no limit
  widened (measured worst parameter 3.5e-5, whole vector 1.65e-5);
* `lidar_synth` equals JAX's 3DSSD batch (1024 points and a zero
  column); `tools.test --synthetic`, `tools.train --synthetic` and its
  refusal without the flag (exit 2), in process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.core.boxes as JB
import dfm_tpu.models.backbones.pointnet2_msg as JM
import dfm_tpu.models.detectors.ssd3d as JS
from dfm_tpu_torch.core.boxes import corners_lidar
from dfm_tpu_torch.models.backbones.pointnet2_msg import SAModuleMSG
from dfm_tpu_torch.models.detectors.ssd3d import (SSD3DConfig, SSD3DNet,
                                                  ssd3d_loss, ssd3d_predict)
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import STATS_ATOL, random_variables
from torch_lidar_common import RANGE, check_step, cloud, jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

B, N, G = 2, 300, 5
OUT_REL = 1e-5
TERM_RTOL = 1e-5
TINY = dict(
    num_candidates=16, sa_num_points=((64,), (32,), (16, 16)),
    sa_fps_ranges=((-1,), (-1,), (32, -1)),
    sa_radii=((0.5, 1.0, 2.0), (1.0, 2.0, 4.0), (2.0, 4.0, 6.0)),
    sa_num_samples=((8, 8, 16), (8, 8, 16), (8, 8, 8)),
    sa_channels=(((8, 8, 16), (8, 8, 16), (8, 8, 16)),
                 ((16, 16, 16), (16, 16, 16), (16, 16, 16)),
                 ((16, 16, 32), (16, 16, 32), (16, 16, 32))),
    sa_aggregation=(16, 24, 32), agg_ks=(8, 16),
    agg_mlps=((16, 16, 32), (16, 16, 32)), shared_channels=(32, 16),
    point_cloud_range=RANGE, score_thr=0.0, max_num=8)
CONFIG = 'configs/ssd3d_kitti_car.py'
CLI_TINY = ['model.point_cloud_range=(0,-8,-2,16,8,1.2)',
            'model.sa_num_points=((256,),(128,),(64,64))',
            'model.sa_fps_ranges=((-1,),(-1,),(128,-1))',
            'model.num_candidates=32', 'model.max_num=8']


def points(seed):
    pts, _ = cloud(B, N, seed, clusters=4)
    inten = np.random.RandomState(seed + 1).rand(B, N, 1)
    return np.concatenate([pts, inten], -1).astype(np.float32)


def gt_on(cands, seed):
    """Car boxes (bottom centre) around candidates 0, 3, 6 of each sample
    (shifted by up to 0.3 m), one far away, the last row padded."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 7), np.float32)
    mask = np.ones((B, G), bool)
    mask[:, -1] = False
    for i in range(B):
        for j in range(G - 1):
            c = cands[i, 3 * j] + rng.uniform(-0.3, 0.3, 3) if j < G - 2 \
                else np.array([15.0, 7.0, 0.0])
            boxes[i, j] = (c[0], c[1], c[2] - 0.78, 3.9, 1.6, 1.56,
                           rng.uniform(-np.pi, np.pi))
    return dict(gt_boxes=boxes, gt_labels=np.zeros((B, G), np.int64),
                gt_mask=mask)


def test_corners_lidar_matches_jax():
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-5, 5, (30, 3)),
                            rng.uniform(0.3, 4, (30, 3)),
                            rng.uniform(-np.pi, np.pi, (30, 1))],
                           -1).astype(np.float32)
    np.testing.assert_allclose(corners_lidar(t(boxes)).numpy(),
                               np.asarray(JB.corners_lidar(boxes)),
                               atol=1e-6)


@pytest.mark.parametrize('train', [False, True])
def test_sa_msg_target_xyz_matches_jax(train):
    xyz = points(3)[..., :3]
    feats = np.random.RandomState(4).randn(B, N, 5).astype(np.float32)
    target = xyz[:, :12] + 0.2
    kw = dict(npoints=(12,), radii=(1.5, 3.0), ks=(8, 16),
              mlps=((8, 16), (8, 8)))
    jm = JM.SAModuleMSG(dilated=False, **kw)
    v = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), xyz, feats, target_xyz=target)), 5)
    (jxyz, jf, jidx), upd = jax.tree.map(np.asarray, jax.jit(
        lambda v, x, f, c: jm.apply(v, x, f, train, target_xyz=c,
                                    mutable=['batch_stats']))(
        v, xyz, feats, target))
    msg = SAModuleMSG(kw['npoints'], kw['radii'], kw['ks'], kw['mlps'], 8,
                      dilated=False)
    key_map = W._dense_key_map(msg)
    msg.load_state_dict(W.state_dict_from_jax(v, key_map))
    gxyz, gf, gidx = msg.train(train)(t(xyz), t(feats), target_xyz=t(target))
    np.testing.assert_array_equal(gxyz.numpy(), jxyz)
    np.testing.assert_array_equal(gidx.numpy(), jidx)
    assert rel(gf.detach().numpy(), jf) <= OUT_REL
    if train:
        want = W.state_dict_from_jax({'params': v['params'],
                                      'batch_stats': upd['batch_stats']},
                                     key_map)
        for k, x in msg.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(x.numpy(), want[k].numpy(),
                                           atol=STATS_ATOL, err_msg=k)


@pytest.fixture(scope='module')
def models():
    jcfg, cfg = JS.SSD3DConfig(**TINY), SSD3DConfig(**TINY)
    pts = points(1)
    jm = JS.SSD3DNet(cfg=jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts)), 1)
    key_map = W.ssd3d_key_map(cfg)
    want, _ = jax_apply(jm, variables, [pts], False)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables, pts=pts,
                key_map=key_map, want=want,
                sd=W.state_dict_from_jax(variables, key_map))


def test_key_map_and_forward_match_jax(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    port = SSD3DNet(models['cfg'])
    port.load_state_dict(models['sd'], strict=True)
    with torch.no_grad():
        got = port.eval()(t(models['pts']))
    want = models['want']
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['seed_points'].numpy(),
                                  want['seed_points'])
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].numpy(), want[k]) <= OUT_REL, k


def test_loss_and_predict_match_jax(models):
    out = models['want']
    gt = gt_on(out['aggregated_points'], 2)
    jterms = jax.jit(lambda o, b: JS.ssd3d_loss(o, b, models['jcfg']))(
        jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, gt))[1]
    _, terms = ssd3d_loss({k: t(v) for k, v in out.items()},
                          {k: t(v) for k, v in gt.items()}, models['cfg'])
    assert set(terms) == set(jterms)
    for k in terms:
        assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JS.ssd3d_predict(
        o, models['jcfg']))(jax.tree.map(jnp.asarray, out)))
    got = ssd3d_predict({k: t(v) for k, v in out.items()}, models['cfg'])
    assert set(got) == set(want) and want['mask'].sum() > 2
    for k in ('labels_3d', 'mask'):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got['scores_3d'].numpy(), want['scores_3d'],
                               atol=1e-6)
    np.testing.assert_allclose(got['boxes_3d'].numpy(), want['boxes_3d'],
                               atol=1e-5, rtol=1e-5)


def test_train_step_matches_jax(models):
    jm, variables = models['jm'], models['variables']
    out, _ = jax_apply(jm, variables, [models['pts']], True)
    batch = dict(points=models['pts'], **gt_on(out['aggregated_points'], 4))
    port = SSD3DNet(models['cfg'])
    port.load_state_dict(models['sd'])

    def inputs64(model):
        pts, mask, g = lidar_to_device(batch, 'cpu')
        return pts.double(), mask, {k: v.double() if v.is_floating_point()
                                    else v for k, v in g.items()}

    metrics, worst, whole = check_step(
        jm, lambda o, bt: JS.ssd3d_loss(o, bt, models['jcfg']), variables,
        models['key_map'], port, jax.tree.map(jnp.asarray, batch),
        lambda bt: (bt['points'],), lidar_to_device(batch, 'cpu'),
        live=('vote_mlp.weight', 'vote_out', 'reg_out', 'cls_out',
              'backbone.sa0.mlp0_0.weight'),
        f64=(JS.SSD3DNet(cfg=models['jcfg'], dtype=jnp.float64), inputs64),
        compiler_options={'xla_llvm_disable_expensive_passes': True})
    assert metrics['loss_corner'] > 0 and metrics['loss_vote'] > 0
    print(f'port float32 step against JAX float64: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    want = get_adapter('SSD3DNet').synthetic_batch(
        types.SimpleNamespace(cfg=JS.SSD3DConfig()), 2, 3)
    got = lidar_synth(SSD3DConfig(), 2, 3)
    assert set(got) == set(want) and got['points'].shape == (2, 1024, 4)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cli_synthetic_and_refusal(tmp_path, capsys):
    assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + CLI_TINY) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] SSD3DNet: decoded 4 output arrays, ' \
        'finite=True' in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--synthetic',
                         '--work-dir', str(tmp_path), '--max-steps', '1',
                         '--cfg-options', 'data.batch_size_per_chip=2']
                        + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'loss_corner=' in out, out
    assert train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                           str(tmp_path)]) == 2
    assert '--synthetic' in capsys.readouterr().err
