"""PointRCNN and its PointNet++ parts against the JAX package, on the CPU.

* `farthest_point_sample` (D-FPS on xyz and F-FPS on [xyz, features]) on
  clouds with duplicate points: indices equal;
* `ball_group` (with and without `min_radius`, groups larger than the
  cloud) and `three_interpolate` on tie-heavy clouds (points on a coarse
  lattice, many at equal distances, duplicates): the groups equal
  exactly (an index channel among the features), the interpolation
  within 1e-6 (one-hot source features: a tie broken the other way moves
  a weight to another index);
* `SAModule`, `SAModuleMSG` (F-FPS / D-FPS / FS fusion sampling over
  `fps_ranges`, dilated radii, aggregation) and `PointNetFPNeck`, eval
  and train mode: centres and indices equal, features within 1e-5
  relative L2 (measured 2.1e-7 / 1.3e-6), BatchNorm statistics atol 1e-5;
* the point coder: the port's encode within 1e-6 of JAX's, decode after
  encode the boxes back (yaw in (-pi, pi]);
* a tiny PointRCNN (four SA stages of 64, 32, 16, 8 centres from 256
  points in four dense blobs; the fixed widths; NMS at 0.5 keeping fewer
  than the 32 proposal slots, so that the masked slots' picks count),
  eval mode: the proposals' labels and mask equal and boxes within 1e-5,
  the RoI points selected equal, every float output within 1e-4
  relative L2 (measured 5.0e-7); the key map takes every leaf;
* `point_rcnn_loss` on JAX's outputs (proposals near the gt boxes in half
  of the slots, so that the RCNN terms have positives): every term within
  rtol 1e-5 (measured 1.5e-7); `point_rcnn_predict` within 1e-6 / 1e-4;
* one training step against JAX's `make_train_step` at `STEP`: TINY with
  stage radii of 2-32 m and 2-4 samples a ball on a cloud whose blobs
  spread 1.5 m, so that the stage-0 balls hold neighbours; the gt boxes
  moved onto the train-mode forward's proposals (`gt_on_proposals`), so
  that 'loss_rcnn_reg' and the `rcnn_reg*` gradients are live. JAX's
  float32 step is not the reference: flax's BatchNorm takes the variance
  as E[x^2] - E[x]^2, and through some forty normalised layers its float32
  gradients lie 2.3e-2 (whole vector) and 4.6e-2 (worst parameter) from
  its own float64 step (ROADMAP.md §3). So JAX's step runs in float64;
  the port's float64 step agrees with it within 1e-6, and the port's
  float32 step is held to it by the rules of
  tests/test_torch_train_step.py, no limit widened: measured worst
  parameter 5.4e-3, whole vector 3.9e-4. JAX's step is compiled at XLA's
  default optimization level: at level 0 (the other tests' fast option)
  XLA's CPU backend gives it wrong gradients;
* `lidar_synth` equals JAX's PointRCNN batch (4096 points, no mask);
  `tools.test --synthetic` and `tools.train --synthetic` (exit 2 without
  the flag), in process. FPS's loop is timed on the card by chip_smoke
  phase 21.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.backbones.pointnet2 as JP
import dfm_tpu.models.backbones.pointnet2_msg as JM
import dfm_tpu.models.detectors.point_rcnn as JR
from dfm_tpu.models.necks.pointnet2_fp import PointNetFPNeck as JFPNeck
from dfm_tpu_torch.models.backbones import pointnet2 as P2
from dfm_tpu_torch.models.backbones.pointnet2_msg import (
    PointNet2SAMSG, SAModuleMSG, sample_centers)
from dfm_tpu_torch.models.detectors.point_rcnn import (
    PointRCNN, PointRCNNConfig, point_coder_decode, point_coder_encode,
    point_rcnn_loss, point_rcnn_predict)
from dfm_tpu_torch.models.necks.pointnet2_fp import PointNetFPNeck
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import STATS_ATOL, random_variables
from torch_lidar_common import (RANGE, boxes_on_points, check_step, cloud,
                                gt_on_proposals, jax_apply, rel, t)

torch.set_num_threads(1)    # from import on; the workers share the cores

B, N, G = 2, 256, 5
OUT_REL = 1e-4
MOD_REL = 1e-5
TERM_RTOL = 1e-5
TINY = dict(point_cloud_range=RANGE, sa_points=(64, 32, 16, 8),
            num_proposals=32, rpn_nms_thr=0.5, roi_num_points=32, max_num=8,
            score_thr=0.05)
# the step's: balls that hold neighbours, few samples a ball (module
# docstring)
STEP = dict(TINY, sa_radii=((2.0, 4.0), (4.0, 8.0), (8.0, 16.0),
                            (16.0, 32.0)),
            sa_samples=((2, 4),) * 4)
CONFIG = 'configs/point_rcnn_kitti.py'
CLI_TINY = ['model.point_cloud_range=(0,-8,-2,16,8,1.2)',
            'model.sa_points=(64,32,16,8)', 'model.num_proposals=16',
            'model.roi_num_points=32', 'model.max_num=8']


def lattice(b, n, seed, step=0.5, extent=4):
    """Points on a coarse lattice (many equal distances) with exact
    duplicates."""
    rng = np.random.RandomState(seed)
    pts = rng.randint(0, extent, (b, n, 3)).astype(np.float32) * step
    pts[:, n // 2:n // 2 + 8] = pts[:, :8]
    return pts


@pytest.mark.parametrize('space', [3, 7])
def test_fps_indices_equal_with_duplicates(space):
    rng = np.random.RandomState(space)
    pts = rng.randn(B, 300, space).astype(np.float32)
    pts[:, 100:140] = pts[:, :40]                       # duplicates
    pts[:, 200:210] = pts[:, 5:6]
    for npoint in (64, 280):
        want = np.asarray(jax.jit(JP.batched_fps, static_argnums=1)(
            jnp.asarray(pts), npoint))
        got = P2.farthest_point_sample(t(pts), npoint).numpy()
        np.testing.assert_array_equal(got, want)
    # the lattice: ties everywhere
    lat = lattice(B, 200, space)
    want = np.asarray(jax.jit(JP.batched_fps, static_argnums=1)(
        jnp.asarray(lat), 50))
    np.testing.assert_array_equal(P2.farthest_point_sample(t(lat), 50)
                                  .numpy(), want)


@pytest.mark.parametrize('case', [(0.8, 16, 0.0), (1.1, 32, 0.6),
                                  (5.0, 300, 0.0)])
def test_ball_group_equal_on_ties(case):
    radius, k, min_r = case
    xyz = lattice(B, 200, 1)
    feats = np.concatenate([np.random.RandomState(2).randn(B, 200, 2),
                            np.broadcast_to(np.arange(200.)[None, :, None],
                                            (B, 200, 1))], -1).astype(
                                                np.float32)
    centers = xyz[:, ::7]
    want = np.asarray(jax.jit(lambda x, f, c: JP.batched_ball_group(
        x, f, c, radius, k, min_r))(xyz, feats, centers))
    got = P2.ball_group(t(xyz), t(feats), t(centers), radius, k,
                        min_r).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if min_r:                 # some centres without any point in the shell
        assert (got[..., :3] == 0).all(-1).any()


def test_three_interpolate_equal_on_ties():
    src = lattice(B, 20, 3)
    dst = lattice(B, 120, 4)
    onehot = np.broadcast_to(np.eye(20, dtype=np.float32), (B, 20, 20))
    want = np.asarray(jax.jit(JP.three_interpolate)(src, onehot, dst))
    got = P2.three_interpolate(t(src), t(onehot), t(dst)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # duplicate and equidistant sources share the weight: ties are common
    assert ((want > 0).sum(-1) == 3).all()


def _load(module, variables, key_map):
    module.load_state_dict(W.state_dict_from_jax(variables, key_map),
                           strict=True)
    return module


@pytest.mark.parametrize('train', [False, True])
def test_sa_msg_fp_modules_match_jax(train):
    pts, _ = cloud(B, 300, 5, clusters=4)
    feats = np.random.RandomState(6).randn(B, 300, 4).astype(np.float32)
    points = np.concatenate([pts, feats], -1)
    # SAModule
    jsa = JP.SAModule(40, 1.5, 12, (8, 16))
    v = random_variables(jax.eval_shape(lambda: jsa.init(
        jax.random.PRNGKey(0), pts, feats)), 7)
    (jxyz, jf), upd = jax_apply(jsa, v, [pts, feats], train)
    sa = _load(P2.SAModule(40, 1.5, 12, (8, 16), 3 + 4), v,
               W._dense_key_map(P2.SAModule(40, 1.5, 12, (8, 16), 7)))
    gxyz, gf = sa.train(train)(t(pts), t(feats))
    np.testing.assert_array_equal(gxyz.numpy(), jxyz)
    assert rel(gf.detach().numpy(), jf) <= MOD_REL
    _stats_agree(sa, v, upd, train)
    # SAModuleMSG with fusion sampling over two ranges, then the stack
    kw = dict(npoints=(10, 6), radii=(0.8, 1.6), ks=(8, 16),
              mlps=((8, 8), (8, 16)), fps_mods=('F-FPS', 'FS'),
              fps_ranges=(150, -1), aggregation=12)
    jm = JM.SAModuleMSG(**kw)
    v = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts, feats)), 8)
    (jxyz, jf, jidx), upd = jax_apply(jm, v, [pts, feats], train)
    msg = SAModuleMSG(kw['npoints'], kw['radii'], kw['ks'], kw['mlps'], 7,
                      kw['fps_mods'], kw['fps_ranges'], aggregation=12)
    msg = _load(msg, v, W._dense_key_map(msg)).train(train)
    gxyz, gf, gidx = msg(t(pts), t(feats))
    np.testing.assert_array_equal(gidx.numpy(), jidx)
    assert gidx.shape[1] == 22 and (gidx[:, :10] < 150).all() and \
        (gidx[:, 10:] >= 150).all()
    assert rel(gf.detach().numpy(), jf) <= MOD_REL
    _stats_agree(msg, v, upd, train)
    want_idx = np.asarray(jax.vmap(lambda x, f: JM.sample_centers(
        x, f, ('D-FPS', 'FS'), (100, -1), (5, 7)))(pts, feats))
    np.testing.assert_array_equal(sample_centers(
        t(pts), t(feats), ('D-FPS', 'FS'), (100, -1), (5, 7)).numpy(),
        want_idx)
    # a two-stage stack and the FP neck on it
    skw = dict(num_points=((32,), (12,)), radii=((0.8, 1.6), (1.6, 3.2)),
               num_samples=((8, 16), (8, 8)),
               sa_channels=(((8, 8), (8, 16)), ((16, 16), (16, 24))),
               aggregation_channels=(None, 20),
               fps_mods=(('D-FPS',), ('FS',)), fps_ranges=((-1,), (-1,)))
    jst = JM.PointNet2SAMSG(**skw)
    vs = random_variables(jax.eval_shape(lambda: jst.init(
        jax.random.PRNGKey(0), points)), 9)
    jout, _ = jax_apply(jst, vs, [points], False)
    stack = PointNet2SAMSG(7, **skw)
    stack = _load(stack, vs, W._dense_key_map(stack)).eval()
    got = stack(t(points))
    for a, b in zip(got['sa_indices'], jout['sa_indices']):
        np.testing.assert_array_equal(a.numpy(), b)
    jfp = JFPNeck(fp_channels=((16, 12), (8, 8)))
    vf = random_variables(jax.eval_shape(lambda: jfp.init(
        jax.random.PRNGKey(0), jout)), 10)
    (jneck), upd = jax_apply(jfp, vf, [jout], train)
    neck = PointNetFPNeck(stack.out_channels, ((16, 12), (8, 8)))
    neck = _load(neck, vf, W._dense_key_map(neck)).train(train)
    gn = neck({k: [None if x is None else t(x) for x in v]
               for k, v in jout.items()})
    np.testing.assert_array_equal(gn['fp_xyz'].numpy(), jneck['fp_xyz'])
    assert rel(gn['fp_features'].detach().numpy(),
               jneck['fp_features']) <= MOD_REL
    _stats_agree(neck, vf, upd, train)


def _stats_agree(module, v, upd, train):
    if not train:
        return
    want = W.state_dict_from_jax({'params': v['params'],
                                  'batch_stats': upd['batch_stats']},
                                 W._dense_key_map(module))
    for k, val in module.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(val.numpy(), want[k].numpy(),
                                       atol=STATS_ATOL, err_msg=k)


def test_point_coder_round_trip_and_jax():
    rng = np.random.RandomState(11)
    boxes = np.concatenate([rng.uniform(-5, 5, (40, 3)),
                            rng.uniform(0.3, 4, (40, 3)),
                            rng.uniform(-np.pi + 1e-3, np.pi, (40, 1))],
                           -1).astype(np.float32)
    pts = (boxes[:, :3] + rng.uniform(-1, 1, (40, 3))).astype(np.float32)
    labels = rng.randint(0, 3, 40)
    ms = PointRCNNConfig().mean_sizes
    want = np.asarray(JR.point_coder_encode(jnp.asarray(boxes),
                                            jnp.asarray(pts),
                                            jnp.asarray(labels), ms))
    enc = point_coder_encode(t(boxes), t(pts), t(labels), ms)
    np.testing.assert_allclose(enc.numpy(), want, atol=1e-6)
    back = point_coder_decode(enc, t(pts), t(labels), ms).numpy()
    np.testing.assert_allclose(back, boxes, atol=1e-5, rtol=1e-5)
    jback = np.asarray(JR.point_coder_decode(jnp.asarray(want),
                                             jnp.asarray(pts),
                                             jnp.asarray(labels), ms))
    np.testing.assert_allclose(back, jback, atol=1e-6, rtol=1e-6)


def batch_of(seed=0, spread=0.05):
    pts, _ = cloud(B, N, seed, clusters=4, per=60, spread=spread)
    boxes, labels, gmask = boxes_on_points(pts, G, seed)
    # boxes_on_points reads clusters of 40 points: centre them on these
    for i in range(B):
        for j in range(G - 1):
            boxes[i, j, :3] = pts[i, N - (j % 4 + 1) * 60 + 3] - \
                np.r_[0, 0, boxes[i, j, 5] / 2]
    return dict(points=pts, gt_boxes=boxes, gt_labels=labels,
                gt_mask=gmask)


@pytest.fixture(scope='module')
def models():
    jcfg = JR.PointRCNNConfig(**TINY)
    cfg = PointRCNNConfig(**TINY)
    batch = batch_of()
    jm = JR.PointRCNN(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            batch['points']))
    variables = random_variables(shapes, 1)
    key_map = W.point_rcnn_key_map(cfg)
    sd = W.state_dict_from_jax(variables, key_map)
    want, _ = jax_apply(jm, variables, [batch['points']], False)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables, sd=sd,
                key_map=key_map, batch=batch, want=want)


def port_model(models):
    port = PointRCNN(models['cfg'])
    port.load_state_dict(models['sd'], strict=True)
    return port


def test_key_map_takes_every_leaf(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    assert set(models['sd']) == set(PointRCNN(models['cfg']).state_dict())


def test_forward_proposals_and_roi_points_match_jax(models):
    b, want = models['batch'], models['want']
    port = port_model(models).eval()
    with torch.no_grad():
        got = port(t(b['points']))
    assert set(got) == set(want)
    for k in ('prop_labels', 'prop_mask'):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert want['prop_mask'].sum() > 2 and not want['prop_mask'].all()
    np.testing.assert_allclose(got['proposals'].numpy(), want['proposals'],
                               atol=1e-5, rtol=1e-5)
    for k in ('xyz', 'cls_pred', 'reg_pred', 'prop_scores', 'rcnn_cls',
              'rcnn_reg'):
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].numpy(), want[k]) <= OUT_REL, k
    # the RoI points: JAX's selection on JAX's proposals
    with torch.no_grad():
        obj = torch.sigmoid(t(want['cls_pred'])).amax(-1)
        sel = port.roi_points(t(b['points']), t(want['cls_pred']), obj,
                              t(want['proposals']))
    inside = np.stack([np.asarray(JR._points_in_boxes(
        jnp.asarray(p), jnp.asarray(r))).T for p, r in
        zip(b['points'], want['proposals'])])
    pidx = np.asarray(jax.lax.top_k(jnp.asarray(inside, jnp.float32),
                                    TINY['roi_num_points'])[1])
    want_xyz = np.take_along_axis(b['points'][:, None], pidx[..., None], 2)
    np.testing.assert_array_equal(sel[0].numpy(), want_xyz)
    np.testing.assert_array_equal(sel[3].numpy(), np.take_along_axis(
        inside, pidx, 2))
    assert 0 < sel[3].float().mean() < 1


def live_outputs(models):
    """JAX's outputs with the first half of the proposal slots replaced by
    the gt boxes, jittered (RCNN positives), all valid."""
    out = dict(models['want'])
    b = models['batch']
    props = out['proposals'].copy()
    rng = np.random.RandomState(3)
    for i in range(B):
        for j in range(G - 1):
            props[i, j] = b['gt_boxes'][i, j] + np.r_[
                rng.uniform(-0.1, 0.1, 3), 0, 0, 0, 0.05]
    out['proposals'] = props.astype(np.float32)
    out['prop_mask'] = np.ones_like(out['prop_mask'])
    return out


def test_loss_and_predict_match_jax(models):
    b = models['batch']
    out = live_outputs(models)
    jterms = jax.jit(lambda o, bt: JR.point_rcnn_loss(o, bt, models['jcfg'])
                     )(jax.tree.map(jnp.asarray, out),
                       jax.tree.map(jnp.asarray, b))[1]
    _, terms = point_rcnn_loss({k: t(v) for k, v in out.items()},
                               {k: t(v) for k, v in b.items()},
                               models['cfg'])
    assert set(terms) == set(jterms)
    for k in terms:
        assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    live = dict(out, rcnn_cls=out['rcnn_cls'] + 2.0)
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JR.point_rcnn_predict(
        o, models['jcfg']))(jax.tree.map(jnp.asarray, live)))
    got = point_rcnn_predict({k: t(v) for k, v in live.items()},
                             models['cfg'])
    assert int(want['mask'].sum()) > 2
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)


def double_inputs(batch):
    pts, mask, gt = lidar_to_device(batch, 'cpu')
    return pts.double(), mask, {k: v.double() if v.is_floating_point()
                                else v for k, v in gt.items()}


def test_train_step_matches_jax():
    jcfg = JR.PointRCNNConfig(**STEP)
    cfg = PointRCNNConfig(**STEP)
    batch = batch_of(spread=1.5)
    jm = JR.PointRCNN(cfg=jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['points'])), 1)
    key_map = W.point_rcnn_key_map(cfg)
    out, _ = jax_apply(jm, variables, [batch['points']], True)
    b = gt_on_proposals(batch, out, range(G - 1), 4)
    port = PointRCNN(cfg)
    port.load_state_dict(W.state_dict_from_jax(variables, key_map))
    metrics, _, _ = check_step(
        jm, lambda o, bt: JR.point_rcnn_loss(o, bt, jcfg), variables,
        key_map, port, jax.tree.map(jnp.asarray, b),
        lambda bt: (bt['points'],), lidar_to_device(b, 'cpu'),
        live=('rcnn_reg',),
        f64=(JR.PointRCNN(cfg=jcfg, dtype=jnp.float64),
             lambda m: double_inputs(b)),
        compiler_options={'xla_llvm_disable_expensive_passes': True})
    assert metrics['loss_rcnn_reg'] > 0


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    jcfg = JR.PointRCNNConfig()
    want = get_adapter('PointRCNN').synthetic_batch(
        types.SimpleNamespace(cfg=jcfg), 2, 3)
    got = lidar_synth(PointRCNNConfig(), 2, 3)
    assert set(got) == set(want) and 'point_mask' not in got
    assert got['points'].shape == (2, 4096, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cli_synthetic_and_refusal(tmp_path, capsys):
    assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + CLI_TINY) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] PointRCNN: decoded 4 output arrays, ' \
        'finite=True' in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--synthetic',
                         '--work-dir', str(tmp_path), '--max-steps', '1',
                         '--cfg-options'] + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'loss_rcnn_cls=' in out, out
    assert train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                           str(tmp_path)]) == 2
    assert '--synthetic' in capsys.readouterr().err
