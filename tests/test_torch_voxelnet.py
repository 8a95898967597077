"""The SECOND LiDAR family (VoxelNet, DynamicVoxelNet, the FreeAnchor
head) against the JAX package, on the CPU at a tiny grid.

* `voxelize_mean` with SECOND's cap of 5 points a voxel: counts equal,
  means within 1e-6;
* VoxelNet forward (eval and train mode: BatchNorm on the batch's
  moments) and DynamicVoxelNet forward: every output within 1e-4
  relative L2 (measured 8.9e-7 in eval, 4.6e-6 in train mode);
* `voxelnet_loss` for 'anchor3d' and 'free_anchor' on the same head maps:
  every term within rtol 1e-5 (measured 6.1e-8 and 1.3e-7), the head
  maps' gradients within 1e-5 relative L2 (measured 5.4e-8 and 2.6e-7);
* `voxelnet_predict` on the same maps within 1e-6 / 1e-4;
* one train step (anchor3d) against JAX's `make_train_step`: the rules of
  tests/test_torch_train_step.py (loss terms rtol 2e-4, gradients 2e-2
  relative L2 a parameter and 2e-3 for the whole vector, BatchNorm
  statistics atol 1e-5, the parameters after the update within what the
  two gradients explain + 2e-6);
* `lidar_synth` equals JAX's `_points_synth`; `KittiLidarSource`'s batches
  equal JAX's for one seed, without and with a GT database, in the first
  epoch (in the next JAX augments its infos' boxes again); the GT
  database equals JAX's `create_gt_database`, files and entries;
* `tools.test` runs the synthetic evaluation and `tools.train` trains on a
  KITTI tree (with and without `--with-gt-db`), both in process.
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from dfm_tpu.data import dbsampler as JDB
from dfm_tpu.data.kitti import KittiDataset as JKittiDataset
from dfm_tpu.models.detectors.dynamic_voxelnet import \
    DynamicVoxelNet as JDynamicVoxelNet
from dfm_tpu.models.detectors.teacher import voxelize_mean as j_voxelize
from dfm_tpu.models.detectors.voxelnet import VoxelNet as JVoxelNet
from dfm_tpu.models.detectors.voxelnet import VoxelNetConfig as JConfig
from dfm_tpu.models.detectors.voxelnet import voxelnet_loss as j_loss
from dfm_tpu.models.detectors.voxelnet import voxelnet_predict as j_predict
from dfm_tpu.runtime.adapters import _points_synth as j_points_synth
from dfm_tpu.runtime.config import load_config as j_load_config
from dfm_tpu.runtime.config import merge_options as j_merge_options
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.data import dbsampler as DB
from dfm_tpu_torch.models.detectors.dynamic_voxelnet import (
    DynamicVoxelNet, DynamicVoxelNetConfig)
from dfm_tpu_torch.models.detectors.teacher import voxelize_mean
from dfm_tpu_torch.models.detectors.voxelnet import (VoxelNet,
                                                     VoxelNetConfig,
                                                     voxelnet_loss,
                                                     voxelnet_predict)
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.runtime.config import load_config, merge_options
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.tools import create_data
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W
from tools.train import KittiLidarSource as JKittiLidarSource

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL, LOSS_RTOL,
                                   LR, PARAM_ATOL, STATS_ATOL, RecordGrads,
                                   random_variables)

torch.set_num_threads(1)    # from import on; the workers share the cores

B, G, P = 2, 6, 700
TINY = dict(
    point_cloud_range=(0, -8, -2, 16, 8, 1.2), voxel_size=(0.4, 0.4, 0.4),
    max_points_per_voxel=5, cv_channels=8, bev_channels=16,
    anchor_ranges=((0, -8, -0.6, 16, 8, -0.6), (0, -8, -0.6, 16, 8, -0.6),
                   (0, -8, -1.78, 16, 8, -1.78)),
    anchor_sizes=((0.8, 0.6, 1.73), (1.76, 0.6, 1.73), (3.9, 1.6, 1.56)),
    anchor_rotations=(0.0, 1.57),
    assigner_cfgs=(dict(pos_iou_thr=0.35, neg_iou_thr=0.2, min_pos_iou=0.2),
                   dict(pos_iou_thr=0.35, neg_iou_thr=0.2, min_pos_iou=0.2),
                   dict(pos_iou_thr=0.6, neg_iou_thr=0.45, min_pos_iou=0.45)),
    nms_pre=256, max_num=30, score_thr=0.05, pre_anchor_topk=12)
GRID_YX = (40, 40)
OUT_REL = 1e-4
TERM_RTOL = 1e-5
MAP_GRAD_REL = 1e-5
CLI_TINY = [f'model.{k}={v!r}'.replace(' ', '') for k, v in TINY.items()
            if k in ('point_cloud_range', 'voxel_size', 'cv_channels',
                     'bev_channels', 'anchor_ranges')]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def batch_of(seed=0):
    """Points uniform in the range plus dense clusters (voxels of more
    than 5 points), a few masked or outside; GT boxes on anchors of each
    class and a padded row."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array(TINY['point_cloud_range'][:3]), \
        np.array(TINY['point_cloud_range'][3:])
    pts = rng.uniform(lo - 0.5, hi + 0.5, (B, P, 3))
    for b in range(B):
        for c in range(8):
            ctr = rng.uniform(lo + 1, hi - 1)
            pts[b, 300 + 40 * c:340 + 40 * c] = ctr + 0.05 * rng.randn(40, 3)
    mask = rng.rand(B, P) > 0.05
    grid = VoxelNetConfig(**TINY).anchor_generator().grid_anchors(GRID_YX)
    boxes = np.zeros((B, G, 7), np.float32)
    labels = np.zeros((B, G), np.int64)
    gmask = np.zeros((B, G), bool)
    picks = [[(2, 10, 12, 0), (0, 20, 5, 1), (1, 30, 30, 0)],
             [(2, 25, 20, 1), (2, 8, 33, 0)]]
    for b, rows in enumerate(picks):
        for g, (c, iy, ix, r) in enumerate(rows):
            boxes[b, g] = grid[0, iy, ix, c, r]
            labels[b, g] = c
            gmask[b, g] = True
    boxes[0, 4] = (6.0, 1.0, -1.0, 4.0, 1.7, 1.5, 0.2)       # padded row
    return dict(points=pts.astype(np.float32), point_mask=mask,
                gt_boxes=boxes, gt_labels=labels, gt_mask=gmask)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def models():
    jcfg = JConfig(**TINY)
    batch = batch_of()
    jm = JVoxelNet(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['points'], batch['point_mask']))
    variables = random_variables(shapes, 1)
    sd = W.state_dict_from_jax(variables, W.voxelnet_key_map())
    return dict(jcfg=jcfg, jm=jm, variables=variables, sd=sd, batch=batch)


def port_model(models, cls=VoxelNet, cfg_cls=VoxelNetConfig, sd=None,
               **opts):
    port = cls(cfg_cls(**dict(TINY, **opts)))
    port.load_state_dict(models['sd'] if sd is None else sd, strict=True)
    return port


def jax_forward(models, train, jm=None, variables=None):
    jm = jm or models['jm']
    v = variables or models['variables']
    b = models['batch']

    def f(v, p, m):
        if train:
            return jm.apply(v, p, m, train=True, mutable=['batch_stats'])
        return jm.apply(v, p, m, train=False), {}
    out, upd = jax.jit(f)(v, b['points'], b['point_mask'])
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, upd)


def test_voxelize_cap_matches_jax():
    b = batch_of(2)
    gs = (8, 40, 40)
    for p, m in zip(b['points'], b['point_mask']):
        for cap in (5, None):
            jm_, jc = j_voxelize(jnp.asarray(p), jnp.asarray(m),
                                 TINY['point_cloud_range'],
                                 TINY['voxel_size'], gs, max_points=cap)
            gm, gc = voxelize_mean(t(p), t(m), TINY['point_cloud_range'],
                                   TINY['voxel_size'], gs, cap)
            np.testing.assert_array_equal(gc.numpy(), np.asarray(jc))
            np.testing.assert_allclose(gm.numpy(), np.asarray(jm_),
                                       atol=1e-6)
            if cap:
                assert gc.max() == cap and (np.asarray(jc) > 0).sum() > 100


def test_key_map_takes_every_leaf(models):
    n_leaves = len(jax.tree.leaves(models['variables']))
    assert len(models['sd']) == n_leaves
    assert set(models['sd']) == set(VoxelNet(VoxelNetConfig(
        **TINY)).state_dict())


@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_jax(models, train):
    want, upd = jax_forward(models, train)
    port = port_model(models).train(train)
    b = models['batch']
    got = port(t(b['points']), t(b['point_mask']))
    for k in ('cls_score', 'bbox_pred', 'dir_pred', 'volume_feat',
              'bev_feat'):
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].detach().numpy(), want[k]) <= OUT_REL, k
    if train:
        stats = W.state_dict_from_jax(
            {'params': models['variables']['params'],
             'batch_stats': upd['batch_stats']}, W.voxelnet_key_map())
        for k, v in port.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           atol=STATS_ATOL, err_msg=k)


def test_dynamic_voxelnet_matches_jax(models):
    jcfg = JConfig(**dict(TINY, max_points_per_voxel=None))
    jm = JDynamicVoxelNet(cfg=jcfg)
    v = {'params': {'voxelnet': models['variables']['params']},
         'batch_stats': {'voxelnet': models['variables']['batch_stats']}}
    want, _ = jax_forward(models, False, jm, v)
    sd = W.state_dict_from_jax(v, W.dynamic_voxelnet_key_map())
    port = port_model(models, DynamicVoxelNet, DynamicVoxelNetConfig, sd,
                      max_points_per_voxel=None).eval()
    b = models['batch']
    got = port(t(b['points']), t(b['point_mask']))
    for k in ('cls_score', 'bbox_pred', 'dir_pred', 'volume_feat'):
        assert rel(got[k].detach().numpy(), want[k]) <= OUT_REL, k
    capped, _ = jax_forward(models, False)
    assert rel(want['volume_feat'], capped['volume_feat']) > 1e-5


@pytest.mark.parametrize('head', ['anchor3d', 'free_anchor'])
def test_loss_matches_jax(models, head):
    """Both losses on JAX's head maps; the maps' gradients too."""
    out, _ = jax_forward(models, False)
    b = models['batch']
    jcfg = JConfig(**dict(TINY, bbox_head=head))
    keys = ('cls_score', 'bbox_pred', 'dir_pred')
    jbatch = {k: jnp.asarray(b[k]) for k in ('gt_boxes', 'gt_labels',
                                             'gt_mask')}

    def jl(maps):
        return j_loss(dict(zip(keys, maps)), jbatch, jcfg)

    (jtotal, jterms), jgrads = jax.jit(jax.value_and_grad(
        jl, has_aux=True))(tuple(jnp.asarray(out[k]) for k in keys))
    maps = [t(out[k]).requires_grad_() for k in keys]
    total, terms = voxelnet_loss(dict(zip(keys, maps)), {
        k: t(b[k]) for k in ('gt_boxes', 'gt_labels', 'gt_mask')},
        VoxelNetConfig(**dict(TINY, bbox_head=head)))
    assert set(terms) == set(jterms)
    for k in terms:
        assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    total.backward()
    for m, g in zip(maps, jgrads):
        assert rel(m.grad.numpy(), np.asarray(g)) <= MAP_GRAD_REL


def test_predict_matches_jax(models):
    out, _ = jax_forward(models, False)
    keys = ('cls_score', 'bbox_pred', 'dir_pred')
    out = dict(out, cls_score=out['cls_score'] + 2.0)    # live scores
    jcfg = models['jcfg']
    want = jax.tree.map(np.asarray, jax.jit(lambda o: j_predict(o, jcfg))(
        {k: jnp.asarray(out[k]) for k in keys}))
    got = voxelnet_predict({k: t(out[k]) for k in keys},
                           VoxelNetConfig(**TINY))
    assert int(want['mask'].sum()) > 0
    for key in ('boxes3d', 'scores', 'labels', 'mask'):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-6,
                                   rtol=1e-4, err_msg=key)


def test_train_step_matches_jax(models):
    b = models['batch']
    tx = optax.chain(RecordGrads.make(),
                     jax_make_optimizer(jax_schedule(**LR)))
    state = create_train_state(models['variables'], tx)
    jcfg = models['jcfg']
    step = make_train_step(models['jm'], lambda o, bt, r: j_loss(o, bt, jcfg),
                           donate=False,
                           model_args_fn=lambda bt: (bt['points'],
                                                     bt['point_mask']))
    jbatch = jax.tree.map(jnp.asarray, b)
    key = jax.random.PRNGKey(0)
    new, metrics = step.lower(state, jbatch, key).compile(
        compiler_options=FAST_COMPILE)(state, jbatch, key)
    key_map = W.voxelnet_key_map()
    jgrads = W.state_dict_from_jax({'params': jax.device_get(
        new.opt_state[0])}, key_map)
    after = W.state_dict_from_jax(jax.device_get(
        {'params': new.params, 'batch_stats': new.batch_stats}), key_map)
    port = port_model(models)
    ts = TrainStep(port, make_optimizer(port), liga_schedule(**LR))
    pts, mask, gt = lidar_to_device(b, 'cpu')
    with torch.backends.mkldnn.flags(enabled=False):
        total, losses = ts.forward(pts, mask, gt)
        ts.backward(total)
    ts.reduce()
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    norm = float(ts.update())
    got = dict(loss=float(total), grad_norm=norm,
               **{k: float(v) for k, v in losses.items()})
    for k, v in got.items():
        np.testing.assert_allclose(v, float(metrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    bad, fg, fw = {}, [], []
    for n, g in grads.items():
        want = jgrads[n].numpy()
        if rel(g.numpy(), want) > GRAD_REL_L2:
            bad[n] = rel(g.numpy(), want)
        fg.append(g.numpy().ravel())
        fw.append(want.ravel())
    assert not bad, bad
    assert rel(np.concatenate(fg), np.concatenate(fw)) <= GRAD_REL_L2_ALL
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / norm)
    clip_jax = min(1.0, 35.0 / float(metrics['grad_norm']))
    for n, v in port.state_dict().items():
        want = after[n].numpy()
        if n.endswith(('running_mean', 'running_var')):
            atol = STATS_ATOL
        else:
            g = grads[n].numpy().astype(np.float64) * clip
            gw = jgrads[n].numpy().astype(np.float64) * clip_jax
            atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                                gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        assert (np.abs(v.numpy() - want) <= atol).all(), n


def test_synthetic_batch_matches_jax():
    jcfg = JConfig(**TINY)
    want = j_points_synth(types.SimpleNamespace(cfg=jcfg), 2, 7)
    got = lidar_synth(VoxelNetConfig(**TINY), 2, 7)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
    """A KITTI tree (chip_smoke's five frames with velodyne points) with
    the port's infos; a copy with the GT database."""
    root = str(tmp_path_factory.mktemp('kitti_lidar'))
    chip_smoke.write_kitti_tree(root)
    assert create_data.main(['kitti', '--root', root, '--splits',
                             'train']) == 0
    db_root = str(tmp_path_factory.mktemp('kitti_lidar_db'))
    chip_smoke.write_kitti_tree(db_root)
    assert create_data.main(['kitti', '--root', db_root, '--splits',
                             'train', '--with-gt-db']) == 0
    return root, db_root


def test_gt_database_matches_jax(kitti, tmp_path):
    _, db_root = kitti
    with open(os.path.join(db_root, 'kitti_infos_train.pkl'), 'rb') as f:
        infos = pickle.load(f)
    jds = JKittiDataset(db_root, infos, train=True)
    out = str(tmp_path)
    j_path = JDB.create_gt_database(infos, db_root, out, jds._load_points_pl)
    with open(j_path, 'rb') as f:
        want = pickle.load(f)
    with open(os.path.join(db_root, 'dfm_gt_database_infos.pkl'), 'rb') as f:
        got = pickle.load(f)
    assert set(got) == set(want) and sum(map(len, got.values())) > 5
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            with open(os.path.join(db_root, g['path']), 'rb') as f, \
                    open(os.path.join(out, w['path']), 'rb') as h:
                assert f.read() == h.read()
    assert max(e['num_points_in_gt'] for v in got.values() for e in v) > 0


def _sources(root, seed, batch_size):
    opts = [f'data.data_root={root}', 'data.max_points=3000',
            'data.max_gt=12']
    cfg = 'configs/hv_second_kitti_3class.py'
    port = train_cli.KittiLidarSource(
        merge_options(load_config(cfg), opts), batch_size)
    jax_src = JKittiLidarSource(j_merge_options(j_load_config(cfg), opts),
                                batch_size)
    return port, jax_src


@pytest.mark.parametrize('with_db', [False, True])
def test_kitti_lidar_source_matches_jax(kitti, with_db):
    root = kitti[1] if with_db else kitti[0]
    port, jsrc = _sources(root, 0, 2)
    assert (port.sampler is not None) == with_db == \
        (jsrc.sampler is not None)
    prng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    n = len(port)
    steps = n // 2                  # the first epoch: each frame once
    pasted = 0
    for s in range(steps):
        got = port.next_samples(s, prng)
        want = jax.tree.map(np.asarray, jsrc.next_batch(s, jrng))
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(s, k))
        pasted += int(got['gt_mask'].sum())
    assert prng.random() == jrng.random()      # the same draws taken
    if with_db:
        # pasted objects on top of the frames' own (two or three each)
        assert pasted > 3 * 2 * steps


def test_tools_test_and_train_lidar(kitti, tmp_path, capsys):
    root, db_root = kitti
    cfg = 'configs/hv_second_kitti_3class.py'
    rc = test_cli.main([cfg, '--device', 'cpu', '--dtype', 'float32',
                        '--cfg-options', f'data.data_root={root}'] +
                       CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert 'running the synthetic evaluation' in out
    assert '[synthetic-eval] VoxelNet: decoded 5 output arrays, ' \
        'finite=True' in out
    for data_root, tag in ((root, 'plain'), (db_root, 'db')):
        work = str(tmp_path / tag)
        rc = train_cli.main([cfg, '--device', 'cpu', '--work-dir', work,
                             '--max-steps', '2', '--cfg-options',
                             f'data.data_root={data_root}',
                             'data.batch_size_per_chip=2',
                             'data.max_points=3000'] + CLI_TINY)
        out = capsys.readouterr().out
        assert rc == 0
        assert 'step 2/2' in out and 'loss_cls=' in out, out
        assert ('ObjectSample GT database' in out) == (tag == 'db')
    rc = train_cli.main(['configs/hv_second_kitti_3class_freeanchor.py',
                         '--device', 'cpu', '--synthetic', '--work-dir',
                         str(tmp_path / 'fa'), '--max-steps', '1',
                         '--cfg-options'] + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'positive_bag_loss=' in out, out
