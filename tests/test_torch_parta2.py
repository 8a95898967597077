"""Part-A2 (sparse U-Net + RoI-aware pooling) against the JAX package, on
the CPU at a tiny sparse grid (9 x 32 x 32, capacity 256 of ~290 occupied
voxels: the level capacities overflow; U-Net base 8, BEV 16).

* the sparse U-Net in train mode inside the model (eval mode in the
  model's forward): the bottom keys and masks equal, the features within
  1e-5 relative L2 (measured 4.3e-7), the SparseBN statistics atol 1e-5;
* both RoI pools on the same RoIs and features: 'voxel_center' (keys
  looked up by `searchsorted`) and 'points' (segment max and mean with a
  drop slot), within 1e-6 (measured 0 and 0), with occupied and empty
  cells;
* PartA2's forward ('points' pool), eval and train mode: the voxel keys,
  masks, proposal labels and masks equal, every float output within 1e-4
  relative L2 (measured 7.3e-7 / 8.1e-7); the 'voxel_center' model's
  outputs are its own pool's and head's; the key map takes every leaf;
* `parta2_loss` on JAX's outputs (RoIs near the gt boxes in half the
  slots: RCNN positives): the part and segmentation targets through
  'loss_seg' / 'loss_part' and every term within rtol 1e-5 (measured
  8.0e-8); `parta2_predict` within 1e-6 / 1e-4; the shipped config's
  100 detections of 64 RoIs, where JAX raises (ROADMAP.md §3): the port
  pads the slots past the RoIs;
* the segmentation, part and RCNN terms' normalisers follow
  `cfg.dist_norm` alike (a stand-in group whose sums double the counts);
* one training step ('points' pool) against JAX's `make_train_step` (the
  rules of tests/test_torch_train_step.py), the blob boxes moved onto the
  train-mode proposals so that 'loss_rcnn_reg' and the `roi_reg`
  gradients are live: measured worst parameter 2.7e-6, whole vector
  1.3e-6;
* `lidar_synth` equals JAX's `_points_synth`; `tools.test --synthetic`
  and `tools.train --synthetic` (exit 2 without the flag), in process.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.parta2 as JA
from dfm_tpu.runtime.adapters import _points_synth as j_points_synth
from dfm_tpu_torch.models.detectors.parta2 import (
    PartA2, PartA2Config, parta2_loss, parta2_predict,
    roi_pool_points, roi_pool_voxel_center)
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import STATS_ATOL, random_variables
from test_torch_voxelnet import TINY as VOXEL_TINY
from torch_lidar_common import (boxes_on_points, check_step, cloud,
                                gt_on_proposals, rel, t)

torch.set_num_threads(1)    # from import on; the workers share the cores

B, P, G = 2, 700, 5
OUT_REL = 1e-4
UNET_REL = 1e-5
TERM_RTOL = 1e-5
TINY = dict({k: v for k, v in VOXEL_TINY.items()
             if k not in ('voxel_size', 'max_points_per_voxel')},
            voxel_size=(0.5, 0.5, 0.4), sparse_shape=(9, 32, 32),
            voxel_capacity=256, unet_base=8, num_proposals=8, roi_grid=4,
            max_num=6)
CONFIG = 'configs/parta2_kitti_3class.py'
CLI_TINY = ['model.point_cloud_range=(0,-8,-2,16,8,1.2)',
            'model.voxel_size=(0.5,0.5,0.4)', 'model.sparse_shape=(9,32,32)',
            'model.voxel_capacity=256', 'model.unet_base=8',
            'model.bev_channels=16', 'model.num_proposals=8',
            'model.roi_grid=4', 'model.max_num=6', 'model.anchor_ranges=((0,-8,-0.6,16,8,-0.6),'
            '(0,-8,-0.6,16,8,-0.6),(0,-8,-1.78,16,8,-1.78))']
INDEX_KEYS = ('keys', 'vmask', 'prop_labels', 'prop_mask')


def batch_of(seed=0):
    """`cloud`'s points, gt boxes on its blobs and one on an anchor of the
    4 x 4 BEV map (a car: anchor positives for the RPN terms)."""
    pts, mask = cloud(B, P, seed, TINY['point_cloud_range'])
    boxes, labels, gmask = boxes_on_points(pts, G, seed)
    grid = PartA2Config(**TINY).anchor_generator().grid_anchors((4, 4))
    boxes[:, G - 2] = grid[0, 2, 1, 2, 0]
    labels[:, G - 2] = 2
    return dict(points=pts, point_mask=mask, gt_boxes=boxes,
                gt_labels=labels, gt_mask=gmask)


@pytest.fixture(scope='module')
def m():
    """The tiny PartA2 ('points' pool) on both sides, the same weights."""
    jcfg = JA.PartA2Config(**TINY)
    batch = batch_of()
    jm = JA.PartA2(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['points'], batch['point_mask']))
    variables = random_variables(shapes, 1)
    sd = W.state_dict_from_jax(variables, W.parta2_key_map())
    return dict(jcfg=jcfg, cfg=PartA2Config(**TINY), jm=jm,
                variables=variables, sd=sd, batch=batch)


def port_model(m, **opts):
    port = PartA2(dataclasses.replace(m['cfg'], **opts))
    port.load_state_dict(m['sd'], strict=True)
    return port


def jax_outputs(m, train=False):
    """JAX's forward (compiled once a mode a module): (outputs, the new
    batch_stats, in train mode also the U-Net's output (level-0
    features, bottom level))."""
    if ('out', train) not in m:
        b = m['batch']

        def f(v, p, k):
            if not train:
                return m['jm'].apply(v, p, k, train=False), {}
            return m['jm'].apply(
                v, p, k, train=True, mutable=['batch_stats', 'intermediates'],
                capture_intermediates=lambda mdl, _: mdl.name == 'unet')
        out, upd = jax.jit(f)(m['variables'], b['points'], b['point_mask'])
        m[('out', train)] = jax.tree.map(np.asarray, (out, upd))
    return m[('out', train)]


def test_key_map_takes_every_leaf(m):
    assert len(m['sd']) == len(jax.tree.leaves(m['variables']))
    assert set(m['sd']) == set(PartA2(m['cfg']).state_dict())


def test_sparse_unet_matches_jax(m):
    """The U-Net in train mode inside JAX's forward against the port's on
    the port's voxelization (keys equal: the voxelization is held to
    JAX's in tests/test_torch_sparse_teacher.py)."""
    _, upd = jax_outputs(m, True)
    x, bottom = upd['intermediates']['unet']['__call__'][0]
    b = m['batch']
    port = port_model(m).train()
    keys, feats, vmask = port.voxelize(t(b['points']), t(b['point_mask']))
    assert vmask.all()                          # the capacity overflows
    gx, gb = port.unet(keys, feats, vmask)
    assert rel(gx.detach().numpy(), x) <= UNET_REL
    np.testing.assert_array_equal(gb[0].numpy(), bottom[0])
    np.testing.assert_array_equal(gb[1].numpy(), bottom[1])
    assert tuple(gb[2]) == tuple(bottom[2])
    assert rel(gb[3].detach().numpy(), bottom[3]) <= UNET_REL
    want = W.state_dict_from_jax({'params': m['variables']['params'],
                                  'batch_stats': upd['batch_stats']},
                                 W.parta2_key_map())
    for k, val in port.unet.state_dict().items():
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(val.numpy(), want['unet.' + k].numpy(),
                                       atol=STATS_ATOL, err_msg=k)


def test_roi_pools_match_jax(m):
    """Both pools on JAX's RoIs, shifted onto the gt boxes in half the
    slots (occupied cells), with random voxel features."""
    out, _ = jax_outputs(m)
    rois = live_rois(m, out)['proposals']
    rng = np.random.RandomState(4)
    v = out['keys'].shape[1]
    seg = rng.randn(B, v, 8).astype(np.float32)
    seg_logit = rng.randn(B, v).astype(np.float32)
    part = rng.randn(B, v, 3).astype(np.float32)
    jm = m['jm']
    for pool in ('points', 'voxel_center'):
        if pool == 'points':
            want = jax.jit(lambda v, *a: jm.apply(
                v, *a, method=lambda s, *x: s._roi_pool_points(*x)))(
                    m['variables'], rois, out['voxel_xyz'], out['vmask'], seg,
                    seg_logit, part)
            got = roi_pool_points(t(rois), t(out['voxel_xyz']),
                                  t(out['vmask']), t(seg), torch.cat(
                                      [torch.sigmoid(t(part)), torch.sigmoid(
                                          t(seg_logit))[..., None]], -1), 4)
        else:
            want = jax.jit(lambda v, *a: jm.apply(
                v, *a, TINY['sparse_shape'],
                method=lambda s, *x: s._roi_pool(*x)))(
                    m['variables'], rois, out['keys'], out['vmask'], seg,
                    seg_logit, part)
            got = roi_pool_voxel_center(
                t(rois), t(out['keys']).long(), t(out['vmask']), torch.cat(
                    [t(seg), torch.sigmoid(t(seg_logit))[..., None],
                     torch.sigmoid(t(part))], -1), m['cfg'])
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, err_msg=pool)
        occupied = (np.abs(want).sum(-1) > 0).mean()
        assert 0 < occupied < 1, (pool, occupied)


@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_jax(m, train):
    b = m['batch']
    want, upd = jax_outputs(m, train)
    port = port_model(m).train(train)
    got = port(t(b['points']), t(b['point_mask']))
    assert set(got) == set(want)
    for k in want:
        g = got[k].detach().numpy()
        assert g.shape == want[k].shape, k
        if k in INDEX_KEYS:
            np.testing.assert_array_equal(g, want[k], err_msg=k)
        else:
            assert rel(g, want[k]) <= OUT_REL, k
    assert want['prop_mask'].any()
    if train:
        stats = W.state_dict_from_jax({'params': m['variables']['params'],
                                       'batch_stats': upd['batch_stats']},
                                      W.parta2_key_map())
        for k, v in port.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           atol=STATS_ATOL, err_msg=k)
    else:
        # the other pool from the same U-Net and RoIs: its own function's
        with torch.no_grad():
            vc = port_model(m, roi_pool='voxel_center').eval()
            out = vc(t(b['points']), t(b['point_mask']))
            seg = vc.unet(*vc.voxelize(t(b['points']), t(b['point_mask'])))
        np.testing.assert_array_equal(out['keys'].numpy(), want['keys'])
        pooled = vc.roi_pool(out['proposals'], out['keys'],
                             torch.cat([out['voxel_xyz'], out['voxel_xyz']],
                                       -1)[..., :3], out['vmask'], seg[0],
                             out['seg_logit'], out['part_reg'])
        rc, rr = vc.roi_head(pooled)
        assert torch.equal(rc, out['rcnn_cls']) and torch.equal(
            rr, out['rcnn_reg'])


def live_rois(m, out):
    """`out` with the first G - 1 RoI slots on the gt boxes (jittered) and
    every slot valid."""
    out = dict(out)
    rng = np.random.RandomState(3)
    props = out['proposals'].copy()
    for i in range(B):
        for j in range(G - 1):
            props[i, j] = m['batch']['gt_boxes'][i, j] + np.r_[
                rng.uniform(-0.1, 0.1, 3), 0, 0, 0, 0.05]
    out['proposals'] = props.astype(np.float32)
    out['prop_mask'] = np.ones_like(out['prop_mask'])
    return out


def test_loss_and_predict_match_jax(m):
    b = m['batch']
    out = live_rois(m, jax_outputs(m)[0])
    jterms = jax.jit(lambda o, bt: JA.parta2_loss(o, bt, m['jcfg']))(
        jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, b))[1]
    _, terms = parta2_loss({k: t(v) for k, v in out.items()},
                           {k: t(v) for k, v in b.items()}, m['cfg'])
    assert set(terms) == set(jterms)
    for k in terms:
        if k != 'rpn_loss_iou':
            assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=TERM_RTOL, atol=1e-7, err_msg=k)
    live = dict(out, rcnn_cls=out['rcnn_cls'] + 2.0)
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JA.parta2_predict(
        o, m['jcfg']))(jax.tree.map(jnp.asarray, live)))
    got = parta2_predict({k: t(v) for k, v in live.items()}, m['cfg'])
    assert int(want['mask'].sum()) > 2
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)


def test_loss_normalisers_follow_dist_norm(m, monkeypatch):
    """In a process group (a stand-in whose global sums double every
    count), the segmentation, part and RCNN terms are normalised over the
    global batch where `cfg.dist_norm` and over the local one where
    not."""
    from dfm_tpu_torch.parallel import dist as D
    out = {k: t(v) for k, v in live_rois(m, jax_outputs(m)[0]).items()}
    gt = {k: t(v) for k, v in m['batch'].items()}
    local = parta2_loss(out, gt, m['cfg'])[1]
    monkeypatch.setattr(D, 'global_sum', lambda x: 2 * x)
    halved = parta2_loss(out, gt, m['cfg'])[1]
    kept = parta2_loss(out, gt, dataclasses.replace(m['cfg'],
                                                    dist_norm=False))[1]
    for k in ('loss_seg', 'loss_part', 'loss_rcnn_cls', 'loss_rcnn_reg'):
        assert float(local[k]) > 0, k
        np.testing.assert_allclose(float(halved[k]), float(local[k]) / 2,
                                   rtol=1e-6, err_msg=k)
    for k in local:
        assert float(kept[k]) == float(local[k]), k


def test_train_step_matches_jax(m):
    """The blob boxes moved onto the train-mode forward's proposals: the
    RCNN regression term is live."""
    jcfg = m['jcfg']
    b = gt_on_proposals(m['batch'], jax_outputs(m, True)[0], range(G - 2),
                        4)
    metrics, _, _ = check_step(
        m['jm'], lambda o, bt: JA.parta2_loss(o, bt, jcfg), m['variables'],
        W.parta2_key_map(), port_model(m), jax.tree.map(jnp.asarray, b),
        lambda bt: (bt['points'], bt['point_mask']),
        lidar_to_device(b, 'cpu'), live=('roi_reg',))
    assert metrics['loss_rcnn_reg'] > 0


def test_synthetic_batch_matches_jax():
    jcfg = JA.PartA2Config(**TINY)
    want = j_points_synth(types.SimpleNamespace(cfg=jcfg), 2, 4)
    got = lidar_synth(PartA2Config(**TINY), 2, 4)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cli_synthetic_and_refusal(tmp_path, capsys):
    assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + CLI_TINY) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] PartA2: decoded 4 output arrays, finite=True' \
        in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--synthetic',
                         '--work-dir', str(tmp_path), '--max-steps', '1',
                         '--cfg-options', 'data.batch_size_per_chip=2']
                        + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'loss_part=' in out, out
    assert train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                           str(tmp_path)]) == 2
    assert '--synthetic' in capsys.readouterr().err


def test_jax_predict_raises_past_the_rois_port_pads(m):
    """The shipped config asks for 100 detections of 64 RoIs: JAX's
    `lax.top_k` raises (ROADMAP.md §3); the port leaves the slots past
    the RoIs empty and fills the rest as with `max_num` = R."""
    out = live_rois(m, jax_outputs(m)[0])
    out = dict(out, rcnn_cls=out['rcnn_cls'] + 2.0)
    r = out['rcnn_cls'].shape[1]
    big = dataclasses.replace(m['jcfg'], max_num=r + 4)
    jout = jax.tree.map(jnp.asarray, out)
    with pytest.raises(ValueError, match='top_k'):
        jax.jit(lambda o: JA.parta2_predict(o, big))(jout)
    fit = dataclasses.replace(m['jcfg'], max_num=r)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o: JA.parta2_predict(o, fit))(jout))
    got = parta2_predict({k: t(v) for k, v in out.items()},
                         dataclasses.replace(m['cfg'], max_num=r + 4))
    for k in want:
        assert got[k].shape[1] == r + 4
        np.testing.assert_allclose(got[k][:, :r].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)
    assert not got['mask'][:, r:].any() and (got['labels'][:, r:] == -1).all()
