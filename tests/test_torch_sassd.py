"""SA-SSD against the JAX package, on the CPU at VoxelNet's tiny grid
(tests/test_torch_voxelnet.py's TINY: 8 x 40 x 40, volume 8, BEV 16).

* the auxiliary branch's trilinear sample of the volume at points on and
  past every face of the range, with a volume of two z slices and of one
  (the `z0` clamp: the one slice read twice): `point_fc`'s output within
  1e-4 relative L2 (measured 4.0e-7 and 3.8e-7);
* SASSD's forward, eval and train mode: every output within 1e-4
  relative L2 (measured 1.3e-6 / 5.4e-6); the key map takes every leaf;
* the two auxiliary terms (foreground points, centre offsets) and the
  whole `sassd_loss` on JAX's outputs: every term within rtol 1e-5
  (measured 1.5e-7), the outputs' gradients within 1e-5 relative L2
  (measured 5.6e-8); `sassd_predict` equals VoxelNet's decode;
* one training step against JAX's `make_train_step` (the rules of
  tests/test_torch_train_step.py; measured worst parameter 3.1e-3, whole
  vector 1.5e-4);
* `lidar_synth` equals JAX's `_points_synth`; `tools.test --synthetic`
  and `tools.train` on a KITTI velodyne tree, in process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.sassd as JS
from dfm_tpu.runtime.adapters import _points_synth as j_points_synth
from dfm_tpu_torch.models.detectors.sassd import (SASSD, SASSDConfig,
                                                  sassd_loss, sassd_predict)
from dfm_tpu_torch.models.detectors.voxelnet import voxelnet_predict
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import STATS_ATOL, random_variables
from test_torch_voxelnet import CLI_TINY, TINY
from torch_lidar_common import (boxes_on_points, check_step, cloud,
                                jax_apply, rel, t)

torch.set_num_threads(1)    # from import on; the workers share the cores

B, P, G = 2, 700, 5
OUT_REL = 1e-4
TERM_RTOL = 1e-5
MAP_GRAD_REL = 1e-5
CONFIG = 'configs/sassd_kitti_3class.py'
AUX = ('point_cls', 'point_reg')


def batch_of(seed=0):
    pts, mask = cloud(B, P, seed, TINY['point_cloud_range'])
    # points on and past every face of the range
    lo = np.array(TINY['point_cloud_range'][:3], np.float32)
    hi = np.array(TINY['point_cloud_range'][3:], np.float32)
    edge = np.stack(np.meshgrid(*[(a - 0.3, a, (a + b) / 2, b, b + 0.3)
                                  for a, b in zip(lo, hi)],
                                indexing='ij'), -1).reshape(-1, 3)
    pts[:, :len(edge)] = edge
    boxes, labels, gmask = boxes_on_points(pts, G, seed)
    return dict(points=pts, point_mask=mask, gt_boxes=boxes,
                gt_labels=labels, gt_mask=gmask)


def make(opts=()):
    opts = dict(TINY, **dict(opts))
    jcfg = JS.SASSDConfig(**opts)
    batch = batch_of()
    jm = JS.SASSD(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['points'], batch['point_mask']))
    variables = random_variables(shapes, 1)
    sd = W.state_dict_from_jax(variables, W.sassd_key_map())
    return dict(jcfg=jcfg, cfg=SASSDConfig(**opts), jm=jm,
                variables=variables, sd=sd, batch=batch)


@pytest.fixture(scope='module')
def models():
    return make()


def jax_outputs(m, train=False):
    """JAX's forward of model `m` (compiled once a mode a module)."""
    if ('out', train) not in m:
        b = m['batch']
        m[('out', train)] = jax_apply(m['jm'], m['variables'],
                                      [b['points'], b['point_mask']], train)
    return m[('out', train)]


def port_model(m):
    port = SASSD(m['cfg'])
    port.load_state_dict(m['sd'], strict=True)
    return port


def test_key_map_takes_every_leaf(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    assert set(models['sd']) == set(SASSD(models['cfg']).state_dict())


@pytest.mark.parametrize('one_slice', [False, True])
def test_aux_sample_at_clamped_edges(one_slice):
    m = make(dict(voxel_size=(0.4, 0.4, 0.8)) if one_slice else {})
    b = m['batch']
    _, inter = jax.jit(lambda v, p, k: m['jm'].apply(
        v, p, k, train=False, capture_intermediates=lambda mdl, name:
        mdl.name == 'point_fc', mutable=['intermediates']))(
            m['variables'], b['points'], b['point_mask'])
    want = np.asarray(inter['intermediates']['point_fc']['__call__'][0])
    port = port_model(m).eval()
    seen = {}
    port.point_fc.register_forward_hook(
        lambda mod, i, o: seen.setdefault('out', o.detach()))
    with torch.no_grad():
        out = port(t(b['points']), t(b['point_mask']))
    assert out['volume_feat'].shape[1] == (1 if one_slice else 2)
    assert rel(seen['out'].numpy(), want) <= OUT_REL


@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_jax(models, train):
    b = models['batch']
    want, upd = jax_outputs(models, train)
    port = port_model(models).train(train)
    got = port(t(b['points']), t(b['point_mask']))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].detach().numpy(), want[k]) <= OUT_REL, k
    if train:
        stats = W.state_dict_from_jax(
            {'params': models['variables']['params'],
             'batch_stats': upd['batch_stats']}, W.sassd_key_map())
        for k, v in port.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           atol=STATS_ATOL, err_msg=k)


def test_loss_matches_jax(models):
    b = models['batch']
    out, _ = jax_outputs(models)
    keys = ('cls_score', 'bbox_pred', 'dir_pred') + AUX
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}

    def jl(maps):
        return JS.sassd_loss(dict(zip(keys, maps)), jbatch, models['jcfg'])

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        tuple(jnp.asarray(out[k]) for k in keys))
    maps = [t(out[k]).requires_grad_() for k in keys]
    total, terms = sassd_loss(dict(zip(keys, maps)),
                              {k: t(v) for k, v in b.items()}, models['cfg'])
    assert set(terms) == set(jterms) and {'loss_aux_cls',
                                          'loss_aux_reg'} <= set(terms)
    for k in terms:
        assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    total.backward()
    for m, g in zip(maps, jgrads):
        assert rel(m.grad.numpy(), np.asarray(g)) <= MAP_GRAD_REL
    # without the aux outputs the loss is VoxelNet's
    _, base = sassd_loss({k: t(out[k]) for k in keys[:3]},
                         {k: t(v) for k, v in b.items()}, models['cfg'])
    assert set(base) == set(terms) - {'loss_aux_cls', 'loss_aux_reg'}
    live = dict(out, cls_score=out['cls_score'] + 2.0)
    got = sassd_predict({k: t(v) for k, v in live.items()}, models['cfg'])
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JS.sassd_predict(
        o, models['jcfg']))({k: jnp.asarray(live[k]) for k in keys[:3]}))
    base = voxelnet_predict({k: t(v) for k, v in live.items()},
                            models['cfg'])
    assert int(want['mask'].sum()) > 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)
        assert torch.equal(got[k], base[k])


def test_train_step_matches_jax(models):
    b = models['batch']
    jcfg = models['jcfg']
    check_step(models['jm'], lambda o, bt: JS.sassd_loss(o, bt, jcfg),
               models['variables'], W.sassd_key_map(), port_model(models),
               jax.tree.map(jnp.asarray, b),
               lambda bt: (bt['points'], bt['point_mask']),
               lidar_to_device(b, 'cpu'))


def test_synthetic_batch_matches_jax():
    jcfg = JS.SASSDConfig(**TINY)
    want = j_points_synth(types.SimpleNamespace(cfg=jcfg), 2, 5)
    got = lidar_synth(SASSDConfig(**TINY), 2, 5)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
    import chip_smoke
    from dfm_tpu_torch.tools import create_data
    root = str(tmp_path_factory.mktemp('kitti_sassd'))
    chip_smoke.write_kitti_tree(root)
    assert create_data.main(['kitti', '--root', root, '--splits',
                             'train']) == 0
    return root


def test_cli_synthetic_and_kitti_train(kitti, tmp_path, capsys):
    assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + CLI_TINY) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] SASSD: decoded 5 output arrays, finite=True' \
        in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                         str(tmp_path), '--max-steps', '2', '--cfg-options',
                         f'data.data_root={kitti}',
                         'data.batch_size_per_chip=2',
                         'data.max_points=3000'] + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'step 2/2' in out and 'loss_aux_reg=' in out, out
