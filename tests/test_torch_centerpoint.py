"""CenterPoint (SECOND + SECONDFPN + CenterHead) against the JAX package,
on the CPU at a tiny grid (4 x 40 x 40, encoder 8, SECOND (16, 32)).

* SECOND and SECONDFPN alone, eval and train mode: outputs within 1e-4
  relative L2 (measured 2.3e-7 / 1.2e-6), BatchNorm statistics atol 1e-5;
  SECONDFPN's stride-2 transposed conv (k = s = 2) gives 2n on odd and
  even maps, within 1e-4 (measured 5.1e-8 and 4.3e-8);
* the z-collapse: the port's BEV map equals JAX's z-major order (channel
  z * C + c) within 1e-4 (measured 1.6e-7), and the model's outputs with
  SECOND's input channels permuted by a seeded permutation miss the
  tolerance a hundredfold (every branch above 1e-2 relative L2; measured
  0.068 and more);
* CenterPoint's forward, eval and train mode: every branch within 1e-4
  relative L2 (measured 9.5e-7 / 2.0e-6); the key map takes every leaf;
* `centerpoint_loss`: every term within rtol 1e-5 (measured 4.3e-7), the
  head maps' gradients within 1e-5 relative L2 (measured 1.8e-7);
  `centerpoint_predict` on the same maps within 1e-6 / 1e-4;
* one training step against JAX's `make_train_step` (the rules of
  tests/test_torch_train_step.py: measured worst parameter 8.8e-6, whole
  vector 6.8e-7);
* the builder's config equals JAX's (the `head` dict a CenterHeadConfig);
  `lidar_synth` equals JAX's `_points_synth`; the CLIs in process:
  `tools.test --synthetic`, `tools.train --synthetic` and on a KITTI
  velodyne tree, and the Waymo config refused without `--synthetic`;
* JAX's `tools/test.py` route for this config on a Waymo tree raises
  (ROADMAP.md §3); the port's `tools.test` exits 2 naming why.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.centerpoint as JC
from dfm_tpu.models.backbones.second import SECOND as JSECOND
from dfm_tpu.models.heads.center_head import \
    CenterHeadConfig as JHeadConfig
from dfm_tpu.models.necks.second_fpn import SECONDFPN as JSECONDFPN
from dfm_tpu.runtime.adapters import _points_synth as j_points_synth
from dfm_tpu_torch.models.backbones.second import SECOND
from dfm_tpu_torch.models.builder import build_detector
from dfm_tpu_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig, centerpoint_loss, centerpoint_predict)
from dfm_tpu_torch.models.heads.center_head import CenterHeadConfig
from dfm_tpu_torch.models.necks.second_fpn import SECONDFPN
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import STATS_ATOL, random_variables
from torch_lidar_common import (RANGE, boxes_on_points, check_step, cloud,
                                jax_apply, rel, t)

torch.set_num_threads(1)    # from import on; the workers share the cores

B, P, G = 2, 700, 5
OUT_REL = 1e-4
TERM_RTOL = 1e-5
MAP_GRAD_REL = 1e-5
HEAD = dict(share_conv_channel=16, head_conv=16, voxel_size=(0.4, 0.4),
            pc_range=(0.0, -8.0), max_per_task=20, score_thr=0.1)
TINY = dict(point_cloud_range=RANGE, voxel_size=(0.4, 0.4, 0.8),
            max_points_per_voxel=5, encoder_channels=8,
            second_channels=(16, 32), second_layers=(1, 1),
            fpn_channels=(16, 16))
CONFIG = 'configs/centerpoint_second_waymo.py'
CLI_TINY = ['model.point_cloud_range=(0,-8,-2,16,8,1.2)',
            'model.voxel_size=(0.4,0.4,0.8)', 'model.encoder_channels=8',
            'model.second_channels=(16,32)', 'model.second_layers=(1,1)',
            'model.fpn_channels=(16,16)', 'model.head.voxel_size=(0.4,0.4)',
            'model.head.pc_range=(0.0,-8.0)']


def configs():
    return (JC.CenterPointConfig(**TINY, head=JHeadConfig(**HEAD)),
            CenterPointConfig(**TINY, head=CenterHeadConfig(**HEAD)))


def batch_of(seed=0):
    pts, mask = cloud(B, P, seed)
    boxes, labels, gmask = boxes_on_points(pts, G, seed)
    return dict(points=pts, point_mask=mask, gt_boxes=boxes,
                gt_labels=labels, gt_mask=gmask)


@pytest.fixture(scope='module')
def models():
    jcfg, cfg = configs()
    batch = batch_of()
    jm = JC.CenterPoint(cfg=jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), batch['points'], batch['point_mask']))
    variables = random_variables(shapes, 1)
    key_map = W.centerpoint_key_map(cfg)
    sd = W.state_dict_from_jax(variables, key_map)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables, sd=sd,
                key_map=key_map, batch=batch)


def jax_outputs(models, train=False):
    """JAX's forward of the tiny model (compiled once a mode a module)."""
    if ('out', train) not in models:
        b = models['batch']
        models[('out', train)] = jax_apply(
            models['jm'], models['variables'],
            [b['points'], b['point_mask']], train)
    return models[('out', train)]


def port_model(models):
    port = CenterPoint(models['cfg'])
    port.load_state_dict(models['sd'], strict=True)
    return port


def flat(task_outs):
    return {f'{i}/{k}': v for i, d in enumerate(task_outs)
            for k, v in d.items()}


def test_key_map_takes_every_leaf(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    assert set(models['sd']) == set(CenterPoint(models['cfg']).state_dict())


@pytest.mark.parametrize('train', [False, True])
def test_second_and_fpn_match_jax(train):
    x = np.random.RandomState(3).randn(2, 12, 10, 24).astype(np.float32)
    jb = JSECOND(out_channels=(16, 32), layer_nums=(2, 1),
                 layer_strides=(1, 2))
    jn = JSECONDFPN(out_channels=(8, 8), upsample_strides=(1, 2))
    vb = random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), x)), 2)
    feats = jb.apply(vb, x)
    vn = random_variables(jax.eval_shape(lambda: jn.init(
        jax.random.PRNGKey(0), feats)), 3)
    (jfeats, ubs), (jout, uns) = (
        jax_apply(jb, vb, [x], train),
        jax_apply(jn, vn, [[np.asarray(f) for f in feats]], train))
    cfg = CenterPointConfig(second_layers=(2, 1), fpn_strides=(1, 2))
    km = [e for e in W.centerpoint_key_map(cfg)
          if e[0].startswith(('backbone', 'neck'))]
    sd = W.state_dict_from_jax({'params': {'backbone': vb['params'],
                                           'neck': vn['params']},
                                'batch_stats': {'backbone': vb['batch_stats'],
                                                'neck': vn['batch_stats']}},
                               km)
    back = SECOND(24, (16, 32), (2, 1), (1, 2)).train(train)
    neck = SECONDFPN((16, 32), (8, 8), (1, 2)).train(train)
    back.load_state_dict({k[9:]: v for k, v in sd.items()
                          if k.startswith('backbone.')})
    neck.load_state_dict({k[5:]: v for k, v in sd.items()
                          if k.startswith('neck.')})
    xt = t(x).permute(0, 3, 1, 2)
    got = back(xt)
    for g, w in zip(got, jfeats):
        assert rel(g.detach().permute(0, 2, 3, 1).numpy(), w) <= OUT_REL
    # the neck on JAX's features, so that train mode sees the same input
    out = neck([t(f).permute(0, 3, 1, 2) for f in jax.tree.map(
        np.asarray, feats)])
    assert out.shape == (2, 16, 12, 10)
    assert rel(out.detach().permute(0, 2, 3, 1).numpy(), jout) <= OUT_REL
    if train:
        want = W.state_dict_from_jax({'params': {'neck': vn['params']},
                                      'batch_stats': {'neck': uns[
                                          'batch_stats']}},
                                     [e for e in km if e[0][:4] == 'neck'])
        for k, v in neck.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), want['neck.' + k],
                                           atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize('hw', [(7, 9), (8, 6)])
def test_fpn_transposed_conv_doubles_odd_and_even(hw):
    x = np.random.RandomState(4).randn(1, *hw, 6).astype(np.float32)
    jn = JSECONDFPN(out_channels=(5,), upsample_strides=(2,))
    v = random_variables(jax.eval_shape(lambda: jn.init(
        jax.random.PRNGKey(0), [x])), 5)
    want, _ = jax_apply(jn, v, [[x]], False)
    km = [('neck.deblock0.conv', ('neck', 'deblock0_conv'), 'convt2d'),
          ('neck.deblock0.bn', ('neck', 'BatchNorm_0'), 'bn')]
    sd = W.state_dict_from_jax({'params': {'neck': v['params']},
                                'batch_stats': {'neck': v['batch_stats']}},
                               km)
    neck = SECONDFPN((6,), (5,), (2,)).eval()
    neck.load_state_dict({k[5:]: val for k, val in sd.items()})
    got = neck([t(x).permute(0, 3, 1, 2)]).permute(0, 2, 3, 1).detach()
    assert got.shape == (1, 2 * hw[0], 2 * hw[1], 5) == want.shape
    assert rel(got.numpy(), want) <= OUT_REL


def test_z_collapse_order(models):
    """The BEV map against JAX's enc1 output collapsed z-major; a seeded
    permutation of SECOND's input channels must break the outputs."""
    b = models['batch']
    jcfg = models['jcfg']
    _, inter = jax.jit(lambda v, p, m: models['jm'].apply(
        v, p, m, train=False, capture_intermediates=lambda mdl, name:
        mdl.name == 'enc1', mutable=['intermediates']))(
            models['variables'], b['points'], b['point_mask'])
    enc1 = np.asarray(inter['intermediates']['enc1']['__call__'][0])
    bb, nz, ny, nx, c = enc1.shape
    want = enc1.transpose(0, 2, 3, 1, 4).reshape(bb, ny, nx, nz * c)
    port = port_model(models).eval()
    with torch.no_grad():
        got = port.bev(port.voxelize(t(b['points']), t(b['point_mask'])))
    assert nz == jcfg.grid_size[0] > 1
    assert rel(got.permute(0, 2, 3, 1).numpy(), want) <= OUT_REL
    jout, _ = jax_outputs(models)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(nz * c))
    sd = dict(models['sd'])
    k = 'backbone.stage0_conv0.conv.weight'
    sd[k] = sd[k][:, perm]
    bad = CenterPoint(models['cfg'])
    bad.load_state_dict(sd)
    with torch.no_grad():
        out = flat(bad.eval()(t(b['points']), t(b['point_mask'])))
    gaps = [rel(v.numpy(), flat(jout)[k]) for k, v in out.items()]
    assert min(gaps) > 100 * OUT_REL, gaps


@pytest.mark.parametrize('train', [False, True])
def test_forward_matches_jax(models, train):
    b = models['batch']
    want, upd = jax_outputs(models, train)
    port = port_model(models).train(train)
    got = flat(port(t(b['points']), t(b['point_mask'])))
    want = flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].detach().numpy(), want[k]) <= OUT_REL, k
    if train:
        stats = W.state_dict_from_jax(
            {'params': models['variables']['params'],
             'batch_stats': upd['batch_stats']}, models['key_map'])
        for k, v in port.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                           atol=STATS_ATOL, err_msg=k)


def test_loss_and_predict_match_jax(models):
    b = models['batch']
    out, _ = jax_outputs(models)
    names = [list(d) for d in out]
    jbatch = {k: jnp.asarray(b[k]) for k in ('gt_boxes', 'gt_labels',
                                             'gt_mask')}

    def jl(maps):
        outs = [dict(zip(n, m)) for n, m in zip(names, maps)]
        losses = JC.centerpoint_loss(outs, jbatch, models['jcfg'])
        return sum(losses.values()), losses

    maps = [tuple(jnp.asarray(d[k]) for k in n) for d, n in zip(out, names)]
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jl, has_aux=True))(maps)
    tmaps = [[t(d[k]).requires_grad_() for k in n] for d, n in
             zip(out, names)]
    terms = centerpoint_loss([dict(zip(n, m)) for n, m in zip(names, tmaps)],
                             {k: t(b[k]) for k in ('gt_boxes', 'gt_labels',
                                                   'gt_mask')},
                             models['cfg'])
    assert set(terms) == set(jterms) and len(terms) == 4
    for k in terms:
        assert float(jterms[k]) > 0, k
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    sum(terms.values()).backward()
    for tm, jg in zip(tmaps, jgrads):
        for m, g in zip(tm, jg):
            assert rel(m.grad.numpy(), np.asarray(g)) <= MAP_GRAD_REL
    # live heatmaps: a few peaks above the threshold
    live = [dict(d, heatmap=d['heatmap'] + 3.0 * (np.arange(
        d['heatmap'].size).reshape(d['heatmap'].shape) % 97 == 0))
        for d in out]
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JC.centerpoint_predict(
        o, models['jcfg']))(jax.tree.map(jnp.asarray, live)))
    got = centerpoint_predict([{k: t(v) for k, v in d.items()}
                               for d in live], models['cfg'])
    assert set(got) == set(want) and (want['scores_3d'] > 0).sum() > 2
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)


def test_train_step_matches_jax(models):
    b = models['batch']
    jcfg = models['jcfg']

    def j_loss(o, bt):
        losses = JC.centerpoint_loss(o, bt, jcfg)
        return sum(losses.values()), losses

    check_step(models['jm'], j_loss, models['variables'], models['key_map'],
               port_model(models), jax.tree.map(jnp.asarray, b),
               lambda bt: (bt['points'], bt['point_mask']),
               lidar_to_device(b, 'cpu'))


def test_builder_and_synthetic_batch_match_jax():
    from dfm_tpu.models.builder import build_detector as j_build
    from dfm_tpu.runtime.config import load_config as j_load
    from dfm_tpu_torch.runtime.config import load_config
    cfg = build_detector(load_config(CONFIG).model)
    jcfg = j_build(j_load(CONFIG).model.to_dict()).cfg
    assert isinstance(cfg.head, CenterHeadConfig)
    assert dataclass_dict(cfg) == dataclass_dict(jcfg)
    want = j_points_synth(types.SimpleNamespace(cfg=jcfg), 2, 7)
    got = lidar_synth(cfg, 2, 7)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def dataclass_dict(cfg):
    import dataclasses
    return {f.name: dataclass_dict(getattr(cfg, f.name))
            if dataclasses.is_dataclass(getattr(cfg, f.name))
            else getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_cli_synthetic_and_train(tmp_path, capsys):
    assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + CLI_TINY) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] CenterPoint: decoded 3 output arrays, ' \
        'finite=True' in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--synthetic',
                         '--work-dir', str(tmp_path / 'w'), '--max-steps',
                         '2', '--cfg-options',
                         'data.batch_size_per_chip=2'] + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'step 2/2' in out and 'task1_loss_heatmap=' in out, \
        out
    # the Waymo config has no train source: --synthetic only
    assert train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                           str(tmp_path / 'n')]) == 2
    assert '--synthetic' in capsys.readouterr().err


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
    """A KITTI tree with velodyne points and the port's train infos."""
    import chip_smoke
    from dfm_tpu_torch.tools import create_data
    root = str(tmp_path_factory.mktemp('kitti_cp'))
    chip_smoke.write_kitti_tree(root)
    assert create_data.main(['kitti', '--root', root, '--splits',
                             'train']) == 0
    return root


def test_cli_trains_on_kitti_velodyne(kitti, tmp_path, capsys):
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                         str(tmp_path), '--max-steps', '2', '--cfg-options',
                         'data.type=KittiDataset', f'data.data_root={kitti}',
                         'data.batch_size_per_chip=2', 'data.max_points=3000']
                        + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'step 2/2' in out and 'task0_loss_bbox=' in out, out


def test_waymo_route_fails_in_jax_and_port_refuses(tmp_path, capsys):
    """JAX's `tools/test.py` sends CenterPoint on a Waymo tree to
    `waymo_real_eval`, whose LiDAR model arguments read the sample's
    'points', which `WaymoDataset` samples do not hold (ROADMAP.md §3)."""
    import contextlib
    import io

    import chip_smoke
    import tools.test as jtest
    from dfm_tpu.models import build_detector as j_build
    from dfm_tpu.runtime.adapters import get_adapter
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    root = str(tmp_path)
    chip_smoke.write_waymo_tree(root, scale=0.05)
    opts = CLI_TINY + [f'data.data_root={root}', 'data.target_hw=(32,48)']
    cfg = j_merge_options(j_load_config(CONFIG), opts)
    handle = j_build(cfg.model.to_dict())
    args = types.SimpleNamespace(checkpoint=None, max_samples=None, out=None,
                                 waymo_gt_bin=None, fuse_conv_bn=False)
    with pytest.raises(KeyError, match='points'), \
            contextlib.redirect_stdout(io.StringIO()):
        jtest.waymo_real_eval(args, cfg, handle, get_adapter(handle.type))
    assert test_cli.main([CONFIG, '--device', 'cpu', '--cfg-options']
                         + opts) == 2
    err = capsys.readouterr().err
    assert 'WaymoDataset' in err and "'points'" in err and \
        '--synthetic' in err
