"""ImVoxelNet in the port against the JAX package, on the CPU.

A tiny ImVoxelNet (ResNet-18, FPN width 16, a (4, 16, 16) grid over
16 x 16 x 4 m in front of one camera, 64x96 images, batch 2) with seeded
flax variables carried over by `utils/weights.py:imvoxelnet_key_map`,
torch in one thread, float32; the JAX model is compiled once for the
module (one `jit` of the forward, one of `value_and_grad`). Tolerances:

* `imvoxel_synth` against JAX's `_mv_synth` (ImVoxelNet branch) and the
  full config's sample grid: exact;
* the stages, each on the JAX stage before it: trunk + FPN level 0, the
  sampled volume, `neck_3d`'s BEV map and the head's three maps,
  relative L2 1e-5 (measured: at most 9.5e-7, trunk + FPN);
* the whole model's outputs from the images: relative L2 1e-4
  (measured: at most 1.2e-6);
* `imvoxelnet_loss` on the same head outputs and gt: every term rtol
  1e-5 (one float32 sum in another order);
* `imvoxelnet_predict` on the same head outputs, class bias raised so
  that boxes are live: atol 1e-6 + rtol 1e-4;
* one train-mode `jax.value_and_grad` step against the port's
  `forward_train` + backward on the same batch: every loss term rtol
  1e-4; the float32 gradients judged against JAX's float64 step, to
  which the port's float64 gradients are held at relative L2 1e-6
  (`test_train_step_matches_jax` says why and how).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models.backbones.resnet import ResNet as JResNet
from dfm_tpu.models.detectors.imvoxelnet import ImVoxelNet as JImVoxelNet
from dfm_tpu.models.detectors.imvoxelnet import \
    ImVoxelNetConfig as JImVoxelNetConfig
from dfm_tpu.models.detectors.imvoxelnet import imvoxelnet_loss as j_loss
from dfm_tpu.models.detectors.imvoxelnet import \
    imvoxelnet_predict as j_predict
from dfm_tpu.models.necks.fpn import FPN as JFPN
from dfm_tpu.runtime.adapters import _mv_synth as j_mv_synth
from dfm_tpu_torch.models import builder as Bld
from dfm_tpu_torch.models.detectors.imvoxelnet import (ImVoxelNet,
                                                       ImVoxelNetConfig,
                                                       imvoxelnet_loss,
                                                       imvoxelnet_predict)
from dfm_tpu_torch.runtime.adapters import imvoxel_synth, mv_to_device
from dfm_tpu_torch.runtime.config import load_config
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import carry
from test_torch_multiview_dfm import flax_variables, rel_l2

torch.set_num_threads(1)    # from import on; the workers share the cores

B, H, WID = 2, 64, 96
STAGE_TOL, MODEL_TOL = 1e-5, 1e-4
TINY = dict(feat_channels=16, voxel_range=(0.0, -8.0, -2.0, 16.0, 8.0, 2.0),
            voxel_grid=(4, 16, 16),
            anchor_ranges=((0.0, -8.0, -1.78, 16.0, 8.0, -1.78),),
            backbone_depth=18, nms_pre=128, max_num=8)
TINY_OPTS = ['model.feat_channels=16',
             "model.voxel_range=(0.0,-8.0,-2.0,16.0,8.0,2.0)",
             'model.voxel_grid=(4,16,16)',
             "model.anchor_ranges=((0.0,-8.0,-1.78,16.0,8.0,-1.78),)",
             'model.backbone_depth=18', 'data.batch_size_per_chip=2']
CONFIG = 'configs/imvoxelnet_kitti_car.py'


def jax_batch(seed, h=H, w=WID):
    handle = types.SimpleNamespace(type='ImVoxelNet',
                                   cfg=JImVoxelNetConfig(**TINY))
    return jax.tree.map(np.asarray, j_mv_synth(handle, B, seed, h, w))


@pytest.fixture(scope='module')
def models():
    jcfg = JImVoxelNetConfig(**TINY)
    jm = JImVoxelNet(cfg=jcfg)
    batch = jax_batch(0)
    imgs, l2i = batch['img'], batch['lidar2img']
    variables = flax_variables(jm, imgs, l2i, (H, WID))
    # class bias raised: live boxes for the predict test
    head = variables['params']['bbox_head']['conv_cls']
    head['bias'] = (0.5 + 0.3 * np.random.RandomState(1).randn(
        *head['bias'].shape)).astype(np.float32)
    jout = jax.tree.map(np.asarray, jax.jit(
        lambda v, i, m: jm.apply(v, i, m, (H, WID), train=False))(
        variables, imgs, l2i))

    def trunk(v, x):
        stages = JResNet(depth=18).apply(
            {k: v[k]['backbone'] for k in ('params', 'batch_stats')}, x,
            False)
        return JFPN(out_channels=16, num_outs=4).apply(
            {'params': v['params']['neck']}, stages, False)[0]

    level0 = np.asarray(jax.jit(trunk)(variables, imgs))
    port = carry(ImVoxelNet(ImVoxelNetConfig(**TINY)), variables,
                 W.imvoxelnet_key_map(18))
    with torch.no_grad():
        pout = port(torch.from_numpy(imgs.copy()), torch.from_numpy(l2i))
    return dict(jcfg=jcfg, jm=jm, variables=variables, batch=batch,
                jout=jout, level0=level0, port=port, pout=pout)


def test_config_builder_and_grid():
    """The shipped config builds `ImVoxelNetConfig` with JAX's fields and
    values; its (12, 248, 216) sample grid is JAX's bit for bit."""
    cfg = load_config(CONFIG)
    got = Bld.build_detector(cfg.model)
    assert isinstance(got, ImVoxelNetConfig)
    assert set(ImVoxelNetConfig.__dataclass_fields__) == set(
        JImVoxelNetConfig.__dataclass_fields__)
    want = JImVoxelNetConfig(**{k: v for k, v in cfg.model.to_dict().items()
                                if k != 'type'})
    for f in ImVoxelNetConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert Bld.unused_keys(cfg.model) == ['type']
    assert 'ImVoxelNet' in Bld.PORTED_TYPES
    pts = got.sample_points()
    assert pts.shape == (12, 248, 216, 3) and pts.dtype == np.float32
    np.testing.assert_array_equal(pts, want.sample_points())


@pytest.mark.parametrize('seed', [0, 5])
def test_imvoxel_synth_matches_jax(seed):
    want = jax_batch(seed, 32, 48)
    got = imvoxel_synth(ImVoxelNetConfig(**TINY), B, seed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['img'].shape == (B, 32, 48, 3)
    assert got['lidar2img'].shape == (B, 4, 4)


def test_trunk_level0(models):
    with torch.no_grad():
        got = models['port'].image_features(
            torch.from_numpy(models['batch']['img']))
    assert got.shape == (B, 16, H // 4, WID // 4)
    assert rel_l2(got.permute(0, 2, 3, 1).numpy(),
                  models['level0']) < STAGE_TOL


def test_stages_on_jax_inputs(models):
    """The volume sampled from JAX's level 0, `neck_3d` on JAX's volume
    and the head on JAX's BEV map, each against JAX's stage output."""
    jout, port = models['jout'], models['port']
    with torch.no_grad():
        vol = port.sample_volume(
            torch.from_numpy(models['level0']).permute(0, 3, 1, 2),
            torch.from_numpy(models['batch']['lidar2img']), (H, WID))
        bev = port.neck_3d(torch.from_numpy(jout['volume_feat']).permute(
            0, 4, 1, 2, 3))
        heads = port.bbox_head(torch.from_numpy(jout['bev_feat']).permute(
            0, 3, 1, 2))
    want = jout['volume_feat']
    seen = np.abs(want).sum(-1) > 0
    assert 0.2 < seen.mean() < 0.95      # the camera sees part of the grid
    assert rel_l2(vol.permute(0, 2, 3, 4, 1).numpy(), want) < STAGE_TOL
    np.testing.assert_array_equal(
        np.abs(vol.permute(0, 2, 3, 4, 1).numpy()).sum(-1) > 0, seen)
    assert rel_l2(bev.permute(0, 2, 3, 1).numpy(),
                  jout['bev_feat']) < STAGE_TOL
    for key, got in zip(('cls_score', 'bbox_pred', 'dir_pred'), heads):
        assert rel_l2(got.numpy(), jout[key]) < STAGE_TOL, key


def test_whole_model(models):
    jout, pout = models['jout'], models['pout']
    for key in ('volume_feat', 'bev_feat', 'cls_score', 'bbox_pred',
                'dir_pred'):
        got = pout[key].numpy()
        assert got.shape == jout[key].shape, key
        assert rel_l2(got, jout[key]) < MODEL_TOL, key


def test_loss_terms(models):
    jout, batch = models['jout'], models['batch']
    keys = ('cls_score', 'bbox_pred', 'dir_pred')
    _, want = jax.jit(lambda o, b: j_loss(o, b, models['jcfg']))(
        {k: jnp.asarray(jout[k]) for k in keys}, batch)
    gt = mv_to_device(batch, 'cpu')[2]
    _, got = imvoxelnet_loss({k: torch.from_numpy(jout[k]) for k in keys},
                             gt, ImVoxelNetConfig(**TINY))
    assert set(got) == set(want) == {'loss_cls', 'loss_bbox', 'loss_dir'}
    assert float(want['loss_bbox']) > 0       # positives were assigned
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_predict(models):
    jout = models['jout']
    keys = ('cls_score', 'bbox_pred', 'dir_pred')
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o: j_predict(o, models['jcfg']))(
        {k: jnp.asarray(jout[k]) for k in keys}))
    got = imvoxelnet_predict({k: torch.from_numpy(jout[k]) for k in keys},
                             ImVoxelNetConfig(**TINY))
    assert int(want['mask'].sum()) == B * TINY['max_num']
    for key in ('boxes3d', 'scores', 'labels', 'mask'):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-6,
                                   rtol=1e-4, err_msg=key)


def test_key_map_takes_every_leaf(models):
    v = models['variables']
    n_leaves = sum(x.size > 0 for x in jax.tree.leaves(v))
    sd = W.state_dict_from_jax(v, W.imvoxelnet_key_map(18))
    assert len(sd) == n_leaves
    assert set(sd) == set(models['port'].state_dict())


def port_step(variables, key_map, batch, double=False):
    """The port's train-mode `forward_train` + backward of the tiny model
    (a float64 model with `double`) -> (terms, {parameter: gradient as
    float64 numpy}), a parameter the loss does not reach (the FPN's
    coarser outputs) a zero gradient, as JAX's."""
    dtype = torch.float64 if double else torch.float32
    port = carry(ImVoxelNet(ImVoxelNetConfig(**TINY), dtype), variables,
                 key_map).train()
    imgs, l2i, gt = mv_to_device(batch, 'cpu')
    if double:
        port, imgs, l2i = port.double(), imgs.double(), l2i.double()
    # oneDNN rounds float64 convolutions as float32
    with torch.backends.mkldnn.flags(enabled=not double):
        total, terms = port.forward_train(imgs, l2i, gt)
        total.backward()
    grads = {k: np.zeros(tuple(p.shape)) if p.grad is None
             else p.grad.double().numpy() for k, p in port.named_parameters()}
    return dict(terms, loss=total), grads


def jax_step(models, double=False):
    """JAX's train-mode value_and_grad of `imvoxelnet_loss` (BatchNorm on
    the batch's moments) -> (total, terms, gradients as the port's state
    dict in float64). With `double` the model, variables and batch are
    float64 under `jax.enable_x64`; JAX's layers ask the convolutions for
    float32 accumulators (`preferred_element_type`), which float64
    operands refuse, so the caller widens that to float64 (its loss still
    rounds the head's maps to float32: ~1e-7 relative)."""
    jcfg, v, batch = models['jcfg'], models['variables'], models['batch']
    jm = JImVoxelNet(cfg=jcfg, dtype=jnp.float64) if double else models['jm']
    if double:
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        batch = {k: np.asarray(a, np.float64) if a.dtype == np.float32
                 else a for k, a in batch.items()}

    def loss_fn(params):
        out, _ = jm.apply(dict(v, params=params), batch['img'],
                          batch['lidar2img'], (H, WID), train=True,
                          mutable=['batch_stats'])
        return j_loss(out, batch, jcfg)

    with jax.enable_x64(double):
        (total, terms), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v['params'])
        grads = jax.tree.map(lambda a: np.asarray(a, np.float64), grads)
    sd = W.state_dict_from_jax({'params': grads}, W.imvoxelnet_key_map(18))
    return total, terms, {k: t.double().numpy() for k, t in sd.items()}


def test_train_step_matches_jax(models, monkeypatch):
    """One train step, JAX's against the port's forward_train + backward:
    the loss terms in float32 within rtol 1e-4, and the gradients judged
    against JAX's float64 step, which the port's float64 step meets
    within relative L2 1e-6 on every parameter (measured <= 1e-7: JAX's
    loss rounds to float32). In float32 the gradients below the BEV map's
    last BatchNorm are ill-conditioned at this size (JAX's own lies up
    to 1.3e-2 relative L2 from its float64 one, the port's up to 8.9e-3,
    measured on the CPU), so
    the port's must be no farther from float64 than 1.5 x JAX's (+ 2e-5),
    JAX's within 2e-2 of it, and the head and the last neck stage, which
    are well conditioned, within 1e-4 of JAX's directly."""
    jtotal, jterms, want = jax_step(models)
    conv = jax.lax.conv_general_dilated

    def conv_wide(lhs, rhs, *args, preferred_element_type=None, **kw):
        if jnp.result_type(lhs, rhs) == jnp.float64:
            preferred_element_type = None
        return conv(lhs, rhs, *args,
                    preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jax.lax, 'conv_general_dilated', conv_wide)
    _, _, ref = jax_step(models, double=True)
    monkeypatch.undo()
    key_map = W.imvoxelnet_key_map(18)
    terms, grads = port_step(models['variables'], key_map, models['batch'])
    _, port64 = port_step(models['variables'], key_map, models['batch'],
                          double=True)
    for k, x in dict(jterms, loss=jtotal).items():
        np.testing.assert_allclose(float(terms[k].detach()), float(x),
                                   rtol=1e-4, err_msg=k)
    assert set(grads) == set(want) == set(ref) == set(port64)
    for k, g in grads.items():
        if not ref[k].any():
            assert not g.any() and not want[k].any() and \
                not port64[k].any(), k
            continue
        assert rel_l2(port64[k], ref[k]) < 1e-6, k
        jax_err = rel_l2(want[k], ref[k])
        assert jax_err < 2e-2, k
        assert rel_l2(g, ref[k]) <= 1.5 * jax_err + 2e-5, k
        if k.startswith(('bbox_head', 'neck_3d.down2')):
            assert rel_l2(g, want[k]) < 1e-4, k
    keys = sorted(grads)
    flat, jflat, rflat = (np.concatenate([d[k].ravel() for k in keys])
                          for d in (grads, want, ref))
    assert rel_l2(jflat, rflat) < 2e-2
    assert rel_l2(flat, rflat) <= 1.5 * rel_l2(jflat, rflat)


def test_clis_synthetic_and_refusals(tmp_path, capsys):
    """`tools.test` / `tools.train --synthetic` run; without the flag both
    exit 2 and name it."""
    opts = ['--cfg-options'] + TINY_OPTS
    assert test_cli.main([CONFIG, '--synthetic', '--device', 'cpu',
                          '--dtype', 'float32'] + opts) == 0
    out = capsys.readouterr().out
    assert '[synthetic-eval] ImVoxelNet' in out and 'finite=True' in out
    assert 'boxes3d: shape=(1, 100, 7)' in out
    assert test_cli.main([CONFIG, '--device', 'cpu'] + opts) == 2
    assert '--synthetic' in capsys.readouterr().err
    work = str(tmp_path / 'w')
    assert train_cli.main([CONFIG, '--synthetic', '--device', 'cpu',
                           '--max-steps', '1', '--work-dir', work]
                          + opts) == 0
    out = capsys.readouterr().out
    assert 'step 1/1' in out and 'loss_bbox=' in out
    assert train_cli.main([CONFIG, '--device', 'cpu', '--work-dir', work]
                          + opts) == 2
    assert '--synthetic' in capsys.readouterr().err
