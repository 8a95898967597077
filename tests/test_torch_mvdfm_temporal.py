"""MultiViewDfM's options beyond camsync in the port against the JAX
package, on the CPU: the 10-sweeps config (two frames concatenated,
`DfMNeck`), the CenterHead branch, and the 3D backbone with the
`voxel_sample` depth head.

Tiny configs: ResNet-18, FPN width 16, B 1 x F 2 x V 2 views of 32x48, a
(4, 16, 16) grid over +-8 m. The same seeded numpy inputs and seeded flax
variables (carried over by `utils/weights.py:mvdfm_key_map`) go through
both packages in float32, torch in one thread. Tolerances:

* `DfMNeck` alone at nz 4 and 12, `voxel_sample`: atol 1e-5;
* the concat volume: relative L2 1e-4 against JAX's, the camsync test's
  rule for its volume (the trunk's convolutions sum in another order), and
  bit for bit the port's one-frame volumes stacked;
* the whole models' outputs (the volume, the BEV map, the head maps, the
  depth head's frustum features and cost) and their detections:
  `test_torch_multiview_dfm.DET_TOL` (1e-4 absolute + 1e-4 relative);
* `mvdfm_loss` with the dense depth term at JAX's pixel draws: rtol 1e-5;
* one train step of the tiny 10-sweeps model (64x96 views, B 2 of
  `mv_synth`'s two-frame batch) against JAX's `make_train_step`: the
  whole-step rules of `tests/test_torch_train_step.py` (loss terms and
  grad_norm rtol 2e-4; gradients relative L2 2e-2 for any parameter;
  BatchNorm statistics atol 1e-5; parameters within what their two
  gradients explain of AdamW's first update + 2e-6), except two: the
  3D neck's and the head's gradients are held at 2e-2 too (not 1e-4) and
  the whole vector at 5e-3 (not 2e-3), because JAX's own float32
  gradients of `DfMNeck` lie 3.5e-3 to 9e-3 from the float64 gradients of
  the same step (the whole vector 3e-4 to 2.2e-3; six grids, sizes and
  seeds measured on the CPU). The port's own rounding is held apart: its
  float32 gradients within relative L2 1e-4 of the step of a float64
  model (`MultiViewDfM(cfg, torch.float64)`: the trunk and the 3D neck in
  float64 too), for the 3D neck and head each and for the whole vector
  (measured: 1.2e-5 and 3.8e-6), and that float64 step within 1e-6 of
  JAX's float64 step under `jax.enable_x64` on every parameter (measured
  1.1e-7);
* `tools.test` with the 10-sweeps config on a tiny Waymo tree whose infos
  carry sweeps: two frames a sample, the 15 LET lines.
"""

import functools
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
from dfm_tpu.models.detectors.multiview_dfm import mvdfm_loss as j_mvdfm_loss
from dfm_tpu.models.detectors.multiview_dfm import (mvdfm_predict as
                                                    j_mvdfm_predict)
from dfm_tpu.models.necks.dfm_neck import DfMNeck as JDfMNeck
from dfm_tpu.ops.frustum import voxel_sample as j_voxel_sample
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.data.waymo import (assemble_multiview_sample,
                                      frames_per_sample)
from dfm_tpu_torch.models.builder import build_detector
from dfm_tpu_torch.models.detectors.multiview_dfm import (MultiViewDfM,
                                                          MVDfMConfig,
                                                          mvdfm_loss,
                                                          mvdfm_predict)
from dfm_tpu_torch.models.necks.dfm_neck import DfMNeck
from dfm_tpu_torch.ops.voxel_sample import voxel_sample
from dfm_tpu_torch.runtime.adapters import mv_synth, mv_to_device
from dfm_tpu_torch.runtime.config import load_config
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.utils import weights as W

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_layers import carry, submap
from test_torch_multiview_dfm import (DET_TOL, REL_L2, flax_variables,
                                      lidar2img, rel_l2)
from test_torch_parallel import run
from test_torch_train_step import (GRAD_REL_L2, LOSS_RTOL, LR, PARAM_ATOL,
                                   STATS_ATOL, RecordGrads, random_variables)

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic Waymo tree)

CONFIG = os.path.join(ROOT, 'configs',
                      'multiview_dfm_r101_waymo_camsync_10sweeps.py')
B, F, V, H, WID = 1, 2, 2, 32, 48
BASE = dict(num_views=V, num_frames=F, feat_channels=16,
            voxel_range=(-8, -8, -1, 8, 8, 3), voxel_grid=(4, 16, 16),
            anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3,
            backbone_depth=18, nms_pre=128, max_num=8)
SWEEPS = dict(frame_fusion='concat', neck_3d='dfm')
VARIANTS = dict(
    camsync={},
    sweeps=SWEEPS,
    center=dict(SWEEPS, bbox_head='center'),
    depth=dict(with_backbone_3d=True, with_depth_head=True, depth_min=1.0,
               depth_max=8.0, depth_num_bins=16))
RUN = ('sweeps', 'center', 'depth')
TRAIN_HW = (64, 96)
LIFTED = ('neck_3d.', 'bbox_head_3d.')
WHOLE_REL_L2 = 5e-3        # the step's whole gradient against JAX's
# the port's float32 step against its float64 model's step (every layer in
# float64): measured 3.8e-6 for the whole vector, 1.2e-5 for the worst
# parameter after the lifting (CPU, oneDNN off)
OWN_ROUNDING = 1e-4
# the port's float64 step against JAX's float64 step, each parameter:
# measured 1.1e-7 (JAX's loss rounds the head's maps to float32)
F64_REL_L2 = 1e-6
CLI_OPTS = ['data.target_hw=(32,48)', 'data.cam_sync=True',
            'model.backbone_depth=18', 'model.feat_channels=16',
            'model.voxel_grid=(4,24,30)', 'model.max_num=20']


def opts(name):
    return dict(BASE, **VARIANTS[name])


def inputs(seed=0):
    imgs = np.random.RandomState(seed).randn(B, F, V, H, WID, 3).astype(
        np.float32)
    return imgs, lidar2img()[:, :, :V]


@functools.lru_cache(maxsize=None)
def variables_of(name):
    """Seeded flax variables of a variant (shared: copy before editing)."""
    imgs, l2i = inputs()
    return flax_variables(JMultiViewDfM(cfg=JMVDfMConfig(**opts(name))),
                          imgs, l2i, (H, WID))


@pytest.fixture(scope='module')
def models():
    """JAX's and the port's outputs of the three variants (live class
    scores for the anchor heads) on the same inputs and weights."""
    torch.set_num_threads(1)
    imgs, l2i = inputs()
    out = {}
    for name in RUN:
        jm = JMultiViewDfM(cfg=JMVDfMConfig(**opts(name)))
        v = jax.tree.map(np.copy, variables_of(name))
        if name != 'center':
            head = v['params']['bbox_head_3d']['conv_cls']
            head['bias'] = (0.5 + 0.3 * np.random.RandomState(1).randn(
                *head['bias'].shape)).astype(np.float32)
        fwd = jax.jit(lambda v, i, m: jm.apply(v, i, m, (H, WID),
                                               train=False))
        jout = jax.tree.map(np.asarray, fwd.lower(v, imgs, l2i).compile(
            compiler_options=FAST_COMPILE)(v, imgs, l2i))
        cfg = MVDfMConfig(**opts(name))
        port = carry(MultiViewDfM(cfg), v, W.mvdfm_key_map(18, cfg))
        with torch.no_grad():
            pout = port(torch.from_numpy(imgs), torch.from_numpy(l2i))
        out[name] = dict(jout=jout, pout=pout, cfg=cfg,
                         jcfg=JMVDfMConfig(**opts(name)))
    return out


@pytest.mark.parametrize('name', list(VARIANTS))
def test_key_map_takes_every_leaf(name):
    """Every leaf of each variant's JAX tree is taken once by the key map,
    and the port's state dict holds nothing else."""
    v = variables_of(name)
    cfg = MVDfMConfig(**opts(name))
    km = W.mvdfm_key_map(18, cfg)
    assert len({f for _, f, _ in km}) == len(km)
    sd = W.state_dict_from_jax(v, km)
    assert len(sd) == sum(x.size > 0 for x in jax.tree.leaves(v))
    assert set(sd) == set(MultiViewDfM(cfg).state_dict())


@pytest.mark.parametrize('nz', [4, 12])
def test_dfm_neck_matches_jax(nz):
    """Both paths and the gate: 4 -> 2 -> 1 planes (final kernel 1) and
    the 10-sweeps config's 12 -> 6 -> 3 (final kernel 3)."""
    x = np.random.RandomState(2).randn(1, nz, 6, 5, 16).astype(np.float32)
    jm = JDfMNeck(in_channels=8, out_channels=24, num_frames=2)
    variables = flax_variables(jm, x, seed=3)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(
        variables, x))
    cfg = MVDfMConfig(feat_channels=8, **SWEEPS)
    key_map = submap(W.mvdfm_key_map(18, cfg), 'neck_3d', ('neck_3d',))
    port = carry(DfMNeck(8, 24, 2, nz), variables, key_map)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (1, 24, 6, 5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


def test_concat_volume(models):
    """The two frames' volumes stacked frame-major (channel f * C + c is
    frame f's), the current frame first."""
    m = models['sweeps']
    got, want = m['pout']['volume_feat'].numpy(), m['jout']['volume_feat']
    assert got.shape == (B, 4, 16, 16, 2 * 16)
    assert rel_l2(got, want) < REL_L2
    assert not np.allclose(got[..., :16], got[..., 16:])
    model = MultiViewDfM(MVDfMConfig(**dict(opts('camsync'), num_frames=1)))
    imgs, l2i = inputs()
    feat0 = torch.from_numpy(np.random.RandomState(7).randn(
        B, F, V, 16, H // 4, WID // 4).astype(np.float32))
    l2i = torch.from_numpy(l2i)
    cat = MultiViewDfM(m['cfg']).sample_volume(feat0, l2i, (H, WID))
    one = [model.sample_volume(feat0[:, f:f + 1], l2i[:, f:f + 1], (H, WID))
           for f in range(F)]
    assert torch.equal(cat, torch.cat(one, 1))
    seen = np.abs(got).sum(-1) > 0
    assert 0.2 < seen.mean() < 0.95


@pytest.mark.parametrize('name', RUN)
def test_outputs_match_jax(models, name):
    m = models[name]
    jout, pout = m['jout'], m['pout']
    keys = sorted(k for k in jout if k != 'task_outs')
    assert keys == sorted(k for k in pout if k != 'task_outs')
    if name == 'depth':
        assert pout['depth_cost'].shape == (B * V, 4, H // 4, WID // 4)
    pairs = [(k, pout[k], jout[k]) for k in keys]
    if name == 'center':
        pairs += [(f'task{t}.{k}', p[k], j[k]) for t, (p, j) in enumerate(
            zip(pout['task_outs'], jout['task_outs'])) for k in j]
    for k, got, want in pairs:
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got.numpy(), want, **DET_TOL, err_msg=k)


@pytest.mark.parametrize('name', ['sweeps', 'center'])
def test_predict_matches_jax(models, name):
    m = models[name]
    heads = ('task_outs', 'bev_feat') if name == 'center' else (
        'cls_score', 'bbox_pred', 'dir_pred')
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o: j_mvdfm_predict(o, m['jcfg']))(
        {k: m['jout'][k] for k in heads}))
    got = mvdfm_predict(m['pout'], m['cfg'])
    assert sorted(got) == sorted(want)
    keep = 'scores_3d' if name == 'center' else 'mask'
    assert 0 < int((want[keep] > 0).sum())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **DET_TOL,
                                   err_msg=k)


def test_voxel_sample_matches_jax():
    """A camera whose frustum leaves the grid on every side, 8 depth bins
    strided by 2."""
    rng = np.random.RandomState(4)
    vol = rng.randn(5, 6, 8, 10).astype(np.float32)          # (C, nz, ny, nx)
    vr = np.array([-5, -4, -1, 5, 4, 3], np.float32)
    vs = (vr[3:] - vr[:3]) / np.array([10, 8, 6], np.float32)
    proj = lidar2img()[0, 0, 1]
    ds = np.linspace(1.0, 12.0, 8, dtype=np.float32)
    want = np.asarray(jax.jit(lambda v, d, p: j_voxel_sample(
        v, d, p, 2, (24, 32), voxel_range=vr, voxel_size=vs))(
        vol.transpose(1, 2, 3, 0), ds, proj))
    got = voxel_sample(torch.from_numpy(vol), ds, torch.from_numpy(proj), 2,
                       (24, 32), vr, vs).permute(1, 2, 3, 0).numpy()
    assert got.shape == want.shape == (4, 12, 16, 5)
    zero = np.abs(want).sum(-1) == 0
    assert 0.05 < zero.mean() < 0.95
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_depth_loss_matches_jax(models):
    """The depth variant's anchor terms and `loss_dense_depth` ('ce', 2048
    pixels of each view, up x4) at JAX's draws under the same key."""
    m = models['depth']
    rng = np.random.RandomState(5)
    gt = mv_synth(m['cfg'], B, 2)
    gt = {k: gt[k] for k in ('gt_boxes', 'gt_labels', 'gt_mask')}
    gt['depth_img'] = (rng.rand(B, V, H, WID) * 8 + 0.5).astype(np.float32)
    key = jax.random.PRNGKey(6)
    heads = ('cls_score', 'bbox_pred', 'dir_pred', 'depth_cost')
    total, want = jax.jit(lambda o, b, k: j_mvdfm_loss(o, b, m['jcfg'], k))(
        {k: m['jout'][k] for k in heads}, gt, key)
    valid = ((gt['depth_img'] > 1.0) & (gt['depth_img'] < 8.0)).reshape(
        B * V, -1)
    keys = jax.random.split(key, B * V)
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], valid.shape[1], (2048,), replace=True,
        p=jnp.asarray(valid[i] / valid[i].sum(), jnp.float32)))
        for i in range(B * V)])
    got_total, got = mvdfm_loss(
        {k: m['pout'][k] for k in heads},
        {k: torch.from_numpy(v) for k, v in gt.items()}, m['cfg'],
        pix_idx=torch.from_numpy(pix))
    assert sorted(got) == sorted(want) == ['loss_bbox', 'loss_cls',
                                           'loss_dense_depth', 'loss_dir']
    for k in want:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-5)


def test_frames_and_sweep_sample(tmp_path):
    """The 10-sweeps config stacks 1 + num_ref_frames = 2 frames (its data
    dict inherits the camsync base's num_frames=1); frame 1 of a sample is
    the info's sweep, its lidar2img rewritten by ego-motion."""
    ten = load_config(CONFIG)
    assert (ten.data.num_frames, ten.data.num_ref_frames) == (1, 1)
    assert frames_per_sample(ten.data, build_detector(ten.model)) == 2
    cam = load_config(CONFIG.replace('_10sweeps', ''))
    assert frames_per_sample(cam.data, build_detector(cam.model)) == 1
    assert frames_per_sample({}, MVDfMConfig(num_frames=3)) == 3
    root = str(tmp_path)
    infos = chip_smoke.write_waymo_tree(root, scale=0.05)
    assert 'sweeps' not in infos[0]
    sweep = infos[1]['sweeps'][0]
    assert sweep['images'] == infos[0]['images']
    s = assemble_multiview_sample(infos[1], root, 2, (32, 48), 5)
    s0 = assemble_multiview_sample(infos[0], root, 1, (32, 48), 5)
    np.testing.assert_array_equal(s['imgs'][1], s0['imgs'][0])
    rel = np.linalg.inv(sweep['ego2global']) @ infos[1]['ego2global']
    np.testing.assert_allclose(s['lidar2img'][1], (
        s0['lidar2img'][0].astype(np.float64) @ rel), rtol=1e-6, atol=1e-4)


def _train_case():
    """The step's config, batch and weights (the port's state dict), and
    a function running JAX's `make_train_step` on them."""
    cfg, jcfg = MVDfMConfig(**opts('sweeps')), JMVDfMConfig(**opts('sweeps'))
    batch = mv_synth(cfg, 2, 3, *TRAIN_HW)
    assert batch['img'].shape[1] == 2
    model = JMultiViewDfM(cfg=jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), batch['img'], batch['lidar2img'], TRAIN_HW,
        train=False))
    variables = random_variables(shapes, 1)
    key_map = W.mvdfm_key_map(18, cfg)

    def reference():
        tx = optax.chain(RecordGrads.make(),
                         jax_make_optimizer(jax_schedule(**LR)))
        state = create_train_state(variables, tx)
        key = jax.random.PRNGKey(3)
        step = make_train_step(
            model, lambda o, b, r: j_mvdfm_loss(o, b, jcfg, r),
            donate=False,
            model_args_fn=lambda b: (b['img'], b['lidar2img'], TRAIN_HW))
        jbatch = jax.tree.map(jnp.asarray, batch)
        new_state, metrics = step.lower(state, jbatch, key).compile(
            compiler_options=FAST_COMPILE)(state, jbatch, key)
        return dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=W.state_dict_from_jax({'params': jax.device_get(
                new_state.opt_state[0]), 'batch_stats': variables[
                    'batch_stats']}, key_map),
            after=W.state_dict_from_jax(jax.device_get(
                {'params': new_state.params,
                 'batch_stats': new_state.batch_stats}), key_map))

    def reference64():
        """JAX's gradients of the same train-mode loss with the model, its
        variables and the batch in float64 under `jax.enable_x64`. JAX's
        layers ask the convolutions for float32 accumulators
        (`preferred_element_type`), which float64 operands refuse, so that
        is widened to float64 here (its loss still rounds the head's maps
        to float32: ~1e-7 relative)."""
        jm = JMultiViewDfM(cfg=jcfg, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        b64 = {k: np.asarray(a, np.float64) if a.dtype == np.float32 else a
               for k, a in batch.items()}

        def loss_fn(params):
            out, _ = jm.apply(dict(v64, params=params), b64['img'],
                              b64['lidar2img'], TRAIN_HW, train=True,
                              mutable=['batch_stats'])
            return j_mvdfm_loss(out, b64, jcfg)[0]

        conv = jax.lax.conv_general_dilated

        def conv_wide(lhs, rhs, *args, preferred_element_type=None, **kw):
            if jnp.result_type(lhs, rhs) == jnp.float64:
                preferred_element_type = None
            return conv(lhs, rhs, *args,
                        preferred_element_type=preferred_element_type, **kw)

        jax.lax.conv_general_dilated = conv_wide
        try:
            with jax.enable_x64(True):
                grads = jax.jit(jax.grad(loss_fn))(v64['params'])
                grads = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                     grads)
        finally:
            jax.lax.conv_general_dilated = conv
        sd64 = W.state_dict_from_jax({'params': grads}, key_map)
        return {k: t.double().numpy() for k, t in sd64.items()}

    return (cfg, batch, W.state_dict_from_jax(variables, key_map), reference,
            reference64)


def _port_grads64(cfg, batch, sd):
    """The port's gradients of the same step with a float64 model (every
    layer, the trunk and the 3D neck included, in float64; its own
    rounding held apart from JAX's), oneDNN off: with it on, PyTorch's
    float64 convolutions round as float32."""
    model = MultiViewDfM(cfg, torch.float64)
    model.load_state_dict(sd, strict=True)
    model = model.double().train()
    imgs, l2i, gt = mv_to_device(batch, 'cpu')
    with torch.backends.mkldnn.flags(enabled=False):
        total, _ = model.forward_train(imgs.double(), l2i.double(), gt)
        total.backward()
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def _port_step(cfg, batch, sd):
    model = MultiViewDfM(cfg)
    model.load_state_dict(sd, strict=True)
    step = TrainStep(model, make_optimizer(model), liga_schedule(**LR))
    with torch.backends.mkldnn.flags(enabled=False):
        total, losses = step.forward(*mv_to_device(batch, 'cpu'))
        step.backward(total)
    step.reduce()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    norm = step.update()
    return dict(metrics=dict(loss=float(total.detach()), **{
        k: float(v) for k, v in losses.items()}), grad_norm=float(norm),
        grads=grads, stats=stats, after=model.state_dict())


@pytest.fixture(scope='module')
def steps(tmp_path_factory):
    """JAX's step, the port's (in a thread meanwhile) and `tools.test` on
    the 10-sweeps config (in a process of its own meanwhile)."""
    torch.set_num_threads(1)
    d = str(tmp_path_factory.mktemp('sweeps'))
    chip_smoke.write_waymo_tree(d, scale=0.05)
    cli = {}

    def test_cli():
        cli['res'] = run([sys.executable, '-m', 'dfm_tpu_torch.tools.test',
                          CONFIG, '--device', 'cpu', '--dtype', 'float32',
                          '--cfg-options', f'data.data_root={d}', *CLI_OPTS])

    cfg, batch, sd, reference, reference64 = _train_case()
    port = {}

    def port_steps():
        torch.set_num_threads(1)
        port.update(f32=_port_step(cfg, batch, sd),
                    f64=_port_grads64(cfg, batch, sd))

    ts = [threading.Thread(target=f) for f in (test_cli, port_steps)]
    for t in ts:
        t.start()
    try:
        ref = reference()
        ref64 = reference64()
    finally:
        for t in ts:
            t.join()
    return dict(jax=ref, jax64=ref64, port=port['f32'], port64=port['f64'],
                sd=sd, cli=cli['res'])


def test_step_matches_jax(steps):
    """Loss terms, grad_norm, gradients, BatchNorm statistics and the
    parameters after the update."""
    got, ref = steps['port'], steps['jax']
    for term in ('loss', 'loss_cls', 'loss_bbox', 'loss_dir'):
        assert ref['metrics'][term] > 0, term
        np.testing.assert_allclose(got['metrics'][term], ref['metrics'][term],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=term)
    np.testing.assert_allclose(got['grad_norm'], ref['metrics']['grad_norm'],
                               rtol=LOSS_RTOL)
    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    g64 = steps['port64']
    flat = {k: [] for k in ('got', 'want', 'g64')}
    bad = {}
    for name, g in got['grads'].items():
        g, want = g.numpy(), ref['grads'][name].numpy()
        assert np.isfinite(g).all(), name
        if rel(g, want) > GRAD_REL_L2:
            bad[name] = rel(g, want)
        if name in g64:
            flat['g64'].append(g64[name].numpy().ravel())
            if name.startswith(LIFTED) and rel(g, g64[name].numpy()) > \
                    OWN_ROUNDING:
                bad[name + ' (against float64)'] = rel(g, g64[name].numpy())
        else:
            assert not np.abs(want).any(), name
            flat['g64'].append(np.zeros(g.size))
        flat['got'].append(g.ravel())
        flat['want'].append(want.ravel())
    assert not bad, f'gradients off (relative L2): {bad}'
    # the port's float64 step against JAX's float64 step, per parameter
    j64 = steps['jax64']
    off64 = {name: rel(g64[name].numpy(), j64[name]) for name in g64
             if np.linalg.norm(j64[name]) > 0}
    assert set(g64) <= set(j64)
    assert max(off64.values()) <= F64_REL_L2, max(off64.items(),
                                                  key=lambda kv: kv[1])
    flat = {k: np.concatenate(x) for k, x in flat.items()}
    assert rel(flat['got'], flat['want']) <= WHOLE_REL_L2
    assert rel(flat['got'], flat['g64']) <= OWN_ROUNDING
    for prefix in ('backbone.', 'neck.', 'neck_3d.mono_', 'neck_3d.stereo_',
                   'neck_3d.aggregate_layer', 'bbox_head_3d.'):
        assert any(k.startswith(prefix) and np.linalg.norm(
            ref['grads'][k].numpy()) > 0 for k in got['grads']), prefix
    for name, t in got['stats'].items():
        np.testing.assert_allclose(t.numpy(), ref['after'][name].numpy(),
                                   rtol=0, atol=STATS_ATOL, err_msg=name)
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / got['grad_norm'])
    clip_jax = min(1.0, 35.0 / ref['metrics']['grad_norm'])
    for name, t in got['after'].items():
        if name.endswith(('running_mean', 'running_var')):
            continue
        g = got['grads'][name].numpy().astype(np.float64) * clip
        gw = ref['grads'][name].numpy().astype(np.float64) * clip_jax
        atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                            gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        err = np.abs(t.numpy() - ref['after'][name].numpy())
        assert (err <= atol).all(), (name, float(err.max()))


def test_tools_test_10sweeps(steps):
    """`tools.test` with the 10-sweeps config at the tiny widths on a tree
    whose second frame lists the first as its sweep: two frames a sample,
    15 finite LET lines."""
    res = steps['cli']
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'MultiViewDfM on cpu, 2 frame(s) a sample' in res.stdout
    lets = re.findall(r'^(?:Vehicle|Pedestrian|Cyclist|Sign|Overall) '
                      r'mAP\w?: (\S+)$', res.stdout, re.M)
    assert len(lets) == 15 and all(np.isfinite(float(x)) for x in lets)
    assert '[metric] python_fallback' in res.stdout
