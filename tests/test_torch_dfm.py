"""The port's DfM slice (dfm_tpu_torch) against the JAX package.

* DfMBackbone (its default form: banded stems, reduced-depth mono)
  against the flax module and against the reference's own torch
  activations (tests/data/golden_dfm_backbone.npz, golden tolerances
  2e-3 / 4e-3 of tests/test_golden_parity.py).
* The whole slice at the tiny config of tests/test_dfm_model.py: every
  head output and depth_cost / volume_feat / bev_feat against
  `DfM.apply` in float32, atol/rtol 3e-4 (dozens of stacked f32 convs
  and GroupNorms summed in other orders; measured max abs err 5e-5 on
  outputs up to 7), in the default form, in the dense form and with the
  conv chain on (its plain versions, on the CPU), all from one state
  dict. The JAX neck builds its fine
  depth-softmax volume in bf16 even in an f32 model; the test makes it
  build that volume in f32 (the port's f32 behaviour), so the
  comparison is f32 throughout.
* The same at B = 2 with flip, crop and scale in the meta, in the
  conv-chain form (its per-sample loops) and the dense form.
* `dfm_predict` on the same head outputs, one streaming step with
  `prev_stereo_cache`, the full-tree weight round trip, and the port's
  independence from JAX.
"""

import os
import re
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.models import BatchMeta as JMeta
from dfm_tpu.models import DfM as JDfM
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models import dfm_predict as jax_predict
from dfm_tpu.models.backbones.dfm_backbone import DfMBackbone as JBackbone
from dfm_tpu.utils.checkpoint_import import (dfm_key_map as jax_key_map,
                                             import_dfm_state_dict)
from dfm_tpu_torch.apis import init_dfm_model, init_dfm_stream
from dfm_tpu_torch.models.backbones.dfm_backbone import DfMBackbone
from dfm_tpu_torch.models.detectors.dfm import BatchMeta, DfM, DfMConfig, \
    dfm_predict
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import randomize

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'data', 'golden_dfm_backbone.npz')
SLICE_TOL = dict(atol=3e-4, rtol=3e-4)
B, H, W_ = 1, 64, 128
TINY = dict(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5), nms_pre=128,
            max_num=8)


def _np_meta(cam):
    return dict(ori_cam2img=cam[None], cam2img=cam[None],
                cur2prev=np.eye(4, dtype=np.float32)[None],
                org_w=np.full((B,), float(W_), np.float32),
                flip=np.zeros((B,), np.float32),
                crop_offset=np.zeros((B, 2), np.float32),
                scale_factor=np.ones((B,), np.float32))


def _jax_out(model, variables, img, m):
    """`DfM.apply` in float32 (the fine depth-softmax volume built in f32,
    as the port builds it in an f32 model)."""
    jmeta = JMeta(**{k: jnp.asarray(v) for k, v in m.items()})
    orig = JFS.build_fine_softmax_volume

    def fine_f32(*a, **kw):
        kw['dtype'] = jnp.float32
        return orig(*a, **kw)

    with mock.patch.object(JFS, 'build_fine_softmax_volume', fine_f32):
        out = jax.jit(lambda v, i, mt: model.apply(v, i, mt, train=False))(
            variables, jnp.asarray(img), jmeta)
    return {k: np.asarray(v) for k, v in out.items()}


def _tiny_cam():
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 200.0
    cam[0, 2], cam[1, 2] = W_ / 2, H / 2
    return cam


@pytest.fixture(scope='module')
def tiny():
    """JAX DfM at the tiny config with random variables, its f32
    outputs, and the port model carrying the same weights."""
    rng = np.random.RandomState(0)
    img = rng.randn(B, 2, H, W_, 3).astype(np.float32)
    m = _np_meta(_tiny_cam())
    m['cur2prev'][0, :3, 3] = (0.1, 0.0, -0.6)     # ego-motion
    model = JDfM(cfg=JConfig(**TINY))
    variables = randomize(model.init(
        jax.random.PRNGKey(0), jnp.asarray(img),
        JMeta(**{k: jnp.asarray(v) for k, v in m.items()}), train=False), 0)
    out = _jax_out(model, variables, img, m)
    port = DfM(DfMConfig(**TINY))
    port.load_state_dict(W.state_dict_from_jax(variables), strict=True)
    meta = BatchMeta(**{k: torch.from_numpy(v) for k, v in m.items()})
    return dict(img=img, variables=variables, jax_out=out,
                port=port.eval(), meta=meta)


def _augmented_meta_b2():
    """Two samples with the augmentation trail set: sample 0 flipped and
    cropped, sample 1 rescaled (0.9) and cropped, each with its own
    intrinsics after augmentation and its own ego-motion."""
    cam = _tiny_cam()
    aug = np.stack([cam, cam])
    aug[0, 0, 2] = W_ - (cam[0, 2] - 3.0)            # crop x 3, then flip
    aug[0, 1, 2] -= 2.0
    aug[1, :2, :3] *= 0.9                            # scale 0.9, then crop
    aug[1, 0, 2] -= 4.0
    aug[1, 1, 2] -= 1.0
    c2p = np.stack([np.eye(4, dtype=np.float32)] * 2)
    c2p[0, :3, 3] = (0.1, 0.0, -0.6)
    c2p[1, :3, 3] = (-0.05, 0.02, -0.8)
    return dict(ori_cam2img=np.stack([cam, cam]), cam2img=aug, cur2prev=c2p,
                org_w=np.asarray([W_ + 6.0, W_ / 0.9], np.float32),
                flip=np.asarray([1.0, 0.0], np.float32),
                crop_offset=np.asarray([[3.0, 2.0], [4.0, 1.0]], np.float32),
                scale_factor=np.asarray([1.0, 0.9], np.float32))


@pytest.fixture(scope='module')
def tiny_b2(tiny):
    """`tiny`'s weights at B = 2 with the augmented meta: the JAX outputs
    and the port's inputs."""
    img = np.random.RandomState(4).randn(2, 2, H, W_, 3).astype(np.float32)
    m = _augmented_meta_b2()
    out = _jax_out(JDfM(cfg=JConfig(**TINY)), tiny['variables'], img, m)
    meta = BatchMeta(**{k: torch.from_numpy(v) for k, v in m.items()})
    return dict(img=img, jax_out=out, meta=meta)


KEYS = ['depth_cost', 'volume_feat', 'bev_feat', 'cls_score', 'bbox_pred',
        'dir_pred']
FORMS = dict(default={}, dense=dict(use_band=False, packed=False),
             stem=dict(use_band=True, packed='stem'),
             chain=dict(use_band=True, packed=True))


def _form(tiny, form):
    """The port model of `tiny` in another form of the 3D trunks, from
    the same state dict."""
    if form == 'default':
        return tiny['port']
    port = DfM(DfMConfig(**TINY), **FORMS[form])
    port.load_state_dict(tiny['port'].state_dict(), strict=True)
    return port.eval()


@pytest.mark.parametrize(
    'form,key', [pytest.param('default', k, id=k) for k in KEYS]
    + [pytest.param(f, k, id=f'{f}-{k}') for f in ('dense', 'chain', 'stem')
       for k in KEYS])
def test_slice_matches_jax(tiny, form, key):
    cached = f'port_out_{form}'
    if cached not in tiny:
        with torch.inference_mode():
            tiny[cached] = _form(tiny, form)(torch.from_numpy(tiny['img']),
                                             tiny['meta'])
    got = tiny[cached][key].numpy()
    want = tiny['jax_out'][key]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **SLICE_TOL)


@pytest.mark.parametrize(
    'form,key', [pytest.param(f, k, id=f'{f}-{k}')
                 for f in ('chain', 'dense') for k in KEYS])
def test_slice_b2_augmented_matches_jax(tiny, tiny_b2, form, key):
    """B = 2 with flip, crop and scale set: the per-sample loops of the
    conv chain (its plain versions on the CPU) and the dense form
    against `DfM.apply`, every output. PyTorch's oneDNN convolutions are
    off here: at batch 2 they sum some 2D convs in another order than at
    batch 1 (a few ulp), and the neck's SPP GroupNorms over 1 x 2 maps
    (E[x^2] - E[x]^2 of two near-equal values, the formula of the JAX
    GroupNorm) turn that into 4e-4 on a few bev_feat values. The native
    convolutions sum each sample as at batch 1, so the comparison
    holds the per-sample paths at the f32 slice tolerance."""
    cached = f'port_out_{form}'
    if cached not in tiny_b2:
        with torch.inference_mode(), torch.backends.mkldnn.flags(
                enabled=False):
            tiny_b2[cached] = _form(tiny, form)(
                torch.from_numpy(tiny_b2['img']), tiny_b2['meta'])
    got = tiny_b2[cached][key].numpy()
    want = tiny_b2['jax_out'][key]
    assert got.shape == want.shape and got.shape[0] == 2
    np.testing.assert_allclose(got, want, **SLICE_TOL)


def test_slice_matches_jax_bf16_fine_volume(tiny):
    """The JAX neck builds its fine depth-softmax volume in bf16 even in
    an f32 model (`dfm_tpu/models/necks/frustum_to_voxel.py:189-191`),
    which the other slice tests patch away; the port builds it in the
    model's dtype. Unpatched, JAX's f32 outputs still agree with the
    port's at the slice tolerance (the bf16 volume moves JAX's own
    outputs by at most 2.3e-4 at this config), so the port keeps f32."""
    m = _np_meta(_tiny_cam())
    m['cur2prev'][0, :3, 3] = (0.1, 0.0, -0.6)
    jmeta = JMeta(**{k: jnp.asarray(v) for k, v in m.items()})
    model = JDfM(cfg=JConfig(**TINY))
    out = jax.jit(lambda v, i, mt: model.apply(v, i, mt, train=False))(
        tiny['variables'], jnp.asarray(tiny['img']), jmeta)
    if 'port_out_default' not in tiny:
        with torch.inference_mode():
            tiny['port_out_default'] = tiny['port'](
                torch.from_numpy(tiny['img']), tiny['meta'])
    moved = 0.0
    for key in KEYS:
        want = np.asarray(out[key])
        moved = max(moved, float(np.abs(want - tiny['jax_out'][key]).max()))
        np.testing.assert_allclose(tiny['port_out_default'][key].numpy(),
                                   want, err_msg=key, **SLICE_TOL)
    assert moved > 0, 'the bf16 volume changed nothing: not reached'


def test_stream_step_matches_two_frame_jax(tiny):
    """Streaming: frame 0 as a self-pair, then frame 1 with the cached
    stereo features == the JAX two-frame forward on (frame 1, frame 0)."""
    img = torch.from_numpy(tiny['img'])
    f1, f0 = img[:, 0], img[:, 1]
    with torch.inference_mode():
        cache0 = tiny['port'](torch.stack([f0, f0], 1),
                              tiny['meta'])['stereo_cache']
        out = tiny['port'](torch.stack([f1, f1], 1), tiny['meta'],
                           prev_stereo_cache=cache0)
    for key in ('cls_score', 'bbox_pred', 'dir_pred'):
        np.testing.assert_allclose(out[key].numpy(), tiny['jax_out'][key],
                                   **SLICE_TOL)


def test_init_dfm_stream_chain_form_matches_two_frame(tiny):
    """`init_dfm_stream` with the conv chain on: a stream step equals
    the two-frame request of `init_dfm_model` in the same form (same
    seeded weights), and the dense form's detections."""
    cfg = DfMConfig(**TINY)
    kw = dict(dtype=torch.float32, device='cpu')
    img = torch.from_numpy(tiny['img'])
    f1, f0 = img[:, 0], img[:, 1]
    stream = init_dfm_stream(cfg, packed=True, **kw)
    assert stream['model'].backbone_stereo.packed is True
    _, cache = stream['infer_first'](torch.stack([f0, f0], 1), tiny['meta'])
    got, _ = stream['infer_stream'](f1, tiny['meta'], cache)
    for form in (dict(packed=True), dict(use_band=False, packed=False)):
        want = init_dfm_model(cfg, **form, **kw)['infer'](img, tiny['meta'])
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(
                got[key].float().numpy(), want[key].float().numpy(),
                atol=1e-3, rtol=0)


def test_full_tree_round_trip(tiny):
    """port state_dict -> JAX importer -> the same flax variables."""
    sd = tiny['port'].state_dict()
    assert sorted(sd) == sorted(W.state_dict_from_jax(tiny['variables']))
    back = import_dfm_state_dict(sd, tiny['variables'], strict=True)
    a = jax.tree_util.tree_leaves_with_path(tiny['variables'])
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(a) == len(b)
    for path, leaf in a:
        np.testing.assert_array_equal(np.asarray(b[path]), np.asarray(leaf))


def test_key_map_copy_matches_jax():
    assert W.dfm_key_map() == jax_key_map()


def test_dfm_predict_matches_jax():
    """Decode + rotated NMS on the same head outputs (continuous random
    scores: no ties for top-k to order differently)."""
    kw = dict(TINY, max_num=24)
    jcfg, pcfg = JConfig(**kw), DfMConfig(**kw)
    _, ny, nx = pcfg.voxel_grid_size()
    rng = np.random.RandomState(1)
    heads = dict(cls_score=rng.randn(2, ny, nx, 18) * 1.5 - 1.0,
                 bbox_pred=rng.randn(2, ny, nx, 42) * 0.3,
                 dir_pred=rng.randn(2, ny, nx, 12))
    heads = {k: v.astype(np.float32) for k, v in heads.items()}
    want = jax.jit(lambda o: jax_predict(o, jcfg))(
        {k: jnp.asarray(v) for k, v in heads.items()})
    got = dfm_predict({k: torch.from_numpy(v) for k, v in heads.items()},
                      pcfg)
    assert set(got) == set(want)
    mask = np.asarray(want['mask'])
    assert mask.sum() > 10
    np.testing.assert_array_equal(got['mask'].numpy(), mask)
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), atol=1e-6)
    np.testing.assert_allclose(got['boxes3d'].numpy(),
                               np.asarray(want['boxes3d']), atol=1e-4,
                               rtol=1e-5)


@pytest.fixture(scope='module')
def golden():
    return np.load(GOLDEN)


def _golden_inputs(z, tag):
    return dict(
        cur=z['cur'].transpose(0, 2, 3, 1), prev=z['prev'].transpose(
            0, 2, 3, 1), depths=z['depths'], cam=z['cam2img'][None],
        c2p=z['cur2prev'][None],
        kw=dict(org_w=np.asarray([z[f'{tag}.org_w']], np.float32),
                flip=np.asarray([z[f'{tag}.flip']], np.float32),
                crop_offset=np.asarray(z[f'{tag}.crop_offset'],
                                       np.float32)[None],
                scale_factor=np.asarray([z[f'{tag}.scale_factor']],
                                        np.float32)))


@pytest.mark.parametrize('tag', ['id', 'aug'])
def test_dfm_backbone_matches_golden_and_flax(golden, tag):
    z = golden
    g = _golden_inputs(z, tag)
    sd = {k[3:]: torch.from_numpy(np.asarray(z[k], np.float32))
          for k in z.files if k.startswith('sd.')}
    port = DfMBackbone(in_channels=g['cur'].shape[-1], cv_channels=32,
                       cost_sample_factor=4,
                       num_depth_bins_out=len(g['depths']))
    port.load_state_dict(sd, strict=True)
    t = torch.from_numpy
    with torch.inference_mode():
        cost, stereo, mono = port(
            t(g['cur']), t(g['prev']), t(g['depths']), t(g['cam']),
            t(g['c2p']), **{k: t(v) for k, v in g['kw'].items()})
    cost = cost[..., 0].numpy()[:, None]                    # (B,1,D,H,W)
    stereo = stereo.numpy().transpose(0, 4, 1, 2, 3)
    mono = mono.numpy().transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(stereo, z[f'{tag}.stereo'], atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(mono, z[f'{tag}.mono'], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(cost, z[f'{tag}.cost'], atol=4e-3, rtol=4e-3)

    # the flax module (its default banded form) on the same weights
    mdl = JBackbone(in_channels=g['cur'].shape[-1], cv_channels=32,
                    cost_sample_factor=4, feat_sample_factor=1,
                    num_depth_bins_out=len(g['depths']), norm='gn')
    args = [jnp.asarray(g[k]) for k in ('cur', 'prev', 'depths', 'cam',
                                        'c2p')]
    jkw = {k: jnp.asarray(v) for k, v in g['kw'].items()}
    v = mdl.init(jax.random.PRNGKey(0), *args, **jkw)
    km = [(k[len('backbone_stereo.'):], f[1:], kind)
          for k, f, kind in jax_key_map()
          if k.startswith('backbone_stereo.')]
    filled = import_dfm_state_dict({k: v_.numpy() for k, v_ in sd.items()},
                                   {'params': v['params']}, key_map=km)
    jc, js, jm = mdl.apply({'params': filled['params']}, *args, **jkw)
    np.testing.assert_allclose(cost[:, 0], np.asarray(jc[..., 0]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(stereo, np.asarray(js).transpose(0, 4, 1, 2, 3),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(mono, np.asarray(jm).transpose(0, 4, 1, 2, 3),
                               atol=1e-4, rtol=1e-4)


def test_init_dfm_model_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA'):
        init_dfm_model(DfMConfig(**TINY))
    h = init_dfm_model(DfMConfig(**TINY), dtype=torch.float32, device='cpu')
    assert next(h['model'].parameters()).device.type == 'cpu'


def test_port_runs_without_jax(tmp_path):
    """A fresh process imports the port (with the K9a / K9b modules, the
    card-only scripts, the KITTI data, evaluation, config, builder and
    tool modules, the training modules, MultiViewDfM's with `DfMNeck`,
    the CenterHead and `voxel_sample`, and 3DSSD's, MVX's, VoteNet's,
    GroupFree3D's, ImVoteNet's, H3DNet's and the indoor data's) and runs a
    tiny CPU forward
    in the full-chain form, whose neck runs the fused K2's plain
    version, K1's sweep on the CPU, a tiny `dataset_inference` on a
    synthetic KITTI tree in `tmp_path` (PNG files), and one CPU train
    step on a training sample of that tree (flip, resize, photometric
    distortion), and one DfMFull step on a synthetic batch with a teacher
    file written and read back, without loading JAX, cv2, PIL, optax or
    msgpack."""
    code = (
        'import sys, numpy as np, torch\n'
        'torch.set_num_threads(1)    # small ops; workers share the cores\n'
        'from dfm_tpu_torch.apis import init_dfm_model, dataset_inference\n'
        'import dfm_tpu_torch.ops.convgn, dfm_tpu_torch.ops.conv3d\n'
        'import dfm_tpu_torch.ops.cuda.conv3d\n'
        'import dfm_tpu_torch.trace_main, dfm_tpu_torch.probe_k5\n'
        'import dfm_tpu_torch.data.calibration, dfm_tpu_torch.data.png\n'
        'import dfm_tpu_torch.data.pipeline, dfm_tpu_torch.data.collate\n'
        'import dfm_tpu_torch.evaluation.kitti_eval\n'
        'import dfm_tpu_torch.evaluation.results\n'
        'import dfm_tpu_torch.runtime.config, dfm_tpu_torch.models.builder\n'
        'import dfm_tpu_torch.tools.test, dfm_tpu_torch.tools.create_data\n'
        'import dfm_tpu_torch.core.targets, dfm_tpu_torch.core.losses\n'
        'import dfm_tpu_torch.models.heads.depth_head\n'
        'import dfm_tpu_torch.runtime.schedule, dfm_tpu_torch.runtime.train\n'
        'import dfm_tpu_torch.runtime.checkpoint\n'
        'import dfm_tpu_torch.runtime.logging, dfm_tpu_torch.tools.train\n'
        'import dfm_tpu_torch.models.necks.dfm_neck\n'
        'import dfm_tpu_torch.models.heads.center_head\n'
        'import dfm_tpu_torch.ops.voxel_sample, dfm_tpu_torch.data.waymo\n'
        'import dfm_tpu_torch.models.detectors.multiview_dfm\n'
        'import dfm_tpu_torch.models.detectors.ssd3d\n'
        'import dfm_tpu_torch.models.detectors.mvx_two_stage\n'
        'import dfm_tpu_torch.models.detectors.votenet\n'
        'import dfm_tpu_torch.models.detectors.groupfree3d\n'
        'import dfm_tpu_torch.models.detectors.imvotenet\n'
        'import dfm_tpu_torch.models.detectors.h3dnet\n'
        'import dfm_tpu_torch.ops.grid_sample, dfm_tpu_torch.data.indoor\n'
        'import dfm_tpu_torch.evaluation.indoor_eval\n'
        'import dfm_tpu_torch.tools.data_converter.indoor_converter\n'
        'from dfm_tpu_torch.data.collate import build_batch\n'
        'from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer\n'
        'from dfm_tpu_torch.runtime.schedule import liga_schedule\n'
        'from dfm_tpu_torch.data.kitti import KittiDataset, '
        'build_kitti_infos\n'
        'import chip_smoke\n'
        'from dfm_tpu_torch.ops import cost_volume as CV\n'
        'from dfm_tpu_torch.ops.cuda.sampling import warp_prev_sweep\n'
        'from dfm_tpu_torch.models.detectors.dfm import BatchMeta, '
        'DfMConfig\n'
        f'cfg = DfMConfig(**{TINY!r})\n'
        "h = init_dfm_model(cfg, dtype=torch.float32, device='cpu', "
        'packed=True)\n'
        f'img = torch.randn(1, 2, {H}, {W_}, 3, '
        'generator=torch.Generator().manual_seed(0))\n'
        'cam = np.eye(4, dtype=np.float32); cam[0, 0] = cam[1, 1] = 200.\n'
        f'cam[0, 2], cam[1, 2] = {W_ / 2}, {H / 2}\n'
        "bb = h['model'].backbone_stereo\n"
        'took = []\n'
        'hg = bb._packed_hg\n'
        'bb._packed_hg = lambda x: took.append(hg(x)) or took[-1]\n'
        "det = h['infer'](img, BatchMeta.identity(1, cam[None]))\n"
        "assert torch.isfinite(det['boxes3d']).all()\n"
        'assert took == [True]          # the hourglass ran on the chain\n'
        'p = CV.sweep_params(torch.eye(4)[None], torch.eye(4)[None], '
        'torch.ones(1), torch.zeros(1), torch.zeros(1, 2), torch.ones(1))\n'
        'out = warp_prev_sweep(torch.randn(1, 8, 16, 4), p, '
        'torch.tensor([2., 4.]), 4, 8, 2)\n'
        'assert out.shape == (1, 2, 4, 8, 4) and torch.isfinite(out).all()\n'
        f'ids = chip_smoke.write_kitti_tree({str(tmp_path)!r}, '
        'frames=chip_smoke.KITTI_FRAMES[1:3])\n'
        f'ds = KittiDataset({str(tmp_path)!r}, build_kitti_infos('
        f'{str(tmp_path)!r}, ids), train=False, '
        f'pipeline_kwargs=dict(crop_size=({H}, {W_})))\n'
        'annos = dataset_inference(h, ds)\n'
        "assert len(annos) == 2 and all('score' in a for a in annos)\n"
        f'tr = KittiDataset({str(tmp_path)!r}, build_kitti_infos('
        f'{str(tmp_path)!r}, ids), train=True, pipeline_kwargs=dict('
        f'crop_size=({H}, {W_}), flip_ratio=1.0))\n'
        "img, meta, gt = build_batch([tr.get_sample(0, "
        "np.random.default_rng(1))], 'cpu')\n"
        "m = init_dfm_model(cfg, dtype=torch.float32, device='cpu')"
        "['model']\n"
        'step = TrainStep(m, make_optimizer(m), liga_schedule(1e-3))\n'
        'out = step(img, meta, gt, torch.Generator().manual_seed(0))\n'
        "assert all(torch.isfinite(v) for v in out.values()), out\n"
        "assert m.training and float(meta.flip[0]) == 1.0\n"
        'from dfm_tpu_torch.models.detectors.dfm_full import DfMFull\n'
        'from dfm_tpu_torch.runtime.adapters import dfm_synth, to_device\n'
        'from dfm_tpu_torch.utils.msgpack_tree import load_msgpack_tree\n'
        'from dfm_tpu_torch.utils.msgpack_tree import msgpack_dumps\n'
        'from dfm_tpu_torch.utils.weights import init_weights\n'
        'full = init_weights(DfMFull(cfg))\n'
        "f = r'" + str(tmp_path / 'teacher.msgpack') + "'\n"
        'open(f, "wb").write(msgpack_dumps('
        'chip_smoke.teacher_tree(full.lidar_teacher, 0)))\n'
        "assert 'enc0' in load_msgpack_tree(f)['params']\n"
        'step = TrainStep(full, make_optimizer(full, frozen_prefixes=('
        "'lidar_teacher',)), liga_schedule(1e-3))\n"
        "out = step(*to_device(dfm_synth(cfg, 1, 0, full=True), 'cpu'))\n"
        "assert torch.isfinite(out['loss_imitation'])\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n"
        "assert 'optax' not in sys.modules and 'msgpack' not in sys.modules\n"
        "assert not any(m.split('.')[0] == 'dfm_tpu' for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith('ok')


def test_no_jax_import_in_port_sources():
    pat = re.compile(
        r'^\s*(import|from)\s+(jax|flax|optax|msgpack|dfm_tpu|cv2|PIL)'
        r'(\.|\s|$)', re.M)
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, names in os.walk(os.path.join(ROOT, 'dfm_tpu_torch')):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    assert len(files) > 20
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_greedy_suppress_matches_jax(seed):
    """The fixed-point form of greedy NMS == the JAX sequential loop, on
    dense random overlaps (long suppression chains) and dead entries."""
    from dfm_tpu.core.nms import _greedy_suppress as jax_greedy
    from dfm_tpu_torch.core.nms import _greedy_suppress
    rng = np.random.RandomState(seed)
    n = 96
    iou = rng.rand(n, n).astype(np.float32)
    iou = (iou + iou.T) / 2
    scores = rng.rand(3, n).astype(np.float32)
    scores[rng.rand(3, n) < 0.2] = -np.inf
    want = np.stack([np.asarray(jax_greedy(jnp.asarray(iou),
                                           jnp.asarray(s), 0.5))
                     for s in scores])
    got = _greedy_suppress(torch.from_numpy(iou), torch.from_numpy(scores),
                           0.5).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_bev_matches_jax():
    from dfm_tpu.core.nms import nms_bev as jax_nms_bev
    from dfm_tpu_torch.core.nms import nms_bev
    rng = np.random.RandomState(3)
    n = 64
    boxes = np.concatenate([rng.rand(n, 2) * 8, rng.rand(n, 2) * 3 + 1,
                            rng.rand(n, 1) * np.pi], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    want = jax_nms_bev(jnp.asarray(boxes), jnp.asarray(scores), 0.25,
                       jnp.asarray(valid))
    got = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), 0.25,
                  torch.from_numpy(valid))
    assert 0 < int(got.sum()) < n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
