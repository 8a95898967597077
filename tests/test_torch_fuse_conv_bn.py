"""The BatchNorm fold (`utils/fuse_conv_bn.py`, `tools.test
--fuse-conv-bn`) on the CPU, in float32, torch in one thread.

* The folded weights against JAX's `fuse_conv_bn` on the same seeded
  flax variables of a tiny FCOS3D (ResNet-18: 20 pairs): the same count,
  each conv's weight and the new bias (JAX's BatchNorm bias after its
  fold; its conv has none) within 1e-6 (both fold in float64 and round
  to float32).
* The fused model's outputs against the unfused ones, every output by
  relative L2 1e-4, on tiny FCOS3D and PGD, a tiny MultiViewDfM camsync
  (OutdoorImVoxelNeck's strided convs), its 10-sweeps variant (DfMNeck's
  z-valid final convs) and its CenterHead variant (ConvNorms with a
  bias), and the tiny DfM (the LIGA backbone and the upconv module; its
  GroupNorm trunks keep their norms); the BatchNorms' running statistics
  and affines are seeded away from the identity first.
* A conv with its own bias: JAX's fold keeps the conv bias unscaled
  (`dfm_tpu/utils/fuse_conv_bn.py:20-37` folds the kernel alone), so its
  fused output moves by bias x (factor - 1); the port's fold scales the
  bias and keeps the output. A model in train mode is refused.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from dfm_tpu.models.detectors.fcos_mono3d import FCOSMono3D as JFCOS
from dfm_tpu.models.heads.fcos_mono3d import FCOS3DConfig as JConfig
from dfm_tpu.models.layers import ConvNorm as JConvNorm
from dfm_tpu.utils.fuse_conv_bn import fuse_conv_bn as jax_fuse
from dfm_tpu_torch.models.detectors.dfm import BatchMeta, DfM, DfMConfig
from dfm_tpu_torch.models.detectors.multiview_dfm import (MultiViewDfM,
                                                          MVDfMConfig)
from dfm_tpu_torch.models.heads.fcos_mono3d import FCOS3DConfig
from dfm_tpu_torch.models.layers import BatchNorm, ConvNorm
from dfm_tpu_torch.models.builder import mono_model
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
from dfm_tpu_torch.utils.weights import _conv_weight, init_weights

from test_torch_dfm import TINY as DFM_TINY, _np_meta, _tiny_cam
from test_torch_multiview_dfm import flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the tiny MultiViewDfM configs and inputs)

WEIGHT_TOL = 1e-6
REL_L2 = 1e-4
MONO = dict(backbone_depth=18, in_channels=32, feat_channels=32,
            nms_pre=100, max_num=20)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # small ops; the suite's workers share cores
    yield
    torch.set_num_threads(threads)


def seeded_stats(model, seed):
    """Every BatchNorm's running statistics and affine away from the
    identity (seeded)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
                m.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
                m.bias.copy_(0.3 * torch.randn(c, generator=g))
    return model.eval()


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def test_folded_weights_match_jax():
    jcfg, pcfg = JConfig(**{k: v for k, v in MONO.items()
                            if k != 'backbone_depth'}), \
        FCOS3DConfig(**{k: v for k, v in MONO.items()
                        if k != 'backbone_depth'})
    img = np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32)
    variables = flax_variables(JFCOS(cfg=jcfg, backbone_depth=18), img,
                               seed=4)
    fused, n = jax_fuse(variables)
    key_map = W.mono_key_map(pcfg, 18)
    port = mono_model(dict(type='FCOSMono3D', **MONO))
    port.load_state_dict(W.state_dict_from_jax(variables, key_map),
                         strict=True)
    assert fuse_conv_bn(port.eval()) == n == 20
    params = dict(port.named_parameters())
    folded = 0
    for prefix, fpath, kind in key_map:
        if kind != 'bn':
            continue
        conv = [(p, f) for p, f, k in key_map if k == 'conv2d' and
                f[:-1] == fpath[:-1] and f[-1] == 'Conv_' +
                fpath[-1].split('_')[1]]
        assert len(conv) == 1, prefix
        cp, cf = conv[0]
        node = fused['params']
        for k in cf:
            node = node[k]
        np.testing.assert_allclose(
            params[f'{cp}.weight'].detach().numpy(),
            _conv_weight(node['kernel'], 'conv2d'), rtol=WEIGHT_TOL,
            atol=WEIGHT_TOL, err_msg=cp)
        bn = fused['params']
        for k in fpath:
            bn = bn[k]
        np.testing.assert_allclose(params[f'{cp}.bias'].detach().numpy(),
                                   bn['bias'], rtol=WEIGHT_TOL,
                                   atol=WEIGHT_TOL, err_msg=cp)
        assert prefix + '.weight' not in params
        folded += 1
    assert folded == 20


def _mono_case(kind):
    model = seeded_stats(init_weights(mono_model(dict(type=kind, **MONO)),
                                      1), 2)
    img = torch.from_numpy(np.random.RandomState(3).randn(
        2, 96, 160, 3).astype(np.float32))

    def outputs(m):
        return {f'{lvl}.{k}': v for lvl, o in enumerate(m(img))
                for k, v in o.items()}

    return model, outputs


def _mv_case(extra):
    cfg = MVDfMConfig(**dict(chip_smoke.MV_TEMPORAL_TINY, **extra))
    model = seeded_stats(init_weights(MultiViewDfM(cfg), 1), 2)
    imgs, l2i = chip_smoke._mv_inputs(cfg, chip_smoke.MV_TEMPORAL_HW,
                                      cfg.num_frames, 5)
    return model, lambda m: chip_smoke._flat_outputs(m(imgs, l2i))


def _dfm_case():
    model = seeded_stats(init_weights(DfM(DfMConfig(**DFM_TINY), packed=False),
                                      1), 2)
    img = torch.from_numpy(np.random.RandomState(0).randn(
        1, 2, 64, 128, 3).astype(np.float32))
    m = _np_meta(_tiny_cam())
    m['cur2prev'][0, :3, 3] = (0.1, 0.0, -0.6)
    meta = BatchMeta(**{k: torch.from_numpy(v) for k, v in m.items()})
    return model, lambda mdl: {k: v for k, v in mdl(img, meta).items()
                               if torch.is_tensor(v)}


# the pairs: ResNet-18 20 (stem, 8 blocks x 2, 3 downsamples);
# OutdoorImVoxelNeck 9 (3 ResModule3D x 2 + 3 downs); DfMNeck 18 (2 paths
# x (3 ResModule3D x 2 + 2 downs + the final BatchNorm)); the CenterHead
# 11 (shared_conv + 2 tasks x 5 branch ConvNorms)
CASES = {
    'FCOSMono3D': (lambda: _mono_case('FCOSMono3D'), 20),
    'PGD': (lambda: _mono_case('PGD'), 20),
    'mvdfm camsync': (lambda: _mv_case(dict(
        num_frames=1, frame_fusion='mean', neck_3d='imvoxel')), 20 + 9),
    'mvdfm 10-sweeps': (lambda: _mv_case({}), 20 + 18),
    'mvdfm center': (lambda: _mv_case(dict(bbox_head='center')),
                     20 + 18 + 11),
    'dfm': (_dfm_case, None),
}


@pytest.mark.parametrize('case', list(CASES))
def test_fused_outputs_match_unfused(case):
    make, count = CASES[case]
    model, outputs = make()
    with torch.no_grad():
        want = outputs(model)
        n = fuse_conv_bn(model)
        got = outputs(model)
    if count is not None:
        assert n == count
    assert n > 0
    assert not any(isinstance(m, BatchNorm) for m in model.modules()) or \
        case == 'dfm'
    assert set(got) == set(want)
    bad = {k: rel_l2(got[k], v) for k, v in want.items()
           if v.is_floating_point() and v.numel() and
           rel_l2(got[k], v) > REL_L2}
    assert not bad, bad


def test_conv_bias_is_folded_unlike_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(1, 7, 8, 6).astype(np.float32)
    jmod = JConvNorm(8, (3, 3), norm='bn', use_bias=True)
    variables = flax_variables(jmod, x, seed=7)
    jwant = np.asarray(jmod.apply(variables, x, train=False))
    jfused, n = jax_fuse(variables)
    assert n == 1
    jgot = np.asarray(jmod.apply(jfused, x, train=False))
    stats = variables['batch_stats']['BatchNorm_0']
    factor = variables['params']['BatchNorm_0']['scale'] / np.sqrt(
        stats['var'] + 1e-5)
    drift = np.abs(variables['params']['Conv_0']['bias'] * (factor - 1))
    assert drift.max() > 1e-2
    assert np.abs(jgot - jwant).max() > 1e-2          # JAX's fold moves it
    port = ConvNorm(6, 8, 3, norm='bn', bias=True)
    port.load_state_dict(W.state_dict_from_jax(variables, [
        ('conv', ('Conv_0',), 'conv2d'), ('bn', ('BatchNorm_0',), 'bn')]),
        strict=True)
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad():
        assert fuse_conv_bn(port.eval()) == 1
        got = port(xt).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), jwant, rtol=1e-5,
                               atol=1e-5)


def test_train_mode_is_refused():
    with pytest.raises(ValueError, match='eval mode'):
        fuse_conv_bn(mono_model(dict(type='FCOSMono3D', **MONO)).train())
