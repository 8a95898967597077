"""Port layers (dfm_tpu_torch/models) against the flax modules.

Random flax variables (numpy, seeded) are carried into the port with
`state_dict_from_jax` and loaded strictly, so every test also pins the
key map and the layout rules (the transposed-conv spatial flip in
particular: a wrong flip gives plausible but different numbers).
Tolerance: float32, atol/rtol 1e-4 for single layers and 2e-4 for the
ResNet / neck stacks (XLA's and PyTorch's CPU convolutions sum in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models import layers as FL
from dfm_tpu.models.backbones.liga_resnet import LIGAResNet as FResNet
from dfm_tpu.models.necks.spp_unet import SPPUNetNeck as FNeck
from dfm_tpu.utils.checkpoint_import import import_dfm_state_dict
from dfm_tpu_torch.models import layers as PL
from dfm_tpu_torch.models.backbones.liga_resnet import LIGAResNet
from dfm_tpu_torch.models.necks.spp_unet import SPPUNetNeck
from dfm_tpu_torch.utils import weights as W

torch.set_num_threads(1)    # from import on; the workers share the cores

TOL = dict(atol=1e-4, rtol=1e-4)
STACK_TOL = dict(atol=2e-4, rtol=2e-4)


def randomize(variables, seed):
    """Seeded random values for every leaf of a flax variables tree:
    kernels lecun-scaled, norm scales near 1, biases / means small,
    variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == 'var':
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if name == 'scale':
            return (1 + 0.3 * rng.randn(*shape)).astype(np.float32)
        if name in ('bias', 'mean'):
            return (0.3 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(
        np.asarray, dict(variables)))


def carry(port, variables, key_map):
    """Load flax `variables` into the port module through the key map."""
    port.load_state_dict(W.state_dict_from_jax(variables, key_map),
                         strict=True)
    return port.eval()


def submap(key_map, prefix, fprefix):
    """Entries of `key_map` under torch `prefix` / flax `fprefix`, with
    both prefixes stripped."""
    return [(k[len(prefix) + 1:], f[len(fprefix):], kind)
            for k, f, kind in key_map
            if k.startswith(prefix + '.') and f[:len(fprefix)] == fprefix]


def to_nc(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def from_nc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_flax(mod, x, *, seed, **kw):
    v = randomize(mod.init(jax.random.PRNGKey(0), x, **kw), seed)
    return v, mod.apply(v, x, **kw)


@pytest.mark.parametrize('ndim,norm', [(2, 'gn'), (2, 'bn'), (3, 'gn'),
                                       (3, 'bn')])
def test_convnorm(ndim, norm):
    x = _x((2,) + (10, 12, 14)[3 - ndim:] + (24,))
    mod = FL.ConvNorm(64, (3,) * ndim, norm=norm)
    v, want = _run_flax(mod, jnp.asarray(x), seed=1, train=False)
    km = [('conv', ('Conv_0',), f'conv{ndim}d'),
          (norm, (W._norm_mod(norm),), norm)]
    port = carry(PL.ConvNorm(24, 64, 3, ndim=ndim, norm=norm), v, km)
    np.testing.assert_allclose(from_nc(port(to_nc(x))), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize('ndim', [2, 3])
def test_conv_transpose_norm(ndim):
    x = _x((1,) + (5, 6, 7)[3 - ndim:] + (6,))
    mod = FL.ConvTransposeNorm(8, ndim=ndim, norm='gn')
    v, want = _run_flax(mod, jnp.asarray(x), seed=2, train=False)
    km = [('0', ('ConvTranspose_0',), f'convt{ndim}d'),
          ('1', ('GroupNorm_0',), 'gn')]
    port = carry(torch.nn.Sequential(PL.ConvTranspose(6, 8, ndim),
                                     PL.GroupNorm(8)), v, km)
    got = from_nc(port(to_nc(x)))
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize('ndim', [2, 3])
def test_hourglass(ndim):
    x = _x((1,) + (8, 12, 16)[3 - ndim:] + (16,))
    mod = FL.Hourglass(16, ndim=ndim, norm='gn')
    v, (want, _, _) = _run_flax(mod, jnp.asarray(x), seed=3, train=False)
    port = carry(PL.Hourglass(16, ndim), v,
                 submap(W._hourglass('hg', ('hg',), ndim), 'hg', ('hg',)))
    np.testing.assert_allclose(from_nc(port(to_nc(x))), np.asarray(want),
                               **TOL)


def test_upconv_module():
    feats = [_x((2, 6, 8, 24), 0), _x((2, 12, 16, 12), 1),
             _x((2, 24, 32, 3), 2)]
    mod = FL.UpconvModule(up_channels=(16, 8), norm='bn')
    jf = [jnp.asarray(f) for f in feats]
    v = randomize(mod.init(jax.random.PRNGKey(0), jf), 4)
    want = mod.apply(v, jf)
    km = []
    for s in range(2):
        km += W._convbn(f'conv.{s}', (f'ConvNorm_{2 * s}',), 2, 'bn')
        km += W._convbn(f'redir.{s}', (f'ConvNorm_{2 * s + 1}',), 2, 'bn')
    port = carry(PL.UpconvModule(24, (12, 3), (16, 8)), v, km)
    got = from_nc(port([to_nc(f) for f in feats]))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_resize_align_corners_false_clamps():
    """The upconv resize (align_corners=False) clamps the source index
    to [0, in-1] at both ends, like the JAX matrix."""
    from dfm_tpu.ops.resize import _interp_matrix_np as jax_m
    from dfm_tpu_torch.ops.resize import _interp_matrix_np as port_m
    for args in ((5, 12, False), (7, 3, False), (6, 13, True), (1, 4, True)):
        np.testing.assert_array_equal(port_m(*args), jax_m(*args))


@pytest.fixture(scope='module')
def resnet_neck():
    """Narrow LIGAResNet-18 + SPPUNetNeck, flax outputs and variables."""
    img = _x((1, 32, 64, 3), 5)
    bb = FResNet(depth=18, base_channels=8)
    vb = randomize(bb.init(jax.random.PRNGKey(0), jnp.asarray(img)), 6)
    feats = bb.apply(vb, jnp.asarray(img))
    neck = FNeck(sem_channels=(16, 8), stereo_channels=(8, 8))
    nin = [jnp.asarray(img)] + list(feats)
    vn = randomize(neck.init(jax.random.PRNGKey(0), nin), 7)
    stereo, sem = neck.apply(vn, nin)
    return img, vb, feats, vn, (stereo, sem)


def _sub_km(module):
    km = W.dfm_key_map(stage_blocks=(2, 2, 2, 2))
    return submap(km, module, (module,))


def test_liga_resnet(resnet_neck):
    img, vb, feats, _, _ = resnet_neck
    port = carry(LIGAResNet(depth=18, base_channels=8), vb,
                 _sub_km('backbone'))
    got = port(to_nc(img))
    assert len(got) == len(feats)
    for g, w in zip(got, feats):
        np.testing.assert_allclose(from_nc(g), np.asarray(w), **STACK_TOL)


def test_spp_unet_neck(resnet_neck):
    img, _, feats, vn, (stereo, sem) = resnet_neck
    port = carry(SPPUNetNeck(in_channels=(3, 8, 16, 16, 16),
                             sem_channels=(16, 8), stereo_channels=(8, 8)),
                 vn, _sub_km('neck'))
    got_st, got_sem = port([to_nc(img)] + [to_nc(f) for f in feats])
    np.testing.assert_allclose(from_nc(got_st), np.asarray(stereo),
                               **STACK_TOL)
    np.testing.assert_allclose(from_nc(got_sem), np.asarray(sem),
                               **STACK_TOL)


def test_state_dict_round_trip_through_importer(resnet_neck):
    """port state_dict -> the JAX importer -> the same flax variables."""
    _, vb, _, vn, _ = resnet_neck
    km = W.dfm_key_map(stage_blocks=(2, 2, 2, 2))
    km = [e for e in km if e[0].split('.')[0] in ('backbone', 'neck')]
    variables = {'params': {'backbone': vb['params'],
                            'neck': vn['params']},
                 'batch_stats': {'backbone': vb['batch_stats'],
                                 'neck': vn['batch_stats']}}
    sd = W.state_dict_from_jax(variables, km)
    back = import_dfm_state_dict(sd, variables, key_map=km, strict=True)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
