"""DCNv2, the DCN ResNet, DLA-34 and the DLA neck in the port against the
JAX package, on the CPU.

The same seeded numpy inputs and seeded flax variables (carried over by
`utils/weights.py`'s key maps) go through both packages in float32, torch
in one thread. Every deformable layer runs with live offsets: the flax
`conv_offset` kernels (zero at init in both packages, which would hide a
wrong offset layout) are seeded and scaled (`live_offsets`) so that the
offsets span a few pixels, some taps falling outside the map and some on
integer coordinates; the op's own cases take offsets in +-3 px with a
quarter of them rounded to integers. Tolerances:

* `deform_conv2d` (stride 1 and 2, dilation 1 and 2, DCNv1 without a mask,
  a 1-pixel-wide map): the output within 1e-5 relative L2 of JAX's and of
  the float64 numpy reference of tests/test_deform_conv.py (`_ref_dcn`);
  the gradients of x, the offsets, the mask and the weight within 1e-5
  relative L2 of `jax.grad`'s; in float64 all four pass
  `torch.autograd.gradcheck` (finite differences) away from integer
  coordinates;
* the ResNet with `stage_with_dcn=(False, True, True, True)` at depth 18
  and 50, `DLANet`'s six levels and `DLANeck` with and without DCN (eval
  mode): each output within 1e-5 relative L2;
* the BatchNorm fold of the DCN ResNet-18 and of DLA + neck: within 1e-5
  relative L2 of the unfused model (float32); JAX's `fuse_conv_bn` pairs
  `Conv_i` with `BatchNorm_i` by index, which the named `DeformConv2d`
  shifts: on a DCN BasicBlock it folds bn1 into conv2 (the output moves
  by more than 1e-2), on a DCN Bottleneck it fails (ROADMAP.md section 3).
"""

import jax
import numpy as np
import pytest
import torch

from dfm_tpu.models.backbones.dla import DLANet as JDLANet
from dfm_tpu.models.backbones.resnet import ResNet as JResNet
from dfm_tpu.models.necks.dla_neck import DLANeck as JDLANeck
from dfm_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from dfm_tpu.utils.fuse_conv_bn import fuse_conv_bn as j_fuse_conv_bn
from dfm_tpu_torch.models.backbones.dla import DLANet
from dfm_tpu_torch.models.backbones.resnet import ResNet
from dfm_tpu_torch.models.layers import DeformConv2d
from dfm_tpu_torch.models.necks.dla_neck import DLANeck
from dfm_tpu_torch.ops.deform_conv import deform_conv2d, tap_positions
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn

from test_deform_conv import _ref_dcn
from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_layers import carry, submap
from test_torch_multiview_dfm import flax_variables

torch.set_num_threads(1)    # from import on; the workers share the cores

REL_L2 = 1e-5
FOLD_REL_L2 = 1e-5
JAX_FOLD_MOVES = 1e-2
DCN = (False, True, True, True)
B, H, WID = 2, 64, 96
LEVEL_HW = [(H >> max(i, 0), WID >> max(i, 0)) for i in range(6)]
# the op's cases: (stride, dilation, modulated, (h, w))
OP_CASES = [(1, 1, True, (7, 9)), (2, 1, True, (7, 9)), (1, 2, True, (7, 9)),
            (1, 1, False, (7, 9)), (1, 1, True, (3, 1))]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def live_offsets(variables, scale=8.0, seed=0):
    """`variables` with every `conv_offset` kernel and bias seeded afresh
    (kernel lecun-scaled x `scale`, bias std 0.5): offsets of a few
    pixels and mask logits away from 0."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == 'conv_offset':
                kern = np.asarray(v['kernel'])
                fan_in = int(np.prod(kern.shape[:-1]))
                out[k] = dict(
                    kernel=(rng.randn(*kern.shape) * scale /
                            np.sqrt(fan_in)).astype(np.float32),
                    bias=(0.5 * rng.randn(*np.shape(v['bias']))).astype(
                        np.float32))
            else:
                out[k] = walk(v)
        return out

    return dict(variables, params=walk(variables['params']))


def offset_spread(model, x):
    """(largest |offset|, share of taps outside the map) over every
    deformable layer of the port's `model` on input `x`."""
    stats = []

    def hook(mod, inp, out):
        k = mod.k
        off = out.float()[:, :2 * k * k]
        h, w = inp[0].shape[2:]
        py, px = tap_positions(off, k, k, mod.stride, mod.dilation)
        outside = (py < 0) | (py > h - 1) | (px < 0) | (px > w - 1)
        stats.append((float(off.abs().max()), float(outside.float().mean())))

    hooks = [m.conv_offset.register_forward_hook(
        lambda c, i, o, m=m: hook(m, i, o))
        for m in model.modules() if isinstance(m, DeformConv2d)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return max(s[0] for s in stats), float(np.mean([s[1] for s in stats]))


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(
        *args)


def _op_inputs(stride, dilation, modulated, hw, seed):
    rng = np.random.RandomState(seed)
    h, w = hw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.randn(B, h, w, 4).astype(np.float32)
    off = np.clip(rng.randn(B, ho, wo, 18) * 1.5, -3, 3)
    whole = rng.rand(*off.shape) < 0.25
    off = np.where(whole, np.round(off), off).astype(np.float32)
    mask = rng.rand(B, ho, wo, 9).astype(np.float32) if modulated else None
    weight = (rng.randn(3, 3, 4, 6) * 0.2).astype(np.float32)
    g = rng.randn(B, ho, wo, 6).astype(np.float32)
    return x, off, mask, weight, g


@pytest.mark.parametrize('stride,dilation,modulated,hw', OP_CASES)
def test_deform_conv2d_matches_jax_and_reference(stride, dilation, modulated,
                                                 hw):
    x, off, mask, weight, g = _op_inputs(stride, dilation, modulated, hw,
                                         stride + 3 * dilation + hw[1])

    def jax_loss(*a):
        xx, oo, ww = a[0], a[1], a[-1]
        mm = a[2] if modulated else None
        return (j_deform_conv2d(xx, oo, mm, ww, stride, dilation) * g).sum()

    jargs = (x, off) + ((mask,) if modulated else ()) + (weight,)
    want = np.asarray(_jit(lambda *a: j_deform_conv2d(
        a[0], a[1], a[2] if modulated else None, a[-1], stride,
        dilation), *jargs))
    jgrads = [np.asarray(t) for t in _jit(jax.grad(
        jax_loss, argnums=tuple(range(len(jargs)))), *jargs)]

    tx = nchw(x).requires_grad_()
    toff = nchw(off).requires_grad_()
    tmask = nchw(mask).requires_grad_() if modulated else None
    tw = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()
                          ).requires_grad_()
    out = deform_conv2d(tx, toff, tmask, tw, stride, dilation)
    (out * nchw(g)).sum().backward()
    got = nhwc(out)
    assert got.shape == want.shape
    assert rel_l2(got, want) <= REL_L2
    ref = _ref_dcn(x.astype(np.float64), off.astype(np.float64),
                   None if mask is None else mask.astype(np.float64),
                   weight.astype(np.float64), stride, dilation)
    assert rel_l2(got, ref) <= REL_L2
    grads = [nhwc(tx.grad), nhwc(toff.grad)] + \
        ([nhwc(tmask.grad)] if modulated else []) + \
        [tw.grad.numpy().transpose(2, 3, 1, 0)]
    for i, (gp, gj) in enumerate(zip(grads, jgrads)):
        assert np.abs(gj).max() > 0, i
        assert rel_l2(gp, gj) <= REL_L2, (i, rel_l2(gp, gj))


@pytest.mark.parametrize('stride,dilation,modulated', [(1, 1, True),
                                                       (2, 2, False)])
def test_deform_conv2d_gradcheck(stride, dilation, modulated):
    """Finite differences in float64 (offsets kept 0.1 px or more from
    integer coordinates: the bilinear weights kink there)."""
    rng = np.random.RandomState(5)
    ho = wo = (5 - 1) // stride + 1
    off = rng.uniform(-2.5, 2.5, (1, 18, ho, wo))
    frac = off - np.floor(off)
    off = np.floor(off) + np.clip(frac, 0.1, 0.9)
    args = [torch.from_numpy(a).requires_grad_() for a in (
        rng.randn(1, 2, 5, 5), off, rng.rand(1, 9, ho, wo),
        rng.randn(3, 2, 3, 3))]
    if not modulated:
        args[2] = None
    assert torch.autograd.gradcheck(
        lambda x, o, m, w: deform_conv2d(x, o, m, w, stride, dilation),
        args, eps=1e-6, atol=1e-7)


def _resnet_case(depth):
    jm = JResNet(depth=depth, stage_with_dcn=DCN)
    x = np.random.RandomState(depth).randn(B, H, WID, 3).astype(np.float32)
    v = live_offsets(flax_variables(jm, x, seed=4), seed=depth)
    want = [np.asarray(o) for o in _jit(
        lambda v, i: jm.apply(v, i, train=False), v, x)]
    key_map = submap(W.resnet_key_map('r', (), depth, DCN), 'r', ())
    port = carry(ResNet(depth, stage_with_dcn=DCN), v, key_map)
    return dict(jm=jm, x=x, v=v, want=want, key_map=key_map, port=port)


@pytest.fixture(scope='module')
def resnet18():
    return _resnet_case(18)


@pytest.fixture(scope='module')
def resnet50():
    return _resnet_case(50)


@pytest.mark.parametrize('depth', [18, 50])
def test_resnet_dcn_matches_jax(request, depth):
    case = request.getfixturevalue(f'resnet{depth}')
    port, x, want = case['port'], case['x'], case['want']
    biggest, outside = offset_spread(port, nchw(x))
    assert biggest > 3.0 and outside > 0.01, (biggest, outside)
    with torch.no_grad():
        got = port(nchw(x))
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_l2(nhwc(g), w) <= REL_L2, (i, rel_l2(nhwc(g), w))


def test_resnet_dcn_fold(resnet18, resnet50):
    """The port folds the DCN ResNet-18's 20 BatchNorms (the DCN conv1's
    into it); JAX's fold mis-pairs both depths."""
    port, x, v, jm = (resnet18[k] for k in ('port', 'x', 'v', 'jm'))
    port = carry(ResNet(18, stage_with_dcn=DCN), v, resnet18['key_map'])
    with torch.no_grad():
        got = port(nchw(x))
    assert fuse_conv_bn(port) == 1 + 2 * 8 + 3
    with torch.no_grad():
        fused = port(nchw(x))
    for g, w in zip(fused, got):
        assert rel_l2(g.numpy(), w.numpy()) <= FOLD_REL_L2
    # JAX's fold pairs conv2 (Conv_0 after the named DCN) with bn1
    vf, _ = j_fuse_conv_bn(v)
    moved = [np.asarray(o) for o in _jit(
        lambda v, i: jm.apply(v, i, train=False), vf, x)]
    assert rel_l2(moved[-1], resnet18['want'][-1]) > JAX_FOLD_MOVES
    # and a Bottleneck's conv3 (Conv_1) with bn2: a broadcast error
    with pytest.raises(ValueError):
        j_fuse_conv_bn(resnet50['v'])


@pytest.fixture(scope='module')
def dla_pair():
    jm = JDLANet()
    x = np.random.RandomState(3).randn(B, H, WID, 3).astype(np.float32)
    v = flax_variables(jm, x, seed=6)
    want = [np.asarray(o) for o in _jit(
        lambda v, i: jm.apply(v, i, train=False), v, x)]
    key_map = submap(W.dla_key_map(), 'backbone', ('backbone',))
    port = carry(DLANet(), v, key_map)
    with torch.no_grad():
        got = port(nchw(x))
    return dict(port=port, x=x, v=v, got=got, want=want, key_map=key_map)


def test_dla_levels_match_jax(dla_pair):
    got, want = dla_pair['got'], dla_pair['want']
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert nhwc(g).shape == w.shape == (B,) + LEVEL_HW[i] + (
            (16, 32, 64, 128, 256, 512)[i],)
        assert rel_l2(nhwc(g), w) <= REL_L2, (i, rel_l2(nhwc(g), w))


def _neck_case(levels, use_dcn):
    jm = JDLANeck(use_dcn=use_dcn)
    v = flax_variables(jm, levels, seed=7)
    if use_dcn:
        v = live_offsets(v, seed=8)
    want = np.asarray(_jit(lambda v, f: jm.apply(v, f, train=False), v,
                           levels))
    key_map = submap(W.dla_neck_key_map(use_dcn=use_dcn), 'neck', ('neck',))
    port = carry(DLANeck(use_dcn=use_dcn), v, key_map)
    return dict(v=v, want=want, key_map=key_map, port=port)


@pytest.fixture(scope='module')
def neck_dcn(dla_pair):
    return _neck_case(dla_pair['want'], True)


@pytest.fixture(scope='module')
def neck_plain(dla_pair):
    return _neck_case(dla_pair['want'], False)


@pytest.mark.parametrize('use_dcn', [True, False])
def test_dla_neck_matches_jax(request, dla_pair, use_dcn):
    """The neck on the trunk's (JAX's) six levels; its fold."""
    case = request.getfixturevalue('neck_dcn' if use_dcn else 'neck_plain')
    port, want = case['port'], case['want']
    feats = [nchw(f) for f in dla_pair['want']]
    if use_dcn:
        biggest, outside = _neck_spread(port, feats)
        assert biggest > 3.0 and outside > 0.01, (biggest, outside)
    with torch.no_grad():
        got = port(feats)
    assert nhwc(got).shape == want.shape == (B, H // 4, WID // 4, 64)
    assert rel_l2(nhwc(got), want) <= REL_L2
    n = sum(isinstance(m, DeformConv2d) for m in port.modules())
    assert n == (16 if use_dcn else 0)
    port = carry(DLANeck(use_dcn=use_dcn), case['v'], case['key_map'])
    assert fuse_conv_bn(port) == 16
    with torch.no_grad():
        fused = port(feats)
    assert rel_l2(fused.numpy(), got.numpy()) <= FOLD_REL_L2


def _neck_spread(port, feats):
    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.neck = port

        def forward(self, _):
            return self.neck(feats)

    return offset_spread(Wrap(), None)


def test_dla_fold_matches_unfused(dla_pair):
    port = carry(DLANet(), dla_pair['v'], dla_pair['key_map'])
    assert fuse_conv_bn(port) == 39
    with torch.no_grad():
        fused = port(nchw(dla_pair['x']))
    for g, w in zip(fused, dla_pair['got']):
        assert rel_l2(g.numpy(), w.numpy()) <= FOLD_REL_L2


@pytest.mark.parametrize('case', ['resnet18', 'resnet50', 'dla_pair',
                                  'neck_dcn', 'neck_plain'])
def test_key_maps_take_every_leaf(request, case):
    """The DCN ResNet, DLA and neck key maps name every leaf of the JAX
    trees, and the port's state dicts hold nothing else."""
    case = request.getfixturevalue(case)
    v = case['v']
    n_leaves = sum(x.size > 0 for x in jax.tree.leaves(v))
    sd = W.state_dict_from_jax(v, case['key_map'])
    assert len(sd) == n_leaves
    assert set(sd) == set(case['port'].state_dict())
