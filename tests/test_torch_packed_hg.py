"""The port's full conv chain (dfm_tpu_torch) against the JAX package:
the 3D hourglass on the chain format and the backbone's default form.

* `packed_hourglass` against the JAX `packed_hourglass` with the Pallas
  kernels (K5 `conv_s2_p2d`, K6 `pack_parity8`, K7b's `gn_from_partials`)
  in interpret mode, and against the port's dense `Hourglass` and its
  reduced-depth `red_hourglass` on the same parameters: float32, atol
  2e-3 + rtol 1e-3 (the JAX test's tolerance: ten stacked convs and
  GroupNorms summed in another order).
* `DfMBackbone` in its default bfloat16 form against the JAX backbone
  under `DFM_PACKED=interpret DFM_PACKED_HG=1 DFM_PACKED_MONO=1` at
  D = 8 (stereo trunk on the chain, mono trunk dense: too short to
  reduce) and D = 48 (both trunks), atol 0.15 + rtol 0.15 (the JAX
  test's tolerance for bf16). The JAX side takes the packed hourglass
  only for planes of 16 x 16 and more, so the inputs are 64 x 64 and
  the calls of the JAX `conv_s2_p2d` are counted.
The CUDA kernels themselves run only on the card
(`tests/test_torch_kernels.py`, `cuda` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.ops.pallas.conv_chain as JCC
from dfm_tpu.models import layers as FL
from dfm_tpu.models.backbones import dfm_backbone as JB
from dfm_tpu_torch.models import layers as PL
from dfm_tpu_torch.models.backbones import dfm_backbone as PB
from dfm_tpu_torch.ops import conv_chain as CC
from dfm_tpu_torch.ops.cuda import sampling as K
from dfm_tpu_torch.ops.reduced_depth import make_reduced_plan
from dfm_tpu_torch.utils import weights as W

from test_torch_conv_chain import _backbone_inputs, _backbone_km, t
from test_torch_layers import carry, randomize, submap

torch.set_num_threads(1)    # from import on; the workers share the cores

D, H, Wd, TH = 8, 16, 32, 8
HG_TOL = dict(atol=2e-3, rtol=1e-3)


class _Plan:
    """The multiplicities of a reduced-depth plan, given outright."""

    def __init__(self, mults):
        self._m = mults

    def mult(self, scale):
        return self._m[scale]


@pytest.fixture(scope='module')
def hourglass():
    """A flax Hourglass with seeded weights, the same weights as the JAX
    parameter holders and in the port's module, and one input volume."""
    x = np.random.RandomState(10).randn(D, H, Wd, 32).astype(np.float32)
    fhg = FL.Hourglass(32, ndim=3, norm='gn')
    vh = randomize(fhg.init(jax.random.PRNGKey(1), jnp.asarray(x)[None]), 14)
    hp = JB.HourglassParams(32).apply(
        {'params': jax.tree.map(jnp.asarray, vh['params'])})
    hg = carry(PL.Hourglass(32), vh,
               submap(W._hourglass('hg', ('hg',), 3), 'hg', ('hg',)))
    return dict(x=x, fhg=fhg, vh=vh, hp=hp, hg=hg,
                pv=JCC.pack_vol_ref(jnp.asarray(x), phase=0, th=TH))


def test_packed_hourglass_matches_jax_and_dense(hourglass):
    """x + Hourglass(x), staying in the chain format."""
    r = hourglass
    want = JB.packed_hourglass(r['pv'], r['hp'], interpret=True)
    fres, _, _ = r['fhg'].apply(r['vh'], jnp.asarray(r['x'])[None])
    K.reset_launch_counts()
    with torch.inference_mode():
        got = PB.packed_hourglass(r['hg'], CC.pack_vol_plain(t(r['x'])))
        x5 = t(r['x']).permute(3, 0, 1, 2)[None]
        dense = (x5 + r['hg'](x5))[0].permute(1, 2, 3, 0)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}
    assert got.border_is_zero() and got.shape == (D, H, Wd, 32)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(JCC.unpack_vol_ref(want)), **HG_TOL)
    np.testing.assert_allclose(got.interior().numpy(), dense.numpy(),
                               **HG_TOL)
    np.testing.assert_allclose(dense.numpy(), r['x'] + np.asarray(fres[0]),
                               **HG_TOL)


def test_packed_hourglass_weighted_matches_jax_and_red_hourglass(hourglass):
    """With slice multiplicities every GroupNorm weighs its statistics:
    `red_hourglass` on the chain, and the pred exit weighted the same
    way."""
    r = hourglass
    rng = np.random.RandomState(12)
    mults = tuple(rng.randint(1, 7, size=D >> s).astype(np.float32)
                  for s in range(3))
    want = JB.packed_hourglass(r['pv'], r['hp'], mults=mults, interpret=True)
    kp = (rng.randn(3, 3, 3, 32, 32) * 0.1).astype(np.float32)
    sp = (1 + 0.3 * rng.randn(32)).astype(np.float32)
    bp = (0.3 * rng.randn(32)).astype(np.float32)
    jup, jps = JCC.conv_p2p(want, jnp.asarray(kp), interpret=True)
    want_pred = JCC.unpack_affine_res(jup, jps, sp, bp, 32, relu=True,
                                      zw=mults[0], interpret=True)
    cn = PL.ConvNorm(32, 32, 3, ndim=3)
    cn.load_state_dict({
        'conv.weight': t(np.transpose(kp, (4, 3, 0, 1, 2))),
        'gn.weight': t(sp), 'gn.bias': t(bp)})
    with torch.inference_mode():
        got = PB.packed_hourglass(r['hg'], CC.pack_vol_plain(t(r['x'])),
                                  mults)
        pred = PB.chain_pred_convnorm(cn, got, mults[0])
        x5 = t(r['x']).permute(3, 0, 1, 2)[None]
        red = (x5 + PB.red_hourglass(r['hg'], x5, _Plan(mults)))
        red_pred = PB._red_conv_norm(cn.conv, cn.gn, red, mults[0], True)
    assert got.border_is_zero()
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(JCC.unpack_vol_ref(want)), **HG_TOL)
    np.testing.assert_allclose(got.interior().numpy(),
                               red[0].permute(1, 2, 3, 0).numpy(), **HG_TOL)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), **HG_TOL)
    np.testing.assert_allclose(pred.numpy(),
                               red_pred[0].permute(1, 2, 3, 0).numpy(),
                               **HG_TOL)
    # the weights matter: unweighted statistics give another result
    with torch.inference_mode():
        plain = PB.packed_hourglass(r['hg'], CC.pack_vol_plain(t(r['x'])))
    assert not torch.allclose(plain.data, got.data, atol=1e-2)


def test_stem_keep_packed_is_the_dense_stem_in_the_format():
    rng = np.random.RandomState(4)
    x = rng.randn(D, H, Wd, 32).astype(np.float32)
    cur2d = rng.randn(H, Wd, 32).astype(np.float32)
    dres0 = W.init_weights(PL.ConvNorm(64, 32, 3, ndim=3))
    dres1 = W.init_weights(PL.ConvNorm(32, 32, 3, ndim=3, act=False))
    with torch.inference_mode():
        prev = CC.pack_vol_plain(t(x))
        dense = PB.packed_stereo_stem(dres0, dres1, t(cur2d), prev)
        kept = PB.packed_stereo_stem(dres0, dres1, t(cur2d), prev,
                                     keep_packed=True)
    assert isinstance(kept, CC.ChainVol) and kept.border_is_zero()
    assert torch.equal(kept.interior(), dense)


@pytest.mark.parametrize('shape,plan_d,hg,mono', [
    ((1, 72, 80, 320, 32), 72, True, True),       # DfM-KITTI, full width
    ((1, 12, 16, 32, 32), 12, True, False),       # no reduced-depth plan
    ((1, 48, 16, 16, 32), 48, True, True),
    ((1, 48, 18, 16, 32), 48, False, False),      # H' not divisible by 4
    ((1, 10, 16, 16, 32), 10, False, False),      # D not divisible by 4
])
def test_chain_form_is_chosen_by_shape(shape, plan_d, hg, mono):
    """The full chain where the shapes allow it, else the chain stem, as
    the JAX package falls back; `packed='stem'` and float32 never take
    the hourglass on the chain by default."""
    x = torch.empty(shape, dtype=torch.bfloat16, device='meta')
    plan = make_reduced_plan(plan_d, e=2)
    for packed in (None, True):
        m = PB.DfMBackbone(packed=packed)
        assert m._packed(x)
        assert m._packed_hg(x) == hg
        assert m._packed_mono(x, plan) == mono
    stem = PB.DfMBackbone(packed='stem')
    assert stem._packed(x) and not stem._packed_hg(x)
    assert not stem._packed_mono(x, plan)
    for m in (PB.DfMBackbone(packed=False),
              PB.DfMBackbone(use_band=False, packed=False)):
        assert not (m._packed(x) or m._packed_hg(x)
                    or m._packed_mono(x, plan))
    x32 = torch.empty(shape, dtype=torch.float32, device='meta')
    assert not PB.DfMBackbone()._packed_hg(x32)
    assert PB.DfMBackbone(packed=True)._packed_hg(x32) == hg


def test_explicit_packed_true_warns_when_a_trunk_leaves_the_chain():
    """`packed=True` names the full chain: a trunk whose shapes send it to
    the `'stem'` form says so; the default (`packed=None`) and
    `packed='stem'` choose by shape in silence."""
    import warnings
    args = _backbone_inputs(8, 64, 64)      # 8 planes: no reduced-depth plan
    targs = [t(a) for a in args]
    with torch.inference_mode():
        with pytest.warns(RuntimeWarning, match='mono trunk.*no reduced'):
            PB.DfMBackbone(num_depth_bins_out=8, packed=True)(*targs)
        targs[0], targs[1] = (a.to(torch.bfloat16) for a in targs[:2])
        for packed in (None, 'stem'):
            with warnings.catch_warnings():
                warnings.simplefilter('error')
                PB.DfMBackbone(num_depth_bins_out=8, packed=packed)(*targs)
    # H' = 18 does not divide by 4: the stereo trunk says so before the
    # dense hourglass, which needs the same of its input, raises
    args = _backbone_inputs(8, 72, 64)
    with torch.inference_mode(), pytest.raises(RuntimeError), \
            pytest.warns(RuntimeWarning, match='stereo trunk.*divide by 4'):
        PB.DfMBackbone(num_depth_bins_out=8, packed=True)(
            *[t(a) for a in args])


@pytest.mark.parametrize('d', [8, 48])
def test_backbone_default_form_matches_jax_full_chain(monkeypatch, d):
    """bf16, the JAX backbone on its default branch (stem, hourglass and
    pred ConvNorm of both trunks through the Pallas kernels in interpret
    mode) against the port's default form."""
    args = _backbone_inputs(d, 64, 64)
    jargs = [jnp.asarray(a) for a in args]
    mdl = JB.DfMBackbone(in_channels=32, cv_channels=32,
                         cost_sample_factor=4, num_depth_bins_out=d,
                         norm='gn', dtype=jnp.bfloat16)
    monkeypatch.setenv('DFM_PACKED', '0')
    v = randomize(mdl.init(jax.random.PRNGKey(0), *jargs), 11)
    monkeypatch.setenv('DFM_PACKED', 'interpret')
    monkeypatch.setenv('DFM_PACKED_HG', '1')
    monkeypatch.setenv('DFM_PACKED_MONO', '1')
    calls = []
    jax_conv_s2 = JCC.conv_s2_p2d

    def counted(pv, *a, **kw):
        calls.append(pv.d)
        return jax_conv_s2(pv, *a, **kw)

    monkeypatch.setattr(JCC, 'conv_s2_p2d', counted)
    want = [np.asarray(o, np.float32) for o in mdl.apply(v, *jargs)]
    # the JAX side took the packed hourglass, and at D = 48 the packed
    # mono chain on its 44 reduced slices
    assert calls == ([8] if d == 8 else [48, 44])

    port = carry(PB.DfMBackbone(num_depth_bins_out=d), v, _backbone_km())
    K.reset_launch_counts()
    with torch.inference_mode():
        targs = [t(a) for a in args]
        targs[0], targs[1] = (a.to(torch.bfloat16) for a in targs[:2])
        prev = torch.empty((1, d, 16, 16, 32), dtype=torch.bfloat16)
        assert port._packed_hg(prev)              # on by default in bf16
        assert port._packed_mono(prev, make_reduced_plan(d)) == (d == 48)
        got = port(*targs)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w_.shape
        np.testing.assert_allclose(g.float().numpy(), w_, atol=0.15,
                                   rtol=0.15)
