"""The port's conv chain, banded stems and reduced-depth mono trunk
(dfm_tpu_torch) against the JAX package.

* `ops/conv_chain.py` (plain versions of K4 `conv_p2p`, K5
  `conv_s2_p2d`, K6 `pack_parity8`, K7a `unpack_affine_res`, K7b
  `gn_affine_res_packed`, K8a `pack_vol`, K8b `unpack_vol`, the
  GroupNorm finishers and `convt1_parity`) against
  `dfm_tpu/ops/pallas/conv_chain.py` with the Pallas kernels in
  interpret mode, in BOTH of the JAX layout's phases: the port has one
  format and must agree with either. float32 data, atol 1e-4 (the JAX
  tests' own tolerance: the same f32 products summed in another order);
  moments rtol 1e-4 (+ atol 1e-2 on sums of ~4000 terms of size ~1).
* `ops/band_volume.py`, `ops/reduced_depth.py` and the reduced-depth
  hourglass / pred against the JAX functions and against the dense
  computation they shortcut, float32, atol 1e-4 (2e-4 after the
  hourglass: ten stacked convs and GroupNorms).
* `DfMBackbone` with the chain on against the JAX backbone under
  `DFM_PACKED=interpret DFM_PACKED_HG=0 DFM_PACKED_MONO=0
  DFM_PACKED_PRED=1` in bfloat16, atol 0.15 + rtol 0.15 (the JAX test's
  tolerance for bf16: identical math up to rounding places and
  accumulation order), and in float32 the port's four forms (dense,
  banded, chain stem, full chain) from one state dict, atol 1e-3. The
  hourglass on the chain and the backbone against the JAX full chain
  are in `tests/test_torch_packed_hg.py`.
The CUDA kernels themselves run only on the card: their cases are
`tests/test_torch_kernels.py::test_cuda_chain_kernels_match_plain` and
`::test_cuda_hourglass_kernels_match_plain` (`cuda` marker, skipped
here), in the file that needs no flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.ops.band_volume as JBV
import dfm_tpu.ops.pallas.conv_chain as JCC
from dfm_tpu.models import layers as FL
from dfm_tpu.models.backbones import dfm_backbone as JB
from dfm_tpu.ops.reduced_depth import make_reduced_plan as jax_plan
from dfm_tpu.utils.checkpoint_import import dfm_key_map as jax_key_map
from dfm_tpu_torch.models import layers as PL
from dfm_tpu_torch.models.backbones import dfm_backbone as PB
from dfm_tpu_torch.ops import band_volume as BV
from dfm_tpu_torch.ops import conv_chain as CC
from dfm_tpu_torch.ops.cuda import conv_chain as KC
from dfm_tpu_torch.ops.cuda import sampling as K
from dfm_tpu_torch.ops.reduced_depth import make_reduced_plan
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import carry, randomize, submap

D, H, Wd, TH = 8, 16, 32, 8
TOL = dict(atol=1e-4, rtol=0)
PHASES = [0, 2]


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def tw(k):
    """flax kernel (kD, kH, kW, I, O) -> the port's (O, I, kD, kH, kW)."""
    return t(np.transpose(k, (4, 3, 0, 1, 2)))


@pytest.fixture(scope='module')
def data():
    rng = np.random.RandomState(0)
    x = rng.randn(D, H, Wd, 32).astype(np.float32)
    k = (rng.randn(3, 3, 3, 32, 32) * 0.1).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(32)).astype(np.float32)
    bias = (0.3 * rng.randn(32)).astype(np.float32)
    return x, k, scale, bias


def jax_pack(x, phase):
    return JCC.pack_vol_ref(jnp.asarray(x), phase=phase, th=TH)


def jax_dense(pv):
    return np.asarray(JCC.unpack_vol_ref(pv))


def jax_ps_per_z(ps, pv):
    """JAX partial moments (NB, NH, 2, 128) -> (D, 2, 32): lane group g
    of block k holds depth slice 4k + g - phase."""
    p = np.asarray(ps).sum(axis=1)
    nb = p.shape[0]
    p = p.reshape(nb, 2, 4, 32).transpose(0, 2, 1, 3).reshape(nb * 4, 2, 32)
    return p[pv.phase:pv.phase + pv.d]


# ------------------------------------------------- format, K8a, K4, K7a

@pytest.mark.parametrize('phase', PHASES)
def test_pack_unpack_matches_jax(data, phase):
    x = data[0]
    cv = CC.pack_vol_plain(t(x))
    assert cv.data.shape == (D + 2, H + 2, Wd + 2, 32)
    assert cv.shape == (D, H, Wd, 32)
    assert cv.border_is_zero()
    assert torch.equal(CC.unpack_vol(cv), t(x))           # bit for bit
    pv = JCC.pack_vol(jnp.asarray(x), phase=phase, th=TH, interpret=True)
    np.testing.assert_array_equal(np.asarray(pv.data),
                                  np.asarray(jax_pack(x, phase).data))
    np.testing.assert_array_equal(CC.unpack_vol(cv).numpy(), jax_dense(pv))
    np.testing.assert_array_equal(
        CC.unpack_vol(cv).numpy(),
        np.asarray(JCC.unpack_vol(pv, interpret=True)))
    assert not CC.ChainVol(cv.data + 1).border_is_zero()


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('phase', PHASES)
def test_conv_p2p_matches_jax(data, phase, residual):
    x, k = data[:2]
    out, ps = JCC.conv_p2p(jax_pack(x, phase), jnp.asarray(k),
                           residual=residual, interpret=True)
    got, gps = CC.conv_p2p_plain(CC.pack_vol_plain(t(x)), tw(k), residual)
    assert got.border_is_zero()
    assert gps.shape == (D, 1, 2, 32) and gps.dtype == torch.float32
    np.testing.assert_allclose(got.interior().numpy(), jax_dense(out), **TOL)
    # moments per depth slice and channel, then folded over depth
    want = jax_ps_per_z(ps, out)
    np.testing.assert_allclose(gps.sum(1).numpy(), want, rtol=1e-4,
                               atol=1e-2)
    # ... and they are the moments of the result itself
    dense = got.interior().double()
    np.testing.assert_allclose(gps[:, 0, 0].numpy(),
                               dense.sum((1, 2)).numpy(), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(gps[:, 0, 1].numpy(),
                               (dense * dense).sum((1, 2)).numpy(),
                               rtol=1e-4, atol=1e-2)


def test_conv_p2p_chain_of_two(data):
    """conv(conv(x)) without leaving the format == two dense convs."""
    x, k = data[:2]
    o1, _ = CC.conv_p2p_plain(CC.pack_vol_plain(t(x)), tw(k))
    o2, _ = CC.conv_p2p_plain(o1, tw(k))
    j1, _ = JCC.conv_p2p(jax_pack(x, 0), jnp.asarray(k), interpret=True)
    j2, _ = JCC.conv_p2p(j1, jnp.asarray(k), interpret=True)
    np.testing.assert_allclose(o2.interior().numpy(), jax_dense(j2),
                               atol=1e-3, rtol=0)


def test_moments_are_of_the_unrounded_result(data):
    """In bf16 the moments are taken before the result is rounded: they
    differ from the moments of the stored tensor."""
    x, k = data[:2]
    cv = CC.pack_vol_plain(t(x).to(torch.bfloat16))
    out, ps = CC.conv_p2p_plain(cv, tw(k))
    assert out.data.dtype == torch.bfloat16
    exact, eps = CC.conv_p2p_plain(
        CC.ChainVol(cv.data.float()), tw(k).to(torch.bfloat16).float())
    torch.testing.assert_close(ps, eps, rtol=1e-6, atol=1e-4)
    stored = out.interior().float()
    assert not torch.allclose((stored * stored).sum((1, 2)), ps[:, 0, 1],
                              rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('phase', PHASES)
def test_gn_from_partials_matches_jax(data, phase, weighted):
    x, k, scale, bias = data
    zw = (np.arange(D) % 3 + 1).astype(np.float32) if weighted else None
    out, ps = JCC.conv_p2p(jax_pack(x, phase), jnp.asarray(k),
                           interpret=True)
    extra = jax_pack(x[::-1].copy(), out.phase)
    want = JCC.gn_from_partials(ps, out, scale, bias, 32, relu=True,
                                extra=extra.data, zw=zw)
    u, gps = CC.conv_p2p_plain(CC.pack_vol_plain(t(x)), tw(k))
    got = CC.gn_from_partials(gps, u, t(scale), t(bias), 32, relu=True,
                              extra=CC.pack_vol_plain(t(x[::-1].copy())),
                              zw=zw)
    assert got.border_is_zero()
    np.testing.assert_allclose(got.interior().numpy(), jax_dense(want),
                               **TOL)
    if not weighted:
        # GroupNorm of the dense conv (flax), then relu, then + extra
        gn = FL.GroupNorm(num_groups=32)
        v = {'params': {'scale': jnp.asarray(scale),
                        'bias': jnp.asarray(bias)}}
        ref = np.asarray(gn.apply(v, jnp.asarray(jax_dense(out))[None]))[0]
        np.testing.assert_allclose(got.interior().numpy(),
                                   np.maximum(ref, 0) + x[::-1], **TOL)


@pytest.mark.parametrize('mode', ['res', 'relu', 'relu_zw'])
def test_unpack_affine_res_matches_jax(data, mode):
    """The chain exit in the stem's mode (residual, no relu) and in the
    pred's (relu, no residual), the latter also with slice weights. The
    JAX residual wants a phase-0 conv output whose input is phase 2."""
    x, k, scale, bias = data
    zw = (np.arange(D) % 4 + 1).astype(np.float32) if mode == 'relu_zw' \
        else None
    jy = jax_pack(x, 2)
    ju, jps = JCC.conv_p2p(jy, jnp.asarray(k), interpret=True)
    want = JCC.unpack_affine_res(
        ju, jps, scale, bias, 32, res_pv=jy if mode == 'res' else None,
        relu=mode != 'res', zw=zw, interpret=True)
    y = CC.pack_vol_plain(t(x))
    u, ps = CC.conv_p2p_plain(y, tw(k))
    K.reset_launch_counts()
    got = CC.unpack_affine_res(u, ps, t(scale), t(bias), 32,
                               res=y if mode == 'res' else None,
                               relu=mode != 'res', zw=zw)
    assert K.LAUNCHES['unpack_affine_res'] == 0      # CPU: plain version
    assert got.shape == (D, H, Wd, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == 'res':        # affine, then the residual, unnormalised
        sc, bs = CC.gn_scale_bias(ps, u.shape, t(scale), t(bias), 32)
        np.testing.assert_allclose(
            got.numpy(), u.interior().numpy() * sc.numpy() + bs.numpy() + x,
            atol=1e-5)


def test_affine_order_is_affine_relu_residual():
    u = CC.pack_vol_plain(torch.full((1, 1, 1, 32), -2.0))
    r = CC.pack_vol_plain(torch.full((1, 1, 1, 32), -3.0))
    sc, bs = torch.full((32,), 2.0), torch.full((32,), 1.0)
    got = CC.unpack_affine_plain(u, sc, bs, res=r, relu=True)
    assert torch.equal(got, torch.full((1, 1, 1, 32), -3.0))  # relu(-3)=0, -3
    got = CC.unpack_affine_plain(u, sc, bs, res=r)
    assert torch.equal(got, torch.full((1, 1, 1, 32), -6.0))


@pytest.mark.parametrize('phase', PHASES)
def test_fold_ps_weighted(data, phase):
    x, k = data[:2]
    zw = np.random.RandomState(5).randint(1, 7, size=D).astype(np.float32)
    out, ps = JCC.conv_p2p(jax_pack(x, phase), jnp.asarray(k),
                           interpret=True)
    js, js2, jw = JCC.fold_ps_weighted(ps, zw, out.phase, D)
    u, gps = CC.conv_p2p_plain(CC.pack_vol_plain(t(x)), tw(k))
    s, s2, wsum = CC.fold_ps_weighted(gps, zw)
    assert wsum == jw == float(zw.sum())
    dense = u.interior().double().numpy()
    direct = (dense * zw[:, None, None, None]).sum((0, 1, 2))
    direct2 = (dense ** 2 * zw[:, None, None, None]).sum((0, 1, 2))
    for got, jx, ref in ((s, js, direct), (s2, js2, direct2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=1e-4,
                                   atol=1e-2)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-2)


def _conv2d_jax(img, kk):
    return jax.lax.conv_general_dilated(
        jnp.asarray(img)[None], jnp.asarray(kk), (1, 1), [(1, 1)] * 2,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'))[0]


def test_dres0_stats_affine_matches_dual_conv(data):
    """conv_p2p(prev) + the composed statistics of the cur half's
    contribution == dual_conv3 + GroupNorm + relu, and == the JAX
    function on the same inputs."""
    x = data[0]
    rng = np.random.RandomState(2)
    k64 = (rng.randn(3, 3, 3, 64, 32) * 0.1).astype(np.float32)
    cur2d = rng.randn(H, Wd, 32).astype(np.float32)
    scale = rng.randn(32).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    gn = FL.GroupNorm(num_groups=32)
    v = {'params': {'scale': jnp.asarray(scale), 'bias': jnp.asarray(bias)}}
    dense = JBV.dual_conv3(jnp.asarray(cur2d)[None], jnp.asarray(x)[None],
                           jnp.asarray(k64))
    ref = np.maximum(np.asarray(gn.apply(v, dense))[0], 0)
    k_cur = k64[..., :32, :]
    ci = _conv2d_jax(cur2d, k_cur.sum(0))
    clo = ci - _conv2d_jax(cur2d, k_cur[0])
    chi = ci - _conv2d_jax(cur2d, k_cur[2])
    ju, jps = JCC.conv_p2p(jax_pack(x, 0), jnp.asarray(k64[..., 32:, :]),
                           interpret=True)
    jy = JCC.dres0_stats_affine(ju, jps, ci, clo, chi, scale, bias, 32)

    u, ps = CC.conv_p2p_plain(CC.pack_vol_plain(t(x)), tw(k64[..., 32:, :]))
    got = CC.dres0_stats_affine(u, ps, t(np.asarray(ci)), t(np.asarray(clo)),
                                t(np.asarray(chi)), t(scale), t(bias), 32)
    assert got.border_is_zero()
    np.testing.assert_allclose(got.interior().numpy(), jax_dense(jy), **TOL)
    np.testing.assert_allclose(got.interior().numpy(), ref, **TOL)


def test_packed_stereo_stem_matches_jax(data):
    """The whole stem on the chain, from the port's own 2D convs of the
    cur map, against the JAX `packed_stereo_stem` (phase 0 in)."""
    x = data[0]
    rng = np.random.RandomState(4)
    cur2d = rng.randn(H, Wd, 32).astype(np.float32)
    mods = []
    for cin, seed in ((64, 0), (32, 1)):
        cn = FL.ConvNorm(32, (3, 3, 3), norm='gn')
        mods.append(randomize(cn.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4, cin))), seed))
    (k0, g0), (k1, g1) = [
        (m['params']['Conv_0']['kernel'], m['params']['GroupNorm_0'])
        for m in mods]
    want = JB.packed_stereo_stem(
        jnp.asarray(cur2d), jax_pack(x, 0), jnp.asarray(k0),
        (g0['scale'], g0['bias']), jnp.asarray(k1),
        (g1['scale'], g1['bias']), 32, interpret=True)
    km = W._convnorm('m', (), 3)
    dres0 = carry(PL.ConvNorm(64, 32, 3, ndim=3), mods[0],
                  submap(km, 'm', ()))
    dres1 = carry(PL.ConvNorm(32, 32, 3, ndim=3, act=False), mods[1],
                  submap(km, 'm', ()))
    with torch.inference_mode():
        got = PB.packed_stereo_stem(dres0, dres1, t(cur2d),
                                    CC.pack_vol_plain(t(x)))
        c0 = PB.dual_conv_norm(dres0, t(cur2d)[None], t(x)[None])
        ref = (dres1(c0) + c0)[0].permute(1, 2, 3, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_wrappers_take_plain_versions_on_cpu(data):
    x, k = data[:2]
    K.reset_launch_counts()
    cv = KC.pack_vol(t(x))
    assert torch.equal(cv.data, CC.pack_vol_plain(t(x)).data)
    out, ps = KC.conv_p2p(cv, tw(k), residual=True)
    want, wps = CC.conv_p2p_plain(cv, tw(k), residual=True)
    assert torch.equal(out.data, want.data) and torch.equal(ps, wps)
    sc, bs = torch.rand(32), torch.rand(32)
    assert torch.equal(KC.unpack_affine(out, sc, bs, cv, True),
                       CC.unpack_affine_plain(out, sc, bs, cv, True))
    assert torch.equal(KC.affine_chain(out, sc, bs, cv, True).data,
                       CC.affine_mask(out, sc, bs, True, cv).data)
    dense = KC.unpack_vol(out)
    assert dense.is_contiguous() and torch.equal(dense, out.interior())
    assert torch.equal(CC.unpack_vol(out), dense)
    k64 = torch.randn(64, 32, 3, 3, 3,
                      generator=torch.Generator().manual_seed(0)) * 0.1
    half, hps = KC.conv_s2_p2d(cv, k64)
    want, wps = CC.conv_s2_plain(cv, k64)
    assert torch.equal(half, want) and torch.equal(hps, wps)
    par = torch.randn(8, 2, 3, 4, 32,
                      generator=torch.Generator().manual_seed(1))
    got, gps = KC.pack_parity8(par)
    want, wps = CC.pack_parity8_plain(par)
    assert torch.equal(got.data, want.data) and torch.equal(gps, wps)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}
    assert set(K.LAUNCHES) == {
        'warp_prev', 'frustum_stereo_sample', 'attention_sample', 'pack_vol',
        'conv_p2p', 'unpack_affine_res', 'conv_s2_p2d', 'pack_parity8',
        'gn_affine_res_packed', 'unpack_vol', 'conv3d_zpack',
        'conv3d_gn_finish', 'conv3d_pallas', 'warp_prev_bwd',
        'frustum_stereo_sample_bwd'}


# ------------------------------------------------- K5, K6, K7b, K8b

def jax_ps_s2_per_z(ps, d2):
    """JAX moments of the stride-2 conv (NB2, NH2, 2, 128) -> (D2, 2, 64):
    lane l of block k2 holds output slice 2 k2 + l // 64, channel
    l % 64."""
    p = np.asarray(ps).sum(axis=1)
    nb2 = p.shape[0]
    p = p.reshape(nb2, 2, 2, 64).transpose(0, 2, 1, 3)
    return p.reshape(nb2 * 2, 2, 64)[:d2]


@pytest.mark.parametrize('phase', PHASES)
def test_conv_s2_matches_jax(data, phase):
    x = data[0]
    k64 = (np.random.RandomState(7).randn(3, 3, 3, 32, 64) * 0.1).astype(
        np.float32)
    want, ps = JCC.conv_s2_p2d(jax_pack(x, phase), jnp.asarray(k64), th2=4,
                               interpret=True)
    got, gps = CC.conv_s2_plain(CC.pack_vol_plain(t(x)), tw(k64))
    assert got.shape == (D // 2, H // 2, Wd // 2, 64)
    assert gps.shape == (D // 2, 1, 2, 64) and gps.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gps.sum(1).numpy(),
                               jax_ps_s2_per_z(ps, D // 2), rtol=1e-4,
                               atol=1e-2)
    # the stored border is the padding of the dense strided conv
    ref = torch.nn.functional.conv3d(t(x).permute(3, 0, 1, 2)[None],
                                     tw(k64), stride=2, padding=1)[0]
    np.testing.assert_allclose(got.numpy(),
                               ref.permute(1, 2, 3, 0).numpy(), **TOL)
    dense = got.double()
    np.testing.assert_allclose(gps[:, 0, 1].numpy(),
                               (dense * dense).sum((1, 2)).numpy(),
                               rtol=1e-4, atol=1e-2)


def test_conv_s2_rejects_odd_shapes():
    with pytest.raises(ValueError, match='even'):
        CC.conv_s2_plain(CC.pack_vol_plain(torch.zeros(3, 4, 4, 32)),
                         torch.zeros(64, 32, 3, 3, 3))
    with pytest.raises(ValueError, match='even'):
        KC.conv_s2_p2d(CC.pack_vol_plain(torch.zeros(4, 4, 5, 32)),
                       torch.zeros(64, 32, 3, 3, 3))


def test_convt1_parity_pack8_matches_jax_and_conv_transpose():
    """Tap products + interleave == the JAX pair (flax kernel, no flip)
    == torch's transposed conv on the imported (flipped) weight."""
    rng = np.random.RandomState(9)
    d2, h2, w2 = D // 2, H // 2, Wd // 2
    x = rng.randn(d2, h2, w2, 64).astype(np.float32)
    kf = (rng.randn(3, 3, 3, 64, 32) * 0.1).astype(np.float32)
    jpar = JCC.convt1_parity(jnp.asarray(x), jnp.asarray(kf))
    jpv, jps = JCC.pack_parity8(jpar, th=TH, interpret=True)
    wt = torch.from_numpy(np.ascontiguousarray(W._conv_weight(kf, 'convt3d')))
    par = CC.convt1_parity(t(x), wt)
    assert par.shape == (8, d2, h2, w2, 32)
    np.testing.assert_allclose(par.numpy(), np.asarray(jpar), **TOL)
    got, ps = CC.pack_parity8_plain(par)
    assert got.border_is_zero() and got.shape == (D, H, Wd, 32)
    assert ps.shape == (D, 1, 2, 32)
    np.testing.assert_allclose(got.interior().numpy(), jax_dense(jpv), **TOL)
    np.testing.assert_allclose(ps.sum(1).numpy(), jax_ps_per_z(jps, jpv),
                               rtol=1e-4, atol=1e-2)
    ref = torch.nn.functional.conv_transpose3d(
        t(x).permute(3, 0, 1, 2)[None], wt, None, 2, 1, 1)[0]
    np.testing.assert_allclose(got.interior().numpy(),
                               ref.permute(1, 2, 3, 0).numpy(), **TOL)
    # the moments are those of the values as stored
    stored = got.interior().double()
    np.testing.assert_allclose(ps[:, 0, 0].numpy(),
                               stored.sum((1, 2)).numpy(), rtol=1e-4,
                               atol=1e-2)


def test_pack_parity8_places_every_parity():
    """par[4 rz + 2 ry + rx, m, n, t] lands on (2m + rz, 2n + ry,
    2t + rx), bit for bit."""
    par = torch.arange(8 * 2 * 3 * 4 * 32, dtype=torch.float32).reshape(
        8, 2, 3, 4, 32)
    full = CC.pack_parity8_plain(par)[0].interior()
    for p, m, n, tt in ((0, 0, 0, 0), (5, 1, 2, 3), (7, 1, 0, 2),
                        (2, 0, 1, 1)):
        rz, ry, rx = p // 4, p // 2 % 2, p % 2
        assert torch.equal(full[2 * m + rz, 2 * n + ry, 2 * tt + rx],
                           par[p, m, n, tt])


@pytest.mark.parametrize('mode', ['res', 'relu', 'plain'])
def test_gn_affine_res_packed_matches_jax(data, mode):
    """The stem exit that stays in the format (K7b's function)."""
    x, k, scale, bias = data
    jy = jax_pack(x, 2)
    ju, jps = JCC.conv_p2p(jy, jnp.asarray(k), interpret=True)
    want = JCC.gn_affine_res_packed(
        ju, jps, scale, bias, 32, res_pv=jy if mode == 'res' else None,
        relu=mode == 'relu', interpret=True)
    y = CC.pack_vol_plain(t(x))
    u, ps = CC.conv_p2p_plain(y, tw(k))
    K.reset_launch_counts()
    got = CC.gn_affine_res_packed(u, ps, t(scale), t(bias), 32,
                                  res=y if mode == 'res' else None,
                                  relu=mode == 'relu')
    assert K.LAUNCHES['gn_affine_res_packed'] == 0     # CPU: plain version
    assert got.border_is_zero()                        # exactly zero
    np.testing.assert_allclose(got.interior().numpy(), jax_dense(want),
                               atol=1e-5)
    # the same function as the chain exit, without leaving the format
    dense = CC.unpack_affine_res(u, ps, t(scale), t(bias), 32,
                                 res=y if mode == 'res' else None,
                                 relu=mode == 'relu')
    assert torch.equal(got.interior(), dense)


@pytest.mark.parametrize('weighted', [False, True])
def test_gn_dense_from_partials_matches_jax(data, weighted):
    x = data[0]
    rng = np.random.RandomState(12)
    k64 = (rng.randn(3, 3, 3, 32, 64) * 0.1).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(64)).astype(np.float32)
    bias = (0.3 * rng.randn(64)).astype(np.float32)
    d2 = D // 2
    zw = (np.arange(d2) % 3 + 1).astype(np.float32) if weighted else None
    ju, jps = JCC.conv_s2_p2d(jax_pack(x, 0), jnp.asarray(k64), th2=4,
                              interpret=True)
    cnt = (float(zw.sum()) if weighted else d2) * (H // 2) * (Wd // 2)
    want = JCC.gn_dense_from_partials(ju, jps, cnt, scale, bias, 32,
                                      relu=True, cout=64, zw=zw, d=d2)
    u, ps = CC.conv_s2_plain(CC.pack_vol_plain(t(x)), tw(k64))
    got = CC.gn_dense_from_partials(u, ps, t(scale), t(bias), 32, zw=zw,
                                    relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not weighted:                   # == GroupNorm of the dense result
        gn = PL.GroupNorm(64)
        gn.load_state_dict({'weight': t(scale), 'bias': t(bias)})
        with torch.inference_mode():
            ref = torch.relu(gn(u.permute(3, 0, 1, 2)[None]))[0]
        np.testing.assert_allclose(got.numpy(),
                                   ref.permute(1, 2, 3, 0).numpy(), **TOL)
    no_relu = CC.gn_dense_from_partials(u, ps, t(scale), t(bias), 32, zw=zw,
                                        relu=False)
    assert float(no_relu.min()) < 0
    assert torch.equal(torch.relu(no_relu), got)


# ------------------------------------------- banded volumes, reduced depth

def _band_inputs(seed, b=2, h=6, w=10, cin=8, cout=12, d=9):
    rng = np.random.RandomState(seed)
    x2d = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) * 0.2).astype(np.float32)
    k2 = (rng.randn(3, 3, 3, cout, cout) * 0.2).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(cout)).astype(np.float32)
    bias = (0.3 * rng.randn(cout)).astype(np.float32)
    return x2d, k, k2, scale, bias, d


def _assert_band(got, want, tol=TOL):
    assert got.d == want.d and got.e == want.lo.shape[1]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_band_functions_match_jax_and_dense():
    x2d, k, k2, scale, bias, d = _band_inputs(0)
    g = 4
    jb0 = JBV.band_from_const(jnp.asarray(x2d), d)
    jb1 = JBV.band_relu(JBV.band_gn(JBV.band_conv3(jb0, jnp.asarray(k)),
                                    scale, bias, g))
    jb2 = JBV.band_gn(JBV.band_conv3(jb1, jnp.asarray(k2)), scale, bias, g)
    jb3 = JBV.band_add(jb2, jb1)

    b0 = BV.band_from_const(t(x2d), d)
    assert b0.e == 0
    b1 = BV.band_relu(BV.band_gn(BV.band_conv3(b0, tw(k)), t(scale),
                                 t(bias), g))
    b2 = BV.band_gn(BV.band_conv3(b1, tw(k2)), t(scale), t(bias), g)
    b3 = BV.band_add(b2, b1)
    assert (b1.e, b2.e, b3.e) == (1, 2, 2)      # one slice per conv
    for got, want in ((b1, jb1), (b2, jb2), (b3, jb3)):
        _assert_band(got, want)
    np.testing.assert_allclose(BV.band_to_dense(b3).numpy(),
                               np.asarray(JBV.band_to_dense(jb3)), **TOL)

    # the dense computation on the broadcast volume
    c1 = PL.ConvNorm(8, 12, 3, ndim=3)
    c2 = PL.ConvNorm(12, 12, 3, ndim=3, act=False)
    c1.gn.groups = c2.gn.groups = g
    for cn, kk in ((c1, k), (c2, k2)):
        cn.load_state_dict({'conv.weight': tw(kk), 'gn.weight': t(scale),
                            'gn.bias': t(bias)})
    with torch.inference_mode():
        x = t(x2d)[:, None].expand(-1, d, -1, -1, -1).permute(0, 4, 1, 2, 3)
        y1 = c1(x)
        ref = (c2(y1) + y1).permute(0, 2, 3, 4, 1)
        got = BV.band_to_dense(BV.band_add(PB.band_conv_norm(
            c2, PB.band_conv_norm(c1, b0)), PB.band_conv_norm(c1, b0)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_dual_conv3_matches_jax_and_dense():
    x2d, _, _, _, _, d = _band_inputs(1)
    rng = np.random.RandomState(6)
    prev = rng.randn(2, d, 6, 10, 8).astype(np.float32)
    k = (rng.randn(3, 3, 3, 16, 12) * 0.2).astype(np.float32)
    want = JBV.dual_conv3(jnp.asarray(x2d), jnp.asarray(prev),
                          jnp.asarray(k))
    got = BV.dual_conv3(t(x2d), t(prev), tw(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = torch.cat([t(x2d)[:, None].expand(-1, d, -1, -1, -1), t(prev)],
                     -1)
    ref = torch.nn.functional.conv3d(full.permute(0, 4, 1, 2, 3), tw(k),
                                     padding=1).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize('d', [48, 72, 8])
def test_make_reduced_plan_matches_jax(d):
    want, got = jax_plan(d, e=2), make_reduced_plan(d, e=2)
    if d == 8:
        assert want is None and got is None       # too short to reduce
        return
    for f in ('d', 'dr', 'bot', 'period', 'mid_mult'):
        assert getattr(got, f) == getattr(want, f)
    assert (got.dr, got.bot, got.period) == (44, 20, 4)
    assert got.mid_mult == {48: 2, 72: 8}[d]
    np.testing.assert_array_equal(got.expand_idx, want.expand_idx)
    assert got.expand_idx.dtype == np.int32
    for s in range(3):
        np.testing.assert_array_equal(got.mult(s), want.mult(s))
        assert got.mult(s).sum() * 2 ** s == d


@pytest.fixture(scope='module')
def reduced():
    """A banded volume of edge 2 at D = 48 (planes 8x16, C = 32), the
    flax reduced hourglass + pred on it, and the port's modules with the
    same weights."""
    d, h, w, c = 48, 8, 16, 32
    rng = np.random.RandomState(7)
    band = BV.BandVol(t(rng.randn(1, h, w, c)), t(rng.randn(1, 2, h, w, c)),
                      t(rng.randn(1, 2, h, w, c)), d)
    plan = make_reduced_plan(d, e=2)
    jplan = jax_plan(d, e=2)
    red = PB.assemble_reduced(band, plan)                     # NCDHW
    jred = jnp.asarray(red.permute(0, 2, 3, 4, 1).numpy())
    np.testing.assert_array_equal(
        np.asarray(JB._assemble_reduced(JBV.BandVol(
            *[jnp.asarray(p.numpy()) for p in band[:3]], d), jplan)),
        np.asarray(jred))
    jhg = JB.RedHourglass(c)
    vh = randomize(jhg.init(jax.random.PRNGKey(0), jred, jplan), 8)
    jres = jhg.apply(vh, jred, jplan)
    jpred = JB.RedDepthPredModule(c)
    vp = randomize(jpred.init(jax.random.PRNGKey(0), jred, jplan), 9)
    jcost = jpred.apply(vp, jred + jres, jplan)
    hg = carry(PL.Hourglass(c), vh,
               submap(W._hourglass('hg', ('hg',), 3), 'hg', ('hg',)))
    pred = torch.nn.Sequential(PL.ConvNorm(c, c, 3, ndim=3),
                               PL.Conv(c, 1, 3, ndim=3))
    carry(pred, vp, W._convnorm('0', ('ConvNorm_0',), 3)
          + [('1', ('Conv_0',), 'conv3d')])
    return dict(band=band, plan=plan, red=red, hg=hg, pred=pred,
                jres=np.asarray(jres), jcost=np.asarray(jcost))


def test_red_hourglass_matches_jax_and_dense(reduced):
    r = reduced
    idx = torch.as_tensor(r['plan'].expand_idx, dtype=torch.long)
    with torch.inference_mode():
        res = PB.red_hourglass(r['hg'], r['red'], r['plan'])
        dense = r['hg'](BV.band_to_dense(r['band']).permute(0, 4, 1, 2, 3))
    tol = dict(atol=2e-4, rtol=0)
    np.testing.assert_allclose(res.permute(0, 2, 3, 4, 1).numpy(), r['jres'],
                               **tol)
    assert res.shape[2] == 44 and dense.shape[2] == 48
    np.testing.assert_allclose(res.index_select(2, idx).numpy(),
                               dense.numpy(), **tol)


def test_red_depth_pred_matches_jax_and_dense(reduced):
    r = reduced
    idx = torch.as_tensor(r['plan'].expand_idx, dtype=torch.long)
    with torch.inference_mode():
        x = r['red'] + PB.red_hourglass(r['hg'], r['red'], r['plan'])
        cost = PB.red_depth_pred(r['pred'], x, r['plan'])
        dense = r['pred'](x.index_select(2, idx))
    tol = dict(atol=2e-4, rtol=0)
    np.testing.assert_allclose(cost.permute(0, 2, 3, 4, 1).numpy(),
                               r['jcost'], **tol)
    np.testing.assert_allclose(cost.index_select(2, idx).numpy(),
                               dense.numpy(), **tol)


def test_weighted_gn_equals_gn_of_expanded_volume():
    rng = np.random.RandomState(10)
    x = t(rng.randn(2, 64, 5, 3, 4))
    mult = np.array([1, 3, 1, 2, 5], np.float32)
    gn = PL.GroupNorm(64)
    gn.load_state_dict({'weight': t(rng.randn(64)), 'bias': t(rng.randn(64))})
    idx = torch.as_tensor(np.repeat(np.arange(5), mult.astype(int)))
    with torch.inference_mode():
        got = PB.weighted_gn(x, mult, gn)
        ref = gn(x.index_select(2, idx))
    np.testing.assert_allclose(got.index_select(2, idx).numpy(), ref.numpy(),
                               atol=1e-5)


# ------------------------------------------------------ the whole backbone

def _backbone_inputs(d, hf, wf, b=1):
    rng = np.random.RandomState(3)
    c = 32
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 50.0
    cam[0, 2], cam[1, 2] = wf / 2, hf / 2
    c2p = np.eye(4, dtype=np.float32)
    c2p[0, 3] = 0.3
    return [rng.randn(b, hf, wf, c).astype(np.float32),
            rng.randn(b, hf, wf, c).astype(np.float32),
            np.linspace(2.0, 2.0 + d, d).astype(np.float32),
            np.repeat(cam[None], b, 0), np.repeat(c2p[None], b, 0)]


def _backbone_km():
    return [(k[len('backbone_stereo.'):], f[1:], kind)
            for k, f, kind in jax_key_map()
            if k.startswith('backbone_stereo.')]


@pytest.mark.parametrize('d', [8, 48])
def test_backbone_chain_form_matches_jax_packed(monkeypatch, d):
    """bf16, the JAX backbone on its packed branch (stem + pred ConvNorm
    through the Pallas kernels in interpret mode) against the port with
    the chain on. D = 8 takes the dense mono hourglass (no reduction),
    D = 48 the reduced-depth one."""
    args = _backbone_inputs(d, 32, 64)
    jargs = [jnp.asarray(a) for a in args]
    mdl = JB.DfMBackbone(in_channels=32, cv_channels=32,
                         cost_sample_factor=4, num_depth_bins_out=d,
                         norm='gn', dtype=jnp.bfloat16)
    monkeypatch.setenv('DFM_PACKED', '0')
    v = randomize(mdl.init(jax.random.PRNGKey(0), *jargs), 11)
    monkeypatch.setenv('DFM_PACKED', 'interpret')
    monkeypatch.setenv('DFM_PACKED_HG', '0')
    monkeypatch.setenv('DFM_PACKED_MONO', '0')
    monkeypatch.setenv('DFM_PACKED_PRED', '1')
    want = [np.asarray(o, np.float32) for o in mdl.apply(v, *jargs)]

    port = carry(PB.DfMBackbone(num_depth_bins_out=d), v, _backbone_km())
    K.reset_launch_counts()
    with torch.inference_mode():
        targs = [t(a) for a in args]
        targs[0], targs[1] = (a.to(torch.bfloat16) for a in targs[:2])
        assert port._packed(targs[1])             # on by default in bf16
        got = port(*targs)
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w_.shape
        np.testing.assert_allclose(g.float().numpy(), w_, atol=0.15,
                                   rtol=0.15)


@pytest.mark.parametrize('d,b', [(8, 2), (48, 1)])
def test_backbone_forms_agree_from_one_state_dict(d, b):
    """float32: dense, banded, chain-stem and full-chain forms of the
    port from one state dict, atol 1e-3 (measured ~3e-5). At D = 48 the
    full chain takes the mono trunk too; at D = 8 (no reduced-depth plan)
    only the stereo trunk."""
    args = [t(a) for a in _backbone_inputs(d, 32, 64, b)]
    forms = dict(dense=dict(use_band=False, packed=False),
                 banded=dict(use_band=True, packed=False),
                 stem=dict(use_band=True, packed='stem'),
                 chain=dict(use_band=True, packed=True))
    outs, sd = {}, None
    for name, kw in forms.items():
        m = PB.DfMBackbone(num_depth_bins_out=d, **kw)
        if sd is None:
            W.init_weights(m)
            g = torch.Generator().manual_seed(1)
            for p in m.parameters():
                if p.dim() == 1:              # GroupNorm weight and bias
                    p.data += 0.3 * torch.randn(p.shape, generator=g)
            sd = m.state_dict()
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            outs[name] = m.eval()(*args)
    assert not PB.DfMBackbone()._packed(args[1])      # f32: off by default
    stem, chain = (PB.DfMBackbone(**forms[f]) for f in ('stem', 'chain'))
    plan = make_reduced_plan(d, e=2)
    assert stem._packed(args[1]) and not stem._packed_hg(args[1])
    assert not stem._packed_mono(args[1], plan)
    assert chain._packed_hg(args[1])
    assert chain._packed_mono(args[1], plan) == (d == 48)
    for name in ('banded', 'stem', 'chain'):
        for got, want in zip(outs[name], outs['dense']):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3,
                                       rtol=0)


def test_backbone_rejects_chain_without_band():
    with pytest.raises(ValueError, match='use_band'):
        PB.DfMBackbone(use_band=False, packed=True)
    with pytest.raises(ValueError, match='32 channels'):
        PB.DfMBackbone(in_channels=16, cv_channels=16, packed=True)
    with pytest.raises(ValueError, match='use_band'):
        PB.DfMBackbone(use_band=False, packed='stem')
    with pytest.raises(ValueError, match="'stem'"):
        PB.DfMBackbone(packed='hourglass')
