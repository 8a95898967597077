"""K9a (`dfm_tpu_torch/ops/convgn.py`: `conv3d_zpack`, `conv3d_gn`) and
K9b (`dfm_tpu_torch/ops/conv3d.py` and its entry point
`ops/cuda/conv3d.py:conv3d`, the counterpart of `conv3d_pallas`) against
the JAX package's Pallas kernels in interpret mode, as
`tests/test_pallas_conv3d.py` runs them on the CPU. The same
seeded numpy inputs go to both; the JAX (3, 3, 3, C, C_out) weights reach
the port through `utils/weights.py:torch_conv_weight`.

Tolerances:
* float32 outputs: atol 1e-4 (the JAX test's own): the same f32 products
  summed in another order.
* bfloat16 conv outputs: one bf16 ulp of the output + atol 1e-6: both
  sides round an f32 sum of exact products, summed in another order, so a
  value at a rounding boundary may round the other way; near zero the two
  f32 sums themselves (up to 1134 signed terms of size ~0.1) differ by a
  few 1e-7, more than an ulp there.
* partials: sums of squares rtol 1e-4; sums rtol 1e-4 + atol 1e-6 *
  sqrt(n * sum of squares), n values per sum (a sum of signed terms
  cancels, so its f32 error scales with the terms, not with the sum).
* `conv3d_gn` in bfloat16: atol 2e-2 + rtol 2e-2, two bf16 roundings (the
  stored conv output, then the result) of values of size ~1.
The CUDA kernels run only on the card:
`tests/test_torch_kernels.py::test_cuda_conv3d_kernels_match_plain`
(`cuda` marker, skipped here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.ops.pallas import convgn as JG
from dfm_tpu.ops.pallas.conv3d import conv3d_pallas
from dfm_tpu_torch.ops import conv3d as C3
from dfm_tpu_torch.ops import conv_chain as CC
from dfm_tpu_torch.ops import convgn as G
from dfm_tpu_torch.ops.cuda import conv3d as KC3
from dfm_tpu_torch.ops.cuda import sampling as K
from dfm_tpu_torch.utils.weights import torch_conv_weight

torch.set_num_threads(1)    # from import on; the workers share the cores

F32_TOL = dict(atol=1e-4, rtol=0)
GN_BF16_TOL = dict(atol=2e-2, rtol=2e-2)
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape, c_out, scale=0.1):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, 3, shape[-1], c_out) * scale).astype(np.float32)
    return x, w


def _both(x, dtype):
    """x as a JAX array and a torch tensor of the same dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _assert_out(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        err = np.abs(got - want)
        assert (err <= _bf16_ulp(want) + 1e-6).all(), float(err.max())


def _assert_partials(got, want, n):
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    assert got.shape == want.shape
    lim = 1e-4 * np.abs(want)
    lim[..., 0, :] += 1e-6 * np.sqrt(n * want[..., 1, :])
    assert (np.abs(got - want) <= lim).all(), float(np.abs(got - want).max())


# ---------------------------------------------------------------- K9b

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', [
    (0, (8, 8, 16, 8), 8),       # test_pallas_conv3d.py, square
    (1, (8, 4, 24, 16), 8),      # test_pallas_conv3d.py, rect 16 -> 8
    (2, (8, 4, 8, 42), 42),      # the widest C of the JAX domain (3C <= 128)
], ids=['square', 'rect', 'c42'])
def test_conv3d_matches_pallas_interpret(case, dtype):
    seed, shape, c_out = case
    x, w = _inputs(seed, shape, c_out)
    jx, tx = _both(x, dtype)
    want = conv3d_pallas(jx, jnp.asarray(w), th=4, interpret=True)
    tw = torch_conv_weight(w)
    got = KC3.conv3d(tx, tw)
    assert got.dtype == tx.dtype and got.is_contiguous()
    assert torch.equal(got, C3.conv3d_plain(tx, tw))
    _assert_out(got, want, dtype)


# ---------------------------------------------------------------- K9a

@pytest.mark.parametrize('th, c, dtype', [
    (4, 8, 'float32'), (8, 8, 'float32'), (4, 32, 'float32'),
    (8, 32, 'float32'), (4, 32, 'bfloat16'), (8, 8, 'bfloat16')])
def test_conv3d_zpack_matches_pallas_interpret(th, c, dtype):
    """Output and partials in the JAX layout (D//4, H//th, 2, 4 C_out),
    C -> C_out = 32."""
    x, w = _inputs(3, (8, 8, 16, c), 32)
    jx, tx = _both(x, dtype)
    want, wps = JG.conv3d_zpack(jx, JG.pack_weights(jnp.asarray(w)), th=th,
                                interpret=True)
    tw = torch_conv_weight(w)
    got, ps = G.conv3d_zpack(tx, G.pack_weights(tw), th)
    assert ps.shape == (2, 8 // th, 2, 128) and ps.dtype == torch.float32
    _assert_out(got, want, dtype)
    _assert_partials(ps, wps, th * 16)
    got2, ps2 = G.conv3d_zpack_plain(tx, tw, th)
    assert torch.equal(got, got2) and torch.equal(ps, ps2)


def test_partials_are_of_the_unrounded_result():
    """bf16: the partials are the moments of the f32 accumulator, not of
    the stored bf16 output."""
    x, w = _inputs(4, (4, 4, 8, 8), 8, scale=0.37)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    out, ps = G.conv3d_zpack_plain(tx, torch_conv_weight(w), th=4)
    af = C3.conv3d_f32(tx, torch_conv_weight(w))
    s = ps[0, 0, 0].reshape(4, 8)
    err = (s - af.sum((1, 2))).abs().max()
    assert err <= 1e-5 < (s - out.float().sum((1, 2))).abs().max()


@pytest.mark.parametrize('groups, residual, relu, dtype', [
    (8, True, True, 'float32'), (32, False, False, 'float32'),
    (8, False, True, 'float32'), (32, True, False, 'float32'),
    (8, True, True, 'bfloat16'), (32, False, True, 'bfloat16')])
def test_conv3d_gn_matches_pallas_interpret(groups, residual, relu, dtype):
    x, w = _inputs(5, (8, 8, 16, 32), 32)
    rng = np.random.RandomState(6)
    scale = (rng.rand(32) + 0.5).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    res = rng.randn(8, 8, 16, 32).astype(np.float32) if residual else None
    jx, tx = _both(x, dtype)
    jr, tr = _both(res, dtype) if residual else (None, None)
    want = JG.conv3d_gn(jx, jnp.asarray(w), jnp.asarray(scale),
                        jnp.asarray(bias), groups, residual=jr, relu=relu,
                        th=4, interpret=True)
    args = (tx, torch_conv_weight(w), torch.from_numpy(scale),
            torch.from_numpy(bias), groups)
    got = G.conv3d_gn(*args, residual=tr, relu=relu, th=4)
    assert got.dtype == tx.dtype
    assert torch.equal(got, G.conv3d_gn_plain(*args, residual=tr, relu=relu,
                                              th=4))
    tol = F32_TOL if dtype == 'float32' else GN_BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_conv3d_gn_order_is_affine_residual_relu():
    """relu comes last: with a negative residual the output is never
    negative, and it differs from K7a's order (affine, relu, residual)."""
    x, w = _inputs(7, (4, 4, 8, 8), 8)
    tx, tw = torch.from_numpy(x), torch_conv_weight(w)
    scale, bias = torch.ones(8), torch.zeros(8)
    res = -torch.rand(4, 4, 8, 8) - 0.5
    got = G.conv3d_gn_plain(tx, tw, scale, bias, 4, residual=res, relu=True,
                            th=4)
    out, ps = G.conv3d_zpack_plain(tx, tw, th=4)
    sc, bs = CC.gn_scale_bias(ps.reshape(-1, 1, 2, 4, 8).sum(3), out.shape,
                              scale, bias, 4)
    assert torch.equal(got, torch.relu(out * sc + bs + res))
    assert bool((got >= 0).all())
    k7a = CC.unpack_affine_plain(CC.pack_vol_plain(out), sc, bs,
                                 CC.pack_vol_plain(res), relu=True)
    assert bool((k7a < 0).any()) and not torch.equal(got, k7a)


@pytest.mark.parametrize('c, c_out', [(8, 32), (32, 32), (6, 5)])
def test_pack_weights_matches_jax_and_band_taps_inverts_it(c, c_out):
    _, w = _inputs(8, (1, 1, 1, c), c_out)
    tw = torch_conv_weight(w)
    w_big = G.pack_weights(tw)
    np.testing.assert_array_equal(w_big.numpy(),
                                  np.asarray(JG.pack_weights(jnp.asarray(w))))
    assert torch.equal(G.band_taps(w_big, c, c_out), tw)
    with pytest.raises(ValueError):
        G.band_taps(w_big, c + 1, c_out)


def test_fold_row_partials_over_tiles():
    """The kernels' moments per (slice, row, 32-column tile), W = 80: three
    tiles, the last ragged, fold to the sums over th rows x all W."""
    rng = np.random.RandomState(9)
    af = torch.from_numpy(rng.randn(8, 6, 80, 5).astype(np.float32))
    tiles = [af[:, :, i:i + 32] for i in range(0, 80, 32)]
    rows = torch.stack([torch.stack([t.sum(2), (t * t).sum(2)], 2)
                        for t in tiles], 2)              # (D, H, 3, 2, C)
    got = G.fold_row_partials(rows, th=3)
    assert got.shape == (2, 2, 2, 20)
    for k, hi, j in ((0, 0, 0), (1, 1, 3), (1, 0, 2)):
        blk = af[4 * k + j, 3 * hi:3 * hi + 3].double()
        np.testing.assert_allclose(got[k, hi, 0, 5 * j:5 * j + 5].numpy(),
                                   blk.sum((0, 1)).numpy(), rtol=1e-5)
        np.testing.assert_allclose(got[k, hi, 1, 5 * j:5 * j + 5].numpy(),
                                   (blk * blk).sum((0, 1)).numpy(), rtol=1e-5)


@pytest.mark.parametrize('c_out, coc', [(5, 8), (16, 16), (42, 32)])
def test_direct_weight_layout(c_out, coc):
    """[C_out chunk][tap][input channel, padded to 8][coc] of
    weight[co, ci, dz, dy, dx], rounded to the volume's type, zeros in the
    padding."""
    c = 10
    w = torch.randn(c_out, c, 3, 3, 3, generator=torch.Generator().
                    manual_seed(c_out))
    assert KC3._out_chunk(c_out) == coc
    b = KC3.direct_weight(w, torch.bfloat16, coc)
    assert b.shape == (-(-c_out // coc), 27, 16, coc) and b.is_contiguous()
    for co, ci, tap in ((0, 0, 0), (c_out - 1, 9, 26), (c_out // 2, 3, 13)):
        dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
        assert b[co // coc, tap, ci, co % coc] == \
            w[co, ci, dz, dy, dx].to(torch.bfloat16).float()
    assert not b[:, :, c:].any()
    assert not b[-1, :, :, c_out % coc or coc:].any()


def test_conv3d_wrappers_take_plain_versions_on_cpu():
    x, w = _inputs(10, (4, 8, 8, 8), 16)
    tx, tw = torch.from_numpy(x), torch_conv_weight(w)
    K.reset_launch_counts()
    assert torch.equal(KC3.conv3d(tx, tw), C3.conv3d_plain(tx, tw))
    for a, b in zip(KC3.conv3d_stats(tx, tw, 4),
                    G.conv3d_zpack_plain(tx, tw, 4)):
        assert torch.equal(a, b)
    for a, b in zip(G.conv3d_zpack(tx, G.pack_weights(tw), 2),
                    G.conv3d_zpack_plain(tx, tw, 2)):
        assert torch.equal(a, b)
    gn = (torch.rand(16), torch.rand(16), 4)
    assert torch.equal(G.conv3d_gn(tx, tw, *gn, relu=True),
                       G.conv3d_gn_plain(tx, tw, *gn, relu=True))
    assert K.LAUNCHES == {name: 0 for name in K.LAUNCHES}


@pytest.mark.parametrize('shape, th', [((6, 8, 8, 8), 4), ((4, 6, 8, 8), 4)])
def test_conv3d_zpack_needs_the_jax_tiling(shape, th):
    """D % 4 == 0 and H % th == 0, as the JAX kernel asserts."""
    x = torch.zeros(shape)
    w = torch.zeros(8, 8, 3, 3, 3)
    with pytest.raises(ValueError):
        G.conv3d_zpack_plain(x, w, th)
    with pytest.raises(ValueError):
        G.conv3d_zpack(x, G.pack_weights(w), th)
