"""Port kernels K1-K3 (dfm_tpu_torch/ops) against the JAX package, and
every CUDA kernel of the port against its plain version on the card.

The plain PyTorch versions are held against
* the JAX XLA references in float32 (atol 1e-5: the same f32 products,
  summed in another order; for the fused K2, the composition of the JAX
  neck's `_fused` cond: stereo sample, sem sample x attention, concat;
  for K1's in-kernel grid, `plane_sweep_grids` at 2e-3 px), and
* the Pallas TPU kernels in interpret mode in bf16 (atol/rtol 6e-2, the
  JAX package's own tolerance for these kernels: they round their
  interpolation weights to bf16).
The CUDA kernels themselves (K1-K3, the conv chain's K4-K8b, whose plain
versions `tests/test_torch_conv_chain.py` and `test_torch_packed_hg.py`
hold against the JAX package, and K9a / K9b, held there by
`tests/test_torch_conv3d.py`) run only on the card (`cuda` marker); here
those cases report as skipped. This file imports no flax, so it also
collects on a machine that has JAX without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.ops.frustum_separable as FS
from dfm_tpu.ops.cost_volume import plane_sweep_grids as jax_grids
from dfm_tpu.ops.packed_sample import pack_taps_2d, packed_bilinear_sample
from dfm_tpu_torch.ops import conv_chain as CC
from dfm_tpu_torch.ops import cost_volume as PCV
from dfm_tpu_torch.ops import frustum_separable as PFS
from dfm_tpu_torch.ops.cuda import conv_chain as KC
from dfm_tpu_torch.ops.cuda import sampling as K

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=6e-2, rtol=6e-2)


def _interpret(fn, *args, **kw):
    """Run a Pallas wrapper with pallas_call in interpret mode (as the
    JAX package's tests do)."""
    from unittest import mock
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def call(*a, **k):
        k['interpret'] = True
        k.pop('compiler_params', None)
        return orig(*a, **k)

    with mock.patch.object(pl, 'pallas_call', call):
        return fn(*args, **kw)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not \
        isinstance(x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------- K1

@pytest.fixture
def warp_data():
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 24, 64, 32
    d, hq, wq = 3, 6, 16
    prev = rng.randn(b, h, w, c).astype(np.float32)
    base_v = rng.rand(b, d, hq, 1) * (h - 2)
    v = (base_v + rng.rand(b, d, hq, wq) * 1.5).astype(np.float32)
    u = (np.linspace(-2, w + 1, wq)[None, None, None, :] +
         rng.rand(b, d, hq, wq)).astype(np.float32)
    return prev, u, v


def _jax_gather(prev, u, v):
    grid = jnp.stack([jnp.asarray(u), jnp.asarray(v)], axis=-1)
    c = prev.shape[-1]
    return jax.vmap(lambda f, g: packed_bilinear_sample(
        pack_taps_2d(f), g, c))(jnp.asarray(prev), grid)


@pytest.mark.parametrize('case', ['in_band', 'band_violated', 'far_oob'])
def test_warp_plain_matches_xla_gather(warp_data, case):
    from dfm_tpu.ops.pallas.cost_warp import band_ok
    prev, u, v = warp_data
    if case == 'band_violated':
        # rows whose taps span far more than the TPU kernel's 4-row
        # band: the JAX package takes its gather path there
        v = v.copy()
        v[0, 0, 0, 0], v[0, 0, 0, 1] = 2.0, 20.0
        v[1, 2] = np.random.RandomState(1).rand(6, 16) * 30 - 3
        assert not bool(band_ok(jnp.asarray(v), prev.shape[1]))
    elif case == 'far_oob':
        v = v + 1000.0
    want = np.asarray(_jax_gather(prev, u, v))
    got = PCV.warp_prev_plain(_t(prev), _t(u), _t(v)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    if case == 'far_oob':
        assert np.abs(got).max() == 0.0


def test_warp_plain_matches_pallas_interpret(warp_data):
    import dfm_tpu.ops.pallas.cost_warp as cw
    prev, u, v = warp_data
    prev_b = jnp.asarray(prev).astype(jnp.bfloat16)
    want = _interpret(cw.warp_prev_band.__wrapped__, prev_b,
                      jnp.asarray(u), jnp.asarray(v))
    got = PCV.warp_prev_plain(_t(prev, torch.bfloat16), _t(u), _t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16_TOL)


@pytest.mark.parametrize('tag', ['id', 'aug'])
def test_plane_sweep_grids_match(tag):
    """Identity aug and a flip + crop + scale aug (the golden fixture's
    `id` / `aug` tags), with ego-motion."""
    depths = np.linspace(2.5, 40.0, 5).astype(np.float32)
    cam = np.array([[700., 0, 310, 12], [0, 700., 95, 0.3],
                    [0, 0, 1, 0.004], [0, 0, 0, 1]], np.float32)
    c2p = np.eye(4, dtype=np.float32)
    c2p[:3, 3] = (0.3, -0.05, -0.9)
    c, s = np.cos(0.02), np.sin(0.02)
    c2p[0, 0], c2p[0, 2], c2p[2, 0], c2p[2, 2] = c, s, -s, c
    aug = dict(id=(640.0, 0.0, (0.0, 0.0), 1.0),
               aug=(1242.0, 1.0, (6.0, 2.0), 0.5))[tag]
    org_w, flip, crop, sf = aug
    feat_shape = (48, 160)
    want_c, want_p = jax_grids(
        jnp.asarray(depths), jnp.asarray(cam), jnp.asarray(c2p), feat_shape,
        4, 1, jnp.float32(org_w), jnp.float32(flip), jnp.asarray(crop),
        jnp.float32(sf))
    got_c, got_p = PCV.plane_sweep_grids(
        _t(depths), _t(cam)[None], _t(c2p)[None], feat_shape, 4, 1,
        _t([org_w]), _t([flip]), _t([crop]), _t([sf]))
    for got, want in ((got_c, want_c), (got_p, want_p)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   atol=2e-3, rtol=1e-5)


# ------------------------------------------------------------ K2, K3

def _frustum_data(seed, table_shape):
    rng = np.random.RandomState(seed)
    nx, ny, nz = 10, 12, 5
    table = rng.randn(*table_shape).astype(np.float32)
    u = (rng.rand(nx, ny) * 70 - 3).astype(np.float32)
    v = (rng.rand(nx, nz) * 36 - 2).astype(np.float32)
    xs = np.linspace(2.0, 30.0, nx)
    return table, u, v, xs, (32, 64)


def test_stereo_sample_plain_matches_xla():
    vol, u, v, xs, pad = _frustum_data(0, (6, 8, 16, 4))
    ds = FS.slab_depth_static(xs, 2.0, 30.0, vol.shape[0])
    want, valid_w = FS.separable_stereo_sample(
        jnp.asarray(vol), jnp.asarray(u), jnp.asarray(v), ds, pad)
    got, valid_g = PFS.stereo_sample_plain(
        _t(vol)[None], _t(u)[None], _t(v)[None],
        *PFS.depth_tables(PFS.slab_depth_static(xs, 2.0, 30.0, 6), 'cpu'),
        pad)
    np.testing.assert_array_equal(valid_g[0].numpy(), np.asarray(valid_w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **F32_TOL)


def test_stereo_sample_plain_matches_pallas_interpret():
    from dfm_tpu.ops.pallas.frustum_sample import (
        frustum_stereo_sample_pallas)
    vol, u, v, xs, pad = _frustum_data(0, (6, 8, 16, 4))
    ds = FS.slab_depth_static(xs, 2.0, 30.0, vol.shape[0])
    groups = FS._group_slabs(ds['z0'])
    want, valid_w = _interpret(
        frustum_stereo_sample_pallas, jnp.asarray(vol).astype(jnp.bfloat16),
        jnp.asarray(u), jnp.asarray(v), ds, pad,
        (groups[0], groups[1], groups[2], FS._runs(ds['z0'])))
    got, valid_g = PFS.stereo_sample_plain(
        _t(vol, torch.bfloat16)[None], _t(u)[None], _t(v)[None],
        *PFS.depth_tables(PFS.slab_depth_static(xs, 2.0, 30.0, 6), 'cpu'),
        pad)
    np.testing.assert_array_equal(valid_g[0].numpy(), np.asarray(valid_w))
    np.testing.assert_allclose(got[0].float().numpy(), _f32(want),
                               **BF16_TOL)


def test_attention_plain_matches_xla():
    sm, u, v, xs, pad = _frustum_data(1, (12, 16, 32))
    sm = np.abs(sm)
    dsf = FS.slab_depth_static(xs, 2.0, 30.0, sm.shape[0])
    want = FS.separable_softmax_attention(
        jnp.asarray(sm), jnp.asarray(u), jnp.asarray(v), dsf, pad)
    got = PFS.attention_sample_plain(
        _t(sm)[None], _t(u)[None], _t(v)[None],
        *PFS.depth_tables(PFS.slab_depth_static(xs, 2.0, 30.0, 12), 'cpu'),
        pad)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **F32_TOL)


def test_attention_plain_matches_pallas_interpret():
    from dfm_tpu.ops.pallas.frustum_sample import attention_sample_pallas
    sm, u, v, xs, pad = _frustum_data(1, (12, 16, 32))
    sm = np.abs(sm)
    dsf = FS.slab_depth_static(xs, 2.0, 30.0, sm.shape[0])
    want, _ = _interpret(attention_sample_pallas,
                         jnp.asarray(sm).astype(jnp.bfloat16),
                         jnp.asarray(u), jnp.asarray(v), dsf, pad)
    got = K.attention_sample(_t(sm, torch.bfloat16)[None], _t(u)[None],
                             _t(v)[None],
                             PFS.slab_depth_static(xs, 2.0, 30.0, 12), pad)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **BF16_TOL)


def test_fine_softmax_volume_matches_xla():
    cost = np.random.RandomState(2).randn(6, 4, 8).astype(np.float32)
    want = FS.build_fine_softmax_volume(jnp.asarray(cost), 4, (16, 32),
                                        dtype=jnp.float32)
    got = PFS.build_fine_softmax_volume(_t(cost)[None], 4, (16, 32),
                                        torch.float32)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def test_sem_sample_matches_xla():
    sem, u, v, xs, pad = _frustum_data(3, (8, 16, 5))
    ds = FS.slab_depth_static(xs, 2.0, 30.0, 6)
    _, valid = FS.separable_stereo_sample(
        jnp.zeros((6, 8, 16, 1)), jnp.asarray(u), jnp.asarray(v), ds, pad)
    want = FS.separable_sem_sample(jnp.asarray(sem), jnp.asarray(u),
                                   jnp.asarray(v), pad, valid)
    got = PFS.sem_sample(_t(sem)[None], _t(u)[None], _t(v)[None], pad,
                         torch.from_numpy(np.array(valid))[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **F32_TOL)


def _voxel_data(seed, b=2, vol_shape=(6, 8, 16, 4), sem_shape=(10, 20, 3),
                grid=(5, 12, 10)):
    """Inputs of the fused K2 at B = 2: voxels outside the image on both
    axes, slabs out of the depth range (xs from 1 to 32 against 2-30),
    taps on the tables' last row and column (u = pad_w - 1, v = pad_h - 1)
    and on the inclusive edge (u = pad_w, v = pad_h), an attention with
    zeros."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = grid
    pad = (32, 64)
    vol = rng.randn(b, *vol_shape).astype(np.float32)
    sem = rng.randn(b, *sem_shape).astype(np.float32)
    att = (rng.rand(b, nz, ny, nx) * (rng.rand(b, nz, ny, nx) > 0.2)
           ).astype(np.float32)
    u = (rng.rand(b, nx, ny) * (pad[1] + 8) - 4).astype(np.float32)
    v = (rng.rand(b, nx, nz) * (pad[0] + 8) - 4).astype(np.float32)
    u[0, :, :3] = [pad[1] - 1, pad[1], 0.0]
    v[1, :, :2] = [pad[0] - 1, pad[0]]
    xs = np.linspace(1.0, 32.0, nx)
    return vol, sem, att, u, v, xs, pad


def _jax_voxel_features(vol, sem, att, u, v, ds, pad):
    """The JAX neck's `_fused` composition per sample, in float32:
    separable_stereo_sample, separable_sem_sample x att, concat."""
    outs = []
    for i in range(vol.shape[0]):
        voxel, valid = FS.separable_stereo_sample(
            jnp.asarray(vol[i]), jnp.asarray(u[i]), jnp.asarray(v[i]), ds,
            pad)
        s2d = FS.separable_sem_sample(jnp.asarray(sem[i]), jnp.asarray(u[i]),
                                      jnp.asarray(v[i]), pad, valid)
        s2d = s2d * jnp.asarray(att[i])[..., None]
        outs.append(np.asarray(jnp.concatenate([voxel, s2d], axis=-1)))
    return np.stack(outs)


def test_voxel_features_plain_matches_jax():
    """The fused K2's plain version against the JAX composition in float32
    (atol 1e-5 + rtol 1e-5) at B = 2, with invalid voxels, slabs out of
    the depth range and taps on the table edges."""
    vol, sem, att, u, v, xs, pad = _voxel_data(0)
    ds = FS.slab_depth_static(xs, 2.0, 30.0, vol.shape[1])
    assert not ds['in_range'].all()
    want = _jax_voxel_features(vol, sem, att, u, v, ds, pad)
    got = PFS.frustum_voxel_features_plain(
        _t(vol), _t(sem), _t(att), _t(u), _t(v),
        *PFS.depth_tables(PFS.slab_depth_static(xs, 2.0, 30.0, 6), 'cpu'),
        pad)
    assert got.shape == vol.shape[:1] + att.shape[1:] + (4 + 3,)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert (want[..., :4] != 0).mean() > 0.2
    assert (want[..., 4:] != 0).mean() > 0.2


def test_voxel_features_stereo_half_matches_pallas_interpret():
    """The stereo half of the fused K2 (bf16, on the CPU: the plain
    version) against the Pallas K2 in interpret mode (BF16_TOL)."""
    from dfm_tpu.ops.pallas.frustum_sample import (
        frustum_stereo_sample_pallas)
    vol, sem, att, u, v, xs, pad = _voxel_data(1)
    ds = FS.slab_depth_static(xs, 2.0, 30.0, vol.shape[1])
    groups = FS._group_slabs(ds['z0'])
    got = K.frustum_voxel_features(
        _t(vol, torch.bfloat16), _t(sem, torch.bfloat16), _t(att), _t(u),
        _t(v), PFS.slab_depth_static(xs, 2.0, 30.0, 6), pad)
    assert got.dtype == torch.bfloat16
    for i in range(vol.shape[0]):
        want, _ = _interpret(
            frustum_stereo_sample_pallas,
            jnp.asarray(vol[i]).astype(jnp.bfloat16), jnp.asarray(u[i]),
            jnp.asarray(v[i]), ds, pad,
            (groups[0], groups[1], groups[2], FS._runs(ds['z0'])))
        np.testing.assert_allclose(got[i, ..., :4].float().numpy(),
                                   _f32(want), **BF16_TOL)


def test_voxel_features_plain_is_the_neck_composition_bf16():
    """In bf16 the fused plain version is, bit for bit, the neck's unfused
    composition (stereo sample; sem sample, masked by valid2d, times the
    attention cast to bf16; concat); with Cs = 0 it is the stereo
    sample."""
    vol, sem, att, u, v, xs, pad = _voxel_data(2)
    tabs = PFS.depth_tables(PFS.slab_depth_static(xs, 2.0, 30.0, 6), 'cpu')
    vb, sb = _t(vol, torch.bfloat16), _t(sem, torch.bfloat16)
    tu, tv, ta = _t(u), _t(v), _t(att)
    voxel, valid = PFS.stereo_sample_plain(vb, tu, tv, *tabs, pad)
    s2d = PFS.sem_sample(sb, tu, tv, pad, valid)
    s2d = s2d * ta.to(s2d.dtype)[..., None]
    want = torch.cat([voxel, s2d], dim=-1)
    got = PFS.frustum_voxel_features_plain(vb, sb, ta, tu, tv, *tabs, pad)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(PFS.frustum_voxel_features_plain(
        vb, sb[..., :0], ta, tu, tv, *tabs, pad), voxel)


def _sweep_meta(tag):
    """Plane-sweep inputs: depths, and per sample cam2img, cur2prev (ego
    motion with a small yaw), org_w, flip, crop_offset, scale_factor.
    `id`: identity aug; `aug`: flip + crop + scale; `b2`, `aug_b2`: B = 2,
    `id` or `aug` beside another aug and ego-motion."""
    depths = np.linspace(2.5, 40.0, 5).astype(np.float32)
    cam = np.array([[700., 0, 310, 12], [0, 700., 95, 0.3],
                    [0, 0, 1, 0.004], [0, 0, 0, 1]], np.float32)

    def ego(t, yaw):
        c2p = np.eye(4, dtype=np.float32)
        c2p[:3, 3] = t
        c, s = np.cos(yaw), np.sin(yaw)
        c2p[0, 0], c2p[0, 2], c2p[2, 0], c2p[2, 2] = c, s, -s, c
        return c2p

    metas = dict(id=(ego((0.3, -0.05, -0.9), 0.02), 640.0, 0.0, (0.0, 0.0),
                     1.0),
                 aug=(ego((0.3, -0.05, -0.9), 0.02), 1242.0, 1.0, (6.0, 2.0),
                      0.5),
                 other=(ego((-0.1, 0.02, 1.2), -0.03), 700.0, 0.0,
                        (3.0, 1.0), 0.8))
    rows = [metas[k] for k in dict(b2=('id', 'other'),
                                   aug_b2=('aug', 'other')).get(tag, (tag,))]
    cols = [np.stack([np.asarray(r[i], np.float32) for r in rows])
            for i in range(5)]
    return depths, np.repeat(cam[None], len(rows), 0), cols


@pytest.mark.parametrize('tag', ['id', 'aug', 'b2'])
@pytest.mark.parametrize('fsf', [1, 4])
def test_sweep_coords_match_grids(tag, fsf):
    """K1's in-kernel sample points (`sweep_coords_plain` of
    `sweep_params`) against the prev grid of the port's
    `plane_sweep_grids` and of the JAX package's, atol 2e-3 px (the
    tolerance of `test_plane_sweep_grids_match`; the composed map is
    rounded once from float64, the grids solve in float32)."""
    depths, cam, (c2p, org_w, flip, crop, sf) = _sweep_meta(tag)
    feat_shape, csf = (48, 160), 4
    hq, wq = 12, 40
    meta = [_t(x) for x in (org_w, flip, crop, sf)]
    params = PCV.sweep_params(_t(cam), _t(c2p), *meta, fsf)
    assert params.shape == (len(cam), PCV.SWEEP_PARAMS)
    u, v = PCV.sweep_coords_plain(params, _t(depths), hq, wq, fsf * csf)
    _, grid = PCV.plane_sweep_grids(_t(depths), _t(cam), _t(c2p),
                                    feat_shape, csf, fsf, *meta)
    tol = dict(atol=2e-3, rtol=1e-5)
    np.testing.assert_allclose(u.numpy(), grid[..., 0].numpy(), **tol)
    np.testing.assert_allclose(v.numpy(), grid[..., 1].numpy(), **tol)
    for i in range(len(cam)):
        _, want = jax_grids(
            jnp.asarray(depths), jnp.asarray(cam[i]), jnp.asarray(c2p[i]),
            feat_shape, csf, fsf, jnp.float32(org_w[i]),
            jnp.float32(flip[i]), jnp.asarray(crop[i]), jnp.float32(sf[i]))
        np.testing.assert_allclose(u[i].numpy(), np.asarray(want[..., 0]),
                                   **tol)
        np.testing.assert_allclose(v[i].numpy(), np.asarray(want[..., 1]),
                                   **tol)


def test_wrappers_take_plain_version_on_cpu(warp_data):
    """On CPU tensors the wrappers return the plain versions and launch
    nothing: K1 (the sweep), K2 (fused, with a sem map and without), K3;
    and `build_plane_sweep_cost` takes K1's sweep on the CPU too."""
    prev, u, v = warp_data
    K.reset_launch_counts()
    depths, cam, (c2p, *meta) = _sweep_meta('b2')
    params = PCV.sweep_params(_t(cam), _t(c2p), *(_t(x) for x in meta))
    got = K.warp_prev_sweep(_t(prev), params, _t(depths), 6, 16, 4)
    want = PCV.warp_prev_plain(_t(prev), *PCV.sweep_coords_plain(
        params, _t(depths), 6, 16, 4))
    assert got.shape == (2, 5, 6, 16, 32) and torch.equal(got, want)
    meta = [_t(x) for x in meta]
    cur2d, warped = PCV.build_plane_sweep_cost(
        _t(prev), _t(prev), _t(depths), _t(cam), _t(c2p), 4, 1, *meta)
    params = PCV.sweep_params(_t(cam), _t(c2p), *meta, 1)
    assert torch.equal(warped, PCV.warp_prev_plain(
        _t(prev), *PCV.sweep_coords_plain(params, _t(depths), 6, 16, 4)))
    assert torch.equal(cur2d, _t(prev)[:, ::4, ::4])
    vol, sem, att, u2, v2, xs, pad = _voxel_data(3)
    ds = PFS.slab_depth_static(xs, 2.0, 30.0, 6)
    tabs = PFS.depth_tables(ds, 'cpu')
    args = (_t(u2), _t(v2))
    got = K.frustum_voxel_features(_t(vol), _t(sem), _t(att), *args, ds, pad)
    assert torch.equal(got, PFS.frustum_voxel_features_plain(
        _t(vol), _t(sem), _t(att), *args, *tabs, pad))
    got = K.frustum_voxel_features(_t(vol), _t(sem)[..., :0], _t(att),
                                   *args, ds, pad)
    assert torch.equal(got, PFS.stereo_sample_plain(_t(vol), *args, *tabs,
                                                    pad)[0])
    sm = _t(np.abs(vol[:, :, :, :, 0]))
    assert torch.equal(K.attention_sample(sm, *args, ds, pad),
                       PFS.attention_sample_plain(sm, *args, *tabs, pad))
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_kernels_match_plain(dtype):
    """Each sampling kernel against its plain version on the card (f32:
    atol 1e-5; bf16: one bf16 rounding of the output): K1's sweep and K2
    on 16-byte and on scalar rows, K3."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dt = getattr(torch, dtype)
    tol = F32_TOL if dt == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    dev = 'cuda'
    rng = np.random.RandomState(0)
    prev = _t(rng.randn(2, 24, 64, 32), dt).to(dev)
    depths, cam, (c2p, *meta) = _sweep_meta('b2')
    params = PCV.sweep_params(_t(cam).to(dev), _t(c2p).to(dev),
                              *(_t(x).to(dev) for x in meta))
    dd = _t(depths).to(dev)
    K.reset_launch_counts()
    for table in (prev, prev[..., :6].contiguous()):   # 16-byte / scalar rows
        np.testing.assert_allclose(
            K.warp_prev_sweep(table, params, dd, 6, 16, 4).float().cpu()
            .numpy(),
            PCV.warp_prev_plain(table, *PCV.sweep_coords_plain(
                params, dd, 6, 16, 4)).float().cpu().numpy(), **tol)
    vol, u2, v2, xs, pad = _frustum_data(0, (2, 6, 8, 16, 40))
    ds = PFS.slab_depth_static(xs, 2.0, 30.0, 6)
    vol_t = _t(vol, dt).to(dev)
    u2 = _t(np.stack([u2, u2 + 3])).to(dev)
    v2 = _t(np.stack([v2, v2 - 2])).to(dev)
    att = _t(rng.rand(2, 5, 12, 10)).to(dev)    # (B, nz, ny, nx)
    for table, cs in ((vol_t, 16), (vol_t[..., :5].contiguous(), 3)):
        sem = _t(rng.randn(2, 10, 20, cs), dt).to(dev)
        got = K.frustum_voxel_features(table, sem, att, u2, v2, ds, pad)
        want = PFS.frustum_voxel_features_plain(
            table, sem, att, u2, v2, *PFS.depth_tables(ds, dev), pad)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
    sm = _t(np.abs(rng.randn(2, 12, 16, 32)), dt).to(dev)
    dsf = PFS.slab_depth_static(xs, 2.0, 30.0, 12)
    np.testing.assert_allclose(
        K.attention_sample(sm, u2, v2, dsf, pad).cpu().numpy(),
        PFS.attention_sample_plain(sm, u2, v2, *PFS.depth_tables(dsf, dev),
                                   pad).cpu().numpy(), **F32_TOL)
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update(warp_prev=2, frustum_stereo_sample=2, attention_sample=1)
    with pytest.raises(ValueError):        # the kernel takes Cs > 0
        K.frustum_voxel_features(vol_t, sem[..., :0], att, u2, v2, ds, pad)
    assert K.LAUNCHES == want


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_attention_sample_edges(dtype):
    """K3 against its plain version at B = 2 (atol 1e-5 + rtol 1e-5; the
    kernel rounds each product and sum as the plain version does): voxels
    outside validity on both axes and out of the depth range, taps on the
    table's last row and column (u = pad_w - 1, v = pad_h - 1) and just
    inside the inclusive edge (u = pad_w, v = pad_h), an odd table width
    (unaligned column pairs) and grids that leave ragged 32 x 32 tiles."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dt = getattr(torch, dtype)
    dev = 'cuda'
    rng = np.random.RandomState(5)
    for (d, h, w), (nz, ny, nx) in (((12, 16, 33), (5, 40, 37)),
                                    ((24, 20, 64), (3, 33, 70))):
        pad = (2 * h, 2 * w)
        sm = _t(np.abs(rng.randn(2, d, h, w)), dt).to(dev)
        u = rng.rand(2, nx, ny) * (pad[1] + 8) - 4
        v = rng.rand(2, nx, nz) * (pad[0] + 8) - 4
        u[0, :, :4] = [0.0, pad[1] - 1, pad[1], pad[1] + 1e-3]
        v[1, :, :3] = [0.0, pad[0] - 1, pad[0]]
        u, v = _t(u).to(dev), _t(v).to(dev)
        xs = np.linspace(1.0, 32.0, nx)          # some slabs out of range
        ds = PFS.slab_depth_static(xs, 2.0, 30.0, d)
        assert not ds['in_range'].all()
        K.reset_launch_counts()
        got = K.attention_sample(sm, u, v, ds, pad)
        want = PFS.attention_sample_plain(sm, u, v,
                                          *PFS.depth_tables(ds, dev), pad)
        assert K.LAUNCHES['attention_sample'] == 1
        assert got.shape == (2, nz, ny, nx) and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **F32_TOL)
        assert float((want != 0).float().mean()) > 0.3
        assert bool((got[want == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cuda_voxel_features_match_plain(dtype):
    """The fused K2 against its plain version on the card at B = 2, with
    grids that leave ragged 8 x 32 (x, y) tiles, invalid voxels, slabs out
    of the depth range, edge taps and zeros in the attention: Cs = 32
    (16-byte chunks: one per lane in bf16, two in float32), Cs = 16 and
    channel counts that take one element per lane (C = 5, Cs = 3), and
    for each the stereo half against the stereo sample. f32: atol 1e-5 +
    rtol 1e-5; bf16: one bf16 rounding (atol 2e-2 + rtol 1e-2); and, as
    the kernel rounds as the plain version does, its bits."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dt = getattr(torch, dtype)
    tol = F32_TOL if dt == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    dev = 'cuda'
    for c, cs, grid in ((32, 32, (5, 40, 37)), (32, 32, (3, 33, 70)),
                        (32, 16, (5, 40, 37)), (5, 3, (4, 35, 19))):
        vol, sem, att, u, v, xs, pad = _voxel_data(
            7, vol_shape=(6, 8, 16, c), sem_shape=(10, 20, cs), grid=grid)
        ds = PFS.slab_depth_static(xs, 2.0, 30.0, 6)
        tabs = PFS.depth_tables(ds, dev)
        vb, sb = _t(vol, dt).to(dev), _t(sem, dt).to(dev)
        tu, tv, ta = _t(u).to(dev), _t(v).to(dev), _t(att).to(dev)
        K.reset_launch_counts()
        got = K.frustum_voxel_features(vb, sb, ta, tu, tv, ds, pad)
        want = PFS.frustum_voxel_features_plain(vb, sb, ta, tu, tv, *tabs,
                                                pad)
        assert got.shape == want.shape == (2,) + grid + (c + cs,)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)
        assert torch.equal(got, want)
        assert bool((got[want == 0] == 0).all())
        assert float((want != 0).float().mean()) > 0.2
        stereo, _ = PFS.stereo_sample_plain(vb, tu, tv, *tabs, pad)
        assert torch.equal(got[..., :c], stereo)
        assert K.LAUNCHES['frustum_stereo_sample'] == 1
    with pytest.raises(TypeError):      # sem in another dtype
        K.frustum_voxel_features(vb, sb.float() if dt != torch.float32
                                 else sb.to(torch.bfloat16), ta, tu, tv, ds,
                                 pad)


@pytest.mark.cuda
@pytest.mark.parametrize('tag', ['id', 'aug'])
def test_cuda_warp_prev_sweep_matches_plain(tag):
    """K1 with its grid computed in the kernel against
    `sweep_coords_plain` + `warp_prev_plain` on the card (f32: atol 1e-5 +
    rtol 1e-5; bf16: one bf16 rounding; and, as the kernel rounds as
    they do, their bits), `id`: one sample with identity
    aug; `aug`: B = 2, flip + crop + scale beside another meta and
    ego-motion; 16-byte rows and one element per lane (C = 6), an output
    of 12 rows (three blocks of 4) x 40 columns."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dev = 'cuda'
    depths, cam, (c2p, *meta) = _sweep_meta(dict(aug='aug_b2').get(tag,
                                                                   tag))
    params = PCV.sweep_params(_t(cam).to(dev), _t(c2p).to(dev),
                              *(_t(x).to(dev) for x in meta), 4)
    dd = _t(depths).to(dev)
    rng = np.random.RandomState(4)
    for dt in (torch.float32, torch.bfloat16):
        tol = F32_TOL if dt == torch.float32 else dict(atol=2e-2, rtol=1e-2)
        prev = _t(rng.randn(len(cam), 48, 160, 32), dt).to(dev)
        for table in (prev, prev[..., :6].contiguous()):
            K.reset_launch_counts()
            got = K.warp_prev_sweep(table, params, dd, 12, 40, 16)
            assert K.LAUNCHES['warp_prev'] == 1
            want = PCV.warp_prev_plain(table, *PCV.sweep_coords_plain(
                params, dd, 12, 40, 16))
            assert got.shape == (len(cam), 5, 12, 40, table.shape[-1])
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(), **tol)
            assert torch.equal(got, want)
            assert float((want != 0).float().mean()) > 0.5


def _bwd_cases(dev, dt=torch.float32):
    """K1-bwd and K2-bwd inputs: (name, function of the kernel's inputs ->
    (kernel result, plain result), requires-grad forward and its inputs)
    at the `aug_b2` sweep meta and the `_voxel_data` grids."""
    depths, cam, (c2p, *meta) = _sweep_meta('aug_b2')
    params = PCV.sweep_params(_t(cam).to(dev), _t(c2p).to(dev),
                              *(_t(x).to(dev) for x in meta), 4)
    dd = _t(depths).to(dev)
    rng = np.random.RandomState(9)
    cases = []
    for c in (32, 6):
        g = _t(rng.randn(len(cam), 5, 12, 40, c), dt).to(dev)
        shape = (len(cam), 48, 160, c)
        cases.append(('warp_prev_sweep_bwd', lambda g=g, shape=shape: (
            K.warp_prev_sweep_bwd(g, params, dd, shape, 16),
            K.warp_prev_sweep_bwd_plain(g, params, dd, shape, 16)),
            lambda x: K.warp_prev_sweep(x, params, dd, 12, 40, 16), shape,
            g))
    for c, cs, grid in ((32, 32, (5, 40, 37)), (5, 3, (4, 35, 19))):
        vol, sem, att, u, v, xs, pad = _voxel_data(
            7, vol_shape=(6, 8, 16, c), sem_shape=(10, 20, cs), grid=grid)
        ds = PFS.slab_depth_static(xs, 2.0, 30.0, 6)
        tu, tv, ta = _t(u).to(dev), _t(v).to(dev), _t(att).to(dev)
        g = _t(rng.randn(2, *grid, c + cs), dt).to(dev)
        args = (ta, tu, tv, ds, pad, vol.shape, sem.shape)
        cases.append(('frustum_voxel_features_bwd', lambda g=g, a=args: (
            K.frustum_voxel_features_bwd(g, *a),
            K.frustum_voxel_features_bwd_plain(g, *a)), None, None, g))
    return cases


def test_backward_wrappers_take_plain_versions_on_cpu():
    """On the CPU the backward wrappers are their plain versions, and
    autograd through K1's and K2's wrappers gives those gradients (atol
    1e-5 + rtol 1e-5: the CPU's accumulating index_put sums in the order
    its threads take)."""
    K.reset_launch_counts()
    for name, run, fwd, shape, g in _bwd_cases('cpu'):
        got, want = run()
        for a, b in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                       **F32_TOL)
            assert a.dtype == torch.float32 and bool((a != 0).any())
        if fwd is not None:
            x = torch.zeros(shape, requires_grad=True)
            grad, = torch.autograd.grad(fwd(x), x, g)
            np.testing.assert_allclose(grad.numpy(), want.numpy(),
                                       **F32_TOL)
    assert K.LAUNCHES == {n: 0 for n in K.LAUNCHES}


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain():
    """K1-bwd and K2-bwd against `torch.autograd.grad` of the plain
    forwards on the card, float32 at B = 2 (the `aug_b2` sweep, the
    `_voxel_data` grids with invalid voxels, slabs out of range and edge
    taps; 16-byte chunks and one element per lane): atol 1e-5 + rtol
    1e-5 (the atomics add in another order); and a K1 / K2 step through
    autograd launches each backward kernel once."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dev = 'cuda'
    for name, run, fwd, shape, g in _bwd_cases(dev):
        K.reset_launch_counts()
        got, want = run()
        for a, b in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       err_msg=name, **F32_TOL)
            assert bool((b != 0).any()), name
        bwd = 'warp_prev_bwd' if name == 'warp_prev_sweep_bwd' else \
            'frustum_stereo_sample_bwd'
        assert K.LAUNCHES[bwd] == 1
        if fwd is not None:
            x = torch.zeros(shape, device=dev, requires_grad=True)
            grad, = torch.autograd.grad(fwd(x), x, g)
            np.testing.assert_allclose(grad.cpu().numpy(),
                                       want.cpu().numpy(), **F32_TOL)
            assert K.LAUNCHES['warp_prev'] == 1 and K.LAUNCHES[bwd] == 2
    vol, sem, att, u, v, xs, pad = _voxel_data(3)
    ds = PFS.slab_depth_static(xs, 2.0, 30.0, 6)
    vb = _t(vol).to(dev).requires_grad_()
    sb = _t(sem).to(dev).requires_grad_()
    K.reset_launch_counts()
    out = K.frustum_voxel_features(vb, sb, _t(att).to(dev), _t(u).to(dev),
                                   _t(v).to(dev), ds, pad)
    gv, gs = torch.autograd.grad(out.square().sum(), (vb, sb))
    assert K.LAUNCHES['frustum_stereo_sample_bwd'] == 1
    cpu = [_t(x).requires_grad_() for x in (vol, sem)]
    ref = PFS.frustum_voxel_features_plain(
        *cpu, _t(att), _t(u), _t(v), *PFS.depth_tables(ds, 'cpu'), pad)
    wv, ws = torch.autograd.grad(ref.square().sum(), cpu)
    for a, b in ((gv, wv), (gs, ws)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **F32_TOL)


@pytest.mark.cuda
def test_cuda_chain_kernels_match_plain():
    """K8a, K4 (both residual modes) and K7a (both exits) against their
    plain versions on the card, at shapes with ragged and whole tiles
    (K4's are 8 x 64; H and W of 13 x 70 and 24 x 200 are multiples of
    neither, and 13 or 7 slices of 12 or 4 tiles split the persistent
    grid's shares in the middle of a tile): outputs to one bf16 rounding
    (atol 1e-2 + rtol 1e-2), moments rtol 1e-4 (+ atol 1e-3: sums of a
    few hundred signed terms), borders zero, K4 bit-identical across two
    runs. cuDNN's TF32 is off for the plain f32 conv."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dev = 'cuda'
    rng = np.random.RandomState(0)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for shape in ((5, 20, 40, 32), (3, 16, 32, 32), (2, 1, 1, 32),
                      (13, 24, 200, 32), (7, 13, 70, 32)):
            x = _t(rng.randn(*shape), torch.bfloat16).to(dev)
            k = _t(rng.randn(32, 32, 3, 3, 3) * 0.1).to(dev)
            sc, bs = _t(rng.rand(32) + 0.5).to(dev), _t(rng.randn(32)).to(dev)
            K.reset_launch_counts()
            cv = KC.pack_vol(x)
            assert torch.equal(cv.data, CC.pack_vol_plain(x).data)
            for residual in (False, True):
                out, ps = KC.conv_p2p(cv, k, residual)
                out2, ps2 = KC.conv_p2p(cv, k, residual)
                assert torch.equal(out.data, out2.data)
                assert torch.equal(ps, ps2)
                want, wps = CC.conv_p2p_plain(cv, k, residual)
                assert out.border_is_zero()
                torch.testing.assert_close(out.data.float(),
                                           want.data.float(), atol=1e-2,
                                           rtol=1e-2)
                torch.testing.assert_close(ps.sum(1), wps.sum(1), rtol=1e-4,
                                           atol=1e-3)
            for res, relu in ((cv, False), (None, True)):
                got = KC.unpack_affine(out, sc, bs, res, relu)
                ref = CC.unpack_affine_plain(out, sc, bs, res, relu)
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=1e-2, rtol=1e-2)
            assert (K.LAUNCHES['pack_vol'], K.LAUNCHES['conv_p2p'],
                    K.LAUNCHES['unpack_affine_res']) == (1, 4, 2)
        with pytest.raises(TypeError):
            KC.pack_vol(x.float())
        with pytest.raises(ValueError):
            KC.pack_vol(x[..., :16].contiguous())
    finally:
        torch.backends.cudnn.allow_tf32 = flag


@pytest.mark.cuda
def test_cuda_hourglass_kernels_match_plain():
    """K5, K6, K7b and K8b against their plain versions on the card, at
    shapes with ragged and whole tiles (K5's are 2 x 64 output voxels:
    H / 2 = 13, 5, 3 and W / 2 = 70, 66, 100 are ragged, depth 44 is the
    reduced mono trunk's): K5 to one bf16 rounding (atol 1e-2
    + rtol 1e-2) with moments rtol 1e-4 (+ atol 1e-3: sums of a few
    hundred signed terms) and bit-identical across two runs; K6 (on
    contiguous sub-volumes and on the strided view `convt1_parity`
    returns), K7b (all four modes) and K8b bit for bit, borders zero.
    cuDNN's TF32 is off for the plain f32 conv."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    dev = 'cuda'
    rng = np.random.RandomState(0)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for shape in ((4, 20, 40, 32), (8, 16, 32, 32), (2, 2, 2, 32),
                      (44, 26, 140, 32), (6, 10, 132, 32), (4, 6, 200, 32)):
            d, h, w, _ = shape
            x = _t(rng.randn(*shape), torch.bfloat16).to(dev)
            k64 = _t(rng.randn(64, 32, 3, 3, 3) * 0.1).to(dev)
            sc, bs = _t(rng.rand(32) + 0.5).to(dev), _t(rng.randn(32)).to(dev)
            K.reset_launch_counts()
            cv = KC.pack_vol(x)
            assert torch.equal(KC.unpack_vol(cv), x)
            out, ps = KC.conv_s2_p2d(cv, k64)
            out2, ps2 = KC.conv_s2_p2d(cv, k64)
            assert torch.equal(out, out2) and torch.equal(ps, ps2)
            want, wps = CC.conv_s2_plain(cv, k64)
            torch.testing.assert_close(out.float(), want.float(), atol=1e-2,
                                       rtol=1e-2)
            torch.testing.assert_close(ps.sum(1), wps.sum(1), rtol=1e-4,
                                       atol=1e-3)
            post = _t(rng.randn(d // 2, h // 2, w // 2, 64),
                      torch.bfloat16).to(dev)
            wt = _t(rng.randn(64, 32, 3, 3, 3) * 0.1).to(dev)
            par = CC.convt1_parity(post, wt)
            assert par.stride(0) == 32       # parities side by side
            for p in (par, par.contiguous()):
                got, gps = KC.pack_parity8(p)
                want, wps = CC.pack_parity8_plain(p)
                assert torch.equal(got.data, want.data)
                assert got.border_is_zero()
                torch.testing.assert_close(gps.sum(1), wps.sum(1), rtol=1e-4,
                                           atol=1e-3)
            for res, relu in ((cv, False), (None, True), (cv, True),
                              (None, False)):
                got = KC.affine_chain(got, sc, bs, res, relu)
                assert got.border_is_zero()
            assert torch.equal(
                KC.affine_chain(cv, sc, bs, cv, True).data,
                CC.affine_mask(cv, sc, bs, True, cv).data)
            assert (K.LAUNCHES['unpack_vol'], K.LAUNCHES['conv_s2_p2d'],
                    K.LAUNCHES['pack_parity8'],
                    K.LAUNCHES['gn_affine_res_packed']) == (1, 2, 2, 5)
        with pytest.raises(ValueError):
            KC.conv_s2_p2d(KC.pack_vol(x[:1]), k64)           # odd depth
        with pytest.raises(ValueError):
            KC.pack_parity8(par[..., :16])                    # 16 channels
        with pytest.raises(TypeError):
            KC.pack_parity8(par.float())
    finally:
        torch.backends.cudnn.allow_tf32 = flag


@pytest.mark.cuda
def test_cuda_conv3d_kernels_match_plain():
    """K9a (`conv3d_stats`) and K9b (`conv3d`), both on the `wgmma` code
    for bf16 with C, C_out % 8 == 0 (K9a its moment instance) and on the
    direct kernel elsewhere, against their plain versions on the card, at
    shapes with ragged and whole tiles (the `wgmma` tile is 8 x 64:
    ragged D shares, H and W at C = 8, 16 and 32, C_out = 8, 24 (two
    chunks) and 64 (two launches of 32)), C = 42 (weights chunked over
    C_out) included: float32 atol 1e-4 + rtol 1e-4 (the same f32
    products summed in another order), bf16 one rounding (atol 1e-2 +
    rtol 1e-2); K9a's partials within chip_smoke's bound (rtol 1e-4;
    sums + 1e-6 * sqrt(N * sum of squares)) and bit-identical across two
    runs; the finish kernel `torch.equal` to its plain apply step on the
    same inputs (16-byte vectors and single elements, with and without
    residual and relu); `conv3d_gn` with residual and relu to one
    rounding more. cuDNN's TF32 is off for the plain f32 convs."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    from dfm_tpu_torch.ops import conv3d as C3
    from dfm_tpu_torch.ops import convgn as G
    from dfm_tpu_torch.ops.cuda import conv3d as KC3
    dev = 'cuda'
    bf = torch.bfloat16
    rng = np.random.RandomState(0)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        K.reset_launch_counts()
        for shape, c_out, dt in (((8, 8, 16, 8), 8, torch.float32),
                                 ((8, 4, 24, 16), 8, bf),
                                 ((5, 7, 40, 42), 42, torch.float32),
                                 ((4, 20, 40, 32), 32, bf)):
            x = _t(rng.randn(*shape), dt).to(dev)
            k = _t(rng.randn(c_out, shape[-1], 3, 3, 3) * 0.1).to(dev)
            tol = F32_TOL if dt == torch.float32 else dict(atol=1e-2,
                                                           rtol=1e-2)
            torch.testing.assert_close(KC3.conv3d(x, k).float(),
                                       C3.conv3d_plain(x, k).float(),
                                       atol=max(tol['atol'], 1e-4),
                                       rtol=max(tol['rtol'], 1e-4))
        for shape, c_out in (((5, 9, 70, 8), 8), ((3, 13, 66, 16), 64),
                             ((7, 17, 130, 16), 24), ((4, 20, 40, 32), 64),
                             ((2, 1, 1, 8), 8)):
            x = _t(rng.randn(*shape), bf).to(dev)
            k = _t(rng.randn(c_out, shape[-1], 3, 3, 3) * 0.1).to(dev)
            assert KC3.tensor_core_chunks(x.dtype, shape[-1], c_out)
            out = KC3.conv3d(x, k)
            assert torch.equal(out, KC3.conv3d(x, k))
            torch.testing.assert_close(out.float(),
                                       C3.conv3d_plain(x, k).float(),
                                       atol=1e-2, rtol=1e-2)
        zpack = (((8, 20, 40, 32), 32, bf, 5), ((4, 16, 64, 32), 32, bf, 8),
                 ((12, 9, 70, 8), 8, bf, 3), ((4, 13, 130, 16), 24, bf, 13),
                 ((8, 12, 66, 32), 64, bf, 4), ((4, 6, 40, 8), 32, bf, 3),
                 ((8, 8, 16, 8), 32, torch.float32, 4),
                 ((4, 6, 40, 12), 32, bf, 3))
        for shape, c_out, dt, th in zpack:
            x = _t(rng.randn(*shape), dt).to(dev)
            k = _t(rng.randn(c_out, shape[-1], 3, 3, 3) * 0.1).to(dev)
            wgmma = KC3.stats_route(dt, shape[-1], c_out)[0] is not None
            assert wgmma == (dt == bf and shape[-1] % 8 == 0)
            out, ps = KC3.conv3d_stats(x, k, th)
            out2, ps2 = KC3.conv3d_stats(x, k, th)
            assert torch.equal(out, out2) and torch.equal(ps, ps2)
            want, wps = G.conv3d_zpack_plain(x, k, th)
            atol = 1e-4 if dt == torch.float32 else 1e-2
            torch.testing.assert_close(out.float(), want.float(), atol=atol,
                                       rtol=atol)
            lim = 1e-4 * wps.double().abs()
            lim[..., 0, :] += 1e-6 * (th * shape[2]
                                      * wps[..., 1, :].double()).sqrt()
            assert bool(((ps.double() - wps.double()).abs() <= lim).all())
            sc = _t(rng.rand(c_out) + 0.5).to(dev)
            bs = _t(rng.randn(c_out)).to(dev)
            res = _t(rng.randn(*shape[:3], c_out), dt).to(dev)
            for r, relu in ((res, True), (None, False)):
                assert torch.equal(KC3.gn_finish(out, sc, bs, r, relu),
                                   G.gn_finish_plain(out, sc, bs, r, relu))
            o6, r6 = out[..., :6].contiguous(), res[..., :6].contiguous()
            assert torch.equal(KC3.gn_finish(o6, sc[:6], bs[:6], r6, True),
                               G.gn_finish_plain(o6, sc[:6], bs[:6], r6,
                                                 True))
            torch.testing.assert_close(
                G.conv3d_gn(x, k, sc, bs, 8, residual=res, relu=True,
                            th=th).float(),
                G.conv3d_gn_plain(x, k, sc, bs, 8, residual=res, relu=True,
                                  th=th).float(), atol=2 * atol, rtol=2 * atol)
        want = dict.fromkeys(K.LAUNCHES, 0)
        # per K9a case: conv3d_stats twice and once in conv3d_gn; three
        # finishes and one in conv3d_gn
        want.update(conv3d_pallas=14, conv3d_zpack=3 * len(zpack),
                    conv3d_gn_finish=4 * len(zpack))
        assert K.LAUNCHES == want
        with pytest.raises(TypeError):
            KC3.conv3d(x.half(), k)
        with pytest.raises(ValueError):
            KC3.conv3d_stats(x[:3].contiguous(), k, 3)     # D % 4
        with pytest.raises(ValueError):
            KC3.conv3d(x[..., :4], k)                      # not contiguous
        with pytest.raises(ValueError):
            KC3.gn_finish(out, sc[:5], bs, None, False)    # sc's length
    finally:
        torch.backends.cudnn.allow_tf32 = flag


@pytest.mark.cuda
def test_cuda_conv3d_zpack_keeps_no_weight_layout():
    """`conv3d_zpack` takes its taps out of the banded weights on every
    call and lays them out for that call only: a loop of calls leaves
    `cached_wgmma_weight`'s table as it found it, and its outputs equal
    `conv3d_stats` on the same taps."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from dfm_tpu_torch.ops import convgn as G
    from dfm_tpu_torch.ops.cuda import conv3d as KC3
    rng = np.random.RandomState(3)
    x = _t(rng.randn(8, 16, 64, 32), torch.bfloat16).cuda()
    k = _t(rng.randn(32, 32, 3, 3, 3) * 0.1).cuda()
    w_big = G.pack_weights(k)
    before = len(KC._WGMMA_WEIGHTS)
    for _ in range(10):
        out, ps = G.conv3d_zpack(x, w_big, 8)
    torch.cuda.synchronize()
    assert len(KC._WGMMA_WEIGHTS) == before
    want, wps = KC3.conv3d_stats(x, G.band_taps(w_big, 32, 32), 8,
                                 cache_weight=False)
    assert torch.equal(out, want) and torch.equal(ps, wps)
