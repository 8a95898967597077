"""FrustumToVoxel's generic branch (`separable=False`) against the JAX
package's, on the CPU at a small grid.

* the ops of `dfm_tpu_torch/ops/frustum.py` against JAX's unpacked
  reference samplers and its base-27 hat sampler with a float32 table
  (the same function): stereo sample, log-sum-exp map, attention, sem
  sample within 1e-5 absolute (measured: 0, 4.8e-7, 6e-8, 0), the
  projection within rtol 1e-6 / atol 1e-5 (measured 3.8e-6 px);
* the neck (voxel ConvNorm with GroupNorm, z pool) against JAX's
  `FrustumToVoxel(separable=False)` in train and eval mode, outputs within
  2e-5 absolute (measured 1.9e-6; both read the base cost from a
  bfloat16 table), and the gradients of a weighted sum to the stereo
  volume and the sem features within 1e-5 relative L2 (measured 3.1e-7
  and 4.2e-7);
* a tensor `coors_3d` takes the generic branch too; the port's separable
  path on the same inputs lies within bfloat16 rounding of the generic
  one (relative L2 2e-2; measured 6.7e-5: the generic attention reads
  the cost rounded to bfloat16, the separable one in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models.necks.frustum_to_voxel import \
    FrustumToVoxel as JFrustumToVoxel
from dfm_tpu.ops import frustum as JF
from dfm_tpu_torch.models.necks.frustum_to_voxel import FrustumToVoxel
from dfm_tpu_torch.ops import frustum as F
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import randomize

B, D, HC, WC, CV, CS = 2, 12, 6, 10, 8, 8
PAD = (24, 40)
HS, WS = 12, 20
DMIN, DMAX = 2.0, 20.0
GRID = (8, 6, 10)                  # Nz, Ny, Nx
COUT = 16
OP_TOL = 1e-5
NECK_ATOL = 2e-5
GRAD_REL = 1e-5
BF16_REL = 2e-2


def coors():
    """(Nz, Ny, Nx, 3) pseudo-lidar centres: x forward in [3, 21), y
    across, z up; a few fall outside the image or the depth range."""
    nz, ny, nx = GRID
    xs = np.linspace(3.0, 21.0, nx, dtype=np.float32)
    ys = np.linspace(-7.0, 7.0, ny, dtype=np.float32)
    zs = np.linspace(-2.0, 1.5, nz, dtype=np.float32)
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing='ij')
    return np.stack([xx, yy, zz], -1)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    cam = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    cam[:, 0, 0] = cam[:, 1, 1] = 18.0
    cam[:, 0, 2], cam[:, 1, 2] = 20.0, 12.0
    cam[1, 0, 3] = 0.9                 # a KITTI P2-style translation
    cam[1, 0, 0] = 17.0
    return dict(
        stereo=rng.randn(B, D, HC, WC, CV).astype(np.float32),
        cost=(2 * rng.randn(B, D, HC, WC)).astype(np.float32),
        sem=rng.randn(B, HS, WS, CS).astype(np.float32), cam=cam)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ops_match_jax():
    x = inputs()
    c = coors()
    for i in range(B):
        want_c = np.asarray(JF.project_voxels_to_frustum(
            jnp.asarray(c), jnp.asarray(x['cam'][i])))
        got_c = F.project_voxels_to_frustum(t(c), t(x['cam'][i]))
        np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-6,
                                   atol=1e-5)
        coord = jnp.asarray(want_c)
        jv, jv2, jvv = JF.sample_stereo_volume(
            jnp.asarray(x['stereo'][i]), coord, PAD, DMIN, DMAX)
        gv, gv2, gvv = F.sample_stereo_volume(
            t(x['stereo'][i]), t(want_c), PAD, DMIN, DMAX)
        np.testing.assert_allclose(gv.numpy(), np.asarray(jv), atol=OP_TOL)
        np.testing.assert_array_equal(gv2.numpy(), np.asarray(jv2))
        np.testing.assert_array_equal(gvv.numpy(), np.asarray(jvv))
        assert 0 < int(gvv.sum()) < gvv.numel()
        cost = x['cost'][i]
        jlse = np.asarray(JF.depth_softmax_lse_map(jnp.asarray(cost), 4, PAD))
        glse = F.depth_softmax_lse_map(t(cost), 4, PAD, band_bytes=4096)
        np.testing.assert_allclose(glse.numpy(), jlse, atol=OP_TOL)
        b27, lse4 = JF.build_base27_tables(jnp.asarray(cost), 4, PAD,
                                           dtype=jnp.float32)
        jatt = np.asarray(JF.sample_softmax_base27_hat(
            b27, lse4, coord, PAD, DMIN, DMAX, 4))
        gatt = F.sample_softmax_attention(t(cost), glse, t(want_c), PAD,
                                          DMIN, DMAX, 4)
        np.testing.assert_allclose(gatt.numpy(), jatt, atol=OP_TOL)
        assert jatt.max() > 0.05
        jsem = np.asarray(JF.sample_sem_features(
            jnp.asarray(x['sem'][i]), coord, PAD, jnp.asarray(jv2)))
        gsem = F.sample_sem_features(t(x['sem'][i]), t(want_c), PAD, gv2)
        np.testing.assert_allclose(gsem.numpy(), jsem, atol=OP_TOL)


@pytest.fixture(scope='module')
def necks():
    x = inputs(1)
    jm = JFrustumToVoxel(out_channels=COUT, depth_min=DMIN, depth_max=DMAX,
                         separable=False)
    args = (jnp.asarray(x['stereo']), jnp.asarray(x['cost']),
            jnp.asarray(x['sem']), jnp.asarray(coors()),
            jnp.asarray(x['cam']), PAD)
    v = randomize(jm.init(jax.random.PRNGKey(0), *args), 3)
    key_map = [(k[len('feature_transformation.'):], f[1:], kind)
               for k, f, kind in W.dfm_key_map()
               if f[0] == 'feature_transformation']
    port = FrustumToVoxel(CV + CS, COUT, DMIN, DMAX, separable=False)
    port.load_state_dict(W.state_dict_from_jax(v, key_map), strict=True)
    return x, jm, v, args, port


@pytest.mark.parametrize('train', [False, True])
def test_neck_matches_jax(necks, train):
    x, jm, v, args, port = necks
    want = np.asarray(jax.jit(lambda vv, *a: jm.apply(
        vv, *a, PAD, train=train), static_argnums=())(v, *args[:5]))
    port.train(train)
    got = port(t(x['stereo']), t(x['cost']), t(x['sem']), coors(),
               t(x['cam']), PAD)
    assert got.shape == (B, GRID[0] // 4) + GRID[1:] + (COUT,)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=NECK_ATOL)
    # a tensor coors_3d takes the generic branch whatever `separable` says
    port.separable = True
    try:
        again = port(t(x['stereo']), t(x['cost']), t(x['sem']),
                     t(coors()), t(x['cam']), PAD)
    finally:
        port.separable = False
    np.testing.assert_array_equal(again.detach().numpy(),
                                  got.detach().numpy())


def test_neck_gradients_match_jax(necks):
    x, jm, v, args, port = necks
    wgt = np.random.RandomState(5).randn(
        B, GRID[0] // 4, GRID[1], GRID[2], COUT).astype(np.float32)

    def loss(stereo, sem):
        out = jm.apply(v, stereo, args[1], sem, args[3], args[4], PAD)
        return jnp.sum(out * wgt)

    jgs, jgm = jax.jit(jax.grad(loss, argnums=(0, 1)))(args[0], args[2])
    stereo = t(x['stereo']).requires_grad_()
    sem = t(x['sem']).requires_grad_()
    port.eval()
    (port(stereo, t(x['cost']), sem, coors(), t(x['cam']), PAD) *
     t(wgt)).sum().backward()
    for got, want in ((stereo.grad, jgs), (sem.grad, jgm)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= GRAD_REL, rel


def test_generic_against_separable(necks):
    """The port's two branches on the same inputs (the separable one on
    the CPU runs the kernels' plain versions)."""
    x, _, _, _, port = necks
    port.eval()
    generic = port(t(x['stereo']), t(x['cost']), t(x['sem']), coors(),
                   t(x['cam']), PAD).detach().numpy()
    port.separable = True
    try:
        sep = port(t(x['stereo']), t(x['cost']), t(x['sem']), coors(),
                   t(x['cam']), PAD).detach().numpy()
    finally:
        port.separable = False
    rel = np.linalg.norm(sep - generic) / np.linalg.norm(generic)
    assert rel <= BF16_REL, rel
