"""MultiViewDfM's modules in the port against the JAX package, on the CPU.

The JAX tests' reduced size (`tests/test_multiview_dfm.py`: B 1, F 2,
V 3, 32x48 images, FPN width 16, a (4, 16, 16) voxel grid, ResNet-50):
the same seeded numpy inputs and the same seeded flax variables, carried
over through `utils/weights.py:mvdfm_key_map`, go through both packages
in float32, torch in one thread. Tolerances:

* the aligned sample grid and the anchors: exact;
* `transform_points`: atol 1e-5 on coordinates up to ~1e3;
* `point_sample` against `packed_bilinear_sample`, floor index -1 and
  the far edge included: atol 1e-5 (the port normalises the coordinates
  to `F.grid_sample`'s [-1, 1] and back: a few ulp of a coordinate up to
  10, ~2e-6 px, times a gradient of up to ~3 between unit-normal taps);
* the ResNet stages, FPN level 0 and the whole model's sampled volume,
  BEV map and head outputs: relative L2 1e-4 (XLA's and PyTorch's CPU
  convolutions sum in other orders through 50 layers);
* `mvdfm_predict` on the models' own outputs, class bias raised so that
  boxes are live: boxes, labels, scores and mask within 1e-4 absolute
  plus 1e-4 relative (random weights decode boxes of tens of metres).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.core import anchors as JA
from dfm_tpu.core.transforms import transform_points as j_transform_points
from dfm_tpu.models import MultiViewDfM as JMultiViewDfM
from dfm_tpu.models import MVDfMConfig as JMVDfMConfig
from dfm_tpu.models import mvdfm_predict as j_mvdfm_predict
from dfm_tpu.models.backbones.resnet import ResNet as JResNet
from dfm_tpu.models.necks.fpn import FPN as JFPN
from dfm_tpu.models.necks.imvoxel_neck import OutdoorImVoxelNeck as JNeck
from dfm_tpu.ops.packed_sample import pack_taps_2d, packed_bilinear_sample
from dfm_tpu_torch.core import anchors as A
from dfm_tpu_torch.core.transforms import transform_points
from dfm_tpu_torch.models.backbones.resnet import ResNet
from dfm_tpu_torch.models.builder import build_detector
from dfm_tpu_torch.models.detectors.multiview_dfm import (MultiViewDfM,
                                                          MVDfMConfig,
                                                          mvdfm_predict)
from dfm_tpu_torch.models.necks.fpn import FPN
from dfm_tpu_torch.models.necks.imvoxel_neck import OutdoorImVoxelNeck
from dfm_tpu_torch.ops.point_sample import point_sample
from dfm_tpu_torch.runtime.config import load_config
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import carry, randomize, submap

torch.set_num_threads(1)    # from import on; the workers share the cores

B, F, V, H, WID = 1, 2, 3, 32, 48
REL_L2 = 1e-4
DET_TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(num_views=V, num_frames=F, feat_channels=16,
            voxel_range=(-8, -8, -1, 8, 8, 3), voxel_grid=(4, 16, 16),
            anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3,
            backbone_depth=50, nms_pre=128, max_num=8)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def lidar2img():
    """A ring of V cameras looking outward (the JAX test's projections)."""
    l2i = np.zeros((B, F, V, 4, 4), np.float32)
    for f in range(F):
        for v in range(V):
            ang = 2 * np.pi * v / V + 0.1 * f
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[-s, c, 0, 0], [0, 0, -1, 0],
                            [c, s, 0, 0], [0, 0, 0, 1]], np.float32)
            k = np.eye(4, dtype=np.float32)
            k[0, 0] = k[1, 1] = 30.0
            k[0, 2], k[1, 2] = WID / 2, H / 2
            l2i[:, f, v] = k @ rot
    return l2i


def flax_variables(module, *args, seed=0):
    """Seeded random variables of the right shapes, without running the
    flax initialisers (`jax.eval_shape` traces only)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, train=False))
    return randomize(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes), seed)


@pytest.fixture(scope='module')
def models():
    jcfg = JMVDfMConfig(**TINY)
    jm = JMultiViewDfM(cfg=jcfg)
    rng = np.random.RandomState(0)
    imgs = rng.randn(B, F, V, H, WID, 3).astype(np.float32)
    l2i = lidar2img()
    variables = flax_variables(jm, imgs, l2i, (H, WID))
    # class bias raised: live boxes for the predict test
    head = variables['params']['bbox_head_3d']['conv_cls']
    head['bias'] = (0.5 + 0.3 * rng.randn(*head['bias'].shape)).astype(
        np.float32)
    jout = jax.jit(lambda v, i, m: jm.apply(v, i, m, (H, WID), train=False))(
        variables, imgs, l2i)
    jout = jax.tree.map(np.asarray, jout)
    port = carry(MultiViewDfM(MVDfMConfig(**TINY)), variables,
                 W.mvdfm_key_map(50))
    with torch.no_grad():
        pout = port(torch.from_numpy(imgs), torch.from_numpy(l2i))
    return dict(jcfg=jcfg, variables=variables, imgs=imgs, l2i=l2i,
                jout=jout, port=port, pout=pout)


def test_aligned_grid_and_anchors():
    """The aligned generator, the sample grid in (Nz, Ny, Nx) order and
    the head anchors: bit for bit."""
    for grid, rng in (((4, 16, 16), (-8, -8, -1, 8, 8, 3)),
                      ((12, 240, 300), (-35.0, -75.0, -2, 75.0, 75.0, 4)),
                      ((3, 5, 7), (-1.3, 0.2, -0.7, 2.9, 4.1, 1.1))):
        cfg = dict(voxel_grid=grid, voxel_range=rng)
        want = JMVDfMConfig(**cfg).sample_points()
        got = MVDfMConfig(**cfg).sample_points()
        assert got.shape == grid + (3,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    sizes, rots = [[1, 2, 3], [0.5, 0.6, 0.7]], [0.0, 1.57]
    ranges = [[-8, -8, -1, 8, 8, 3], [-4, -5, 0, 6, 7, 1]]
    np.testing.assert_array_equal(
        A.AlignedAnchor3DRangeGenerator(ranges, sizes, rots).grid_anchors(
            (6, 10)),
        JA.AlignedAnchor3DRangeGenerator(ranges, sizes, rots).grid_anchors(
            (6, 10)))
    np.testing.assert_array_equal(
        MVDfMConfig(**TINY).anchor_generator().grid_anchors((16, 16)),
        JMVDfMConfig(**TINY).anchor_generator().grid_anchors((16, 16)))


def test_transform_points():
    rng = np.random.RandomState(1)
    pts = (rng.randn(5, 7, 3) * 30).astype(np.float32)
    mat = lidar2img()[0, 0, 1]
    want = np.asarray(j_transform_points(jnp.asarray(pts), jnp.asarray(mat)))
    got = transform_points(torch.from_numpy(pts), torch.from_numpy(mat))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


def test_point_sample_edges():
    """Interior points, floor index -1, the far edge, fully outside, and
    the mask; against the JAX tap-packed sample."""
    rng = np.random.RandomState(2)
    h, w, c = 7, 9, 5
    feat = rng.randn(h, w, c).astype(np.float32)
    xs = np.array([-1.5, -1.0, -0.7, -0.01, 0.0, 0.3, 4.5, w - 1.0,
                   w - 0.6, w - 0.01, w + 0.2], np.float32)
    ys = np.array([-1.2, -0.4, 0.0, 2.7, h - 1.0, h - 0.3, h + 0.5],
                  np.float32)
    coords = np.stack(np.meshgrid(xs, ys, indexing='ij'), -1).reshape(-1, 2)
    coords = np.concatenate(
        [coords, (rng.rand(64, 2) * [w + 1, h + 1] - 1).astype(np.float32)])
    want = np.asarray(packed_bilinear_sample(
        pack_taps_2d(jnp.asarray(feat)), jnp.asarray(coords), c))
    tfeat = torch.from_numpy(feat).permute(2, 0, 1)
    got = point_sample(tfeat, torch.from_numpy(coords)).numpy().T
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the floor -1 and far-edge points read their one inside tap
    assert np.abs(want).min(1).max() > 0
    valid = rng.rand(len(coords)) > 0.5
    got = point_sample(tfeat, torch.from_numpy(coords),
                       torch.from_numpy(valid)).numpy().T
    np.testing.assert_allclose(got, want * valid[:, None], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('depth', [18, 50])
def test_resnet_stages(depth, models):
    """The four stage outputs (the model's own ResNet-50 weights; a
    seeded ResNet-18 for the basic blocks and their key map)."""
    x = np.random.RandomState(3).randn(2, H, WID, 3).astype(np.float32)
    jm = JResNet(depth=depth)
    if depth == 50:
        v = models['variables']
        variables = {k: v[k]['backbone'] for k in ('params', 'batch_stats')}
    else:
        variables = flax_variables(jm, x, seed=4)
    want = jm.apply(variables, x, False)
    key_map = submap(W.resnet_key_map('backbone', ('backbone',), depth),
                     'backbone', ('backbone',))
    port = carry(ResNet(depth), variables, key_map)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 4
    for g, w_ in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w_.shape
        assert rel_l2(g, w_) < REL_L2


def test_fpn_four_inputs():
    """Four inputs of odd sizes (the top-down crop), num_outs 4 and 5
    (one extra conv): every level, and level 0 alone."""
    rng = np.random.RandomState(5)
    shapes = [(2, 9, 13, 8), (2, 5, 7, 12), (2, 3, 4, 16), (2, 2, 2, 20)]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    for num_outs in (4, 5):
        jm = JFPN(out_channels=6, num_outs=num_outs)
        variables = flax_variables(jm, xs, seed=num_outs)
        want = jm.apply(variables, xs, False)
        key_map = [(k, (k,), 'conv2d') for k in variables['params']]
        port = carry(FPN([8, 12, 16, 20], 6, num_outs=num_outs), variables,
                     key_map)
        txs = [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs]
        with torch.no_grad():
            got = port(txs)
            level0 = port(txs, levels=1)
        assert len(got) == num_outs and len(level0) == 1
        for g, w_ in zip(got, want):
            assert rel_l2(g.permute(0, 2, 3, 1).numpy(), w_) < REL_L2
        assert torch.equal(level0[0], got[0])


@pytest.mark.parametrize('nz', [3, 12])
def test_imvoxel_neck(nz):
    """z 3 -> 2 -> 1 -> 1 and the camsync config's 12 -> 6 -> 3 -> 2 ->
    mean: Conv3DSum pads 1 at stride 2 as torch's padding=1 does."""
    x = np.random.RandomState(6).randn(1, nz, 6, 5, 8).astype(np.float32)
    jm = JNeck(in_channels=8, out_channels=24)
    variables = flax_variables(jm, x, seed=7)
    want = np.asarray(jm.apply(variables, x, False))
    key_map = submap(W.mvdfm_key_map(50), 'neck_3d', ('neck_3d',))
    port = carry(OutdoorImVoxelNeck(8, 24), variables, key_map)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (1, 24, 6, 5)
    assert rel_l2(got.permute(0, 2, 3, 1).numpy(), want) < REL_L2


def test_level0_volume_bev_heads(models):
    """FPN level 0 over the model's ResNet stages, then the whole model:
    the sampled volume (F = 2, mean fusion), the BEV map and the three
    head outputs."""
    jout, pout = models['jout'], models['pout']
    v = models['variables']
    flat = models['imgs'].reshape(B * F * V, H, WID, 3)
    stages = JResNet(depth=50).apply(
        {k: v[k]['backbone'] for k in ('params', 'batch_stats')}, flat,
        False)
    want0 = JFPN(out_channels=16, num_outs=4).apply(
        {'params': v['params']['neck']}, stages, False)[0]
    with torch.no_grad():
        got0 = models['port'].image_features(torch.from_numpy(
            models['imgs']))
    got0 = got0.reshape((-1,) + got0.shape[3:]).permute(0, 2, 3, 1)
    assert rel_l2(got0.numpy(), want0) < REL_L2
    nz, ny, nx = TINY['voxel_grid']
    assert pout['volume_feat'].shape == (B, nz, ny, nx, 16)
    vol = jout['volume_feat']
    # the camera ring sees part of the grid: filled and empty voxels
    seen = np.abs(vol).sum(-1) > 0
    assert 0.2 < seen.mean() < 0.95
    for key in ('volume_feat', 'bev_feat', 'cls_score', 'bbox_pred',
                'dir_pred'):
        got = pout[key].numpy()
        assert got.shape == jout[key].shape, key
        assert rel_l2(got, jout[key]) < REL_L2, key
    np.testing.assert_array_equal(np.abs(pout['volume_feat'].numpy()).sum(
        -1) > 0, seen)


def test_mvdfm_predict(models):
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o: j_mvdfm_predict(o, models['jcfg']))(
        {k: jnp.asarray(models['jout'][k])
         for k in ('cls_score', 'bbox_pred', 'dir_pred')}))
    got = mvdfm_predict(models['pout'], MVDfMConfig(**TINY))
    assert int(want['mask'].sum()) == TINY['max_num']
    for key in ('boxes3d', 'scores', 'labels', 'mask'):
        np.testing.assert_allclose(got[key].numpy(), want[key], **DET_TOL,
                                   err_msg=key)


def test_camsync_config_and_unported_options():
    """The camsync and 10-sweeps configs build MVDfMConfig with their
    values; unknown keys are refused, and so is `DfMNeck` without concat
    fusion; every option of the JAX config builds (DfMNeck, CenterHead,
    the 3D backbone and the depth head); DCN stages build."""
    cfg = load_config('configs/multiview_dfm_r101_waymo_camsync.py')
    mcfg = build_detector(cfg.model)
    assert isinstance(mcfg, MVDfMConfig)
    assert (mcfg.backbone_depth, mcfg.voxel_grid, mcfg.nms_pre,
            mcfg.max_num) == (101, (12, 240, 300), 1024, 500)
    ten = build_detector(load_config(
        'configs/multiview_dfm_r101_waymo_camsync_10sweeps.py').model)
    assert (ten.num_frames, ten.frame_fusion, ten.neck_3d, ten.nms_pre,
            ten.max_num, ten.backbone_depth, ten.voxel_grid) == (
        2, 'concat', 'dfm', 500, 100, 101, (12, 240, 300))
    with pytest.raises(ValueError, match='not_a_field'):
        build_detector(dict(type='MultiViewDfM', not_a_field=1))
    with pytest.raises(ValueError, match='concat'):
        MultiViewDfM(MVDfMConfig(**dict(TINY, neck_3d='dfm')))
    for opts, module in ((dict(frame_fusion='concat', neck_3d='dfm'),
                          'neck_3d.aggregate_layer.weight'),
                         (dict(bbox_head='center'),
                          'bbox_head_3d.task1.heatmap_final.bias'),
                         (dict(with_backbone_3d=True, with_depth_head=True),
                          'depth_pred.1.weight')):
        assert module in MultiViewDfM(MVDfMConfig(**dict(
            TINY, **opts))).state_dict()
    # DCNv2 stages build (their parity with JAX: tests/test_torch_dla.py)
    dcn = ResNet(50, stage_with_dcn=(False, True, True, True)).state_dict()
    assert 'layer2.0.conv2.conv_offset.weight' in dcn
    assert not any(k.startswith('layer1.') and 'conv_offset' in k
                   for k in dcn)


def test_key_map_takes_every_leaf(models):
    """Every leaf of the JAX tree is taken by the key map, and the
    port's state dict holds nothing else."""
    v = models['variables']
    n_leaves = sum(x.size > 0 for x in jax.tree.leaves(v))
    sd = W.state_dict_from_jax(v, W.mvdfm_key_map(50))
    assert len(sd) == n_leaves
    assert set(sd) == set(models['port'].state_dict())
