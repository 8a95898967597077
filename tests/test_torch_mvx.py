"""MVX-FasterRCNN (PointFusion) against the JAX package, on the CPU.

* `bilinear_sample` on 400 coordinates around and past a 7x9 map (the
  four edges, the corners, the last pixel, points one past each side,
  negative ones): bit for bit JAX's op-by-op result; within 5e-7 of its
  jitted one (XLA fuses the four taps' multiply-adds);
* `point_fusion_sample` on points in front of, beside and behind a
  camera: the validity equal, the samples within 1e-6;
* a small MVX (ResNet-18 with an FPN of 16 channels, a fusion of 16, the
  VoxelNet tests' 40 x 40 grid with 8 and 16 channels) on 2 x 700 points
  and 2 x 64x96 images, eval mode: the validity equal, every float output
  within 1e-4 relative L2 (measured 2.1e-6); the key map takes every
  leaf;
* `mvx_loss` on JAX's outputs with gt boxes on anchors: every term within
  rtol 1e-5 (measured 6.0e-8); `mvx_predict` within 1e-6 / 1e-4;
* one training step against JAX's `make_train_step` by the rules of
  tests/test_torch_train_step.py (the image branch's, the fusion's and the
  encoder's gradients live; measured worst parameter 2.8e-3, whole
  vector 6.3e-4);
* `mvx_synth` equals JAX's MVX batch; `tools.test --synthetic` under both
  type names, `tools.train --synthetic` and its refusal without the flag
  (exit 2), in process.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.mvx_two_stage as JX
from dfm_tpu.ops.grid_sample import bilinear_sample as j_bilinear
from dfm_tpu_torch.models.detectors.mvx_two_stage import (
    MVXConfig, MVXFasterRCNN, mvx_loss, mvx_predict, point_fusion_sample)
from dfm_tpu_torch.ops.grid_sample import bilinear_sample
from dfm_tpu_torch.runtime.adapters import mvx_synth, mvx_to_device
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import random_variables
from test_torch_voxelnet import TINY as VOXEL_TINY
from test_torch_voxelnet import batch_of
from torch_lidar_common import check_step, jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

B, H, WID = 2, 64, 96
OUT_REL = 1e-4
TERM_RTOL = 1e-5
JIT_ATOL = 5e-7
TINY = dict(VOXEL_TINY, img_channels=16, fusion_mid=16)
CONFIG = 'configs/mvx_fasterrcnn_kitti.py'
CLI_TINY = ["model.point_cloud_range=(0,-8,-2,16,8,1.2)",
            'model.voxel_size=(0.4,0.4,0.4)', 'model.cv_channels=8',
            'model.bev_channels=16', 'model.img_channels=16',
            'model.fusion_mid=16',
            "model.anchor_ranges=((0,-8,-0.6,16,8,-0.6),(0,-8,-0.6,16,8,-0.6),"
            "(0,-8,-1.78,16,8,-1.78))", 'data.batch_size_per_chip=2']


def camera(h=H, w=WID):
    """lidar2img (4, 4) of a camera at the origin looking down x, f 30 px,
    the principal point at the image centre."""
    rot = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                    [0, 0, 0, 1]], np.float32)
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 30.0
    cam[0, 2], cam[1, 2] = w / 2.0, h / 2.0
    return cam @ rot


def mvx_batch(seed=0):
    b = batch_of(seed)
    rng = np.random.RandomState(seed + 1)
    b['img'] = rng.randn(B, H, WID, 3).astype(np.float32)
    b['lidar2img'] = np.tile(camera()[None], (B, 1, 1))
    return b


def test_bilinear_sample_matches_jax_edges_included():
    rng = np.random.RandomState(0)
    feat = rng.randn(7, 9, 5).astype(np.float32)
    edges = [[0, 0], [8, 6], [8, 0], [0, 6], [4, 0], [4, 6], [0, 3], [8, 3],
             [-1, -1], [-0.5, 3], [8.5, 6.5], [7.999, 5.999], [9, 7],
             [-1, 6], [8, -1], [3.5, -0.25], [-0.25, 2.5]]
    co = np.concatenate([rng.uniform(-2, 11, (383, 2)), edges]).astype(
        np.float32)
    got = bilinear_sample(t(feat), t(co)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_bilinear(feat, co)))
    np.testing.assert_allclose(got, np.asarray(jax.jit(j_bilinear)(
        feat, co)), atol=JIT_ATOL, rtol=0)
    assert (got[-4:-2] == 0).all() and (got[-3] == 0).all()


def test_point_fusion_sample_matches_jax():
    rng = np.random.RandomState(1)
    feat = rng.randn(16, 24, 6).astype(np.float32)
    pts = np.concatenate([rng.uniform((0.5, -8, -2), (16, 8, 2), (300, 3)),
                          rng.uniform((-5, -3, -1), (0.0, 3, 1), (40, 3))]
                         ).astype(np.float32)
    want, wvalid = jax.jit(lambda f, p, m: JX.point_fusion_sample(
        f, p, m, (H, WID)))(feat, pts, camera())
    got, valid = point_fusion_sample(t(feat), t(pts), t(camera()), (H, WID))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    assert 0.2 < valid.float().mean() < 0.9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope='module')
def models():
    jcfg, cfg = JX.MVXConfig(**TINY), MVXConfig(**TINY)
    b = mvx_batch()
    args = [b['points'], b['point_mask'], b['img'], b['lidar2img']]
    jm = JX.MVXFasterRCNN(cfg=jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *args)), 1)
    key_map = W.mvx_key_map(cfg)
    want, _ = jax_apply(jm, variables, args, False)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables, batch=b,
                key_map=key_map, want=want,
                sd=W.state_dict_from_jax(variables, key_map))


def test_key_map_and_forward_match_jax(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    port = MVXFasterRCNN(models['cfg'])
    port.load_state_dict(models['sd'], strict=True)
    pts, cond, _ = mvx_to_device(models['batch'], 'cpu')
    with torch.no_grad():
        got = port.eval()(pts, *cond)
    want = models['want']
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['fusion_valid'].numpy(),
                                  want['fusion_valid'])
    assert 0.2 < want['fusion_valid'].mean() < 0.9
    for k in ('cls_score', 'bbox_pred', 'dir_pred', 'bev_feat'):
        assert got[k].shape == want[k].shape, k
        assert rel(got[k].numpy(), want[k]) <= OUT_REL, k


def test_loss_and_predict_match_jax(models):
    out = {k: v for k, v in models['want'].items() if k != 'fusion_valid'}
    gt = {k: models['batch'][k] for k in ('gt_boxes', 'gt_labels',
                                          'gt_mask')}
    jterms = jax.jit(lambda o, b: JX.mvx_loss(o, b, models['jcfg']))(
        jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, gt))[1]
    _, terms = mvx_loss({k: t(v) for k, v in out.items()},
                        {k: t(v) for k, v in gt.items()}, models['cfg'])
    assert set(terms) == set(jterms)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]),
                                   rtol=TERM_RTOL, err_msg=k)
    live = dict(out, cls_score=out['cls_score'] + 2.0)
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JX.mvx_predict(
        o, models['jcfg']))(jax.tree.map(jnp.asarray, live)))
    got = mvx_predict({k: t(v) for k, v in live.items()}, models['cfg'])
    assert int(want['mask'].sum()) > 2
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)


def test_train_step_matches_jax(models):
    port = MVXFasterRCNN(models['cfg'])
    port.load_state_dict(models['sd'])
    b = models['batch']
    _, worst, whole = check_step(
        models['jm'], lambda o, bt: JX.mvx_loss(o, bt, models['jcfg']),
        models['variables'], models['key_map'], port,
        jax.tree.map(jnp.asarray, b),
        lambda bt: (bt['points'], bt['point_mask'], bt['img'],
                    bt['lidar2img']),
        mvx_to_device(b, 'cpu'),
        live=('img_backbone.conv1', 'img_neck.lateral0', 'fuse0', 'fuse1',
              'pts_encoder.enc0.conv', 'bbox_head'))
    print(f'port float32 step against JAX float32: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    want = get_adapter('MVXFasterRCNN').synthetic_batch(
        types.SimpleNamespace(cfg=JX.MVXConfig()), 2, 3)
    got = mvx_synth(MVXConfig(), 2, 3)
    assert set(got) == set(want) and got['img'].shape == (2, 64, 96, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_cli_synthetic_and_refusal(tmp_path, capsys):
    for kind in ('MVXFasterRCNN', 'DynamicMVXFasterRCNN'):
        assert test_cli.main([CONFIG, '--device', 'cpu', '--dtype',
                              'float32', '--synthetic', '--cfg-options',
                              f'model.type={kind}'] + CLI_TINY) == 0
        out = capsys.readouterr().out
        assert f'[synthetic-eval] {kind}: decoded 5 output arrays, ' \
            'finite=True' in out, out
    rc = train_cli.main([CONFIG, '--device', 'cpu', '--synthetic',
                         '--work-dir', str(tmp_path), '--max-steps', '1',
                         '--cfg-options'] + CLI_TINY)
    out = capsys.readouterr().out
    assert rc == 0 and 'loss_cls=' in out, out
    assert train_cli.main([CONFIG, '--device', 'cpu', '--work-dir',
                           str(tmp_path)]) == 2
    assert '--synthetic' in capsys.readouterr().err
