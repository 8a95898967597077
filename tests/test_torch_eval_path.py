"""The port's KITTI evaluation path, whole, against the JAX package.

* Geometry under KITTI's own P2, whose fourth column is not zero, after
  the pipeline's bottom crop: the plane sweep's prev-frame points
  (`sweep_params` + `sweep_coords_plain`, what K1 computes) against
  `plane_sweep_grids` within 2e-3 px at the main-path shape, and the
  neck's `slab_uv` against JAX's within 1e-3 px.
* The whole slice at the tiny config of tests/test_torch_dfm.py in
  float32: the synthetic KITTI tree of chip_smoke.py (PNG files, two
  widths, two intrinsics, a frame paired with itself), cropped to
  192 x 384 (bottom, centre: the horizon and the objects in view) ->
  info pickle -> `KittiDataset(train=False)` ->
  `dataset_inference` of the JAX package (`init_dfm_model`, its fine
  depth volume built in float32 as the port builds it in an f32 model)
  and of the port, the same random weights (`state_dict_from_jax`), the
  classification bias raised on both sides so that NMS and the
  converter see live boxes. The annos agree in names and count exactly,
  boxes within 2e-3 (m, rad) and 0.05 px, scores within 1e-4 (f32 head
  outputs agree to 3e-4 at this config; measured on the CPU: boxes
  7.4e-5, 2D boxes 1.1e-3 px, scores 2.4e-7, 31 live annos), and they
  differ from frame to frame.
* The CLI, `python -m dfm_tpu_torch.tools.test`, on the CPU at the tiny
  config: from a config to AP lines, with a checkpoint; another model
  type, or no data, exits 2.
"""

import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.apis import dataset_inference as jax_dataset_inference
from dfm_tpu.apis import init_dfm_model as jax_init
from dfm_tpu.data.kitti import KittiDataset as JKittiDataset
from dfm_tpu.models import BatchMeta as JMeta
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.ops.cost_volume import plane_sweep_grids as jax_grids
from dfm_tpu_torch.apis import dataset_inference, init_dfm_model
from dfm_tpu_torch.data.calibration import Calibration
from dfm_tpu_torch.data.kitti import KittiDataset
from dfm_tpu_torch.models.detectors.dfm import DfMConfig
from dfm_tpu_torch.ops import cost_volume as CV
from dfm_tpu_torch.ops import frustum_separable as FS
from dfm_tpu_torch.tools import create_data
from dfm_tpu_torch.tools import test as cli
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic KITTI tree)

TINY = dict(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5), nms_pre=128,
            max_num=8)
CROP = (192, 384)
CLS_BIAS = 1.0


@pytest.mark.parametrize('which,hw', [(0, (375, 1242)), (1, (370, 1224))])
def test_geometry_with_kitti_p2_and_crop(which, hw):
    cfg = DfMConfig()
    calib = Calibration(np.asarray(chip_smoke.KITTI_P2[which]))
    ori = calib.cam2img
    off = (0, hw[0] - 320)                   # crop_frame's (x, y), 320 rows
    calib.offset(*off)
    aug = calib.cam2img
    assert ori[0, 3] != 0 and aug[1, 2] != ori[1, 2]
    c2p = np.eye(4, dtype=np.float32)
    c2p[2, 3] = chip_smoke.FORWARD_M
    depths = cfg.downsampled_depths()
    args = dict(org_w=np.float32(hw[1]), flip=np.float32(0),
                crop_offset=np.asarray(off, np.float32),
                scale_factor=np.float32(1))
    _, want = jax_grids(jnp.asarray(depths), jnp.asarray(ori),
                        jnp.asarray(c2p), (320, 1280), 4, 1,
                        **{k: jnp.asarray(v) for k, v in args.items()})
    t = lambda a: torch.as_tensor(np.asarray(a))[None]   # noqa: E731
    params = CV.sweep_params(t(ori), t(c2p), **{k: t(v) for k, v in
                                                args.items()})
    u, v = CV.sweep_coords_plain(params, torch.as_tensor(depths), 80, 320, 4)
    got = torch.stack([u[0], v[0]], -1).numpy()
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)

    coors = cfg.coordinates_3d()
    xs, ys, zs = coors[0, 0, :, 0], coors[0, :, 0, 1], coors[:, 0, 0, 2]
    gu, gv = FS.slab_uv(t(aug), xs, ys, zs)
    wu, wv = JFS.slab_uv(jnp.asarray(aug), xs, ys, zs)
    np.testing.assert_allclose(gu[0].numpy(), np.asarray(wu), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(gv[0].numpy(), np.asarray(wv), atol=1e-3,
                               rtol=0)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The synthetic KITTI tree and its val info pickle, written by the
    port's create_data."""
    root = str(tmp_path_factory.mktemp('kitti'))
    chip_smoke.write_kitti_tree(root)
    assert create_data.main(['kitti', '--root', root, '--splits', 'val']) \
        == 0
    return root, os.path.join(root, 'kitti_infos_val.pkl')


@pytest.fixture(scope='module')
def weights():
    """Seeded random JAX variables at the tiny config (from the model's
    shapes, no init compile), the classification bias raised."""
    model_shapes = jax.eval_shape(lambda: jax_init(
        JConfig(**TINY), dtype=jnp.float32)['model'].init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2) + CROP + (3,)),
            JMeta(ori_cam2img=jnp.eye(4)[None], cam2img=jnp.eye(4)[None],
                  cur2prev=jnp.eye(4)[None], org_w=jnp.ones(1),
                  flip=jnp.zeros(1), crop_offset=jnp.zeros((1, 2)),
                  scale_factor=jnp.ones(1)), train=False))
    variables = randomize(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), model_shapes), 3)
    variables['params']['bbox_head_3d']['conv_cls']['bias'] += CLS_BIAS
    return variables


def _annos_agree(got, want):
    assert len(got) == len(want)
    live = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert list(g['name']) == list(w['name'])
        live += len(w['name'])
        np.testing.assert_allclose(g['score'], w['score'], atol=1e-4, rtol=0)
        for k in ('location', 'dimensions', 'rotation_y', 'alpha'):
            np.testing.assert_allclose(g[k], w[k], atol=2e-3, rtol=0,
                                       err_msg=k)
        np.testing.assert_allclose(g['bbox'], w['bbox'], atol=0.05, rtol=0)
    return live


def test_dataset_inference_matches_jax(tree, weights):
    root, pkl = tree
    kw = dict(train=False, pipeline_kwargs=dict(crop_size=CROP))
    handle = jax_init(JConfig(**TINY), dtype=jnp.float32)
    orig = JFS.build_fine_softmax_volume

    def fine_f32(*a, **k):
        k['dtype'] = jnp.float32
        return orig(*a, **k)

    with mock.patch.object(JFS, 'build_fine_softmax_volume', fine_f32):
        want = jax_dataset_inference(handle, weights,
                                     JKittiDataset(root, pkl, **kw))
    port = init_dfm_model(DfMConfig(**TINY), dtype=torch.float32,
                          device='cpu')
    port['model'].load_state_dict(W.state_dict_from_jax(weights))
    got = dataset_inference(port, KittiDataset(root, pkl, **kw))
    assert len(got) == 4
    assert _annos_agree(got, want) >= 8
    assert not np.array_equal(want[0]['location'], want[1]['location'])


def test_cli_from_config_to_ap(tree, tmp_path, capsys):
    """The CLI on the CPU at the tiny config: seeded weights saved as an
    mmcv checkpoint with teacher keys, loaded, four frames, AP lines."""
    root, _ = tree
    model = init_dfm_model(DfMConfig(**TINY), dtype=torch.float32,
                           device='cpu')['model']
    ckpt = str(tmp_path / 'ref.pth')
    sd = dict(model.state_dict())
    sd['lidar_model.backbone.conv.weight'] = torch.zeros(2, 2)
    torch.save({'meta': {'epoch': 1}, 'state_dict': sd}, ckpt)
    opts = [f'data.data_root={root}', f'data.crop_size={CROP}'] + \
        [f'model.{k}={v!r}' for k, v in TINY.items()]
    out = str(tmp_path / 'annos.pkl')
    argv = [os.path.join(ROOT, 'configs', 'dfm_r34_kitti_3class.py'),
            '--device', 'cpu', '--checkpoint', ckpt, '--out', out,
            '--cfg-options'] + opts
    assert cli.main(argv) == 0
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith('Car_3d_')]
    assert len(lines) == 6 and '[4/4]' in text and '1 keys not taken' in text
    assert all(np.isfinite(float(ln.split(': ')[1])) for ln in lines)
    assert os.path.getsize(out) > 0
    assert cli.main(argv[:1] + ['--device', 'cpu', '--cfg-options',
                                'data.data_root=' + str(tmp_path)]) == 2


def test_cli_refuses_unported_model():
    res = subprocess.run(
        [sys.executable, '-m', 'dfm_tpu_torch.tools.test',
         os.path.join(ROOT, 'configs', 'centerpoint_second_waymo.py')],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 2 and 'not ported' in res.stderr
