"""PGD-Waymo's per-camera modes and the mono demo in the port, against the
JAX package, on the CPU.

* `WaymoDataset(load_mode='cam_frame' | 'cam_mono')` on the synthetic
  Waymo tree of `chip_smoke.write_waymo_tree` (five views at 1/20 of
  Waymo's sizes; frame 0's views re-encoded as JPEG by `cv2.imencode`,
  frame 1's kept as PNG), with and without `cam_sync`: `len`, the
  (frame, camera) index and every sample key against JAX's: the GT
  boxes, labels and mask exactly, the images within 1e-6 on the
  normalised scale (`target_hw` half the views: the resize halves
  exactly);
* `merge_multi_view_boxes` on JAX's own case
  (`tests/test_waymo_data.py::test_merge_multi_view_boxes`) and on seeded
  cases of five cameras (overlapping duplicates, scores under the
  threshold, more boxes than `max_per_frame`): boxes, scores and labels
  exactly;
* JAX's `tools/test.py` route for PGD on a `WaymoDataset`
  (`waymo_real_eval`) raises in the ResNet's max pool on the (1, F, V,
  H, W, 3) stack, for both configs; the port's `tools.test` exits 2 and
  names the reason (ROADMAP.md §3), and decodes with `--synthetic`;
* the demo (`python -m dfm_tpu_torch.demo.mono_det_demo`) against JAX's
  `demo/mono_det_demo.py` on carried weights (a tiny FCOS3D, ResNet-18,
  width 32, float32 on both sides, class bias raised so that boxes are
  live) on a 96x160 JPEG: the same number of lines and classes, every
  printed number within one unit of its last printed digit; the PNG it
  writes reads back with the port's `read_png` as the input image
  outside the drawn pixels, and every drawn pixel lies within 1 px
  (8-neighbourhood) of a pixel `cv2.line` drew in JAX's output.
"""

import contextlib
import dataclasses
import io
import os
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.data import waymo as JW
from dfm_tpu_torch.data.png import read_png
from dfm_tpu_torch.data.waymo import WaymoDataset
from dfm_tpu_torch.demo import mono_det_demo as demo
from dfm_tpu_torch.models.heads.fcos_mono3d import FCOS3DConfig
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_multiview_dfm import flax_variables

torch.set_num_threads(1)    # from import on; the workers share the cores

cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic Waymo tree)

TARGET_HW = (32, 48)
CONFIGS = ('configs/pgd_r101_waymo_mono3d.py',
           'configs/pgd_r101_waymo_mv3d.py')
TINY_OPTS = ['model.backbone_depth=18', 'model.in_channels=32',
             'model.feat_channels=32', 'model.depth_branch=(16,)',
             'data.target_hw=(32,48)']
DEMO_HW = (96, 160)
DEMO_OPTS = dict(in_channels=32, feat_channels=32, nms_pre=100, max_num=12)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('waymo'))
    infos = chip_smoke.write_waymo_tree(root, scale=0.05)
    for view in infos[0]['images']:
        png = os.path.join(root, view['image_path'])
        jpg = png[:-4] + '.jpg'
        ok, buf = cv2.imencode('.jpg', cv2.imread(png),
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        with open(jpg, 'wb') as f:
            f.write(buf.tobytes())
        view['image_path'] = view['image_path'][:-4] + '.jpg'
    return root, infos


@pytest.mark.parametrize('cam_sync', [False, True])
@pytest.mark.parametrize('mode', ['cam_frame', 'cam_mono'])
def test_camera_samples_match_jax(tree, mode, cam_sync):
    root, infos = tree
    kw = dict(target_hw=TARGET_HW, num_views=5, max_gt=8, load_mode=mode,
              cam_sync=cam_sync)
    got = WaymoDataset(root, [dict(i) for i in infos], **kw)
    want = JW.WaymoDataset(root, [dict(i) for i in infos], **kw)
    assert len(got) == len(want) == len(infos) * (5 if mode == 'cam_frame'
                                                   else 1)
    assert got.cam_index == want.cam_index and got.num_views == 1
    seen = 0
    for i in range(len(got)):
        s, w = got.get_sample(i), want.get_sample(i)
        assert set(s) == set(w)
        assert s['imgs'].shape == (1, 1) + TARGET_HW + (3,)
        np.testing.assert_allclose(s['imgs'], w['imgs'], rtol=0, atol=1e-6)
        for k in ('lidar2img', 'gt_boxes', 'gt_labels', 'gt_mask'):
            assert s[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)
        seen += int(s['gt_mask'].sum())
    # the filter keeps some GT boxes and drops others
    assert 0 < seen < len(got) * int(
        np.asarray(infos[0]['annos']['labels']).size)


def test_lidar_frame_mode_unchanged_and_bad_mode(tree):
    root, infos = tree
    ds = WaymoDataset(root, [dict(i) for i in infos], target_hw=TARGET_HW)
    assert ds.cam_index is None and len(ds) == len(infos)
    assert ds.get_sample(0)['imgs'].shape == (1, 5) + TARGET_HW + (3,)
    with pytest.raises(ValueError, match='load_mode'):
        WaymoDataset(root, infos, load_mode='cam')


def merge_cases():
    cases = [[
        dict(boxes3d=np.array([[5.0, 0, 0, 4, 2, 1.6, 0.0]]),
             scores=np.array([0.9]), labels=np.array([0])),
        dict(boxes3d=np.array([[5.05, 0, 0, 4, 2, 1.6, 0.0],
                               [20.0, 5, 0, 4, 2, 1.6, 0.0]]),
             scores=np.array([0.8, 0.7]), labels=np.array([0, 0]))]]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        per_cam = []
        for _ in range(5):
            n = int(rng.integers(0, 40))
            base = np.concatenate([rng.uniform(-30, 30, (n, 3)),
                                   rng.uniform(0.5, 5, (n, 3)),
                                   rng.uniform(-np.pi, np.pi, (n, 1))], 1)
            dup = base[:n // 3] + rng.normal(0, 0.05, (n // 3, 7))
            boxes = np.concatenate([base, dup]).astype(np.float32)
            scores = rng.random(len(boxes)).astype(np.float32)
            scores[rng.random(len(boxes)) < 0.1] = 1e-4
            per_cam.append(dict(boxes3d=boxes, scores=scores,
                                labels=rng.integers(0, 3, len(boxes))))
        cases.append(per_cam)
    return cases


@pytest.mark.parametrize('case', range(4))
def test_merge_multi_view_boxes_matches_jax(tree, case):
    root, infos = tree
    per_cam = merge_cases()[case]
    kw = dict(nms_thr=0.05, max_per_frame=100) if case < 2 else \
        dict(nms_thr=0.3, max_per_frame=20)
    want = JW.WaymoDataset(root, list(infos), num_views=3,
                           target_hw=(256, 384)).merge_multi_view_boxes(
        per_cam, **kw)
    got = WaymoDataset(root, list(infos), num_views=3,
                       target_hw=(256, 384)).merge_multi_view_boxes(
        per_cam, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == 0:       # JAX's own test's expectations
        assert len(got['scores']) == 2
        assert abs(got['boxes3d'][1, 0] - 20.0) < 1e-4
    else:
        assert 0 < len(got['scores']) <= kw['max_per_frame']


@pytest.mark.parametrize('config', CONFIGS)
def test_pgd_waymo_route_fails_in_jax_and_port_refuses(tree, config,
                                                       capsys):
    import tools.test as jtest
    from dfm_tpu.models import build_detector as j_build
    from dfm_tpu.runtime.adapters import get_adapter
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    root, _ = tree
    opts = TINY_OPTS + [f'data.data_root={root}']
    cfg = j_merge_options(j_load_config(config), opts)
    handle = j_build(cfg.model.to_dict())
    args = types.SimpleNamespace(checkpoint=None, max_samples=None, out=None,
                                 waymo_gt_bin=None, fuse_conv_bn=False)
    with pytest.raises(ValueError), contextlib.redirect_stdout(io.StringIO()):
        jtest.waymo_real_eval(args, cfg, handle, get_adapter(handle.type))
    assert test_cli.main([config, '--device', 'cpu', '--cfg-options']
                         + opts) == 2
    err = capsys.readouterr().err
    assert 'WaymoDataset' in err and 'max pool' in err
    assert '--synthetic' in err
    assert test_cli.main([config, '--device', 'cpu', '--dtype', 'float32',
                          '--synthetic', '--cfg-options'] + opts) == 0
    assert 'finite=True' in capsys.readouterr().out


NUMBER = re.compile(r'-?\d+(?:\.(\d+))?')


def check_lines(got, want):
    """Line for line: the same words, every number within one unit of
    its last printed digit."""
    assert len(got) == len(want) and len(want) > 2
    for g, w in zip(got, want):
        assert NUMBER.sub('#', g) == NUMBER.sub('#', w), (g, w)
        for mg, mw in zip(NUMBER.finditer(g), NUMBER.finditer(w)):
            unit = 10.0 ** -len(mw.group(1) or '')
            assert abs(float(mg.group()) - float(mw.group())) <= unit * 1.01, \
                (g, w)


@pytest.fixture(scope='module')
def demo_runs(tmp_path_factory):
    """JAX's demo and the port's on one JPEG with the same weights."""
    import dfm_tpu.apis as japis
    from dfm_tpu.models import FCOS3DConfig as JFCOS3DConfig
    from dfm_tpu.models import FCOSMono3D as JFCOSMono3D
    sys.path.insert(0, os.path.join(ROOT, 'demo'))
    import mono_det_demo as jdemo
    tmp = tmp_path_factory.mktemp('demo')
    img = chip_smoke_scene(*DEMO_HW)
    image = str(tmp / 'scene.jpg')
    ok, buf = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, 92])
    with open(image, 'wb') as f:
        f.write(buf.tobytes())
    jcfg = JFCOS3DConfig(score_thr=0.1, **DEMO_OPTS)
    jm = JFCOSMono3D(cfg=jcfg, backbone_depth=18, dtype=jnp.float32)
    variables = flax_variables(jm, np.zeros((1,) + DEMO_HW + (3,),
                                            np.float32), seed=3)
    head = variables['params']['bbox_head']['conv_cls']
    head['bias'] = np.full_like(head['bias'], 0.5)
    real_init = japis.init_mono_model

    def tiny_init(cfg=None, backbone_depth=101, dtype=None):
        # JAX's demo builds FCOS3DConfig(score_thr) at ResNet-101 in bf16
        # and initialises it eagerly; here the tiny float32 model, its
        # init giving the seeded variables
        h = real_init(dataclasses.replace(cfg, **DEMO_OPTS), 18,
                      jnp.float32)
        return dict(h, model=types.SimpleNamespace(
            init=lambda *a, **k: variables))

    jout = str(tmp / 'jax_vis.png')
    japis.init_mono_model = tiny_init
    argv = sys.argv
    text = io.StringIO()
    try:
        sys.argv = ['mono_det_demo.py', image, '--fx', '150', '--out', jout]
        with contextlib.redirect_stdout(text):
            jdemo.main()
    finally:
        japis.init_mono_model = real_init
        sys.argv = argv
    pcfg = FCOS3DConfig(score_thr=0.1, **DEMO_OPTS)
    sd = W.state_dict_from_jax(variables, W.mono_key_map(pcfg, 18))
    ckpt = str(tmp / 'demo.pth')
    torch.save(sd, ckpt)
    pout = str(tmp / 'port_vis.png')
    real_port_init = demo.init_mono_model

    def tiny_port_init(cfg, device=None):
        # the port's demo builds the same ResNet-101 bf16 FCOS3D; here the
        # tiny float32 model the checkpoint was carried from
        return real_port_init(dataclasses.replace(cfg, **DEMO_OPTS), 18,
                              torch.float32, device)

    ptext = io.StringIO()
    demo.init_mono_model = tiny_port_init
    try:
        with contextlib.redirect_stdout(ptext):
            rc = demo.main([image, '--fx', '150', '--out', pout,
                            '--checkpoint', ckpt, '--device', 'cpu'])
    finally:
        demo.init_mono_model = real_port_init
    return dict(jax=text.getvalue(), port=ptext.getvalue(), rc=rc,
                image=cv2.imread(image), jax_png=cv2.imread(jout),
                port_png=pout)


def chip_smoke_scene(h, w):
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(xx / 17.0)[..., None] * 50 + np.cos(yy / 11.0)[..., None]
           * 40 + [100, 110, 120] + rng.normal(0, 8, (h, w, 3)))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_demo_lines_match_jax(demo_runs):
    assert demo_runs['rc'] == 0
    want = [ln for ln in demo_runs['jax'].splitlines()
            if not ln.startswith('wrote')]
    got = [ln for ln in demo_runs['port'].splitlines()
           if not ln.startswith('wrote')]
    assert re.match(r'\d+ detections', want[0]) and int(
        want[0].split()[0]) > 2
    check_lines(got, want)


def test_demo_png_drawn_within_1px_of_cv2(demo_runs):
    img, jax_png = demo_runs['image'], demo_runs['jax_png']
    got = read_png(demo_runs['port_png'])
    assert got.shape == img.shape and got.dtype == np.uint8
    green = np.all(got == demo.GREEN, -1) & ~np.all(img == demo.GREEN, -1)
    np.testing.assert_array_equal(got[~green], img[~green])
    assert green.sum() > 100
    cv_drawn = np.any(jax_png != img, -1)
    near = cv_drawn.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            near |= np.roll(np.roll(cv_drawn, dy, 0), dx, 1)
    assert near[green].all(), int((~near[green]).sum())


def test_draw_segments_clips():
    """Segments far outside the image are clipped, not rasterised over
    their whole extent; a point segment draws a disc of radius 1."""
    img = np.zeros((20, 30, 3), np.uint8)
    demo.draw_segments(img, [((-1e6, 5), (1e6, 5)), ((10, 15), (10, 15)),
                             ((-50, -50), (-10, -10))])
    row = np.all(img == demo.GREEN, -1)
    assert row[4:7].all() and row[5].all()
    assert row[14:17, 10].all() and row[15, 9:12].all()
    assert row.sum() == 3 * 30 + 5        # three rows and a 5-pixel disc
