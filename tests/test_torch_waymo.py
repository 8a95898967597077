"""The port's Waymo data and evaluation against the JAX package, on the CPU.

* `waymo_proto`: the same bytes as the JAX codec, both ways;
* `waymo_let` equals JAX's `let_detection_metrics` (to 1e-12) on
  predictions whose scores float32 holds exactly (0.25, 0.5, 0.75), in
  memory and read back from .bin files;
* the one deliberate difference: the cases of the JAX package's
  `test_dataset_evaluate_end_to_end` and `test_gt_bin_from_infos`, through
  the .bin path, read 0.5 and 1.0 (JAX's rounded cutoffs drop a 0.9 read
  back as float32 0.8999999762);
* `gt_objects_from_infos` gives the JAX tool's objects;
* `assemble_multiview_sample` on a PNG tree against JAX's with cv2:
  views that halve exactly (Waymo's at 640x960) bit for bit, another
  scale within one 8-bit level (cv2's fixed-point weights), lidar2img
  (ego-motion rewrite of a previous frame included) to 1e-6;
* a perfect echo of the tree's objects scores LET-mAP 1 through
  `format_results`;
* the CLI `tools.test` on a MultiViewDfM config in a process with JAX and
  cv2 blocked.
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from dfm_tpu.data import waymo as JW
from dfm_tpu.evaluation import waymo_proto as JP
from dfm_tpu.evaluation.waymo_let import let_detection_metrics as j_let
from dfm_tpu_torch.data.waymo import WaymoDataset, assemble_multiview_sample
from dfm_tpu_torch.evaluation import waymo_eval as WE
from dfm_tpu_torch.evaluation import waymo_proto as WP
from dfm_tpu_torch.evaluation.waymo_let import let_detection_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _obj(mod, x, y, score, z=1.0, heading=0.2, cls=1, ctx='c', ts=1,
         gt=False):
    box = mod.Box(center_x=x, center_y=y, center_z=z, length=4.5, width=2.0,
                  height=1.6, heading=heading)
    if not gt:
        return mod.ObjectPred(box=box, type=cls, score=score,
                              context_name=ctx, frame_timestamp_micros=ts)
    return mod.ObjectPred(box=box, type=cls, score=0.5, context_name=ctx,
                          frame_timestamp_micros=ts,
                          num_lidar_points_in_box=50,
                          most_visible_camera_name='FRONT',
                          camera_synced_box=box)


def _scene(mod, seed=7):
    """Three frames of ten GT and noisy predictions of three classes,
    scores 0.25, 0.5 or 0.75, a few far-off false positives."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for f in range(3):
        ctx, ts = f'ctx{f}', 100 + f
        for i in range(10):
            c = rng.uniform([8, -25, 0], [70, 25, 2])
            h = float(rng.uniform(-np.pi, np.pi))
            cls = (1, 2, 4)[i % 3]
            gts.append(_obj(mod, c[0], c[1], 0.5, c[2], h, cls, ctx, ts,
                            gt=True))
            if rng.rand() > 0.3:
                u = c / np.linalg.norm(c)
                pc = c + u * rng.uniform(-1, 1) * np.linalg.norm(c) * 0.08 \
                    + rng.randn(3) * 0.04
                preds.append(_obj(mod, pc[0], pc[1],
                                  float(rng.choice([0.25, 0.5, 0.75])),
                                  pc[2], h + float(rng.randn() * 0.04), cls,
                                  ctx, ts))
        for _ in range(3):
            c = rng.uniform([8, -25, 0], [70, 25, 2])
            preds.append(_obj(mod, c[0] + 100, c[1], 0.25, cls=1, ctx=ctx,
                              ts=ts))
    return preds, gts


def test_proto_bytes_match_jax():
    ours = _scene(WP)
    theirs = _scene(JP)
    for a, b in zip(ours, theirs):
        data = WP.encode_objects(a)
        assert data == JP.encode_objects(b)
        back = WP.decode_objects(data)
        assert WP.encode_objects(back) == data
        assert [o.__dict__.keys() for o in back] == \
            [o.__dict__.keys() for o in JP.decode_objects(data)]
        assert all(o.box == WP.Box(**p.box.__dict__)
                   for o, p in zip(back, JP.decode_objects(data)))


def test_let_equals_jax_on_exact_scores(tmp_path):
    """In memory and read back from .bin files (where the JAX metric
    agrees: these scores are exact in float32)."""
    preds, gts = _scene(WP)
    want = j_let(*_scene(JP))
    got = let_detection_metrics(preds, gts)
    assert set(got) == set(want)
    assert any(0 < want[k] < 1 for k in want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    pred_bin, gt_bin = str(tmp_path / 'p.bin'), str(tmp_path / 'g.bin')
    WE.gt_annos_to_bin(gts, gt_bin)
    WE.gt_annos_to_bin(preds, pred_bin)
    got = WE.evaluate_waymo(pred_bin, gt_bin)
    assert got['_source'] == 'python_fallback'
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_dataset_evaluate_end_to_end(tmp_path):
    """The case of the JAX test of that name: a 0.9 prediction on frame A
    matches, a 0.4 one on frame B is 4 m too high. Through the .bin the
    port reads 0.5 (JAX reads 0.2375: its rounded cutoff 0.9 drops the
    decoded 0.8999999762)."""
    ds = WaymoDataset.__new__(WaymoDataset)
    ds.infos = [dict(context_name='ctxA', timestamp_micros=11),
                dict(context_name='ctxB', timestamp_micros=22)]
    gt_bin = str(tmp_path / 'gt.bin')
    WE.gt_annos_to_bin([_obj(WP, 30, 0, 0.5, ctx='ctxA', ts=11, gt=True),
                        _obj(WP, 25, 5, 0.5, ctx='ctxB', ts=22, gt=True)],
                       gt_bin)
    results = [
        dict(boxes_3d=np.array([[30, 0, 1 - 0.8, 4.5, 2.0, 1.6, 0.2]]),
             labels_3d=np.array([0]), scores_3d=np.array([0.9])),
        dict(boxes_3d=np.array([[25, 5, 5 - 0.8 + 4, 4.5, 2.0, 1.6, 0.2]]),
             labels_3d=np.array([0]), scores_3d=np.array([0.4])),
    ]
    ap = ds.evaluate(results, gt_bin, str(tmp_path))
    assert ap['_source'] == 'python_fallback'
    assert ap['Vehicle mAP'] == pytest.approx(0.5, abs=1e-9)
    assert ap['Vehicle mAPH'] == pytest.approx(0.5, abs=1e-9)


def test_gt_bin_from_infos(tmp_path):
    """The case of the JAX test of that name: the camera filter, the
    synced box, and a matching 0.9 prediction through the .bin reading
    1.0 (JAX reads 0.0). The objects equal the JAX tool's."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    try:
        import create_waymo_gt_bin as cgb
    finally:
        sys.path.remove(os.path.join(ROOT, 'tools'))
    infos = [dict(context_name='ctxA', timestamp_micros=5, annos=dict(
        gt_boxes_3d=np.array([[30, 0, 0.2, 4.5, 2.0, 1.6, 0.2],
                              [40, 5, 0.2, 4.5, 2.0, 1.6, 0.0]]),
        labels=np.array([0, 0]), camera_names=['FRONT', ''],
        num_lidar_points=np.array([10, 10])))]
    for cam_sync in (True, False):
        objs = WE.gt_objects_from_infos(infos, cam_sync=cam_sync)
        want = cgb.gt_objects_from_infos(infos, cam_sync=cam_sync)
        assert WP.encode_objects(objs) == JP.encode_objects(want)
    objs = WE.gt_objects_from_infos(infos, cam_sync=True)
    assert len(objs) == 1 and objs[0].box.center_z == pytest.approx(1.0)
    gt_bin, pred_bin = str(tmp_path / 'gt.bin'), str(tmp_path / 'p.bin')
    assert WE.gt_annos_to_bin(objs, gt_bin) == 1
    WE.gt_annos_to_bin([_obj(WP, 30, 0, 0.9, z=1.0, ctx='ctxA', ts=5)],
                       pred_bin)
    ap = WE.evaluate_waymo(pred_bin, gt_bin)
    assert ap['Vehicle mAP'] == pytest.approx(1.0, abs=1e-9)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """Five views at 1/20 of Waymo's sizes (96x64 and 96x44), two frames,
    the second frame's info with the first as its previous sweep."""
    root = str(tmp_path_factory.mktemp('waymo'))
    infos = chip_smoke.write_waymo_tree(root, scale=0.05)
    infos[1]['sweeps'] = [dict(images=infos[0]['images'],
                               ego2global=infos[0]['ego2global'])]
    return root, infos


@pytest.mark.parametrize('target_hw,num_frames', [((32, 48), 2),
                                                   ((40, 50), 1)])
def test_assemble_matches_jax_cv2(tree, target_hw, num_frames):
    pytest.importorskip('cv2')
    root, infos = tree
    got = assemble_multiview_sample(infos[1], root, num_frames, target_hw,
                                    5, max_gt=8)
    want = JW.assemble_multiview_sample(infos[1], root, num_frames,
                                        target_hw, 5, max_gt=8)
    assert got['imgs'].shape == (num_frames, 5) + target_hw + (3,)
    # one 8-bit level where the scale is not 1/2 (cv2's fixed point)
    atol = 1e-6 if target_hw == (32, 48) else 1.0 / 57.0
    np.testing.assert_allclose(got['imgs'], want['imgs'], atol=atol, rtol=0)
    np.testing.assert_allclose(got['lidar2img'], want['lidar2img'],
                               rtol=1e-6, atol=1e-6)
    for k in ('gt_boxes', 'gt_labels', 'gt_mask'):
        np.testing.assert_array_equal(got[k], want[k])
    if num_frames == 2:      # the ego-motion rewrite of the previous frame
        assert not np.allclose(got['lidar2img'][0], got['lidar2img'][1])


def test_dataset_echo_scores_one(tree, tmp_path):
    """The tree's own objects as predictions: every class at LET-mAP 1
    through format_results and the GT built from the infos (cam_sync)."""
    root, infos = tree
    ds = WaymoDataset(root, copy.deepcopy(infos), num_views=5,
                      target_hw=(32, 48), cam_sync=True)
    assert len(ds) == 2
    s = ds.get_sample(0)
    assert s['imgs'].shape == (1, 5, 32, 48, 3) and s['gt_mask'].sum() == 6
    gt_bin = str(tmp_path / 'gt.bin')
    assert WE.gt_annos_to_bin(WE.gt_objects_from_infos(ds.infos), gt_bin) \
        == 12
    results = [dict(boxes_3d=i['annos']['gt_boxes_3d'],
                    labels_3d=i['annos']['labels'],
                    scores_3d=np.full(6, 0.75)) for i in ds.infos]
    ap = ds.evaluate(results, gt_bin, str(tmp_path))
    for cls in ('Vehicle', 'Pedestrian', 'Cyclist', 'Overall'):
        assert ap[f'{cls} mAP'] == pytest.approx(1.0), cls
    # the camera modes are ported (tests/test_torch_waymo_cam.py); an
    # unknown mode is refused
    assert len(WaymoDataset(root, [], load_mode='cam_frame')) == 0
    with pytest.raises(ValueError, match='load_mode'):
        WaymoDataset(root, [], load_mode='cam')


def test_cli_without_jax(tree, tmp_path):
    """A fresh process with jax, flax, cv2 and the JAX package blocked:
    imports the new modules and runs `tools.test` on the tree at a tiny
    MultiViewDfM (ResNet-18, a checkpoint of the port's layout with its
    class bias raised) on the CPU, to the LET lines."""
    root, _ = tree
    ckpt = str(tmp_path / 'mv.pth')
    code = f"""
import sys
for name in ('jax', 'flax', 'cv2', 'dfm_tpu'):
    sys.modules[name] = None          # any import of them raises
import torch

torch.set_num_threads(1)    # from import on; the workers share the cores
torch.set_num_threads(1)
from dfm_tpu_torch.apis import init_mvdfm_model
from dfm_tpu_torch.models.builder import build_detector
from dfm_tpu_torch.runtime.config import load_config, merge_options
from dfm_tpu_torch.tools import test
import dfm_tpu_torch.ops.point_sample, dfm_tpu_torch.data.waymo
import dfm_tpu_torch.evaluation.waymo_eval
cfg = merge_options(load_config(sys.argv[1]), sys.argv[4:])
h = init_mvdfm_model(build_detector(cfg.model), torch.float32, 'cpu')
with torch.no_grad():
    h['model'].bbox_head_3d.conv_cls.bias.fill_(0.5)
torch.save(h['model'].state_dict(), sys.argv[2])
rc = test.main([sys.argv[1], '--device', 'cpu', '--checkpoint', sys.argv[2],
                '--out', sys.argv[3], '--cfg-options'] + sys.argv[4:])
assert rc == 0, rc
print('ok')
"""
    opts = [f'data.data_root={root}', 'data.target_hw=(32,48)',
            'data.cam_sync=True', 'model.backbone_depth=18',
            'model.feat_channels=16', 'model.voxel_grid=(4,24,30)',
            'model.max_num=20']
    res = subprocess.run(
        [sys.executable, '-c', code,
         'configs/multiview_dfm_r101_waymo_camsync.py', ckpt,
         str(tmp_path / 'dets.pkl')] + opts,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert out.strip().endswith('ok')
    assert '[metric] python_fallback' in out
    for cls in ('Vehicle', 'Pedestrian', 'Cyclist', 'Overall'):
        for m in ('mAP', 'mAPH', 'mAPL'):
            assert f'{cls} {m}: ' in out, (cls, m)
    with open(tmp_path / 'dets.pkl', 'rb') as f:
        dets = pickle.load(f)
    assert len(dets) == 2 and all(len(d['scores_3d']) == 20 for d in dets)
    assert all(np.isfinite(d['boxes_3d']).all() for d in dets)
