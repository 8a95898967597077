"""The port's Waymo converter against the JAX package's, on the CPU.

Records written here (`chip_smoke.write_waymo_tfrecord`: three frames of
five cameras with the committed JPEG fixtures, seven labels; the
reference's mini TFRecord is absent):

* `parse_frame` gives JAX's dict, every key of it equal;
* the converter's calib P / Tr and text files equal JAX's, each camera's
  `lidar2img` is P @ Tr, and its boxes are JAX's `box3d` with width and
  length in the port's order (exact);
* the port's `WaymoDataset` assembles a sample from the converted tree,
  and `tools.test` on the MultiViewDfM camsync config reads it through to
  the 15 LET lines against the GT .bin of `create_waymo_gt_bin`;
* `results_to_bin` writes JAX's bytes;
* the GT .bin from the converted infos is JAX's `gt_objects_from_infos`
  of the same boxes, byte for byte, with and without cam_sync;
* the slice's modules import, and the converter runs, in a process
  where jax, flax, cv2 and the JAX package cannot be imported.
"""

import os
import pickle

import numpy as np
import pytest

import chip_smoke
from dfm_tpu.evaluation import waymo_eval as JWE
from dfm_tpu.evaluation.waymo_proto import encode_objects as j_encode
from dfm_tpu_torch.data.waymo import WaymoDataset
from dfm_tpu_torch.evaluation import waymo_eval as WE
from dfm_tpu_torch.tools import create_waymo_gt_bin
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools.data_converter import waymo_converter as C
from dfm_tpu_torch.tools.data_converter import waymo_raw as R
from tools.create_waymo_gt_bin import \
    gt_objects_from_infos as j_gt_objects_from_infos
from tools.data_converter import waymo_converter as JC
from tools.data_converter import waymo_raw as JR

FRAMES = 3


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp('waymo_raw')
    rec_dir = d / 'records'
    rec_dir.mkdir()
    rec = str(rec_dir / 'segment-0.tfrecord')
    chip_smoke.write_waymo_tfrecord(rec, FRAMES)
    out = str(d / 'port')
    assert C.main(['--tfrecord-dir', str(rec_dir), '--out', out]) == 0
    with open(os.path.join(out, 'waymo_infos_val.pkl'), 'rb') as f:
        infos = pickle.load(f)
    jout = str(d / 'jax')
    jinfos = JC.convert_segment(rec, jout, 0, prefix='1')
    return dict(rec=rec, out=out, infos=infos, jout=jout, jinfos=jinfos)


def _equal(a, b, what):
    if isinstance(b, dict):
        for k in b:
            _equal(a[k], b[k], f'{what}.{k}')
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f'{what}[{i}]')
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_parse_frame_matches_jax(tree):
    recs = list(R.read_tfrecord(tree['rec']))
    assert recs == list(JR.read_tfrecord(tree['rec'])) and \
        len(recs) == FRAMES
    for rec in recs:
        got, want = R.parse_frame(rec), JR.parse_frame(rec)
        assert set(got) == set(want)
        _equal(got, want, 'frame')           # JAX's keys of each label
        assert len(got['cameras']) == 5 and len(got['images']) == 5
        labels = got['labels']
        assert [lb['most_visible_camera'] for lb in labels[:3]] == \
            ['FRONT', 'FRONT', '']
        assert labels[0]['camera_synced_box']['center_x'] == \
            labels[0]['box']['center_x'] + 0.2
        assert labels[1]['camera_synced_box'] is None
        p, tr = R.camera_projection(got['cameras'][1])
        jp, jtr = JR.camera_projection(want['cameras'][1])
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(tr, jtr)


def test_calib_images_and_boxes_match_jax(tree):
    infos, jinfos = tree['infos'], tree['jinfos']
    assert len(infos) == len(jinfos) == FRAMES
    for info, jinfo in zip(infos, jinfos):
        name = info['token']
        assert name == jinfo['token']
        _equal(info['calib'], jinfo['calib'], 'calib')
        np.testing.assert_array_equal(info['pose'], jinfo['pose'])
        for sub in ('calib', 'pose'):
            with open(os.path.join(tree['out'], 'training', sub,
                                   name + '.txt')) as f, \
                    open(os.path.join(tree['jout'], 'training', sub,
                                      name + '.txt')) as g:
                assert f.read() == g.read(), sub
        for i, cam in enumerate(info['images']):
            p = np.eye(4)
            p[:3] = jinfo['calib'][f'P{i}']
            np.testing.assert_array_equal(cam['cam2img'], p)
            np.testing.assert_array_equal(
                cam['lidar2img'], p @ jinfo['calib'][f'Tr_velo_to_cam_{i}'])
            assert cam['image_path'] == jinfo['images'][i]
            with open(os.path.join(tree['out'], cam['image_path']),
                      'rb') as f, open(os.path.join(
                          tree['jout'], jinfo['images'][i]), 'rb') as g:
                assert f.read() == g.read()
        annos = info['annos']
        jboxes = np.asarray([a['box3d'] for a in jinfo['annos']], np.float32)
        # the port's (x, y, z, length, width, height, yaw): JAX's box3d
        # lists width first
        np.testing.assert_array_equal(annos['gt_boxes'][:, [0, 1, 2, 4, 3, 5,
                                                            6]], jboxes)
        assert list(annos['names']) == [a['name'] for a in jinfo['annos']]
        assert list(annos['num_lidar_points']) == \
            [a['num_points'] for a in jinfo['annos']]
        assert list(annos['labels']) == [0, 0, 0, 0, 1, 2, 0]
        # named in the record, then found by projection, then none
        assert annos['camera_names'] == ['FRONT', 'FRONT', 'FRONT_LEFT',
                                         'SIDE_LEFT', 'FRONT', 'FRONT', '']
        sync = info['cam_sync_annos']
        assert len(sync['gt_boxes']) == 6
        np.testing.assert_allclose(sync['gt_boxes'][0, 0],
                                   annos['gt_boxes'][0, 0] + 0.2, rtol=1e-6)
    assert 'sweeps' not in infos[0]
    assert infos[1]['sweeps'][0]['images'] == infos[0]['images']


def test_dataset_reads_converted_tree(tree):
    """Every view of every frame decoded (the JPEG reader) and scaled into
    the target, the gt the cam-synced set."""
    ds = WaymoDataset(tree['out'], os.path.join(tree['out'],
                                                'waymo_infos_val.pkl'),
                      num_frames=2, target_hw=(64, 96), cam_sync=True)
    assert len(ds) == FRAMES
    s = ds.get_sample(1)
    assert s['imgs'].shape == (2, 5, 64, 96, 3)
    assert np.isfinite(s['imgs']).all()
    assert (np.abs(s['imgs']).reshape(10, -1).max(1) > 0).all()
    assert int(s['gt_mask'].sum()) == 6
    np.testing.assert_array_equal(s['gt_boxes'][:6],
                                  ds.infos[1]['annos']['gt_boxes'])
    cam = ds.infos[1]['images'][0]
    scale = min(64 / cam['height'], 96 / cam['width'])
    np.testing.assert_allclose(
        s['lidar2img'][0, 0],
        np.diag([scale, scale, 1, 1]) @ cam['lidar2img'], rtol=1e-6)


def test_results_to_bin_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    results, frames = [], {}
    for i in range(3):
        n = 0 if i == 1 else 5
        results.append(dict(
            sample_idx=np.full(n, i),
            name=np.array(['Car', 'Pedestrian', 'Cyclist', 'Van',
                           'Car'][:n]),
            dimensions=rng.uniform(0.5, 5, (n, 3)),
            location=rng.uniform(-20, 40, (n, 3)),
            rotation_y=rng.uniform(-4, 4, n), score=rng.uniform(0, 1, n)))
        t = np.eye(4)
        t[:3, 3] = rng.uniform(-2, 2, 3)
        frames[str(i)] = dict(T_front_cam_to_vehicle=t,
                              context_name=f'ctx{i}',
                              timestamp_micros=1000 + i)
    got, want = str(tmp_path / 'p.bin'), str(tmp_path / 'j.bin')
    assert WE.results_to_bin(results, frames, got) == \
        JWE.results_to_bin(results, frames, want) == 8
    with open(got, 'rb') as f, open(want, 'rb') as g:
        assert f.read() == g.read()


@pytest.mark.parametrize('cam_sync', [True, False])
def test_gt_bin_matches_jax(tree, tmp_path, cam_sync, capsys):
    """`create_waymo_gt_bin --infos` on the converted infos: JAX's
    objects of the same boxes (under JAX's key 'gt_boxes_3d')."""
    info_path = os.path.join(tree['out'], 'waymo_infos_val.pkl')
    out = str(tmp_path / 'gt.bin')
    args = ['--infos', info_path, '--out', out]
    assert create_waymo_gt_bin.main(
        args + ([] if cam_sync else ['--no-cam-sync'])) == 0
    jinfos = [dict(info, annos=dict(info['annos'],
                                    gt_boxes_3d=info['annos']['gt_boxes']))
              for info in tree['infos']]
    for info in jinfos:
        del info['annos']['gt_boxes']
    want = j_encode(j_gt_objects_from_infos(jinfos, cam_sync=cam_sync))
    with open(out, 'rb') as f:
        assert f.read() == want
    n = 6 if cam_sync else 7
    assert f'wrote {n * FRAMES} GT objects' in capsys.readouterr().out


def test_tools_test_reads_converted_tree(tree, tmp_path, capsys):
    """MultiViewDfM camsync (tiny widths, float32, CPU) through `tools.test`
    on the converted tree against the converted GT .bin: 15 LET lines."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gt = str(tmp_path / 'gt.bin')
    create_waymo_gt_bin.main(['--infos', os.path.join(
        tree['out'], 'waymo_infos_val.pkl'), '--out', gt])
    try:
        rc = test_cli.main([
            'configs/multiview_dfm_r101_waymo_camsync.py', '--device', 'cpu',
            '--dtype', 'float32', '--waymo-gt-bin', gt, '--cfg-options',
            f'data.data_root={tree["out"]}', 'data.target_hw=(32,48)',
            'data.cam_sync=True', 'model.backbone_depth=18',
            'model.feat_channels=16', 'model.voxel_grid=(4,24,30)',
            'model.max_num=20'])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert rc == 0
    assert f'[{FRAMES}/{FRAMES}]' in out and '[metric] python_fallback' in out
    for cls in ('Vehicle', 'Pedestrian', 'Cyclist', 'Overall'):
        for m in ('mAP', 'mAPH', 'mAPL'):
            assert f'{cls} {m}: ' in out, (cls, m)


def test_new_modules_import_without_jax(tree, tmp_path):
    """A fresh process with jax, flax, cv2 and the JAX package blocked
    imports this slice's modules and converts the records again."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import sys
for name in ('jax', 'flax', 'cv2', 'dfm_tpu', 'tools'):
    sys.modules[name] = None          # any import of them raises
import dfm_tpu_torch.ops.frustum, dfm_tpu_torch.ops.sparse_conv
import dfm_tpu_torch.data.dbsampler, dfm_tpu_torch.apis
import dfm_tpu_torch.models.detectors.voxelnet
import dfm_tpu_torch.models.detectors.dynamic_voxelnet
import dfm_tpu_torch.models.detectors.dfm_with_teacher
import dfm_tpu_torch.models.heads.free_anchor3d
import dfm_tpu_torch.tools.create_waymo_gt_bin
import dfm_tpu_torch.tools.model_converters.convert_second_checkpoints
from dfm_tpu_torch.tools.data_converter import waymo_converter
assert waymo_converter.main(['--tfrecord-dir',
                             {os.path.dirname(tree['rec'])!r}, '--out',
                             {str(tmp_path)!r}]) == 0
print('ok')
"""
    res = subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('ok')
