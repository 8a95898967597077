"""The port's indoor data chain against the JAX package, on the CPU.

* `indoor_eval` (`depth_box3d_overlap`, `average_precision`, the greedy
  matching) on seeded random scenes (six-column ScanNet boxes and
  seven-column SUN RGB-D ones, some classes without a gt or without a
  detection, padded detections masked): every entry within 1e-6 of JAX's
  (measured 0: the same numpy);
* the converters on synthetic extracted trees (`chip_smoke.
  write_sunrgbd_tree` / `write_scannet_tree`: `scipy.io.savemat` depth,
  ScanNet's `.npy` files, the 12x20 baseline JPEG below as SUN RGB-D's
  image, one frame without one): `create_data sunrgbd|scannet` writes
  infos equal to JAX's `build_*_infos` key for key (arrays exactly), and
  the points bins JAX's builders write are the same bytes; the image
  shape read by the port's JPEG reader;
* `SUNRGBDDataset` / `ScanNetDataset` train samples (flips, rotation,
  scale, the point draw) and val samples (ScanNet's axis alignment) of
  the same seed against JAX's: bit for bit;
* the CLIs at a small size (VoteNet with 64 proposals on 2,000 points a
  scene, float32): `tools.test` on each tree prints finite mAP / mAR
  lines at 0.25 and 0.5 and writes `--out`, `tools.train` takes 2 steps
  on the ScanNet tree and resumes to 3 (the optimizer's sha1);
* JAX's `tools/test.py` indoor route (`indoor_real_eval`) on a ScanNet
  tree raises KeyError: it reads 'boxes3d' of `votenet_predict`'s output,
  which names it 'boxes_3d' (ROADMAP.md §3), where the port's `tools.test`
  prints the AP lines.
"""

import base64
import contextlib
import hashlib
import io
import os
import pickle
import re
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from dfm_tpu.data import indoor as JD
from dfm_tpu.data import indoor_converter as JC
from dfm_tpu.evaluation import indoor_eval as JE
from dfm_tpu_torch.data import indoor as PD
from dfm_tpu_torch.data.jpeg import read_jpeg
from dfm_tpu_torch.evaluation import indoor_eval as PE
from dfm_tpu_torch.runtime.checkpoint import CheckpointManager
from dfm_tpu_torch.tools import create_data
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic indoor trees)

EVAL_ATOL = 1e-6
CONFIGS = dict(scannet=os.path.join(ROOT, 'configs', 'votenet_scannet.py'),
               sunrgbd=os.path.join(ROOT, 'configs', 'votenet_sunrgbd.py'))
CLI_SMALL = ['data.num_points=2000', 'model.num_proposals=64',
             'data.batch_size_per_chip=2']
# a 12x20 baseline JPEG (quality 80, 4:2:0), SUN RGB-D's image
JPEG_12x20 = base64.b64decode(
    '/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQY'
    'GBcUFhYaHSUfGhsjHBYWICwgIyYnKSopGR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYa'
    'KCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCj/wAAR'
    'CAAMABQDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA'
    'AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK'
    'FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG'
    'h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl'
    '5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA'
    'AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk'
    'NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE'
    'hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk'
    '5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDx2z8IkH/VZwMcr39q3bLwmwK4jI/SvUbP'
    'TLXzVBTI5z784roLLTbbYflOQQM/l/jXl5VntRWPPwmZTPJl8KNtBDRoD2ZaK9zh0i0kUloz'
    'kHHX2or7WGfVOVHvQzKfKj//2Q==')


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """Both extracted trees, converted by the port's create_data."""
    base = tmp_path_factory.mktemp('indoor')
    out = {}
    for name, write in (('scannet', chip_smoke.write_scannet_tree),
                        ('sunrgbd', chip_smoke.write_sunrgbd_tree)):
        root = str(base / name)
        kw = dict(jpeg=JPEG_12x20) if name == 'sunrgbd' else {}
        write(root, seed=3, **kw)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert create_data.main([name, '--root', root, '--splits',
                                     'train', 'val']) == 0
        assert buf.getvalue().count('wrote 2 infos') == 2
        out[name] = root
    return out


def _infos(root, name, split):
    with open(os.path.join(root, f'{name}_infos_{split}.pkl'), 'rb') as f:
        return pickle.load(f)


def _equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f'{what}[{i}]')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want and type(got) is type(want), what


def _digests(root):
    out = {}
    for sub in ('points', 'instance_mask', 'semantic_mask'):
        d = os.path.join(root, sub)
        for f in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, f), 'rb') as fh:
                out[f'{sub}/{f}'] = hashlib.sha1(fh.read()).hexdigest()
    return out


@pytest.mark.parametrize('name', ['scannet', 'sunrgbd'])
def test_converter_infos_match_jax(trees, name, tmp_path):
    root = trees[name]
    copy = str(tmp_path / name)
    shutil.copytree(root, copy)
    build = getattr(JC, f'build_{name}_infos')
    for split in ('train', 'val'):
        _equal(_infos(root, name, split), build(copy, split),
               f'{name} {split}')
    assert _digests(copy) == _digests(root) and _digests(root)
    if name == 'sunrgbd':
        infos = _infos(root, name, 'train') + _infos(root, name, 'val')
        assert [i['image']['image_shape'] for i in infos] == \
            [(12, 20)] * 3 + [(0, 0)]
        assert read_jpeg(os.path.join(root, 'sunrgbd_trainval',
                                      'image', '000001.jpg')).shape == \
            (12, 20, 3)
        assert all(i['annos']['gt_num'] == 3 for i in infos)


@pytest.mark.parametrize('name', ['scannet', 'sunrgbd'])
def test_dataset_samples_match_jax(trees, name):
    root = trees[name]
    cls = dict(scannet='ScanNetDataset', sunrgbd='SUNRGBDDataset')[name]
    for split, train in (('train', True), ('val', False)):
        info = os.path.join(root, f'{name}_infos_{split}.pkl')
        kw = dict(train=train, num_points=1500, max_gt=6, seed=5)
        jds, pds = getattr(JD, cls)(root, info, **kw), \
            getattr(PD, cls)(root, info, **kw)
        for i in (0, 1, 0):              # a scene drawn again
            _equal(pds.get_sample(i), jds.get_sample(i), f'{name} {i}')
        _equal(pds.gt_annos(), jds.gt_annos(), f'{name} gt')
    assert pds.get_sample(0)['points'].shape == (1500, 4)


def _random_annos(seed, n_img=4, n_cls=5, six=False):
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for i in range(n_img):
        g = rng.randint(0, 6)
        ctr = rng.uniform(-3, 3, (g, 3))
        dims = rng.uniform(0.3, 2.0, (g, 3))
        yaw = np.zeros((g, 1)) if six else rng.uniform(-np.pi, np.pi, (g, 1))
        boxes = np.concatenate([ctr, dims] + ([] if six else [yaw]), 1)
        labels = rng.randint(0, n_cls - 1, g)       # the last class: no gt
        n = rng.randint(0, 12)
        pick = rng.randint(0, max(g, 1), n)
        jitter = rng.normal(0, 0.15, (n, 7))
        base = np.concatenate([ctr, dims, yaw], 1)[pick] if g else \
            rng.uniform(-3, 3, (n, 7))
        det = (base + jitter).astype(np.float32)
        det[:, 3:6] = np.abs(det[:, 3:6]) + 0.1
        dl = labels[pick] if g else rng.randint(0, n_cls, n)
        dl = np.where(rng.rand(n) < 0.2, rng.randint(0, n_cls, n), dl)
        mask = rng.rand(n) > 0.1
        gts.append(dict(gt_boxes=boxes.astype(np.float32), gt_labels=labels))
        dts.append(dict(boxes3d=det, scores=rng.rand(n).astype(np.float32),
                        labels=np.where(mask, dl, -1), mask=mask))
    return gts, dts


@pytest.mark.parametrize('six', [False, True])
def test_indoor_eval_matches_jax(six):
    gts, dts = _random_annos(7 + six, six=six)
    l2c = {i: f'c{i}' for i in range(5)}
    want = JE.indoor_eval(gts, dts, (0.25, 0.5), l2c)
    got = PE.indoor_eval(gts, dts, (0.25, 0.5), l2c)
    assert set(got) == set(want) and want['mAP_0.25'] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= EVAL_ATOL, k
    b1 = np.random.RandomState(1).uniform(0.2, 2, (6, 7))
    b2 = np.random.RandomState(2).uniform(0.2, 2, (5, 7))
    np.testing.assert_allclose(PE.depth_box3d_overlap(b1, b2),
                               JE.depth_box3d_overlap(b1, b2),
                               atol=EVAL_ATOL)


def _main(cli, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


AP_LINE = re.compile(r'^(mA[PR]_0\.(?:25|50)): (\S+)$', re.M)


@pytest.mark.parametrize('name', ['scannet', 'sunrgbd'])
def test_tools_test_votenet_to_indoor_ap(trees, name, tmp_path):
    out = str(tmp_path / 'dets.pkl')
    rc, text = _main(test_cli, [
        CONFIGS[name], '--device', 'cpu', '--dtype', 'float32', '--out',
        out, '--cfg-options', f'data.data_root={trees[name]}', *CLI_SMALL])
    assert rc == 0, text
    lines = dict(AP_LINE.findall(text))
    assert set(lines) == {'mAP_0.25', 'mAR_0.25', 'mAP_0.50', 'mAR_0.50'}, \
        text[-2000:]
    assert all(np.isfinite(float(v)) for v in lines.values())
    assert '[2/2] dets=64' in text
    with open(out, 'rb') as f:
        dets = pickle.load(f)
    assert len(dets) == 2 and dets[0]['boxes3d'].shape == (64, 7)


def test_tools_train_votenet_indoor_and_resume(trees, tmp_path):
    work = str(tmp_path / 'w')
    args = [CONFIGS['scannet'], '--device', 'cpu', '--work-dir', work,
            '--cfg-options', f'data.data_root={trees["scannet"]}',
            *CLI_SMALL]
    rc, text = _main(train_cli, args + ['--max-steps', '2'])
    assert rc == 0 and 'step 2/2' in text and 'loss_vote=' in text, text
    ck = CheckpointManager(os.path.join(work, 'ckpts'))
    digest = train_cli.optimizer_digest(ck.load()['optimizer'])
    rc, text = _main(train_cli, args + ['--max-steps', '3',
                                        '--auto-resume'])
    assert rc == 0 and f'resumed from step 2 (optimizer state sha1 ' \
        f'{digest})' in text and 'step 3/3' in text, text
    # without the infos the CLIs refuse, naming the file
    empty = ['--cfg-options', f'data.data_root={tmp_path}']
    assert train_cli.main([CONFIGS['sunrgbd'], '--device', 'cpu',
                           '--work-dir', work] + empty) == 2
    assert test_cli.main([CONFIGS['sunrgbd'], '--device', 'cpu'] +
                         empty) == 2


def test_jax_indoor_route_raises_key_error(tmp_path):
    """JAX's `indoor_real_eval` (tools/test.py:234-283) reads
    det0['boxes3d'] of `votenet_predict`'s output (votenet.py:185)."""
    import tools.test as jtest
    from dfm_tpu.data.indoor_converter import build_scannet_infos, \
        write_infos
    from dfm_tpu.models import build_detector as j_build
    from dfm_tpu.runtime.adapters import get_adapter
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    root = str(tmp_path)
    chip_smoke.write_scannet_tree(root, points=600)
    write_infos(build_scannet_infos(root, 'val'),
                os.path.join(root, 'scannet_infos_val.pkl'))
    cfg = j_merge_options(j_load_config(CONFIGS['scannet']), [
        f'data.data_root={root}', 'data.num_points=300',
        'model.num_proposals=16'])
    handle = j_build(cfg.model.to_dict())
    args = types.SimpleNamespace(checkpoint=None, max_samples=1, out=None,
                                 fuse_conv_bn=False)
    with pytest.raises(KeyError, match='boxes3d'), \
            contextlib.redirect_stdout(io.StringIO()):
        jtest.indoor_real_eval(args, cfg, handle, get_adapter(handle.type))
