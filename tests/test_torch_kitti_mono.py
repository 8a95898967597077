"""The port's KITTI mono data, COCO 2D mAP and the mono CLIs, on the CPU.

On the synthetic KITTI tree of `chip_smoke.write_kitti_tree` (four frames
of 375x1242 and 370x1224 PNGs):

* `mono_info_from_native` against JAX's (which reads an image's size with
  `cv2.imread`, the port from its PNG header), with and without a resize:
  the image path, P2 and the annotations exactly;
* `load_mono_image` (`read_png` + `resize_linear_cv2` + normalise)
  against JAX's (`cv2.imread` + `cv2.resize(INTER_LINEAR)` + normalise)
  at the configs' 384x1280 and unresized: within 1e-4 on the normalised
  scale (cv2's float32 taps summed in another order: a few ulp);
* `KittiMonoDataset` samples against JAX's, key for key, exactly;
* `coco_map_2d` against JAX's on seeded random detections (three
  classes, some images without a gt of a class): every entry within
  1e-12;
* the CLIs at a tiny width (ResNet-18, FPN 32, 96x320 images), float32
  on the CPU: `tools.test` of PGD with a live checkpoint to the 36 AP
  lines, the same with `--fuse-conv-bn` (20 BatchNorms folded; with
  `model.nms_thr=1.0` beside an unfused run with it, its detections
  matched one to one within chip_smoke's `_annos_match` tolerance,
  1e-4 x (1 + |value|) and the 2D boxes 0.12 px: NMS's IoU decisions
  could flip under the fold's float32 rounding on another CPU),
  `--synthetic` on both mono configs (finite; the other families' are in
  `test_torch_ported_configs.py`), `tools.train` of PGD for 2 steps, a
  resume to 3 (the optimizer's sha1), and `tools.test` on that checkpoint;
* `init_mono_model` + `inference_mono_3d` on a raw BGR image: the
  model's own decode of the normalised image, bit for bit; without a
  device the entry point refuses the CPU.
"""

import contextlib
import io
import os
import pickle
import re
import sys

import numpy as np
import pytest
import torch

from dfm_tpu.data import kitti_mono as J
from dfm_tpu_torch.data import kitti_mono as P
from dfm_tpu_torch.apis import init_mono_model, inference_mono_3d
from dfm_tpu_torch.data.kitti import build_kitti_infos
from dfm_tpu_torch.data.pipeline import normalize_image
from dfm_tpu_torch.data.png import read_png
from dfm_tpu_torch.models.detectors.fcos_mono3d import fcos_mono3d_predict
from dfm_tpu_torch.models.builder import build_detector, mono_model
from dfm_tpu_torch.runtime.checkpoint import CheckpointManager
from dfm_tpu_torch.runtime.config import load_config, merge_options
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils.weights import init_weights

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic KITTI tree, live weights)

IMG_HW = (384, 1280)
IMG_TOL = 1e-4          # normalised scale
MAP_TOL = 1e-12
PGD = os.path.join(ROOT, 'configs', 'pgd_r101_kitti_mono.py')
FCOS = os.path.join(ROOT, 'configs', 'fcos3d_r101_kitti_mono.py')
TINY_OPTS = ['model.backbone_depth=18', 'model.in_channels=32',
             'model.feat_channels=32', 'data.img_hw=(96,320)',
             'model.nms_pre=100', 'model.max_num=20']
PORTED_CONFIGS = ('fcos3d_r101_kitti_mono.py', 'pgd_r101_kitti_mono.py')


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    ids = chip_smoke.write_kitti_tree(root)
    infos = build_kitti_infos(root, ids)
    for split in ('train', 'val'):
        with open(os.path.join(root, f'kitti_infos_{split}.pkl'), 'wb') as f:
            pickle.dump(infos, f)
    return root, infos


def _equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _equal(got[k], want[k], f'{what}.{k}')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize('img_hw', [None, IMG_HW, (96, 320)])
def test_mono_info_from_native_matches_jax(tree, img_hw):
    pytest.importorskip('cv2')
    root, infos = tree
    for info in infos:
        _equal(P.mono_info_from_native(info, root, img_hw),
               J.mono_info_from_native(info, root, img_hw), 'info')
        # with the size in the info, neither reads the image
        shaped = dict(info, image=dict(info['image'],
                                       image_shape=(400, 1300)))
        _equal(P.mono_info_from_native(shaped, root, img_hw),
               J.mono_info_from_native(shaped, root, img_hw), 'shaped')


@pytest.mark.parametrize('img_hw', [None, IMG_HW])
def test_load_mono_image_matches_cv2(tree, img_hw):
    pytest.importorskip('cv2')
    root, infos = tree
    for info in infos[:2]:
        path = os.path.join(root, info['image']['image_path'])
        got, want = P.load_mono_image(path, img_hw), \
            J.load_mono_image(path, img_hw)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=IMG_TOL)


def test_dataset_samples_match_jax(tree):
    root, infos = tree
    mono = [P.mono_info_from_native(i, root, IMG_HW) for i in infos]
    got, want = P.KittiMonoDataset(mono, max_gt=8), \
        J.KittiMonoDataset(mono, max_gt=8)
    assert len(got) == len(want) == len(infos)
    for i in range(len(got)):
        s = got.get_sample(i)
        assert s['gt_mask'].sum() > 0
        _equal(s, want.get_sample(i), f'sample {i}')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_coco_map_2d_matches_jax(seed):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(5):
        g = rng.randint(0, 6)
        gb = rng.rand(g, 2) * 200
        gb = np.concatenate([gb, gb + 10 + rng.rand(g, 2) * 60], 1)
        gl = rng.randint(0, 3, g)
        n = rng.randint(0, 9)
        pick = rng.randint(0, max(g, 1), n)
        pb = gb[pick] + rng.randn(n, 4) * 6 if g else rng.rand(n, 4) * 200
        pb[:, 2:] = np.maximum(pb[:, 2:], pb[:, :2] + 1)
        pl = gl[pick] if g else rng.randint(0, 3, n)
        pl = np.where(rng.rand(n) < 0.2, (pl + 1) % 3, pl)
        preds.append(dict(bboxes=pb, scores=rng.rand(n), labels=pl))
        gts.append(dict(bboxes=gb, labels=gl))
    got, want = P.coco_map_2d(preds, gts, 3), J.coco_map_2d(preds, gts, 3)
    assert set(got) == set(want)
    assert want['mAP_50'] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MAP_TOL,
                                   err_msg=k)


def _main(cli, args):
    """(rc, stdout) of a CLI's main in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


@pytest.fixture(scope='module')
def clis(tree, tmp_path_factory):
    """The CLIs' runs on the tree: tools.test (live checkpoint, unfused
    and fused, --out), --synthetic on both mono configs, tools.train
    (2 steps, the resume to 3) and tools.test on its checkpoint."""
    root, _ = tree
    d = str(tmp_path_factory.mktemp('cli'))
    opts = ['--cfg-options', f'data.data_root={root}', *TINY_OPTS]
    cfg = merge_options(load_config(PGD), opts[1:])
    model = chip_smoke._live_weights(init_weights(mono_model(cfg.model)), 3,
                                     5.0)
    live = os.path.join(d, 'live.pth')
    torch.save(model.state_dict(), live)
    out = {}
    base = [PGD, '--device', 'cpu', '--dtype', 'float32', '--checkpoint',
            live]
    for name, extra in (('plain', []), ('fused', ['--fuse-conv-bn'])):
        pkl = os.path.join(d, f'{name}.pkl')
        rc, text = _main(test_cli, base + ['--out', pkl] + extra + opts +
                         list(chip_smoke.MONO_PAIR_OPTIONS))
        with open(pkl, 'rb') as f:
            out[name] = (rc, text, pickle.load(f))
    out['synthetic'] = {c: _main(test_cli, [
        os.path.join(ROOT, 'configs', c), '--device', 'cpu', '--dtype',
        'float32', '--synthetic']) for c in PORTED_CONFIGS}
    work = os.path.join(d, 'w')
    train = [PGD, '--device', 'cpu', '--work-dir', work] + opts
    out['train'] = _main(train_cli, train + ['--max-steps', '2'])
    ck = CheckpointManager(os.path.join(work, 'ckpts'))
    out['digest'] = train_cli.optimizer_digest(ck.load()['optimizer'])
    out['resume'] = _main(train_cli, train + ['--max-steps', '3',
                                              '--auto-resume'])
    out['steps'] = ck.latest_step()
    out['trained'] = _main(test_cli, [
        FCOS, '--device', 'cpu', '--dtype', 'float32', '--cfg-options',
        f'data.data_root={root}', *TINY_OPTS, 'model.type=PGD',
        '--checkpoint', ck.path(3)])
    return out


AP_LINE = re.compile(r'^(Car|Pedestrian|Cyclist)_\w+: (\S+)$', re.M)


def _ap_lines(text):
    aps = AP_LINE.findall(text)
    assert len(aps) == 36 and all(np.isfinite(float(v)) for _, v in aps), \
        text[-2000:]
    return aps


def test_tools_test_mono_to_ap(clis):
    rc, text, annos = clis['plain']
    assert rc == 0 and len(annos) == 4
    assert sum(len(a['name']) for a in annos) > 0
    _ap_lines(text)


def test_tools_test_fuse_conv_bn(clis):
    (rc, text, fused), (_, _, plain) = clis['fused'], clis['plain']
    assert rc == 0
    assert '[fuse] 20 BatchNorm(s) folded' in text
    _ap_lines(text)
    assert sum(len(a['name']) for a in fused) > 0
    for f, p in zip(fused, plain):
        chip_smoke._annos_match('fused', f, p)


@pytest.mark.parametrize('config', PORTED_CONFIGS)
def test_tools_test_synthetic(clis, config):
    rc, text = clis['synthetic'][config]
    assert rc == 0 and 'finite=True' in text, text


def test_tools_train_mono(clis):
    (rc, text), (rc2, text2) = clis['train'], clis['resume']
    assert rc == 0 and rc2 == 0
    for key in ('loss_kpts', 'loss_consistency', 'loss_depth_uncertain'):
        assert re.search(rf' {key}=[-0-9.]+ ', text), key
    assert f'resumed from step 2 (optimizer state sha1 {clis["digest"]})' \
        in text2 and 'step 3/3' in text2
    assert clis['steps'] == 3 and clis['trained'][0] == 0
    _ap_lines(clis['trained'][1])


def test_inference_mono_3d(tree):
    """`init_mono_model` + `inference_mono_3d` on a raw BGR image and its
    (3, 4) P2 give the model's own decode of the normalised image, bit
    for bit; without a device the entry point wants the card."""
    root, infos = tree
    cfg = build_detector(dict(type='PGD', in_channels=32, feat_channels=32,
                              depth_branch=(16,), max_num=20))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            init_mono_model(cfg, 18, torch.float32)
    handle = init_mono_model(cfg, 18, torch.float32, 'cpu')
    chip_smoke._live_weights(handle['model'], 2, 5.0)
    img = read_png(os.path.join(root, infos[0]['image']['image_path']))
    p2 = np.asarray(infos[0]['calib']['P2'], np.float32)[:3]
    got = inference_mono_3d(handle, img, p2)
    norm = torch.from_numpy(normalize_image(img.astype(np.float32)))[None]
    cam = torch.eye(4)[None]
    cam[0, :3] = torch.from_numpy(p2)
    with torch.no_grad():
        want = fcos_mono3d_predict(handle['model'](norm), img.shape[:2], cam,
                                   cfg)
    assert int(want['mask'].sum()) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
