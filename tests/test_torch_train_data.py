"""The training data path, checkpoints and the train CLI of the port.

* `resize_linear_cv2` and the float HSV conversions against cv2 (where
  cv2 is installed): at most 1e-3 on the 0-255 scale (cv2's float32
  INTER_LINEAR sums in another order: 4.5e-4 measured);
* `apply_photometric` and `KittiDataset(train=True).get_sample` against
  the JAX package for the same seed over three frames of a synthetic
  KITTI tree (flipped and not, rescaled, photometric distortion): the gt
  boxes, labels, masks, meta and depth maps exact, the images within
  1e-2 on the 0-255 scale (the resize's 4.5e-4 carried through
  brightness, contrast up to x1.5 twice, saturation and hue; 5.7e-3
  measured; the photometric step alone 2e-3), and the generator in the
  same state after
  every sample (the same draws in the same order);
* the object filters (truncated, ignored, range by corners) against
  JAX's, exactly;
* `CheckpointManager`: max_keep, latest_step, a bit-for-bit restore;
* the train CLI on the CPU at the tiny config: 2 steps, a checkpoint the
  evaluation's loader takes, a resume, and a type it does not train
  refused.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from dfm_tpu.data import pipeline as JP
from dfm_tpu.data.kitti import KittiDataset as JKittiDataset
from dfm_tpu.data.kitti import build_kitti_infos as j_build_infos
from dfm_tpu_torch.data import pipeline as PP
from dfm_tpu_torch.data.kitti import KittiDataset, build_kitti_infos
from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
from dfm_tpu_torch.runtime.checkpoint import CheckpointManager
from dfm_tpu_torch.runtime.train import make_optimizer
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils.weights import (init_weights,
                                         load_reference_checkpoint)

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CV2_TOL = 1e-3          # 0-255 scale
PHOTO_TOL = 2e-3        # 0-255 scale, the photometric step alone
IMG_TOL = 1e-2          # 0-255 scale, a whole augmented frame
TINY_OPTS = ['model.depth_num_bins=48', 'model.voxel_size=(3.6,3.8,0.5)',
             'data.crop_size=(128,256)', 'model.num_depth_sample_pixels=256']


@pytest.mark.parametrize('hw,new', [((37, 53), (55, 39)),
                                    ((37, 53), (50, 35)),
                                    ((64, 96), (101, 67)),
                                    ((40, 40), (40, 40))])
def test_resize_matches_cv2(hw, new):
    cv2 = pytest.importorskip('cv2')
    img = (np.random.default_rng(0).random(hw + (3,)) * 255).astype(
        np.float32)
    np.testing.assert_allclose(
        PP.resize_linear_cv2(img, *new),
        cv2.resize(img, new, interpolation=cv2.INTER_LINEAR), atol=CV2_TOL)


def test_hsv_round_trip_matches_cv2():
    cv2 = pytest.importorskip('cv2')
    rng = np.random.default_rng(1)
    x = rng.random((32, 32, 3)).astype(np.float32)
    x[0, 0] = 0.0                           # V = 0
    x[1, 1] = 0.5                           # max = min
    x[2, 2] = (1.0, 0.2, 0.2)               # each channel the max once
    x[3, 3] = (0.2, 1.0, 0.2)
    x[4, 4] = (0.2, 0.2, 1.0)
    hsv = PP.bgr_to_hsv(x)
    want = cv2.cvtColor(x, cv2.COLOR_BGR2HSV)
    np.testing.assert_allclose(hsv[..., 1:] * 255, want[..., 1:] * 255,
                               atol=CV2_TOL)
    np.testing.assert_allclose(hsv[..., 0], want[..., 0], atol=1e-3)
    hsv = want.copy()
    hsv[..., 0] = rng.random((32, 32)) * 360
    hsv[5, 5, 1] = 0.0                      # S = 0: grey
    np.testing.assert_allclose(
        PP.hsv_to_bgr(hsv) * 255,
        cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR) * 255, atol=CV2_TOL)


def test_photometric_matches_jax():
    pytest.importorskip('cv2')
    img = (np.random.default_rng(2).random((24, 40, 3)) * 255).astype(
        np.float32)
    for seed in range(8):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        got = PP.apply_photometric(img.copy(), r1)
        want = JP.apply_photometric(img.copy(), r2)
        np.testing.assert_allclose(got, want, atol=PHOTO_TOL)
        assert r1.random() == r2.random()


def test_object_filters_match_jax():
    """`truncated_object_filter`, `ignored_object_filter` and
    `object_range_filter_corner` against the JAX package's, exactly."""
    rng = np.random.default_rng(3)
    n = 12
    annos = dict(truncated=rng.random(n) * 1.2, labels=rng.integers(-1, 3, n),
                 names=np.array(['Car'] * n), bbox2d=rng.random((n, 4)),
                 plane=np.arange(4.0), score=np.float32(1.0))
    annos['truncated'][[1, 5]] = (0.98, 1.0)     # dropped
    annos['labels'][[2, 7]] = -1                 # dropped
    for pfn, jfn in ((PP.truncated_object_filter, JP.truncated_object_filter),
                     (PP.ignored_object_filter, JP.ignored_object_filter)):
        got, want = pfn(dict(annos)), jfn(dict(annos))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert len(got['labels']) < n
    boxes = np.concatenate([rng.uniform(-5, 65, (n, 1)),
                            rng.uniform(-35, 35, (n, 1)),
                            rng.uniform(-2, 0, (n, 1)),
                            rng.uniform(1, 4, (n, 3)),
                            rng.uniform(-7, 7, (n, 1))], 1).astype(np.float32)
    labels = rng.integers(0, 3, n)
    pcr = (2, -30.4, -3, 59.6, 30.4, 1)
    got = PP.object_range_filter_corner(boxes.copy(), labels.copy(), pcr)
    want = JP.object_range_filter_corner(boxes.copy(), labels.copy(), pcr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < len(got[1]) < n


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    ids = chip_smoke.write_kitti_tree(
        root, frames=chip_smoke.KITTI_FRAMES[:3])
    for split in ('train', 'val'):
        with open(os.path.join(root, f'kitti_infos_{split}.pkl'), 'wb') as f:
            pickle.dump(build_kitti_infos(root, ids), f)
    return root, ids


def test_train_get_sample_matches_jax(tree):
    pytest.importorskip('cv2')
    root, ids = tree
    kw = dict(crop_size=(320, 1280), scale_range=(0.95, 1.05),
              flip_ratio=0.5, max_gt=32)
    port = KittiDataset(root, build_kitti_infos(root, ids), train=True,
                        pipeline_kwargs=kw)
    jax_ds = JKittiDataset(root, j_build_infos(root, ids), train=True,
                           pipeline_kwargs=kw)
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    flips, scales = [], []
    for i in range(len(ids)):
        got, want = port.get_sample(i, r1), jax_ds.get_sample(i, r2)
        assert set(got) == set(want)
        for k in want:
            if k == 'img':
                continue
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        unnorm = lambda a: a * PP.IMG_STD + PP.IMG_MEAN   # noqa: E731
        np.testing.assert_allclose(unnorm(got['img']), unnorm(want['img']),
                                   atol=IMG_TOL)
        flips.append(float(want['flip']))
        scales.append(float(want['scale_factor']))
        assert r1.bit_generator.state == r2.bit_generator.state
    assert 0.0 in flips and 1.0 in flips, flips
    assert all(s != 1.0 for s in scales)


def test_checkpoint_manager(tmp_path):
    model = init_weights(DfM(DfMConfig(depth_num_bins=48,
                                       voxel_size=(3.6, 3.8, 0.5))))
    opt = make_optimizer(model)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=torch.Generator()
                             .manual_seed(p.numel()))
    opt.step()
    mgr = CheckpointManager(tmp_path / 'ck', max_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3):
        mgr.save(step, model, opt, {'step': step})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    fresh = init_weights(DfM(DfMConfig(depth_num_bins=48,
                                       voxel_size=(3.6, 3.8, 0.5))), 5)
    fresh_opt = make_optimizer(fresh)
    assert mgr.restore(fresh, fresh_opt) == 3
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert train_cli.optimizer_digest(opt.state_dict()) == \
        train_cli.optimizer_digest(fresh_opt.state_dict())
    # the evaluation's loader takes the file as it is
    rest = load_reference_checkpoint(fresh, mgr.path(3))
    assert rest == []


def test_train_cli_on_cpu(tree, tmp_path, capsys):
    """(In one torch thread: the tiny model's ops are too small to share
    out, and the suite runs several workers on the same cores.)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_cli_on_cpu(tree, tmp_path, capsys)
    finally:
        torch.set_num_threads(threads)


def _train_cli_on_cpu(tree, tmp_path, capsys):
    root, _ = tree
    cfg = os.path.join(ROOT, 'configs', 'dfm_r34_kitti_3class.py')
    work = str(tmp_path / 'w')
    args = [cfg, '--cfg-options', 'model.type=DfM', f'data.data_root={root}',
            *TINY_OPTS, '--work-dir', work, '--device', 'cpu',
            '--eval-samples', '1']
    assert train_cli.main(args + ['--max-steps', '2']) == 0
    with open(os.path.join(work, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs] == [1, 2]
    for key in ('loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
                'loss_dense_depth', 'grad_norm'):
        assert all(np.isfinite(r[f'train/{key}']) for r in recs), key
    ck = CheckpointManager(os.path.join(work, 'ckpts'))
    assert ck.latest_step() == 2
    digest = train_cli.optimizer_digest(ck.load()['optimizer'])
    assert train_cli.main(args + ['--max-steps', '3', '--auto-resume']) == 0
    out = capsys.readouterr().out
    assert f'resumed from step 2 (optimizer state sha1 {digest})' in out
    assert 'step 3/3' in out and ck.latest_step() == 3
    # a type the port does not train (DfMFull trains:
    # tests/test_torch_dfm_full_train.py)
    assert train_cli.main([cfg, '--cfg-options', 'model.type=EncoderDecoder3D',
                           f'data.data_root={root}', '--device', 'cpu']) == 2
    assert 'not ported yet' in capsys.readouterr().err


def test_train_cli_trains_on_jax_draws_2_and_3(tree, tmp_path, monkeypatch):
    """With one seed, the port's train CLI trains its steps 1 and 2 on the
    batches of JAX's `KittiDfMSource` draws 2 and 3 (draw 1 is the batch
    JAX's CLI initialises the model on, `tools/train.py:514-517`): images
    within IMG_TOL on the 0-255 scale, meta and targets exact, at the tiny
    config's crop. The training step is replaced by a recorder."""
    pytest.importorskip('cv2')
    from dfm_tpu.models import BatchMeta as JBatchMeta
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    from tools.train import KittiDfMSource as JKittiDfMSource
    from dfm_tpu_torch.data.collate import GT_KEYS, META_KEYS
    root, _ = tree
    seen = []

    class Recorder:
        def __init__(self, *args, **kw):
            pass

        def __call__(self, img, meta, gt, generator, depth_pix_idx=None):
            seen.append((img, meta, gt))
            return {'loss': torch.tensor(0.0)}

    monkeypatch.setattr(train_cli, 'TrainStep', Recorder)
    cfg = os.path.join(ROOT, 'configs', 'dfm_r34_kitti_3class.py')
    opts = ['model.type=DfM', f'data.data_root={root}', *TINY_OPTS]
    assert train_cli.main([cfg, '--cfg-options', *opts, '--work-dir',
                           str(tmp_path / 'w'), '--device', 'cpu',
                           '--max-steps', '2', '--seed', '3']) == 0
    assert len(seen) == 2
    jcfg = j_merge_options(j_load_config(cfg), opts)
    source = JKittiDfMSource(jcfg, jcfg.data.get('batch_size_per_chip', 1))
    rng = np.random.default_rng(3)
    draws = [source.next_batch(step, rng) for step in range(3)]
    assert issubclass(type(draws[0]['meta']), JBatchMeta)
    unnorm = lambda a: a * PP.IMG_STD + PP.IMG_MEAN   # noqa: E731
    for (img, meta, gt), want in zip(seen, draws[1:]):
        np.testing.assert_allclose(unnorm(img.numpy()),
                                   unnorm(np.asarray(want['img'])),
                                   atol=IMG_TOL)
        for k in META_KEYS:
            np.testing.assert_array_equal(getattr(meta, k).numpy(),
                                          np.asarray(getattr(want['meta'],
                                                             k)), err_msg=k)
        for k in GT_KEYS:
            np.testing.assert_array_equal(gt[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    # the draws differ: the test would see a shift of one
    assert not np.array_equal(np.asarray(draws[1]['img']),
                              np.asarray(draws[2]['img']))
