"""The port's evaluation half, config loader, builder and checkpoint
loader against the JAX package.

* `detections_to_kitti_annos` on seeded random detections, exactly; the
  `kitti_eval` AP dict on seeded random annos (DontCare, Van and
  Person_sitting rows, all three difficulties) key for key within 1e-6;
  the GT-echo oracle (the labels' own boxes as detections) on the
  synthetic KITTI tree, Car's 3d easy AP above 99.
* `load_config` / `merge_options` on the repo's DfM configs (with a
  `_base_` chain two deep) give the JAX loader's dict; `build_detector`
  gives the `DfMConfig` JAX builds, field for field, and ignores only
  the training keys.
* `load_reference_state_dict` against `import_dfm_state_dict`: one
  synthetic reference-layout state dict at the tiny config, with the
  teacher, ATSS and `num_batches_tracked` keys a DfMFull checkpoint
  holds, loaded into the port and imported into JAX variables carried
  back by `state_dict_from_jax`, gives the same tensors exactly; a
  missing key and a wrong shape raise.
* `cached_wgmma_weight` (the conv kernels' weight layouts) keeps no
  weight alive, and `conv3d_zpack`'s per-call weight adds no entry.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.evaluation import detections_to_kitti_annos as jax_annos
from dfm_tpu.evaluation import kitti_eval as jax_kitti_eval
from dfm_tpu.models import BatchMeta as JMeta
from dfm_tpu.models import DfM as JDfM
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models import build_detector as jax_build
from dfm_tpu.runtime import config as JC
from dfm_tpu.utils.checkpoint_import import (dfm_key_map as jax_key_map,
                                             expected_torch_shapes,
                                             import_dfm_state_dict)
from dfm_tpu_torch.data.kitti import build_kitti_infos
from dfm_tpu_torch.evaluation.kitti_eval import kitti_eval
from dfm_tpu_torch.evaluation.results import detections_to_kitti_annos
from dfm_tpu_torch.models import builder as B
from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
from dfm_tpu_torch.ops import convgn as CG
from dfm_tpu_torch.ops.cuda import conv3d as KC3
from dfm_tpu_torch.ops.cuda import conv_chain as KC
from dfm_tpu_torch.runtime import config as PC
from dfm_tpu_torch.utils import weights as W

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic KITTI tree)

P2 = np.asarray(chip_smoke.KITTI_P2[0])
DFM_CONFIGS = ['dfm_r34_kitti_3class.py', 'dfm_r34_kitti_3class_wophotodist.py',
               'dfm_r34_kitti_3class_wophotodist_wodistnorm.py',
               'dfm_r18_mini_overfit.py']
TINY = dict(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5), nms_pre=128,
            max_num=8)
# the keys of the DfM configs that the builder ignores: the type and
# DfMFull's ATSS head and teacher checkpoint (the training fields are
# fields of the port's DfMConfig, as of the JAX package's)
IGNORED_KEYS = {'type', 'atss', 'teacher_checkpoint'}


def _detections(rng, m=40):
    """Padded pseudo-lidar detections of 3 classes, most in view."""
    boxes = np.stack([rng.uniform(3, 50, m), rng.uniform(-15, 15, m),
                      rng.uniform(-2, 0, m), rng.uniform(0.5, 5, m),
                      rng.uniform(0.4, 2, m), rng.uniform(1, 2, m),
                      rng.uniform(-np.pi, np.pi, m)], 1).astype(np.float32)
    return dict(boxes3d=boxes, scores=rng.uniform(0, 1, m).astype(np.float32),
                labels=rng.integers(0, 3, m), mask=rng.uniform(0, 1, m) < 0.8)


@pytest.mark.parametrize('seed', [0, 1])
def test_detections_to_kitti_annos_matches_jax(seed):
    det = _detections(np.random.default_rng(seed))
    for shape, least in (((375, 1242), 6), ((111, 370), 1)):
        got = detections_to_kitti_annos(det, P2, shape)
        want = jax_annos(det, P2, shape)
        assert sorted(got) == sorted(want)
        assert least <= len(got['name']) < 40
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    empty = dict(det, mask=np.zeros(40, bool))
    assert len(detections_to_kitti_annos(empty, P2, (375, 1242))['name']) == 0


NAMES = ('Car', 'Pedestrian', 'Cyclist', 'Van', 'Person_sitting',
         'DontCare')
DIMS = {'Car': (3.9, 1.5, 1.6), 'Van': (4.8, 2.1, 1.9),
        'Pedestrian': (0.8, 1.75, 0.6), 'Person_sitting': (0.8, 1.2, 0.6),
        'Cyclist': (1.8, 1.7, 0.6), 'DontCare': (1, 1, 1)}


def _random_annos(rng, frames=6):
    """Seeded GT and detection annos: GT of every kind with the three
    difficulties' truncation / occlusion / height spread, detections as
    jittered GT (some off by a class) plus false positives."""
    gts, dts = [], []
    for _ in range(frames):
        n = rng.integers(4, 9)
        names = rng.choice(NAMES, n)
        loc = np.stack([rng.uniform(-8, 8, n), rng.uniform(1.4, 1.8, n),
                        rng.uniform(6, 45, n)], 1)
        dims = np.array([DIMS[x] for x in names]) * rng.uniform(0.9, 1.1,
                                                              (n, 1))
        ry = rng.uniform(-np.pi, np.pi, n)
        top = rng.uniform(100, 200, n)
        bbox = np.stack([rng.uniform(0, 1000, n), top, np.zeros(n),
                         top + rng.choice([20, 30, 60, 120], n)], 1)
        bbox[:, 2] = bbox[:, 0] + rng.uniform(20, 150, n)
        gt = dict(name=names, truncated=rng.choice([0, 0.2, 0.4, 0.6], n),
                  occluded=rng.integers(0, 4, n),
                  alpha=ry - np.arctan2(loc[:, 0], loc[:, 2]), bbox=bbox,
                  dimensions=dims, location=loc, rotation_y=ry)
        keep = np.flatnonzero(names != 'DontCare')
        take = keep[rng.uniform(0, 1, len(keep)) < 0.8]
        k = len(take) + 2
        dnames = np.concatenate([
            np.where(np.isin(names[take], ('Van', 'Person_sitting')),
                     'Car', names[take]),
            rng.choice(NAMES[:3], 2)])
        swap = rng.uniform(0, 1, k) < 0.1
        dnames[swap] = rng.choice(NAMES[:3], swap.sum())
        jit = lambda a, s: a + rng.normal(0, s, a.shape)  # noqa: E731
        dloc = np.concatenate([jit(loc[take], 0.3),
                               loc[rng.integers(0, n, 2)] + 3])
        ddims = np.concatenate([jit(dims[take], 0.1), dims[:1].repeat(2, 0)])
        dry = np.concatenate([jit(ry[take], 0.1), rng.uniform(-3, 3, 2)])
        dbox = np.concatenate([jit(bbox[take], 4), bbox[:1].repeat(2, 0)])
        dts.append(dict(name=dnames, truncated=np.zeros(k),
                        occluded=np.zeros(k, np.int64),
                        alpha=dry - np.arctan2(dloc[:, 0], dloc[:, 2]),
                        bbox=dbox, dimensions=ddims, location=dloc,
                        rotation_y=dry, score=rng.uniform(0.05, 1, k)))
        gts.append(gt)
    return gts, dts


@pytest.mark.parametrize('seed', [0, 1])
def test_kitti_eval_matches_jax(seed):
    gts, dts = _random_annos(np.random.default_rng(seed))
    got = kitti_eval(gts, dts)
    want = jax_kitti_eval(gts, dts)
    assert sorted(got) == sorted(want) and len(got) == 3 * 3 * 3 * 2 + 18
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0 < np.mean(list(got.values())) < 100


def test_gt_echo_ap_above_99(tmp_path):
    """The tree's own GT boxes (pseudo-lidar) through the converter and
    the evaluator: Car's 3d easy AP above 99 (44 cars; the 40-point AP
    of n < 41 perfect matches is (n - 1) / 40, as the other classes'
    show)."""
    ids = chip_smoke.write_kitti_tree(str(tmp_path))
    infos = build_kitti_infos(str(tmp_path), ids)
    dts = []
    for info in infos:
        a = info['annos']
        det = dict(boxes3d=a['gt_boxes_pl'],
                   scores=np.full(len(a['labels']), 0.9, np.float32),
                   labels=a['labels'], mask=np.ones(len(a['labels']), bool))
        dts.append(detections_to_kitti_annos(
            det, np.asarray(info['calib']['P2'])[:3], (375, 1242)))
    res = kitti_eval([dict(i['annos_eval']) for i in infos], dts)
    assert res['Car_3d_easy_strict'] > 99, res
    assert res['Pedestrian_3d_easy_strict'] == pytest.approx(7 / 40 * 100)
    assert res['Cyclist_3d_easy_strict'] == pytest.approx(7 / 40 * 100)


@pytest.mark.parametrize('name', DFM_CONFIGS)
def test_config_and_builder_match_jax(name):
    path = os.path.join(ROOT, 'configs', name)
    opts = ['model.score_thr=0.2', 'data.crop_size=(64, 128)',
            'model.anchor_rotations=[0.0, 1.57]', 'data.new.key=abc']
    got, want = PC.load_config(path), JC.load_config(path)
    assert got.to_dict() == want.to_dict()
    got, want = PC.merge_options(got, opts), JC.merge_options(want, opts)
    assert got.to_dict() == want.to_dict()
    cfg = B.build_detector(got.model)
    jcfg = jax_build(want.model.to_dict()).cfg
    for f in cfg.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.score_thr == 0.2 and cfg.anchor_rotations == (0.0, 1.57)
    assert set(B.unused_keys(got.model)) <= IGNORED_KEYS
    assert set(JConfig.__dataclass_fields__) == set(
        DfMConfig.__dataclass_fields__)


def test_builder_refuses_unported_types():
    with pytest.raises(NotImplementedError, match='not ported'):
        B.build_detector(dict(type='EncoderDecoder3D'))


@pytest.mark.parametrize('blocks', [(3, 4, 6, 3), (2, 2, 2, 2)])
def test_key_maps_agree(blocks):
    """The port's dfm_key_map(stage_blocks) and the JAX
    dfm_key_map(num_hg, head_num_convs, num_3dconvs, stage_blocks, ...)
    at their defaults: the same entries."""
    assert W.dfm_key_map(blocks) == jax_key_map(stage_blocks=blocks)


@pytest.fixture(scope='module')
def reference_sd():
    """A reference-layout state dict at the tiny config (seeded numpy),
    the keys of a DfMFull checkpoint the port does not take, and the
    flax template (zeros, from the model's shapes) it imports into."""
    model = JDfM(cfg=JConfig(**TINY))
    meta = JMeta(ori_cam2img=jnp.eye(4)[None], cam2img=jnp.eye(4)[None],
                 cur2prev=jnp.eye(4)[None], org_w=jnp.ones(1),
                 flip=jnp.zeros(1), crop_offset=jnp.zeros((1, 2)),
                 scale_factor=jnp.ones(1))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 128, 3)), meta,
        train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rng = np.random.default_rng(0)
    sd = {k: rng.normal(0, 0.3, s).astype(np.float32)
          for k, s in expected_torch_shapes(template).items()}
    extra = {'lidar_model.backbone.compress_conv.conv.weight':
             rng.normal(size=(8, 4, 3, 3)).astype(np.float32),
             'bbox_head_2d.atss_cls.weight':
             rng.normal(size=(3, 64, 3, 3)).astype(np.float32),
             'backbone.bn1.num_batches_tracked': np.asarray(7)}
    sd = {k: torch.from_numpy(v) for k, v in {**sd, **extra}.items()}
    return sd, sorted(extra), template


def test_load_reference_state_dict_matches_importer(reference_sd):
    sd, extra, template = reference_sd
    port = DfM(DfMConfig(**TINY))
    rest = W.load_reference_state_dict(port, {'meta': {'epoch': 60},
                                              'state_dict': sd})
    assert rest == extra
    want = W.state_dict_from_jax(import_dfm_state_dict(sd, template))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    bare = DfM(DfMConfig(**TINY))
    assert W.load_reference_state_dict(bare, sd) == extra
    assert all(torch.equal(t, got[k]) for k, t in bare.state_dict().items())


def test_load_reference_state_dict_raises(reference_sd):
    sd, _, _ = reference_sd
    port = DfM(DfMConfig(**TINY))
    gone = 'neck.rpnconv.1.gn.bias'
    with pytest.raises(KeyError, match=gone):
        W.load_reference_state_dict(
            port, {k: v for k, v in sd.items() if k != gone})
    key = 'bbox_head_3d.conv_cls.weight'
    bad = dict(sd, **{key: torch.zeros(5, 64, 1, 1)})
    with pytest.raises(ValueError, match='shape mismatch at ' + key):
        W.load_reference_state_dict(port, bad)


def test_load_reference_checkpoint_file(reference_sd, tmp_path):
    """An mmcv checkpoint of plain types loads with weights_only=True;
    one whose meta holds another object is refused, not unpickled."""
    sd, extra, _ = reference_sd
    path = str(tmp_path / 'ref.pth')
    torch.save({'meta': {'epoch': 60, 'CLASSES': ('Car', 'Pedestrian',
                                                  'Cyclist')},
                'state_dict': sd, 'optimizer': {}}, path)
    assert W.load_reference_checkpoint(DfM(DfMConfig(**TINY)), path) == extra
    torch.save({'meta': {'config': argparse.Namespace(a=1)},
                'state_dict': sd}, path)
    with pytest.raises(RuntimeError, match='weights_only'):
        W.load_reference_checkpoint(DfM(DfMConfig(**TINY)), path)


def test_wgmma_weight_table_keeps_no_dead_weight():
    """Entries live as long as their weight: a parameter's views share one
    layout, an in-place update lays it out anew, weights made for one
    call leave nothing behind, and `conv3d_zpack`'s per-call taps
    (`cache=False`) add no entry."""
    table = KC._WGMMA_WEIGHTS
    before = len(table)
    p = torch.nn.Parameter(torch.randn(64, 32, 3, 3, 3))
    a = KC.cached_wgmma_weight(p[:32])
    assert KC.cached_wgmma_weight(p[:32]) is a and len(table) == before + 1
    with torch.no_grad():
        p.mul_(2)
    b = KC.cached_wgmma_weight(p[:32])
    assert b is not a and torch.equal(b, KC.wgmma_weight(p[:32].detach()))
    for _ in range(80):
        KC.cached_wgmma_weight(torch.randn(32, 32, 3, 3, 3))
    assert len(table) == before + 1
    w_big = CG.pack_weights(torch.randn(32, 32, 3, 3, 3))
    taps = CG.band_taps(w_big, 32, 32)
    lay = KC3.chunk_weights(taps, [32], 4, cache=False)
    assert len(table) == before + 1
    assert torch.equal(lay[0], KC.wgmma_weight(taps, koct=4))
    del p, a, b
    assert len(table) == before
