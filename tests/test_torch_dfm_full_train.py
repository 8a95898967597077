"""DfMFull training with the port against the JAX package, on the CPU.

* One whole train step at chip_smoke.py's tiny training config
  (`TRAIN_TINY`, the flagship's `atss`) on a `_dfm_synth(full=True)` batch
  (B = 2, 64x128, teacher points and 2D targets), against JAX's
  `make_train_step` with `dfm_full_loss` and `make_optimizer(
  frozen_prefixes=('lidar_teacher',))`, at the bare step's tolerances
  (tests/test_torch_train_step.py, whose helpers it uses): every loss
  term, the new four included (rtol 2e-4); every gradient by relative
  L2 (2e-2 any parameter, 2e-3 the whole vector, 1e-4 the layers after
  the voxel lifting and the new heads), the teacher's none (JAX's are
  exactly 0: its outputs are stop_gradient-ed); the parameters after
  the update by what their two gradients explain + 2e-6, the teacher's
  unchanged bit for bit; every BatchNorm running statistic, the
  teacher's included (atol 1e-5 + rtol 1e-5: the teacher's first
  BatchNorm normalises raw coordinates, tens of metres, so flax's
  E[x^2] - E[x]^2 cancels most of its digits: 2.5e-6 relative measured).
* The same weights and batch without points or 2D targets: the port's
  DfMFull still runs its 2D head, and its loss is `dfm_loss`'s terms
  alone, each equal (rtol 2e-4) to those of JAX's step above (they read
  only the student's outputs, the gt and the step's key).
* `dfm_synth` equal to JAX's `_dfm_synth` for two seeds, bit for bit.
* The msgpack reader against `flax.serialization`: every msgpack type
  flax writes, bfloat16 (widened to float32), numpy scalars and flax's
  chunked arrays (its chunk size lowered in the test), equal to
  `msgpack_restore`; another ext type refused by its code; the stdlib
  writer (`utils/msgpack_tree.py:msgpack_dumps`) read back by
  `msgpack_restore`.
* The train CLI on the CPU at the tiny config: `--synthetic`, 2 steps
  with the teacher restored from a JAX `LidarTeacher` tree, the four new
  terms finite in metrics.jsonl, the teacher's parameters in the
  checkpoint equal to the file's, a resume to step 3 with the saved
  optimizer state, and a tree shaped as the sparse SECOND converter's
  refused; a DfMFull checkpoint of the CLI evaluated as its student.
"""

import json
import os
import sys
from unittest import mock

import flax.serialization as FS
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.models import ATSS2DConfig as JATSS
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models import DfMFull as JDfMFull
from dfm_tpu.models.detectors.dfm_full import dfm_full_loss as jax_full_loss
from dfm_tpu.models.detectors.teacher import LidarTeacher as JTeacher
from dfm_tpu.runtime.adapters import _dfm_synth as jax_synth
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.models.builder import atss_config
from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
from dfm_tpu_torch.models.detectors.dfm_full import DfMFull, dfm_full_loss
from dfm_tpu_torch.runtime.adapters import dfm_synth, to_device
from dfm_tpu_torch.runtime.checkpoint import CheckpointManager
from dfm_tpu_torch.runtime.config import load_config
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.msgpack_tree import (load_msgpack_tree,
                                              msgpack_dumps, msgpack_loads)

from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL,
                                   GRAD_REL_L2_LIFTED, LOSS_RTOL, LR,
                                   PARAM_ATOL, STATS_ATOL, RecordGrads,
                                   random_variables)

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CONFIG = os.path.join(ROOT, 'configs', 'dfm_r34_kitti_3class.py')
TINY = chip_smoke.TRAIN_TINY
B, H, W_ = 2, 64, 128
LIFTED = ('dfm.feature_transformation.', 'dfm.backbone_3d.',
          'dfm.bbox_head_3d.', 'neck_2d.', 'bbox_head_2d.', 'imit_bev.',
          'imit_vol.')
DFM_TERMS = ['loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
             'loss_dense_depth']
NEW_TERMS = ['loss_cls2d', 'loss_bbox2d', 'loss_centerness2d',
             'loss_imitation']
STATS_RTOL = 1e-5
# XLA's CPU backend without LLVM's costly passes: the same graph, its
# compile about 15 s shorter (of about 60 s: 20 s tracing, 40 s XLA)
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}
TINY_OPTS = ['model.depth_num_bins=48', 'model.voxel_size=(3.6,3.8,0.5)',
             'model.num_depth_sample_pixels=256']


def _atss():
    return atss_config(load_config(CONFIG).model)


@pytest.fixture(scope='module')
def step_pair():
    cfg = JConfig(**TINY)
    acfg = JATSS(**vars(_atss()))
    handle = type('Handle', (), {'cfg': cfg})
    batch = jax_synth(handle, B, 7, h=H, w=W_, full=True)
    model = JDfMFull(cfg=cfg, atss_cfg=acfg)
    args = (batch['img'], batch['meta'], batch['points'],
            batch['point_mask'])
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args,
                                               train=False))
    variables = random_variables(shapes, 1)
    tx = optax.chain(RecordGrads.make(), jax_make_optimizer(
        jax_schedule(**LR), frozen_prefixes=('lidar_teacher',)))
    state = create_train_state(variables, tx)
    key = jax.random.PRNGKey(3)
    step = make_train_step(
        model, lambda o, b, r: jax_full_loss(o, b, cfg, acfg, (H, W_), r),
        donate=False, model_args_fn=lambda b: (
            b['img'], b['meta'], b.get('points'), b.get('point_mask')))
    orig = JFS.build_fine_softmax_volume

    def fine_f32(*a, **kw):
        kw['dtype'] = jnp.float32
        return orig(*a, **kw)

    with mock.patch.object(JFS, 'build_fine_softmax_volume', fine_f32):
        new_state, metrics = step.lower(state, batch, key).compile(
            compiler_options=FAST_COMPILE)(state, batch, key)
    # JAX's depth-pixel draws under the step's key (one key per sample)
    keys = jax.random.split(key, B)
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], H * W_, (cfg.num_depth_sample_pixels,), replace=True,
        p=jnp.full((H * W_,), 1.0 / (H * W_), jnp.float32)))
        for i in range(B)])
    key_map = W.dfm_full_key_map(stacked_convs=acfg.stacked_convs)
    return dict(
        batch=dfm_synth(DfMConfig(**TINY), B, 7, h=H, w=W_, full=True),
        sd=W.state_dict_from_jax(variables, key_map), pix=pix,
        metrics={k: float(v) for k, v in metrics.items()},
        grads=W.state_dict_from_jax({'params': jax.device_get(
            new_state.opt_state[0]), 'batch_stats': variables[
                'batch_stats']}, key_map),
        after=W.state_dict_from_jax(jax.device_get(
            {'params': new_state.params,
             'batch_stats': new_state.batch_stats}), key_map),
        port={})


def _port_model(pair):
    model = DfMFull(DfMConfig(**TINY), _atss())
    model.load_state_dict(pair['sd'], strict=True)
    return model


def port_step(pair):
    if not pair['port']:
        model = _port_model(pair)
        step = TrainStep(model, make_optimizer(
            model, frozen_prefixes=('lidar_teacher',)), liga_schedule(**LR))
        img, meta, gt = to_device(pair['batch'], 'cpu')
        with torch.backends.mkldnn.flags(enabled=False):
            total, losses = step.forward(
                img, meta, gt, depth_pix_idx=torch.from_numpy(pair['pix']))
            step.backward(total)
        grads = {n: None if p.grad is None else p.grad.clone()
                 for n, p in model.named_parameters()}
        norm = step.update()
        pair['port'] = dict(
            metrics=dict(loss=float(total.detach()), grad_norm=float(norm),
                         **{k: float(v.detach()) for k, v in losses.items()}),
            grads=grads, after=model.state_dict())
    return pair['port']


@pytest.mark.parametrize('term', ['loss'] + DFM_TERMS + NEW_TERMS +
                         ['grad_norm'])
def test_loss_terms_match_jax(step_pair, term):
    got = port_step(step_pair)['metrics'][term]
    want = step_pair['metrics'][term]
    if term in ('loss_bbox', 'loss_iou', 'loss_dir') + tuple(NEW_TERMS):
        assert want > 0, f'{term}: the batch does not reach it'
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7)


def test_gradients_match_jax(step_pair):
    got = port_step(step_pair)['grads']
    assert set(got) == {k for k in step_pair['grads']
                        if not k.endswith(('running_mean', 'running_var'))}
    rel, flat_g, flat_w = {}, [], []
    for name, g in got.items():
        want = step_pair['grads'][name].numpy()
        if name.startswith('lidar_teacher.'):
            assert g is None and not want.any(), name
            continue
        g = g.numpy()
        assert np.isfinite(g).all(), name
        rel[name] = np.linalg.norm(g - want) / max(np.linalg.norm(want),
                                                   1e-30)
        flat_g.append(g.ravel())
        flat_w.append(want.ravel())
    bad = {k: v for k, v in rel.items() if v > (
        GRAD_REL_L2_LIFTED if k.startswith(LIFTED) else GRAD_REL_L2)}
    assert not bad, f'gradients off (relative L2): {bad}'
    flat_g, flat_w = np.concatenate(flat_g), np.concatenate(flat_w)
    assert np.linalg.norm(flat_g - flat_w) <= \
        GRAD_REL_L2_ALL * np.linalg.norm(flat_w)
    # the imitation and the 2D head reach the student
    for prefix in ('imit_vol.', 'imit_bev.', 'neck_2d.', 'bbox_head_2d.',
                   'dfm.neck.', 'dfm.backbone_stereo.'):
        assert any(k.startswith(prefix) and np.linalg.norm(
            step_pair['grads'][k].numpy()) > 0 for k in got), prefix


def test_parameters_and_batch_stats_after_step(step_pair):
    """As tests/test_torch_train_step.py's test of the same name; the
    teacher's parameters are the loaded ones, bit for bit, on both sides,
    and its running statistics move."""
    port = port_step(step_pair)
    got = port['after']
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / port['metrics']['grad_norm'])
    clip_jax = min(1.0, 35.0 / step_pair['metrics']['grad_norm'])
    flips = total = 0
    for name, t in got.items():
        want = step_pair['after'][name].numpy()
        stat = name.endswith(('running_mean', 'running_var'))
        if name.startswith('lidar_teacher.') and not stat:
            assert torch.equal(t, step_pair['sd'][name]), name
            np.testing.assert_array_equal(want, step_pair['sd'][name].numpy())
            continue
        if stat:
            # + STATS_RTOL: the teacher's first BatchNorm sees raw
            # coordinates (metres): E[x^2] - E[x]^2 cancels
            atol = STATS_ATOL + STATS_RTOL * np.abs(want)
        else:
            g = port['grads'][name].numpy().astype(np.float64) * clip
            gw = step_pair['grads'][name].numpy().astype(np.float64) * \
                clip_jax
            flip = np.sign(g) != np.sign(gw)
            flips += int(flip.sum())
            total += flip.size
            atol = lr0 * np.abs(g / (np.abs(g) + 1e-8) -
                                gw / (np.abs(gw) + 1e-8)) + PARAM_ATOL
        err = np.abs(t.numpy() - want)
        assert (err <= atol).all(), (name, float(err.max()))
    assert flips <= 1e-3 * total, (flips, total)
    moved = [n for n in got if n.startswith('lidar_teacher.') and
             n.endswith('running_var') and not np.allclose(
                 got[n].numpy(), step_pair['sd'][n].numpy())]
    assert moved, "no teacher BatchNorm running_var moved in train mode"


def test_batch_without_points_or_2d_targets(step_pair):
    model = _port_model(step_pair).train()
    img, meta, gt = to_device(step_pair['batch'], 'cpu')
    for k in ('points', 'point_mask', 'gt_bboxes2d', 'centers2d'):
        gt.pop(k)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        out = model(img, meta, gt.get('points'), gt.get('point_mask'))
        assert 'outs_2d' in out and 'imitation' not in out
        total, losses = dfm_full_loss(
            out, gt, model.cfg, model.atss_cfg, (H, W_),
            model.anchors_per_class(out['cls_score'].shape[1:3], 'cpu'),
            depth_pix_idx=torch.from_numpy(step_pair['pix']))
    assert sorted(losses) == sorted(DFM_TERMS)
    for k in DFM_TERMS:
        np.testing.assert_allclose(float(losses[k]), step_pair['metrics'][k],
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(total), sum(
        step_pair['metrics'][k] for k in DFM_TERMS), rtol=LOSS_RTOL)


@pytest.mark.parametrize('seed', [0, 1])
def test_dfm_synth_matches_jax(seed):
    cfg = DfMConfig(**TINY)
    want = jax_synth(type('Handle', (), {'cfg': JConfig(**TINY)}), 2, seed,
                     full=True)
    got = dfm_synth(cfg, 2, seed, full=True)
    assert set(got) == set(want)
    for k, v in got.items():
        if k == 'meta':
            for f, x in v.items():
                np.testing.assert_array_equal(
                    x, np.asarray(getattr(want['meta'], f)), err_msg=f)
        else:
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
            assert v.dtype == np.asarray(want[k]).dtype, k


def _same(got, want, path=()):
    """`got` (the port's reader) equals `want` (flax's): bfloat16 arrays
    as their float32 values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, path + (i,))
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, 'dtype'):
        w = np.asarray(want)
        if w.dtype.name == 'bfloat16':
            w = w.astype(np.float32)
        assert np.asarray(got).dtype == w.dtype and np.shape(got) == \
            w.shape, path
        np.testing.assert_array_equal(np.asarray(got), w, err_msg=str(path))
        assert isinstance(got, np.ndarray) == isinstance(want, np.ndarray)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize('chunk', [None, 4096])
def test_msgpack_reader_matches_flax(chunk):
    rng = np.random.default_rng(2)
    tree = {
        'params': {'enc0': {'Conv_0': {'kernel': rng.standard_normal(
            (3, 3, 3, 4, 16), dtype=np.float32)}},
            'half': jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16),
            'i32': np.arange(-40, 40, dtype=np.int32).reshape(4, 20),
            'u8': np.arange(200, dtype=np.uint8), 'f64': rng.random(3),
            'mask': rng.random(9) > 0.5,
            'big': rng.standard_normal(70000, dtype=np.float32)},
        'scalars': {'f32': np.float32(2.5), 'i64': np.int64(-7)},
        'many': {f'k{i}': i for i in range(20)},
        'ints': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 40, -1, -32,
                 -33, -200, -40000, -2 ** 40],
        'floats': [1.5, -0.0, 1e300], 'none': None, 'flags': [True, False],
        'text': 'x' * 40, 'short': 'ab', 'raw': bytes(range(256)) * 300,
        'long_list': list(range(20))}
    ctx = mock.patch.object(FS, 'MAX_CHUNK_SIZE', chunk) if chunk else \
        mock.patch.object(FS, 'MAX_CHUNK_SIZE', FS.MAX_CHUNK_SIZE)
    with ctx:
        data = FS.msgpack_serialize(tree)
    if chunk:
        assert b'__msgpack_chunked_array__' in data
    _same(msgpack_loads(data), FS.msgpack_restore(data))


def test_msgpack_reader_refuses_other_ext_types():
    data = FS.msgpack_serialize({'z': complex(1.0, 2.0)})
    with pytest.raises(ValueError, match='ext type 2'):
        msgpack_loads(data)
    with pytest.raises(ValueError, match='ends inside'):
        msgpack_loads(FS.msgpack_serialize({'a': np.ones(4)})[:-3])


def test_chip_smoke_writer_reads_back_with_flax():
    tree = chip_smoke.teacher_tree(DfMFull(DfMConfig(**TINY)).lidar_teacher,
                                   0)
    tree['other'] = {'text': 'y' * 300, 'raw': b'abc', 'n': [1, 200, 70000]}
    data = msgpack_dumps(tree)
    _same(FS.msgpack_restore(data), tree)
    _same(msgpack_loads(data), tree)


def _jax_teacher_file(path, seed):
    """A JAX `LidarTeacher` tree at the tiny config (seeded values)
    written by flax; returns its tree."""
    cfg = DfMConfig(**TINY)
    jm = JTeacher(point_cloud_range=cfg.point_cloud_range,
                  voxel_size=cfg.voxel_size)
    pts = jnp.zeros((1, 8, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), pts,
                                            jnp.ones((1, 8), bool)))
    tree = jax.device_get(random_variables(shapes, seed))
    with open(path, 'wb') as f:
        f.write(FS.msgpack_serialize(tree))
    return tree


def test_train_cli_dfm_full_synthetic(tmp_path, capsys):
    teacher = str(tmp_path / 'teacher.msgpack')
    tree = _jax_teacher_file(teacher, 4)
    work = str(tmp_path / 'w')
    args = [CONFIG, '--synthetic', '--device', 'cpu', '--work-dir', work,
            '--cfg-options', *TINY_OPTS,
            f'model.teacher_checkpoint={teacher}']
    assert train_cli.main(args + ['--max-steps', '2']) == 0
    out = capsys.readouterr().out
    assert f'[teacher] restored from {teacher}' in out
    with open(os.path.join(work, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs] == [1, 2]
    for key in ['loss', 'grad_norm'] + DFM_TERMS + NEW_TERMS:
        assert all(np.isfinite(r[f'train/{key}']) for r in recs), key
    ck = CheckpointManager(os.path.join(work, 'ckpts'))
    saved = ck.load()
    want = W.teacher_state_dict(load_msgpack_tree(teacher))
    params = [k for k in want if not k.endswith(('running_mean',
                                                 'running_var'))]
    assert len(params) == 8 + 2 * 10 + 2     # convs, norms, convts
    for k in params:
        assert torch.equal(saved['state_dict'][f'lidar_teacher.{k}'],
                           want[k]), k
    np.testing.assert_array_equal(
        want['enc0.conv.weight'].numpy(),
        tree['params']['enc0']['Conv_0']['kernel'].transpose(4, 3, 0, 1, 2))
    digest = train_cli.optimizer_digest(saved['optimizer'])
    assert train_cli.main(args + ['--max-steps', '3', '--auto-resume']) == 0
    out = capsys.readouterr().out
    assert f'resumed from step 2 (optimizer state sha1 {digest})' in out
    assert 'step 3/3' in out and ck.latest_step() == 3
    # the DfMFull checkpoint evaluates as its student
    student = DfM(DfMConfig(**TINY))
    rest = W.load_reference_state_dict(student, test_cli.student_state_dict(
        W.read_checkpoint(ck.path(3))))
    assert rest and all(k.split('.')[0] in (
        'lidar_teacher', 'neck_2d', 'bbox_head_2d', 'imit_bev', 'imit_vol')
        for k in rest)
    last = ck.load()['state_dict']
    for k, v in student.state_dict().items():
        assert torch.equal(v, last[f'dfm.{k}']), k
    # a tree of the sparse SECOND converter (middle_encoder + bev) is
    # not the dense teacher's
    sparse = str(tmp_path / 'sparse.msgpack')
    with open(sparse, 'wb') as f:
        f.write(FS.msgpack_serialize({'params': {
            'middle_encoder': {'conv_input': {'kernel': np.zeros(
                (27, 3, 16), np.float32)}},
            'bev': tree['params']['bev']}}))
    with pytest.raises(KeyError, match='enc0.*enc1.*enc2'):
        train_cli.main([CONFIG, '--synthetic', '--device', 'cpu',
                        '--work-dir', str(tmp_path / 'w2'), '--cfg-options',
                        *TINY_OPTS, f'model.teacher_checkpoint={sparse}'])
