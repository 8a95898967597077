"""The 0.05 m sparse teacher against the JAX package, on the CPU at small
sparse shapes.

* `ops/sparse_conv.py`: `_unique_compact`, `sparse_voxelize_mean`,
  `neighbor_table`, `sparse_conv_downsample` and `inverse_table` give
  JAX's integers exactly (keys, masks, slots, tables), with room to
  spare and past the capacity (the smallest keys kept); the voxel means
  within 1e-6 (measured 0), `subm_conv` within 1e-6 relative L2
  (measured 4.9e-8), `sparse_to_dense` exactly;
* `SparseLidarTeacher` (17 x 64 x 64 grid, capacity 640, overflowing) in
  eval and train mode: volume and BEV features within 1e-4 relative L2
  (measured 1.6e-7 in eval, 3.1e-6 in train mode), the SparseBN running
  statistics within 1e-5 (measured 1.2e-7);
* the SECOND converter on a seeded state dict in reference key names, in
  spconv's v2 (kz, ky, kx, C_in, C_out) and the (C_out, C_in, kz, ky,
  kx) layout: the sparse encoder's tree equal to JAX's
  `convert_sparse_encoder`, the BEV hourglass to JAX's importer with
  `teacher_key_map`, bit for bit; its file read back by
  `teacher_state_dict(tree, 'sparse')` into the port's teacher, which
  refuses a dense tree naming the groups it lacks;
* DfMWithTeacher's step with this teacher is in
  tests/test_torch_dfm_with_teacher.py.
"""

import os
import sys
import threading
from typing import Tuple
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dfm_tpu.models.detectors.teacher as JT
import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models.detectors.dfm_with_teacher import \
    DfMWithTeacher as JDfMWithTeacher
from dfm_tpu.models.detectors.dfm_with_teacher import \
    dfm_loss_with_imitation as j_loss
from dfm_tpu.ops import sparse_conv as JS
from dfm_tpu.runtime.adapters import _dfm_synth as jax_synth
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu.utils.checkpoint_import import (expected_torch_shapes,
                                             import_dfm_state_dict,
                                             teacher_key_map)
from dfm_tpu_torch.models.detectors.dfm import DfMConfig
from dfm_tpu_torch.models.detectors.dfm_with_teacher import DfMWithTeacher
from dfm_tpu_torch.models.detectors.teacher import SparseLidarTeacher
from dfm_tpu_torch.ops import sparse_conv as S
from dfm_tpu_torch.runtime.adapters import dfm_synth, to_device
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.tools.model_converters import \
    convert_second_checkpoints as CONV
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.msgpack_tree import load_msgpack_tree
from tools.model_converters.convert_second_checkpoints import \
    convert_sparse_encoder as j_convert_sparse_encoder

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_train_step import (GRAD_REL_L2, GRAD_REL_L2_ALL,
                                   GRAD_REL_L2_LIFTED, LOSS_RTOL, LR,
                                   PARAM_ATOL, STATS_ATOL, RecordGrads,
                                   random_variables)

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

PCR = (2, -30.4, -3, 59.6, 30.4, 1)
# a teacher whose dense output is the tiny DfM's imitation grid (2, 16, 16)
SMALL = dict(voxel_size=(0.9, 0.95, 0.25), sparse_shape=(17, 64, 64),
             capacity=640)
TINY = chip_smoke.TRAIN_TINY
B, H, W_ = 2, 64, 128
OP_TOL = 1e-6
OUT_REL = 1e-4
LIFTED = ('dfm.feature_transformation.', 'dfm.backbone_3d.',
          'dfm.bbox_head_3d.', 'imit_bev.', 'imit_vol.')


def t(x):
    return torch.from_numpy(np.array(x))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def cloud(seed, n=1500, lo=PCR[:3], hi=PCR[3:]):
    """Points uniform in (and a little beyond) the range, dense clusters
    (voxels of more than 5 points) and a few masked."""
    rng = np.random.RandomState(seed)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    pts = rng.uniform(lo - 1, hi + 1, (n, 3))
    for c in range(10):
        ctr = rng.uniform(lo + 2, hi - 2)
        pts[40 * c:40 * c + 40] = ctr + 0.1 * rng.randn(40, 3)
    return pts.astype(np.float32), rng.rand(n) > 0.03


def test_sparse_ops_match_jax():
    """Voxelization past the capacity (1.5k points, 300 voxels kept), the
    downsampling with room to spare and past it."""
    grid, capacity = SMALL['sparse_shape'], 300
    pts, mask = cloud(0)
    jk, jf, jm = jax.jit(JS.sparse_voxelize_mean, static_argnums=(3, 4, 5))(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(PCR),
        SMALL['voxel_size'], grid, capacity)
    k, f, m = S.sparse_voxelize_mean(t(pts), t(mask), PCR,
                                     SMALL['voxel_size'], grid, capacity)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=OP_TOL)
    assert int(m.sum()) == capacity
    # _unique_compact on repeated candidates, with and without overflow
    cand = np.random.RandomState(1).randint(0, 500, 900)
    valid = np.random.RandomState(2).rand(900) > 0.2
    for cap in (512, 100):
        want = jax.jit(JS._unique_compact, static_argnums=2)(
            jnp.asarray(cand, jnp.int32), jnp.asarray(valid), cap)
        got = S._unique_compact(t(cand), t(valid), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nbr = S.neighbor_table(k, m, grid)
    jnbr = np.asarray(jax.jit(JS.neighbor_table, static_argnums=2)(
        jk, jm, grid))
    np.testing.assert_array_equal(nbr.numpy(), jnbr)
    assert (jnbr >= 0).sum() > int(m.sum())          # real neighbours
    w = np.random.RandomState(3).randn(27, 3, 8).astype(np.float32)
    assert rel(S.subm_conv(f, nbr, t(w)).numpy(), np.asarray(jax.jit(
        JS.subm_conv)(jf, jnp.asarray(jnbr), jnp.asarray(w)))) <= OP_TOL
    down = jax.jit(JS.sparse_conv_downsample, static_argnums=(2, 3, 4, 5))
    inv_t = jax.jit(JS.inverse_table, static_argnums=(4, 5, 6, 7))
    for stride, pad, cap in (((2, 2, 2), (1, 1, 1), 1024),
                             ((2, 1, 1), (0, 1, 1), 64)):
        got = S.sparse_conv_downsample(k, m, grid, stride, pad, cap)
        want = down(jk, jm, grid, stride, pad, cap)
        assert got[2] == tuple(want[2])
        for i in (0, 1, 3):
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(want[i]))
        inv = S.inverse_table(k, m, got[0], got[1], grid, got[2], stride,
                              pad)
        jinv = inv_t(jk, jm, want[0], want[1], grid, got[2], stride, pad)
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
        assert (np.asarray(jinv) >= 0).any()
    assert int(got[1].sum()) == 64 and not bool(
        S.sparse_conv_downsample(k, m, grid, (2, 2, 2), (1, 1, 1),
                                 1024)[1].all())
    np.testing.assert_allclose(
        S.sparse_to_dense(k, m, f, grid).numpy(),
        np.asarray(jax.jit(JS.sparse_to_dense, static_argnums=3)(
            jk, jm, jf, grid)), atol=0)


class SmallTeacher(JT.SparseLidarTeacher):
    voxel_size: Tuple[float, float, float] = SMALL['voxel_size']
    sparse_shape: Tuple[int, int, int] = SMALL['sparse_shape']
    capacity: int = SMALL['capacity']


def flax_shapes(port, key_map):
    """The flax {'params', 'batch_stats'} tree of shapes of which
    `state_dict_from_jax(., key_map)` gives `port`'s state dict (its
    inverse; JAX's `eval_shape` of the init costs seconds of tracing)."""
    sd = port.state_dict()
    tree = {'params': {}, 'batch_stats': {}}

    def put(group, path, leaf, shape):
        node = tree[group]
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)

    for prefix, fpath, kind in key_map:
        if kind == 'param':
            put('params', fpath[:-1], fpath[-1], sd[prefix].shape)
        elif kind.startswith('conv'):
            w = tuple(sd[f'{prefix}.weight'].shape)
            put('params', fpath, 'kernel', w[2:] + (
                w[:2] if kind.startswith('convt') else w[1::-1]))
            if f'{prefix}.bias' in sd:
                put('params', fpath, 'bias', (w[0],))
        else:
            c = sd[f'{prefix}.weight'].shape
            put('params', fpath, 'scale', c)
            put('params', fpath, 'bias', c)
            if kind == 'bn':
                put('batch_stats', fpath, 'mean', c)
                put('batch_stats', fpath, 'var', c)
    return tree


def teacher_points():
    pts, mask = zip(*[cloud(s) for s in (4, 5)])
    return np.stack(pts), np.stack(mask)


@pytest.fixture(scope='module')
def teacher():
    """The small JAX teacher's seeded variables and its outputs on two
    clouds (each past the capacity) in eval and in train mode (with the
    updated statistics)."""
    pts, mask = teacher_points()
    jm = SmallTeacher(point_cloud_range=PCR, bev_channels=16)
    v = random_variables(flax_shapes(SparseLidarTeacher(
        PCR, bev_channels=16, **SMALL), W.sparse_teacher_key_map()), 2)
    runs = {}

    def run(train):
        out, upd = jax.jit(lambda vv, p, m: jm.apply(
            vv, p, m, train=train, mutable=['batch_stats']))(v, pts, mask)
        runs[train] = jax.tree.map(np.asarray, (out, upd['batch_stats']))

    # XLA compiles one mode while Python traces the other
    th = threading.Thread(target=run, args=(False,))
    th.start()
    try:
        run(True)
    finally:
        th.join()
    return dict(v=v, pts=pts, mask=mask, runs=runs)


@pytest.mark.parametrize('train', [False, True])
def test_sparse_teacher_matches_jax(teacher, train):
    (vol_w, bev_w), stats = teacher['runs'][train]
    port = SparseLidarTeacher(PCR, bev_channels=16, **SMALL)
    sd = W.state_dict_from_jax(teacher['v'], W.sparse_teacher_key_map())
    port.load_state_dict(sd, strict=True)
    port.train(train)
    vol, bev = port(t(teacher['pts']), t(teacher['mask']))
    assert vol.shape == (2, 2, 16, 16, 32) == vol_w.shape
    assert rel(vol.detach().numpy(), vol_w) <= OUT_REL
    assert rel(bev.detach().numpy(), bev_w) <= OUT_REL
    assert np.abs(vol_w).max() > 0
    if train:
        want = W.state_dict_from_jax(dict(params=teacher['v']['params'],
                                          batch_stats=stats),
                                     W.sparse_teacher_key_map())
        for k, x in port.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(x.numpy(), want[k].numpy(),
                                           atol=STATS_ATOL, err_msg=k)


def second_state_dict(v, layout, seed=0):
    """A seeded SECOND state dict in the reference's key names
    (`lidar_model.` prefix) with the shapes of the teacher tree `v`."""
    rng = np.random.RandomState(seed)
    sd = {}
    me = v['params']['middle_encoder']
    torch_layers = ['conv_input', 'encoder_layers.encoder_layer1.0'] + [
        f'encoder_layers.encoder_layer{s + 1}.{j}'
        for s in (1, 2, 3) for j in (0, 1, 2)]
    for (conv, bn), layer in zip(W.SPARSE_ENCODER_LAYERS, torch_layers):
        _, cin, cout = me[conv]['kernel'].shape
        shape = (3, 3, 3, cin, cout) if layer == 'conv_input' or \
            layout == 'v2' else (cout, cin, 3, 3, 3)
        sd[f'middle_encoder.{layer}.0.weight'] = rng.randn(*shape)
        for leaf in ('weight', 'bias', 'running_mean'):
            sd[f'middle_encoder.{layer}.1.{leaf}'] = rng.randn(cout)
        sd[f'middle_encoder.{layer}.1.running_var'] = rng.rand(cout) + 0.5
    _, cin, cout = me['conv_out']['kernel'].shape
    sd['middle_encoder.conv_out.0.weight'] = rng.randn(
        *((1, 1, 1, cin, cout) if layout == 'v2' else (cout, cin, 1, 1, 1)))
    for k, shape in expected_torch_shapes(v, teacher_key_map()).items():
        sd[k] = rng.rand(*shape) + 0.5 if k.endswith('running_var') \
            else rng.randn(*shape)
    return {f'lidar_model.{k}': torch.from_numpy(x.astype(np.float32))
            for k, x in sd.items()}


@pytest.mark.parametrize('layout', ['v2', 'torch'])
def test_converter_matches_jax(teacher, tmp_path, layout):
    v = teacher['v']
    sd = second_state_dict(v, layout)
    path = str(tmp_path / 'second.pth')
    torch.save({'state_dict': sd}, path)
    dst = str(tmp_path / 'teacher.msgpack')
    assert CONV.main([path, dst]) == 0
    tree = load_msgpack_tree(dst)
    plain = {k[len('lidar_model.'):]: x.numpy() for k, x in sd.items()}
    jp, js = j_convert_sparse_encoder(plain)
    jbev = import_dfm_state_dict(plain, v, key_map=teacher_key_map(),
                                 strict=False)
    want = {'params': {'middle_encoder': jp, 'bev': jbev['params']['bev']},
            'batch_stats': {'middle_encoder': js,
                            'bev': jbev['batch_stats']['bev']}}
    assert CONV.bev_key_map() == teacher_key_map()
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got_leaves) == len(want_leaves) > 0
    for p, x in got_leaves:
        np.testing.assert_array_equal(x, np.asarray(want_leaves[p]),
                                      err_msg=str(p))
    port = SparseLidarTeacher(PCR, bev_channels=16, **SMALL)
    port.load_state_dict(W.teacher_state_dict(tree, 'sparse'), strict=True)
    with pytest.raises(KeyError, match='middle_encoder'):
        W.teacher_state_dict({'params': {'bev': tree['params']['bev']}},
                             'sparse')
    with pytest.raises(KeyError, match='enc0.*enc1.*enc2'):
        W.teacher_state_dict(tree)
    assert CONV.main([path, dst, '--encoder', 'dense']) == 2
