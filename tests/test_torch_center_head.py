"""The port's CenterHead against the JAX package, on the CPU.

The same seeded numpy inputs (and, for the forward, the same seeded flax
variables carried over by `utils/weights.py:center_head_key_map`) go
through both packages in float32, torch in one thread. Tolerances:

* the forward's branch maps: atol 1e-5 (3x3 convs over 32 channels of
  unit-scale values, the sums in another order);
* `gaussian_radius`: rtol 4e-6 (a few ulp: XLA fuses the quadratics'
  products); the heatmap targets and the regression targets: atol 1e-6;
  the cell indices and the mask exactly;
* the loss terms (`center_head_loss`, `mvdfm_loss`'s center branch):
  rtol 1e-5 (the same float32 sums in another order);
* the decode and `circle_nms_mask`, on heatmaps with ties: the kept
  mask, the labels and the candidates' order exactly, boxes and scores
  atol 1e-5 (exp / atan2 of the same float32 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models.detectors.multiview_dfm import mvdfm_loss as j_mvdfm_loss
from dfm_tpu.models.detectors.multiview_dfm import (MVDfMConfig as
                                                    JMVDfMConfig)
from dfm_tpu.models.detectors.multiview_dfm import (mvdfm_predict as
                                                    j_mvdfm_predict)
from dfm_tpu.models.heads import center_head as J
from dfm_tpu_torch.models.detectors.multiview_dfm import (MVDfMConfig,
                                                          mvdfm_loss,
                                                          mvdfm_predict)
from dfm_tpu_torch.models.heads import center_head as P
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import carry
from test_torch_multiview_dfm import flax_variables

torch.set_num_threads(1)    # from import on; the workers share the cores

TASK_IDS = ((0,), (1, 2))
NY, NX = 24, 20
KW = dict(tasks=(('Car',), ('Pedestrian', 'Cyclist')), voxel_size=(0.5, 0.5),
          pc_range=(0.0, -6.0), max_objs=8, max_per_task=12,
          circle_nms_thr=1.0, score_thr=0.05)
JCFG, PCFG = J.CenterHeadConfig(**KW), P.CenterHeadConfig(**KW)


def gt_batch(seed, b=2, g=9):
    """Boxes of every class inside and outside the grid, some masked, one
    pair sharing a cell."""
    rng = np.random.RandomState(seed)
    boxes = np.stack([
        rng.uniform(lo, hi, (b, g)) for lo, hi in (
            (-1, 11), (-7, 7), (-2, 0), (0.5, 4.5), (0.5, 2.2), (1.4, 1.8),
            (-np.pi, np.pi))], -1).astype(np.float32)
    boxes[:, 1, :2] = boxes[:, 0, :2] + 0.1
    labels = rng.randint(0, 3, (b, g)).astype(np.int32)
    mask = rng.rand(b, g) > 0.2
    mask[:, :2] = True
    return dict(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)


def task_outs(seed, b=2, ties=False):
    """Random branch maps (B, Ny, Nx, ch) of both tasks; with `ties`,
    heatmaps of a few levels so that many cells share a score."""
    rng = np.random.RandomState(seed)
    outs = []
    for classes in TASK_IDS:
        o = {k: (rng.randn(b, NY, NX, ch) * s).astype(np.float32)
             for k, ch, s in (('reg', 2, 0.3), ('height', 1, 0.5),
                              ('dim', 3, 0.3), ('rot', 2, 1.0))}
        hm = rng.randn(b, NY, NX, len(classes)) * 2 - 1
        if ties:
            hm = np.round(hm)
        o['heatmap'] = hm.astype(np.float32)
        outs.append(o)
    return outs


def to_t(x):
    return jax.tree.map(torch.from_numpy, x)


def test_gaussian_radius():
    sizes = np.random.RandomState(0).uniform(0.2, 30, (64, 2)).astype(
        np.float32)
    for overlap in (0.1, 0.7):
        want = np.asarray(J.gaussian_radius(jnp.asarray(sizes), overlap))
        got = P.gaussian_radius(torch.from_numpy(sizes), overlap).numpy()
        np.testing.assert_allclose(got, want, atol=0, rtol=4e-6)


def test_forward_matches_jax():
    """shared_conv and both tasks' six branches (the seeded flax tree
    through the key map, every leaf taken)."""
    bev = np.random.RandomState(1).randn(2, NY, NX, 32).astype(np.float32)
    jm = J.CenterHead(cfg=JCFG)
    variables = flax_variables(jm, bev, seed=2)
    key_map = W.center_head_key_map('h', (), PCFG)
    sd = W.state_dict_from_jax(variables, key_map)
    assert len(sd) == sum(x.size > 0 for x in jax.tree.leaves(variables))
    port = carry(torch.nn.ModuleDict(dict(h=P.CenterHead(PCFG, 32))),
                 variables, key_map)['h']
    want = jm.apply(variables, bev, False)
    with torch.no_grad():
        got = port(torch.from_numpy(bev).permute(0, 3, 1, 2))
    assert len(got) == 2
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) == sorted(
            ['reg', 'height', 'dim', 'rot', 'heatmap'])
        for k in w:
            assert g[k].shape == w[k].shape, (t, k)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=1e-5, rtol=0, err_msg=(t, k))


@pytest.mark.parametrize('task', [0, 1])
def test_targets_match_jax(task):
    gt = gt_batch(3)
    for i in range(2):
        args = [gt[k][i] for k in ('gt_boxes', 'gt_labels', 'gt_mask')]
        want = [np.asarray(x) for x in jax.jit(
            lambda *a: J.center_head_targets(*a, TASK_IDS[task], (NY, NX),
                                             JCFG))(*args)]
        got = [x.numpy() for x in P.center_head_targets(
            *map(torch.from_numpy, args), TASK_IDS[task], (NY, NX), PCFG)]
        assert want[3].sum() > 0 and (want[0] == 1).sum() > 0
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, k
            if k < 2:
                np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)


def test_loss_terms_match_jax():
    gt, outs = gt_batch(4), task_outs(5)
    want = jax.jit(lambda o, g: J.center_head_loss(o, g, JCFG, TASK_IDS))(
        outs, gt)
    got = P.center_head_loss(to_t(outs), to_t(gt), PCFG, TASK_IDS)
    assert sorted(got) == sorted(want) == sorted(
        f'task{t}_loss_{k}' for t in range(2) for k in ('heatmap', 'bbox'))
    for k in want:
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_circle_nms_matches_jax():
    rng = np.random.RandomState(6)
    centers = rng.uniform(0, 4, (40, 2)).astype(np.float32)
    scores = np.round(rng.rand(40), 1).astype(np.float32)   # ties
    want = np.asarray(J.circle_nms_mask(jnp.asarray(centers),
                                        jnp.asarray(scores), 0.5))
    got = P.circle_nms_mask(torch.from_numpy(centers),
                            torch.from_numpy(scores), 0.5).numpy()
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('ties', [False, True])
def test_decode_matches_jax(ties):
    outs = task_outs(7, ties=ties)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o: J.center_head_decode(o, JCFG, TASK_IDS))(outs))
    got = P.center_head_decode(to_t(outs), PCFG, TASK_IDS)
    kept = want['scores_3d'] > 0
    assert 0 < kept.sum() < len(kept)
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    np.testing.assert_array_equal(got['scores_3d'].numpy() > 0, kept)
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5,
                                   rtol=0, err_msg=k)


def test_mvdfm_center_branch_matches_jax():
    """`mvdfm_loss` and `mvdfm_predict` route 'task_outs' to the
    CenterHead with `_center_cfg`'s cells and the config's tasks."""
    opts = dict(bbox_head='center', voxel_range=(0, -6, -1, 10, 6, 3),
                voxel_grid=(4, NY, NX))
    jcfg, cfg = JMVDfMConfig(**opts), MVDfMConfig(**opts)
    gt, outs = gt_batch(8), task_outs(9)
    bev = np.zeros((2, NY, NX, 8), np.float32)
    total, want = jax.jit(lambda o, g: j_mvdfm_loss(o, g, jcfg))(
        dict(task_outs=outs, bev_feat=bev), gt)
    got_total, got = mvdfm_loss(dict(task_outs=to_t(outs),
                                     bev_feat=torch.from_numpy(bev)),
                                to_t(gt), cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-5)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda o: j_mvdfm_predict(o, jcfg))(dict(task_outs=outs,
                                                 bev_feat=bev)))
    got = mvdfm_predict(dict(task_outs=to_t(outs)), cfg)
    assert sorted(got) == sorted(want) == ['boxes_3d', 'labels_3d',
                                           'scores_3d']
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5,
                                   rtol=0, err_msg=k)
