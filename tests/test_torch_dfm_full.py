"""DfMFull's modules in the port against the JAX package, on the CPU.

Every case feeds the same seeded numpy inputs (and, for modules with
weights, the same seeded flax variables carried over through
`utils/weights.py:dfm_full_key_map`) to both packages, torch in one
thread. Tolerances:

* FPN, the ATSS head, the LiDAR teacher in eval mode: atol = rtol = 1e-5
  (a few stacked float32 convs and norms summed in other orders); the
  teacher in train mode and its updated running statistics: 1e-4 (its
  BatchNorm statistics at the hourglass's 1/4 level come from 32 values
  a channel, E[x^2] - E[x]^2 in float32: 2e-5 measured);
* `atss_assign`: the assignment exactly, ties and a masked gt included
  (the IoUs 1e-6);
* each `atss2d_loss` term rtol 1e-5, its gradient to the head outputs
  atol 1e-7 + rtol 1e-4;
* `binary_cross_entropy`, `giou_loss_2d`: rtol 1e-6;
  `points_in_rotated_boxes_bev` exactly, on points at least 1e-3 off every
  box edge;
* `voxelize_mean`, both routes (all points and the cap of 2 a voxel),
  with points outside the range (below it too: negative offsets floor
  away from 0), masked points and crowded voxels: counts exactly, means
  atol 1e-6;
* `imitation_loss`: rtol 1e-5, its gradient to the student atol 1e-9 +
  rtol 1e-4, on the BEV and on the volume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.core import losses as JL
from dfm_tpu.core.boxes import points_in_rotated_boxes_bev as j_in_boxes
from dfm_tpu.models.detectors import teacher as JT
from dfm_tpu.models.detectors.imitation import imitation_loss as j_imitation
from dfm_tpu.models.heads import atss2d as JA
from dfm_tpu.models.necks.fpn import FPN as JFPN
from dfm_tpu_torch.core import losses as L
from dfm_tpu_torch.core.boxes import points_in_rotated_boxes_bev
from dfm_tpu_torch.models.detectors import teacher as T
from dfm_tpu_torch.models.detectors.imitation import imitation_loss
from dfm_tpu_torch.models.heads import atss2d as A
from dfm_tpu_torch.models.necks.fpn import FPN
from dfm_tpu_torch.utils import weights as W

from test_torch_layers import carry, randomize

torch.set_num_threads(1)    # from import on; the workers share the cores

TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_BN_TOL = dict(atol=1e-4, rtol=1e-4)
ATSS = dict(num_classes=3, in_channels=16, feat_channels=64,
            stacked_convs=2)
IMG_HW = (64, 128)


def init_vars(module, seed, *args):
    """Seeded flax variables of `module` (`randomize` over the shapes of
    its init, traced without running it)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return randomize(jax.tree.map(lambda t: np.zeros(t.shape, t.dtype),
                                  shapes), seed)


def sub_map(prefix, **kw):
    """`dfm_full_key_map`'s entries under `prefix`, relative to it."""
    return [(p[len(prefix) + 1:], f[1:], k)
            for p, f, k in W.dfm_full_key_map(**kw)
            if p.startswith(prefix + '.')]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_fpn_matches_jax():
    """One input, five outputs: lateral0 1x1, fpn_conv0 3x3 and four
    stride-2 extra convs, the ReLU before each but the first."""
    x = np.random.RandomState(0).randn(2, 12, 20, 16).astype(np.float32)
    jm = JFPN(out_channels=16, num_outs=5)
    v = init_vars(jm, 1, [jnp.asarray(x)])
    want = jax.jit(jm.apply)(v, [jnp.asarray(x)])
    port = FPN(16, 16)
    carry(port, v, sub_map('neck_2d'))
    got = port(nchw(x))
    assert [tuple(g.shape[2:]) for g in got] == [(12, 20), (6, 10), (3, 5),
                                                 (2, 3), (1, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w), **TOL)


def _levels(rng, b=2, c=16):
    h, w = IMG_HW
    return [rng.randn(b, (h + s - 1) // s, (w + s - 1) // s, c).astype(
        np.float32) for s in (4, 8, 16, 32, 64)]


def test_atss_head_matches_jax():
    """Its GroupNorm towers shared by the five levels; outputs
    channels-last."""
    feats = _levels(np.random.RandomState(1))
    jm = JA.ATSS2DHead(cfg=JA.ATSS2DConfig(**ATSS))
    v = init_vars(jm, 2, [jnp.asarray(f) for f in feats])
    want = jax.jit(jm.apply)(v, [jnp.asarray(f) for f in feats])
    port = A.ATSS2DHead(A.ATSS2DConfig(**ATSS))
    carry(port, v, sub_map('bbox_head_2d', stacked_convs=2))
    got = port([nchw(f) for f in feats])
    for g, w in zip(got, want):
        for k in ('cls_score', 'bbox_pred', 'centerness'):
            np.testing.assert_allclose(g[k].detach().numpy(),
                                       np.asarray(w[k]), err_msg=k, **TOL)


def _assign_case():
    """Anchors of IMG_HW; gt 0 with its centre on a grid corner at the
    stride-4 level (four anchors tie in distance), gt 1 masked, gt 2
    large with a centre off its box's middle, gt 3 on a stride-8 line."""
    anchors = np.concatenate([
        JA.level_anchors(((IMG_HW[0] + s - 1) // s, (IMG_HW[1] + s - 1) // s),
                         s, 8.0) for s in (4, 8, 16, 32, 64)], 0)
    sizes = [((IMG_HW[0] + s - 1) // s) * ((IMG_HW[1] + s - 1) // s)
             for s in (4, 8, 16, 32, 64)]
    boxes = np.array([[10.0, 12.0, 30.0, 28.0], [40.0, 8.0, 70.0, 40.0],
                      [50.0, 20.0, 120.0, 60.0], [4.0, 30.0, 60.0, 50.0]],
                     np.float32)
    centers = np.array([[20.0, 20.0], [55.0, 24.0], [70.0, 44.0],
                        [32.0, 40.0]], np.float32)
    mask = np.array([True, False, True, True])
    return anchors, sizes, boxes, centers, mask


def test_atss_assign_matches_jax_exactly():
    anchors, sizes, boxes, centers, mask = _assign_case()
    want, want_iou = jax.jit(lambda b, c, m: JA.atss_assign(
        anchors, sizes, b, c, m, topk=9))(boxes, centers, mask)
    got, iou = A.atss_assign(torch.from_numpy(anchors), sizes,
                             torch.from_numpy(boxes),
                             torch.from_numpy(centers),
                             torch.from_numpy(mask), topk=9)
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assigned = set(got.numpy().tolist()) - {-1}
    assert {0, 2} <= assigned and 1 not in assigned, assigned
    # the tie: four stride-4 anchors at the same distance from gt 0
    d = np.linalg.norm((anchors[:sizes[0], :2] + anchors[:sizes[0], 2:]) / 2
                       - centers[0], axis=-1)
    assert np.sort(d)[3] == np.sort(d)[0]


def _atss_gt(b=2):
    rng = np.random.RandomState(4)
    boxes = np.array([[[10.0, 12.0, 30.0, 28.0], [40.0, 8.0, 70.0, 40.0],
                       [50.0, 20.0, 120.0, 60.0]],
                      [[5.0, 5.0, 60.0, 60.0], [70.0, 10.0, 100.0, 30.0],
                       [0.0, 0.0, 1.0, 1.0]]], np.float32)[:b]
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2 + rng.uniform(
        -3, 3, boxes[..., :2].shape).astype(np.float32)
    return dict(gt_bboxes2d=boxes, centers2d=ctr.astype(np.float32),
                gt_labels=np.array([[0, 1, 2], [2, 0, 1]], np.int32)[:b],
                gt_mask=np.array([[True, True, True],
                                  [True, True, False]])[:b])


@pytest.fixture(scope='module')
def atss_loss_pair():
    rng = np.random.RandomState(5)
    h, w = IMG_HW
    outs = [dict(cls_score=rng.randn(2, hh, ww, 3).astype(np.float32) - 2,
                 bbox_pred=rng.randn(2, hh, ww, 4).astype(np.float32) * 0.5,
                 centerness=rng.randn(2, hh, ww, 1).astype(np.float32))
            for hh, ww in [((h + s - 1) // s, (w + s - 1) // s)
                           for s in (4, 8, 16, 32, 64)]]
    gt = _atss_gt()
    cfg = JA.ATSS2DConfig(**ATSS)
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def jloss(o):
        return JA.atss2d_loss(o, IMG_HW, jgt, cfg)

    terms = ('loss_cls2d', 'loss_bbox2d', 'loss_centerness2d')
    want, want_grad = jax.jit(lambda o: (jloss(o), {
        k: jax.grad(lambda o, k=k: jloss(o)[k])(o) for k in terms}))(outs)
    want = {k: float(v) for k, v in want.items()}
    touts = [{k: torch.from_numpy(v).requires_grad_() for k, v in o.items()}
             for o in outs]
    got = A.atss2d_loss(touts, IMG_HW, {k: torch.from_numpy(v)
                                        for k, v in gt.items()},
                        A.ATSS2DConfig(**ATSS))
    return dict(want=want, want_grad=want_grad, got=got, touts=touts)


@pytest.mark.parametrize('term', ['loss_cls2d', 'loss_bbox2d',
                                  'loss_centerness2d'])
def test_atss2d_loss_and_gradient_match_jax(atss_loss_pair, term):
    pair = atss_loss_pair
    assert pair['want'][term] > 0
    np.testing.assert_allclose(float(pair['got'][term].detach()),
                               pair['want'][term],
                               rtol=1e-5)
    keys = ('cls_score', 'bbox_pred', 'centerness')
    grads = torch.autograd.grad(pair['got'][term], [
        o[k] for o in pair['touts'] for k in keys], retain_graph=True,
        allow_unused=True)
    wants = [np.asarray(o[k]) for o in pair['want_grad'][term] for k in keys]
    assert any(np.abs(w).max() > 0 for w in wants)
    for g, w in zip(grads, wants):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, atol=1e-7, rtol=1e-4)


def test_bce_and_giou_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(64).astype(np.float32) * 4
    tgt = rng.rand(64).astype(np.float32)
    wts = (rng.rand(64) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(L.binary_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(tgt),
                                     torch.from_numpy(wts), 7.0)),
        float(JL.binary_cross_entropy(logits, tgt, wts, 7.0)), rtol=1e-6)
    xy = rng.rand(2, 64, 2).astype(np.float32) * 50
    wh = rng.rand(2, 64, 2).astype(np.float32) * 30
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes[0, :4] = 0.0                  # zero-area pairs
    boxes[1, 4:8, 2:] = boxes[1, 4:8, :2] - 1.0     # inverted boxes
    np.testing.assert_allclose(
        float(L.giou_loss_2d(torch.from_numpy(boxes[0]),
                             torch.from_numpy(boxes[1]),
                             torch.from_numpy(wts), 5.0)),
        float(JL.giou_loss_2d(boxes[0], boxes[1], wts, 5.0)), rtol=1e-6)


def test_points_in_rotated_boxes_matches_jax_exactly():
    rng = np.random.RandomState(7)
    boxes = np.concatenate([rng.uniform(-10, 10, (6, 3)),
                            rng.uniform(1, 6, (6, 3)),
                            rng.uniform(-np.pi, np.pi, (6, 1))], 1)
    pts = rng.uniform(-14, 14, (4000, 2))
    # keep the points at least 1e-3 off every edge (float64 test)
    rel = pts[:, None] - boxes[None, :, :2]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    local = np.stack([rel[..., 0] * c - rel[..., 1] * s,
                      rel[..., 0] * s + rel[..., 1] * c], -1)
    margin = np.abs(np.abs(local) - boxes[None, :, 3:5] / 2).min(-1)
    pts = pts[(margin > 1e-3).all(1)].astype(np.float32)
    boxes = boxes.astype(np.float32)
    want = np.asarray(j_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))
    got = points_in_rotated_boxes_bev(torch.from_numpy(pts),
                                      torch.from_numpy(boxes)).numpy()
    assert 50 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


PCR = (0.0, -1.6, -0.8, 3.2, 1.6, 0.8)
VOX = (0.2, 0.2, 0.2)          # grid (8, 16, 16)


def _points(seed, n=600):
    """Points over 1.2x the range (some outside, some below it), a tenth
    masked, the last 200 crowded into four voxels."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array(PCR[:3]), np.array(PCR[3:])
    pts = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo),
                      (n, 3)).astype(np.float32)
    pts[-200:] = (lo + (np.array([3, 5, 2]) + 0.5) * 0.2 + rng.choice(
        [0.0, 0.2], (200, 3)) * 0.9).astype(np.float32)
    return pts, rng.rand(n) > 0.1


@pytest.mark.parametrize('max_points', [None, 2])
def test_voxelize_mean_matches_jax(max_points):
    pts, mask = _points(8)
    gs = (8, 16, 16)
    want_m, want_c = jax.jit(lambda p, m: JT.voxelize_mean(
        p, m, PCR, VOX, gs, max_points))(pts, mask)
    got_m, got_c = T.voxelize_mean(torch.from_numpy(pts),
                                   torch.from_numpy(mask), PCR, VOX, gs,
                                   max_points)
    want_c = np.asarray(want_c)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert want_c.max() > (2 if max_points is None else 1)
    if max_points:
        assert want_c.max() == max_points
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-6)


@pytest.mark.parametrize('train', [True, False])
def test_lidar_teacher_matches_jax(train):
    """A tiny grid (8, 16, 16), B = 2: the volume and BEV features, and in
    train mode the running statistics after the update."""
    pts = np.stack([_points(9)[0], _points(10)[0]])
    mask = np.stack([_points(9)[1], _points(10)[1]])
    kw = dict(point_cloud_range=PCR, voxel_size=VOX, volume_channels=8,
              bev_channels=16)
    jm = JT.LidarTeacher(**kw)
    v = init_vars(jm, 3, jnp.asarray(pts), jnp.asarray(mask))
    if train:
        (want_vol, want_bev), upd = jax.jit(lambda v, p, m: jm.apply(
            v, p, m, train=True, mutable=['batch_stats']))(
                v, jnp.asarray(pts), jnp.asarray(mask))
    else:
        want_vol, want_bev = jax.jit(jm.apply)(v, jnp.asarray(pts),
                                               jnp.asarray(mask))
    tol = TRAIN_BN_TOL if train else TOL
    port = T.LidarTeacher(PCR, VOX, volume_channels=8, bev_channels=16)
    port.load_state_dict(W.teacher_state_dict(v), strict=True)
    port.train(train)
    vol, bev = port(torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_allclose(vol.detach().numpy(), np.asarray(want_vol),
                               **tol)
    np.testing.assert_allclose(bev.detach().numpy(), np.asarray(want_bev),
                               **tol)
    assert (np.asarray(want_vol) == 0).any() and (np.asarray(want_vol) !=
                                                  0).any()
    if train:
        after = W.teacher_state_dict(dict(params=v['params'],
                                          batch_stats=upd['batch_stats']))
        stats = [k for k in after if k.endswith(('running_mean',
                                                 'running_var'))]
        assert len(stats) == 2 * (3 + 1 + 6)
        sd = port.state_dict()
        for k in stats:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(),
                                       err_msg=k, **tol)


@pytest.mark.parametrize('kind', ['bev', 'volume'])
def test_imitation_loss_and_gradient_match_jax(kind):
    rng = np.random.RandomState(11)
    ny, nx, c = 12, 10, 8
    shape = (2, ny, nx, c) if kind == 'bev' else (2, 3, ny, nx, c)
    student = rng.randn(*shape).astype(np.float32)
    teacher = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    teacher[..., 2:5, :] = 0.0         # cells without support
    xs, ys = np.linspace(0, 18, nx), np.linspace(-10, 10, ny)
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    centers = np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)
    boxes = np.array([[[6, 0, -1, 8, 5, 1.5, 0.4], [14, -5, -1, 4, 3, 1.5,
                                                    -1.1]],
                      [[9, 3, -1, 10, 6, 1.5, 2.0], [3, 3, -1, 1, 1, 1, 0]]],
                     np.float32)
    gmask = np.array([[True, True], [True, False]])

    def jloss(s):
        return j_imitation(s, jnp.asarray(teacher), jnp.asarray(centers),
                           jnp.asarray(boxes), jnp.asarray(gmask),
                           normalizer_clamp_value=2.0)

    want, want_grad = jax.jit(jax.value_and_grad(jloss))(student)
    st = torch.from_numpy(student).requires_grad_()
    got = imitation_loss(st, torch.from_numpy(teacher),
                         torch.from_numpy(centers), torch.from_numpy(boxes),
                         torch.from_numpy(gmask), normalizer_clamp_value=2.0)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad),
                               atol=1e-9, rtol=1e-4)
