"""The port's training pieces against the JAX package, one by one:
box encode, 3D IoU, anchor assignment and targets, the detection
losses, the anchor head's loss, the depth loss, the LIGA schedule, the
clip + AdamW update against optax, and BatchNorm in train mode against
flax. Same seed-made numpy inputs on both sides; each test states its
tolerance. Values and gradients are compared (the gradient through
`torch.autograd` against `jax.grad`), and every case with padded or
absent gts checks that the gradients are finite.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfm_tpu.core import coders as JC
from dfm_tpu.core import iou as JI
from dfm_tpu.core import losses as JL
from dfm_tpu.core import targets as JT
from dfm_tpu.models.detectors.dfm import DfMConfig as JConfig
from dfm_tpu.models.detectors.dfm import _anchors_per_class
from dfm_tpu.models.heads.anchor3d_head import anchor3d_head_loss as j_head_loss
from dfm_tpu.models.heads.depth_head import depth_distribution_loss as j_depth
from dfm_tpu.runtime.schedule import liga_schedule as j_schedule
from dfm_tpu.runtime.train import make_optimizer as j_make_optimizer
from dfm_tpu_torch.core import coders as PC
from dfm_tpu_torch.core import iou as PI
from dfm_tpu_torch.core import losses as PL
from dfm_tpu_torch.core import targets as PT
from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
from dfm_tpu_torch.models.heads.anchor3d_head import anchor3d_head_loss
from dfm_tpu_torch.models.heads.depth_head import (LOSS_TYPES,
                                                   depth_distribution_loss)
from dfm_tpu_torch.models.layers import BatchNorm
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import (clip_by_global_norm, global_norm,
                                         make_optimizer)

TINY = dict(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5))
NY = NX = 16
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# gradients through the rotated-polygon clip (iou3d_loss and the head's
# loss_iou): near-parallel edges make them sensitive to the order of the
# float32 operations; JAX's jit and its own eager run of the same pairs
# differ by up to 4.1e-4 (the iou3d_loss case below), the port against
# the jit by up to 8.5e-5
IOU_GRAD_TOL = dict(rtol=1e-4, atol=5e-4)


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def boxes(rng, n, spread=1.0):
    """(n, 7) LiDAR boxes with positive sizes."""
    b = np.concatenate([rng.uniform(0, 40, (n, 1)),
                        rng.uniform(-10, 10, (n, 1)),
                        rng.uniform(-2, 0, (n, 1)),
                        rng.uniform(0.5, 4, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1)) * spread], 1)
    return b.astype(np.float32)


def test_delta_encode_matches_jax():
    rng = np.random.default_rng(0)
    a, g = boxes(rng, 50), boxes(rng, 50)
    np.testing.assert_allclose(PC.delta_xyzwlhr_encode(t(a), t(g)).numpy(),
                               np.asarray(JC.delta_xyzwlhr_encode(a, g)),
                               **VAL_TOL)


def test_rotated_iou_3d_and_nearest_bev_iou_match_jax():
    rng = np.random.default_rng(1)
    b1, b2 = boxes(rng, 12), boxes(rng, 9)
    b2[:4] = b1[:4] + rng.normal(0, 0.3, (4, 7)).astype(np.float32)
    # eager: XLA's fused jit of the polygon clip differs from JAX's own
    # op-by-op run by up to 3.6e-4 on these pairs (float32 order)
    iou3d = np.asarray(JI.rotated_iou_3d(b1, b2))
    np.testing.assert_allclose(PI.rotated_iou_3d(t(b1), t(b2)).numpy(),
                               iou3d, atol=1e-5)
    np.testing.assert_allclose(PI.nearest_bev_iou(t(b1), t(b2)).numpy(),
                               np.asarray(jax.jit(JI.nearest_bev_iou)(
                                   b1, b2)), atol=1e-6)
    # the paired form is the diagonal of the pairwise one
    np.testing.assert_allclose(PI.paired_iou_3d(t(b1[:9]), t(b2)).numpy(),
                               np.diag(iou3d[:9]), atol=1e-5)


def _cls_anchors(cfg_cls=JConfig):
    per_class, _ = _anchors_per_class(cfg_cls(**TINY), (NY, NX))
    return [np.asarray(a) for a in per_class]


def _gts(kind):
    """(B, G, 7) gt boxes on anchors of the three classes, labels, mask.
    kind: 'several' (classes 0-2, padded rows), 'zero_pos' (valid gts
    far from every anchor), 'all_pad' (every row padding)."""
    anchors = _cls_anchors()
    b, g = 2, 5
    gt = np.zeros((b, g, 7), np.float32)
    lab = np.zeros((b, g), np.int64)
    mask = np.zeros((b, g), bool)
    if kind == 'several':
        for i, (c, k) in enumerate([(0, 37), (1, 100), (2, 301), (0, 38)]):
            gt[i % 2, i // 2] = anchors[c][k]
            lab[i % 2, i // 2] = c
            mask[i % 2, i // 2] = True
        gt[0, 3] = (25.0, 3.0, -1.0, 3.5, 1.5, 1.5, 0.1)   # padded row
    elif kind == 'zero_pos':
        gt[:, 0] = (500.0, 500.0, -1.0, 3.9, 1.6, 1.56, 0.0)
        mask[:, 0] = True
    return gt, lab, mask


@pytest.mark.parametrize('kind', ['several', 'zero_pos', 'all_pad'])
def test_max_iou_assign_and_targets_match_jax(kind):
    gt, lab, mask = _gts(kind)
    anchors = _cls_anchors()
    cfgs = JConfig().assigner_cfgs
    for c in range(3):
        for i in range(gt.shape[0]):
            m = mask[i] & (lab[i] == c)
            ov = np.asarray(JI.nearest_bev_iou(gt[i], anchors[c]))
            want = np.asarray(JT.max_iou_assign(
                ov, m, cfgs[c]['pos_iou_thr'], cfgs[c]['neg_iou_thr'],
                cfgs[c]['min_pos_iou']))
            got = PT.max_iou_assign(t(ov), t(m), cfgs[c]['pos_iou_thr'],
                                    cfgs[c]['neg_iou_thr'],
                                    cfgs[c]['min_pos_iou'])
            np.testing.assert_array_equal(got.numpy(), want)
            jt = JT.anchor_targets_single_class(
                anchors[c], gt[i], m, cfgs[c]['pos_iou_thr'],
                cfgs[c]['neg_iou_thr'], cfgs[c]['min_pos_iou'], c, 3)
            pt = PT.anchor_targets_single_class(
                t(anchors[c]), t(gt[i]), t(m), cfgs[c]['pos_iou_thr'],
                cfgs[c]['neg_iou_thr'], cfgs[c]['min_pos_iou'], c, 3)
            for k in jt:
                np.testing.assert_allclose(
                    pt[k].numpy().astype(np.float64),
                    np.asarray(jt[k]).astype(np.float64), atol=1e-6,
                    err_msg=f'{kind} class {c} sample {i} {k}')
            if kind == 'several' and m.any():
                assert pt['pos_mask'].any()


def _head_preds(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, (2, NY, NX, 6 * k)).astype(np.float32)
            for s, k in ((1.0, 3), (0.2, 7), (1.0, 2))]


_JAX_HEAD = {}


def _jax_head_loss(jcfg):
    """jit of JAX's head loss and its gradient in the predictions, the gts
    as arguments (one compile for every case)."""
    if 'fn' not in _JAX_HEAD:
        janchors, _ = _anchors_per_class(jcfg, (NY, NX))

        def total(p, gt, lab, mask):
            terms = j_head_loss(tuple(p), janchors, gt, lab, mask,
                                list(jcfg.assigner_cfgs), num_classes=3)
            return sum(terms.values()), terms

        _JAX_HEAD['fn'] = jax.jit(jax.value_and_grad(total, has_aux=True))
    return _JAX_HEAD['fn']


@pytest.mark.parametrize('kind', ['several', 'zero_pos', 'all_pad'])
def test_anchor3d_head_loss_matches_jax(kind):
    """Values and gradients (rtol 1e-4) of every term; finite gradients
    with padded rows, zero positives and an all-padding batch."""
    gt, lab, mask = _gts(kind)
    preds = _head_preds(2)
    jcfg = JConfig(**TINY)

    terms = ('loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou')
    (_, want), jg = _jax_head_loss(jcfg)(
        [jnp.asarray(p) for p in preds], gt, lab, mask)
    want = {k: float(v) for k, v in want.items()}
    port = DfM(DfMConfig(**TINY))
    tp = [t(p, grad=True) for p in preds]
    got = anchor3d_head_loss(tuple(tp), port.anchors_per_class(
        (NY, NX), 'cpu'), t(gt), t(lab), t(mask),
        list(DfMConfig().assigner_cfgs), num_classes=3, dist_norm=True)
    for k in terms:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if kind == 'several':
        assert want['loss_bbox'] > 0 and want['loss_iou'] > 0
    else:
        assert want['loss_bbox'] == 0 and float(got['loss_bbox']) == 0
    sum(got.values()).backward()
    for p, g, tol in zip(tp, jg, (GRAD_TOL, IOU_GRAD_TOL, GRAD_TOL)):
        assert torch.isfinite(p.grad).all()
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), **tol)


def test_losses_match_jax():
    """The four losses and their gradients, with weights and
    avg_factor; iou3d_loss with a degenerate non-positive pair that the
    hard select must keep out."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (40, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 40)
    w = (rng.random(40) > 0.2).astype(np.float32)
    pred = rng.normal(0, 1, (40, 7)).astype(np.float32)
    tgt = pred + rng.normal(0, 0.2, (40, 7)).astype(np.float32)
    dl = rng.normal(0, 1, (40, 2)).astype(np.float32)
    dt = rng.integers(0, 2, 40)
    pb = boxes(rng, 20)
    tb = pb + rng.normal(0, 0.2, pb.shape).astype(np.float32)
    tb[:, 3:6] = np.abs(tb[:, 3:6])
    pb[0] = tb[0]                              # identical pair
    iw = np.ones(20, np.float32)
    iw[0] = 0.0
    cases = [
        (PL.sigmoid_focal_loss, JL.sigmoid_focal_loss, (logits, labels, w),
         dict(avg_factor=7.0)),
        (PL.smooth_l1_loss, JL.smooth_l1_loss, (pred, tgt, w[:, None]),
         dict(avg_factor=5.0)),
        (PL.softmax_cross_entropy, JL.softmax_cross_entropy, (dl, dt, w),
         dict(avg_factor=3.0)),
        (PL.iou3d_loss, JL.iou3d_loss, (pb, tb, iw), dict(avg_factor=4.0)),
    ]
    for pfn, jfn, (x, *rest), kw in cases:
        want, jg = jax.jit(jax.value_and_grad(
            lambda a: jfn(a, *rest, **kw)))(jnp.asarray(x))
        tx = t(x, grad=True)
        got = pfn(tx, *[t(r) for r in rest], **kw)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   err_msg=pfn.__name__)
        assert torch.isfinite(tx.grad).all(), pfn.__name__
        np.testing.assert_allclose(
            tx.grad.numpy(), np.asarray(jg), err_msg=pfn.__name__,
            **(IOU_GRAD_TOL if pfn is PL.iou3d_loss else GRAD_TOL))


def _depth_inputs(seed, empty_second=False):
    rng = np.random.default_rng(seed)
    b, d, h, w = 2, 12, 6, 10
    cost = rng.normal(0, 1, (b, d, h, w)).astype(np.float32)
    depth = np.where(rng.random((b, 4 * h, 4 * w)) < 0.3,
                     rng.uniform(1, 65, (b, 4 * h, 4 * w)), 0).astype(
                         np.float32)
    if empty_second:
        depth[1] = 0
    fg = (rng.random((b, 4 * h, 4 * w)) < 0.3).astype(np.int32)
    return cost, depth, fg


@pytest.mark.parametrize('loss_type', LOSS_TYPES)
def test_depth_loss_matches_jax_with_its_draws(loss_type):
    """Each loss type JAX implements, at JAX's own pixel draws
    (`jax.random.choice` under the same key), with a second image that
    has no valid depth pixel in one case; values rtol 1e-5, gradients
    of the cost rtol 1e-4."""
    cost, depth, fg = _depth_inputs(4, empty_second=loss_type == 'focal')
    cfg = dict(type=loss_type, loss_weight=1.5, fg_weight=5, bg_weight=1,
               alpha=1, gamma=2, sigma=1.5)
    ds = np.asarray(JConfig(depth_num_bins=48).depth_samples())
    key = jax.random.PRNGKey(7)
    n = 64
    args = dict(up_factor=4, num_sample_pixels=n, depth_min=2.0,
                depth_max=59.6)
    want, jg = jax.value_and_grad(lambda c: j_depth(
        c, depth, fg, jnp.asarray(ds), key, cfg, **args))(jnp.asarray(cost))
    valid = ((depth > 2.0) & (depth < 59.6)).reshape(2, -1)
    keys = jax.random.split(key, 2)
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], valid.shape[1], (n,), replace=True,
        p=jnp.asarray(valid[i] / max(valid[i].sum(), 1), jnp.float32)))
        for i in range(2)])
    tc = t(cost, grad=True)
    got = depth_distribution_loss(tc, t(depth), t(fg), t(ds), cfg,
                                  pix_idx=t(pix), **args)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert torch.isfinite(tc.grad).all()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg), **GRAD_TOL)


def test_depth_loss_draws_valid_pixels_from_the_generator():
    cost, depth, fg = _depth_inputs(5)
    ds = t(JConfig(depth_num_bins=48).depth_samples())
    cfg = dict(type='balanced_focal')
    losses = [float(depth_distribution_loss(
        t(cost), t(depth), t(fg), ds, cfg, num_sample_pixels=32,
        generator=torch.Generator().manual_seed(s))) for s in (0, 0, 1)]
    assert losses[0] == losses[1] != losses[2]
    from dfm_tpu_torch.models.heads.depth_head import sample_depth_pixels
    idx = sample_depth_pixels(t(depth), 500, torch.Generator().manual_seed(2))
    flat = depth.reshape(2, -1)
    picked = np.take_along_axis(flat, idx.numpy(), 1)
    assert ((picked > 2.0) & (picked < 59.6)).all()


def test_liga_schedule_matches_jax():
    kw = dict(base_lr=1e-3, warmup_iters=464, warmup_ratio=0.1,
              decay_steps=(1000, 1500), gamma=0.1)
    ours, theirs = liga_schedule(**kw), j_schedule(**kw)
    for count in (0, 1, 2, 463, 464, 465, 999, 1000, 1001, 1499, 1500, 2000):
        np.testing.assert_allclose(ours(count), float(theirs(count)),
                                   rtol=1e-7, err_msg=str(count))


class _Tree(torch.nn.Module):
    """A small parameter tree: 'a' (trained) and 'lidar_teacher'."""

    def __init__(self, params):
        super().__init__()
        self.a = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(t(v)) for k, v in params['a'].items()})
        self.lidar_teacher = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(t(v))
             for k, v in params['lidar_teacher'].items()})


@pytest.mark.parametrize('scale', [0.01, 100.0])
def test_two_updates_match_optax(scale):
    """Two updates (clip at 35, then AdamW under the schedule) on a small
    tree with a frozen prefix, against optax's `make_optimizer`: the
    trained leaves within 1e-6, the frozen ones unchanged. scale 100
    takes the gradient norm over 35, so the clip acts."""
    rng = np.random.default_rng(8)
    params = {'a': {'w': rng.normal(0, 1, (5, 4)).astype(np.float32),
                    'b': rng.normal(0, 1, (4,)).astype(np.float32)},
              'lidar_teacher': {'k': rng.normal(0, 1, (3,)).astype(
                  np.float32)}}
    grads = [jax.tree.map(lambda x: (rng.normal(0, scale, x.shape)).astype(
        np.float32), params) for _ in range(2)]
    sched_kw = dict(base_lr=1e-2, warmup_iters=3, warmup_ratio=0.1)
    tx = j_make_optimizer(j_schedule(**sched_kw), 1e-4, 35.0,
                          frozen_prefixes=('lidar_teacher',))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    model = _Tree(params)
    opt = make_optimizer(model, 1e-4, frozen_prefixes=('lidar_teacher',))
    sched = liga_schedule(**sched_kw)
    trained = list(opt.param_groups[0]['params'])
    norms = []
    for count, g in enumerate(grads):
        for name, p in model.named_parameters():
            top, leaf = name.split('.')
            p.grad = t(g[top][leaf])
        norms.append(float(global_norm([p.grad for p in trained])))
        clip_by_global_norm([p.grad for p in trained], 35.0)
        for group in opt.param_groups:
            group['lr'] = sched(count)
        opt.step()
    assert (max(norms) > 35) == (scale > 1)
    for name, p in model.named_parameters():
        top, leaf = name.split('.')
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[top][leaf]), atol=1e-6,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(model.lidar_teacher['k'].detach().numpy(),
                                  params['lidar_teacher']['k'])


def test_batchnorm_train_matches_flax():
    """One train-mode call: the output (atol 1e-5) and the updated
    running mean / var (flax's batch_stats: momentum 0.9, the biased
    variance; atol 1e-6)."""
    rng = np.random.default_rng(9)
    x = (rng.normal(2.0, 3.0, (4, 5, 6, 8))).astype(np.float32)   # NHWC
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    scale = rng.normal(1, 0.2, 8).astype(np.float32)
    bias = rng.normal(0, 0.2, 8).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    v = {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': mean0, 'var': var0}}
    y, upd = bn.apply(v, x, mutable=['batch_stats'])
    port = BatchNorm(8).train()
    with torch.no_grad():
        port.weight.copy_(t(scale))
        port.bias.copy_(t(bias))
        port.running_mean.copy_(t(mean0))
        port.running_var.copy_(t(var0))
    out = port(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd['batch_stats']['mean']),
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd['batch_stats']['var']),
                               atol=1e-6)
    port.eval()
    y_eval = nn.BatchNorm(use_running_average=True, momentum=0.9,
                          epsilon=1e-5).apply(
        {'params': v['params'], 'batch_stats': upd['batch_stats']}, x)
    np.testing.assert_allclose(
        port(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy(),
        np.asarray(y_eval), atol=1e-5)
