"""One DfM training step of the port against the JAX package's
`make_train_step` (tiny config, float32, B = 2 with the augmented meta).

The weights are seeded random values carried over with
`state_dict_from_jax`; the batch places gt boxes of all three classes on
anchors (so the head loss has positives), with padded gt rows, a sparse
depth map and a foreground mask; the depth loss takes JAX's own pixel
draws (`jax.random.choice` under the step's key). JAX's step is the
package's `make_train_step` with `make_optimizer` (clip 35, AdamW, the
LIGA schedule), its raw gradients read back through a pass-through
transformation chained in front. Compared, in the banded and the dense
form of the port: every loss term (rtol 2e-4); every parameter's
gradient by relative L2: 1e-4 for the layers after the voxel lifting
(voxel ConvNorm, BEV hourglass, head), 2e-2 for every parameter, and
2e-3 for the whole gradient vector. The 2e-2 is the conditioning of the
float32 gradients of the 2D trunk and the depth predictors at this size
(BatchNorm and GroupNorm statistics over a few pixels): one ulp of
relative noise on the weights alone moves such gradients by as much as
their gap to JAX (chip_smoke.py phase 7 measures it at the tiny config
in every run: the whole gradient of its training sample moves by about
1e-2); the parameters after the update, each
element within what its two gradients explain of the first AdamW
update, + 2e-6; and the BatchNorm running statistics (atol 1e-5).

As in tests/test_torch_dfm.py, the JAX neck is made to build its fine
depth-softmax volume in float32 (the port's float32 behaviour;
`test_torch_dfm.py::test_slice_matches_jax_bf16_fine_volume` holds the
port to JAX's bf16 volume at the slice tolerance), and
PyTorch's oneDNN convolutions are off (at batch 2 they sum in another
order).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dfm_tpu.ops.frustum_separable as JFS
from dfm_tpu.models import BatchMeta as JMeta
from dfm_tpu.models import DfM as JDfM
from dfm_tpu.models import DfMConfig as JConfig
from dfm_tpu.models.detectors.dfm import dfm_loss as jax_dfm_loss
from dfm_tpu.runtime.schedule import liga_schedule as jax_schedule
from dfm_tpu.runtime.train import (create_train_state, make_optimizer as
                                   jax_make_optimizer, make_train_step)
from dfm_tpu_torch.models.detectors.dfm import BatchMeta, DfM, DfMConfig
from dfm_tpu_torch.runtime.schedule import liga_schedule
from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
from dfm_tpu_torch.utils import weights as W

from test_torch_dfm import TINY, H, W_, _augmented_meta_b2

B, G = 2, 6
LR = dict(base_lr=1e-3, warmup_iters=4, warmup_ratio=0.1)
LOSS_RTOL = 2e-4
GRAD_REL_L2 = 2e-2          # any parameter
GRAD_REL_L2_ALL = 2e-3      # the whole gradient vector
GRAD_REL_L2_LIFTED = 1e-4   # the layers after the voxel lifting
LIFTED = ('feature_transformation.', 'backbone_3d.', 'bbox_head_3d.')
PARAM_ATOL = 2e-6
STATS_ATOL = 1e-5


def random_variables(tree, seed):
    """Seeded values for a flax variables tree of shapes: kernels
    lecun-scaled, norm scales near 1, biases / means small, variances in
    [0.5, 1.5) (the rules of test_torch_layers.randomize)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = tuple(x.shape)
        if name == 'var':
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        if name == 'scale':
            return (1 + 0.3 * rng.randn(*shape)).astype(np.float32)
        if name in ('bias', 'mean'):
            return (0.3 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def gt_on_anchors(cfg, ny, nx):
    """(B, G, 7) boxes on anchors of each class, labels, mask: sample 0
    has a car, a pedestrian and a cyclist and padded rows, sample 1 two
    cars (one at rotation pi/2)."""
    grid = cfg.anchor_generator().grid_anchors((ny, nx))   # (1,Ny,Nx,S,R,7)
    boxes = np.zeros((B, G, 7), np.float32)
    labels = np.zeros((B, G), np.int64)
    mask = np.zeros((B, G), bool)
    picks = [[(0, 5, 9, 0), (1, 8, 3, 1), (2, 11, 12, 0)],
             [(0, 4, 6, 1), (0, 12, 10, 0)]]
    for b, rows in enumerate(picks):
        for g, (c, iy, ix, r) in enumerate(rows):
            boxes[b, g] = grid[0, iy, ix, c, r]
            labels[b, g] = c
            mask[b, g] = True
    boxes[0, 4] = (30.0, 1.0, -1.0, 4.0, 1.7, 1.5, 0.2)   # padded row
    return boxes, labels, mask


def depth_maps(seed):
    rng = np.random.RandomState(seed)
    depth = np.where(rng.rand(B, H, W_) < 0.3,
                     rng.uniform(1.0, 65.0, (B, H, W_)), 0).astype(np.float32)
    fg = (rng.rand(B, H, W_) < 0.2).astype(np.int32) * 2
    return depth, fg


class RecordGrads:
    """An optax transformation that passes the updates on and keeps them
    in its state: chained first, the raw gradients of the step."""

    @staticmethod
    def make():
        return optax.GradientTransformation(
            lambda params: jax.tree.map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope='module')
def step_pair():
    cfg = JConfig(**TINY)
    img = np.random.RandomState(5).randn(B, 2, H, W_, 3).astype(np.float32)
    m = _augmented_meta_b2()
    jmeta = JMeta(**{k: jnp.asarray(v) for k, v in m.items()})
    model = JDfM(cfg=cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(img), jmeta,
                           train=False))
    variables = random_variables(shapes, 1)
    tx = optax.chain(RecordGrads.make(),
                     jax_make_optimizer(jax_schedule(**LR)))
    state = create_train_state(variables, tx)
    boxes, labels, mask = gt_on_anchors(cfg, 16, 16)
    depth, fg = depth_maps(6)
    batch = dict(img=jnp.asarray(img), meta=jmeta,
                 gt_boxes=jnp.asarray(boxes), gt_labels=jnp.asarray(labels),
                 gt_mask=jnp.asarray(mask), depth_img=jnp.asarray(depth),
                 depth_fgmask_img=jnp.asarray(fg))
    key = jax.random.PRNGKey(3)
    orig = JFS.build_fine_softmax_volume

    def fine_f32(*a, **kw):
        kw['dtype'] = jnp.float32
        return orig(*a, **kw)

    step = make_train_step(model, lambda o, b, r: jax_dfm_loss(o, b, cfg, r),
                           donate=False)
    with mock.patch.object(JFS, 'build_fine_softmax_volume', fine_f32):
        new_state, metrics = step(state, batch, key)
    # JAX's depth-pixel draws under the step's key (dfm_loss ->
    # depth_distribution_loss: one key per sample of `rng`)
    valid = ((depth > cfg.depth_min) & (depth < cfg.depth_max)).reshape(B, -1)
    keys = jax.random.split(key, B)
    pix = np.stack([np.asarray(jax.random.choice(
        keys[i], H * W_, (cfg.num_depth_sample_pixels,), replace=True,
        p=jnp.asarray(valid[i] / valid[i].sum(), jnp.float32)))
        for i in range(B)])
    sd = W.state_dict_from_jax(variables)
    return dict(
        img=img, meta=m, sd=sd, pix=pix, boxes=boxes, labels=labels,
        mask=mask, depth=depth, fg=fg,
        metrics={k: float(v) for k, v in metrics.items()},
        grads=W.state_dict_from_jax({'params': jax.device_get(
            new_state.opt_state[0]), 'batch_stats': variables[
                'batch_stats']}),
        after=W.state_dict_from_jax(jax.device_get(
            {'params': new_state.params,
             'batch_stats': new_state.batch_stats})),
        port={})


FORMS = dict(banded={}, dense=dict(use_band=False, packed=False))


def port_step(pair, form):
    if form not in pair['port']:
        model = DfM(DfMConfig(**TINY), **FORMS[form])
        model.load_state_dict(pair['sd'], strict=True)
        opt = make_optimizer(model)
        step = TrainStep(model, opt, liga_schedule(**LR))
        meta = BatchMeta(**{k: torch.from_numpy(v)
                            for k, v in pair['meta'].items()})
        gt = dict(gt_boxes=torch.from_numpy(pair['boxes']),
                  gt_labels=torch.from_numpy(pair['labels']),
                  gt_mask=torch.from_numpy(pair['mask']),
                  depth_img=torch.from_numpy(pair['depth']),
                  depth_fgmask_img=torch.from_numpy(pair['fg']))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)       # small ops; the suite's workers share cores
        with torch.backends.mkldnn.flags(enabled=False):
            total, losses = step.forward(
                torch.from_numpy(pair['img']), meta, gt,
                depth_pix_idx=torch.from_numpy(pair['pix']))
            step.backward(total)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        norm = step.update()
        torch.set_num_threads(threads)
        pair['port'][form] = dict(
            metrics=dict(loss=float(total.detach()), grad_norm=float(norm),
                         **{k: float(v.detach()) for k, v in losses.items()}),
            grads=grads, after=model.state_dict())
    return pair['port'][form]


TERMS = ['loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
         'loss_dense_depth', 'grad_norm']


@pytest.mark.parametrize('form', list(FORMS))
@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_jax(step_pair, form, term):
    got = port_step(step_pair, form)['metrics'][term]
    want = step_pair['metrics'][term]
    if term in ('loss_bbox', 'loss_iou', 'loss_dir'):
        assert want > 0, f'{term}: the batch has no positive anchor'
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize('form', list(FORMS))
def test_gradients_match_jax(step_pair, form):
    got = port_step(step_pair, form)['grads']
    assert set(got) <= set(step_pair['grads'])
    rel, flat_g, flat_w = {}, [], []
    for name, g in got.items():
        g = g.numpy()
        want = step_pair['grads'][name].numpy()
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
    # the trunks ahead of the cost get their gradients (the attention's
    # stop_gradient cuts only its own path)
    for prefix in ('backbone_stereo.dres0.', 'backbone_stereo.pred_mono.',
                   'backbone_stereo.hg_stereo.', 'neck.', 'backbone.'):
        assert any(k.startswith(prefix) and np.linalg.norm(
            step_pair['grads'][k].numpy()) > 0 for k in got), prefix


@pytest.mark.parametrize('form', list(FORMS))
def test_parameters_and_batch_stats_after_step(step_pair, form):
    """The first AdamW update moves a parameter by lr * g / (|g| + eps)
    (+ the decay, the same on both sides), g after the clip at norm 35,
    so each element may differ from JAX's by what its two gradients
    explain, lr0 * |g / (|g| + eps) - g_jax / (|g_jax| + eps)| (one
    whole update where their signs
    differ, a few per cent of one where |g| is a few eps), + PARAM_ATOL;
    elements whose gradients differ in sign must be rare (at most 1e-3 of
    them). The gradients themselves are bounded by
    `test_gradients_match_jax`."""
    port = port_step(step_pair, form)
    got = port['after']
    lr0 = liga_schedule(**LR)(0)
    clip = min(1.0, 35.0 / port['metrics']['grad_norm'])
    clip_jax = min(1.0, 35.0 / step_pair['metrics']['grad_norm'])
    flips = total = 0
    for name, t in got.items():
        want = step_pair['after'][name].numpy()
        if name.endswith(('running_mean', 'running_var')):
            atol = STATS_ATOL
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
    moved = [n for n in got if n.endswith('running_var') and not np.allclose(
        got[n].numpy(), step_pair['sd'][n].numpy())]
    assert moved, 'no BatchNorm running_var moved in train mode'
