"""ImVoteNet with its image branch in train mode against the JAX package,
on the CPU (apart from tests/test_torch_imvotenet.py so that each file
stays within a minute on one worker).

The small heads of tests/test_torch_imvotenet.py (16 proposals, 4
classes, 3 heading bins; the fixed SSG backbone; the image branch's
ResNet-18 + 64-channel FPN + one-conv ATSS head at 16 slots) on one
sample of 2,500 points, a 50 x 70 image and a 4 x 4 depth2img:

* the train-mode forward of the shipped form (`freeze_img_branch`)
  against JAX's float64 one (the branch reads the raw 0-255 image, and
  float32 rounding of its batch statistics moves the decoded boxes):
  the branch alone gives the same decoded (1, 16, 6) slots (classes and
  order equal in both packages and precisions), the whole model's
  towers (seeds equal) and every BatchNorm's statistics after it, the
  branch's too; the port's float64 forward within F64_REL 1e-6 relative
  L2 of JAX's, its float32 forward within OUT_REL 1e-5 or as far as
  JAX's own float32 forward lies;
* one training step of the shipped form (the train-mode boxes fused, no
  gradient into the branch, which JAX's AdamW and the port decay all
  the same) against JAX's float64 `make_train_step` by
  `torch_lidar_common.check_step` with `f64` and `probe`, as the step
  without the branch: measured worst parameter 1.25e-2, whole vector
  1.04e-2 (JAX's own float32 step 5.3e-2 and 3.8e-2). Two leaves lie
  beyond check_step's float32 limits in both packages and are named in
  its `rounding`, where the port's float32 step may lie no farther than
  JAX's own: `backbone.sa0.mlp0.weight`'s gradient (the port's 2.16e-2,
  JAX's 5.89e-2, GRAD_REL_L2 2e-2) and the branch's first BatchNorm's
  running variance (values up to 749 from the raw image: the port's
  largest error 9.8e-4, JAX's 9.8e-3, STATS_ATOL 1e-5).

The stage-1 form (`freeze_img_branch=False`, the ATSS 2D loss's gradient
through the branch) is compared on its loss terms only
(tests/test_torch_imvotenet.py): the 2D loss runs in float32 in both
packages, in their float64 steps too, so that the two float64 steps'
branch gradients agree to 1.7e-5 (the FPN's extra convs), not to the
1e-6 that check_step asks of them (ROADMAP.md §3).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.imvotenet as JI
from dfm_tpu.models.backbones.liga_resnet import LIGAResNet as JLIGA
from dfm_tpu.models.heads import atss2d as JA
from dfm_tpu.models.necks.fpn import FPN as JFPN
from dfm_tpu_torch.models.detectors.imvotenet import (ImVoteNet,
                                                      ImVoteNetConfig)
from dfm_tpu_torch.runtime.adapters import imvotenet_to_device
from dfm_tpu_torch.utils import weights as W

from test_torch_imvotenet import (COMPILE, IMG_HW, TINY, boxes2d, depth2img,
                                  gt_near, image, scene)
from test_torch_train_step import random_variables
from torch_lidar_common import _to64, check_step, jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

OUT_REL = 1e-5
F64_REL = 1e-6


@pytest.fixture(scope='module')
def frozen():
    """The shipped form's JAX module, seeded variables, key map and port
    state dict on one sample."""
    kw = dict(TINY, with_img_branch=True, freeze_img_branch=True)
    jcfg, cfg = JI.ImVoteNetConfig(**kw), ImVoteNetConfig(**kw)
    jm = JI.ImVoteNet(cfg=jcfg)
    args = [x[:1] for x in (scene(0), image(1), boxes2d(2), depth2img(4))]
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *args)), 1)
    key_map = W.imvotenet_key_map(cfg)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, args=args, variables=variables,
                key_map=key_map, sd=W.state_dict_from_jax(variables,
                                                          key_map))


def _sub(variables, name):
    return {c: variables[c][name] for c in ('params', 'batch_stats')
            if name in variables.get(c, {})}


def _train_forward(m, f64):
    """The train-mode forward of the frozen form in float64 (`f64`) or
    float32 -> for JAX and the port: dict of the branch's decoded slots
    (alone), each tower's outputs and every BatchNorm's statistics after
    it (the port's keys)."""
    dtype = jnp.float64 if f64 else jnp.float32
    v = jax.tree.map(_to64, m['variables']) if f64 else m['variables']
    args = [_to64(x) if f64 else x for x in m['args']]
    acfg = JA.ATSS2DConfig(num_classes=4, in_channels=64, feat_channels=64,
                           stacked_convs=1, strides=(8, 16, 32, 64, 128))

    def branch(x):
        def train(module, name, *a):
            return module.apply(_sub(v, name), *a, True,
                                mutable=['batch_stats'])[0]
        feats = train(JLIGA(
            depth=18, strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
            num_channels_factor=(1, 2, 4, 8), out_indices=(1, 2, 3),
            with_max_pool=True, norm='bn', dtype=dtype), 'img_backbone', x)
        fpn = train(JFPN(out_channels=64, num_outs=5, dtype=dtype),
                    'img_neck', feats)
        head = train(JA.ATSS2DHead(cfg=acfg, dtype=dtype), 'img_bbox_head',
                     fpn)
        return JA.atss2d_decode(head, IMG_HW, acfg, 16)

    with jax.enable_x64(f64):
        slots = np.asarray(jax.jit(branch)(args[1]))
        out, upd = jax_apply(JI.ImVoteNet(cfg=m['jcfg'], dtype=dtype), v,
                             args, True)
    after = W.state_dict_from_jax(dict(params=v['params'], **upd),
                                  m['key_map'])
    want = dict(slots=slots, **{
        f'{tower}.{k}': out[tower][k] for tower in out
        for k in ('seed_xyz', 'vote_xyz', 'centers', 'raw')}, **{
        n: x.numpy() for n, x in after.items()
        if n.endswith(('running_mean', 'running_var'))})
    tdtype = torch.float64 if f64 else torch.float32
    port = ImVoteNet(m['cfg'], dtype=tdtype).to(tdtype)
    port.load_state_dict(m['sd'])
    port.train()
    with torch.no_grad():
        pout = port(*[t(x) for x in args[:1]], None,
                    *[t(x) for x in args[1:]])
        sd = {n: x.clone() for n, x in port.state_dict().items()}
        _, pslots = port.image_branch(t(args[1]))
    got = dict(slots=pslots.numpy(), **{
        f'{tower}.{k}': pout[tower][k].numpy() for tower in pout
        for k in ('seed_xyz', 'vote_xyz', 'centers', 'raw')}, **{
        n: sd[n].numpy() for n in want if n.endswith(
            ('running_mean', 'running_var'))})
    return want, got


def test_branch_train_forward_matches_jax(frozen):
    """JAX's float64 train-mode forward is the reference (the branch reads
    the raw 0-255 image: float32 rounding of its batch statistics moves
    the decoded boxes, and through the fusion the joint and image
    towers): the port's float64 forward within F64_REL of it, the port's
    float32 forward within OUT_REL or as far as JAX's own float32 forward
    lies; the slots' classes and order, and the seeds, equal in all
    four."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        f64 = pool.submit(_train_forward, frozen, True)
        jax32, port32 = _train_forward(frozen, False)
        ref, port64 = f64.result()
    assert set(ref) == set(port64) == set(jax32) == set(port32)
    assert ref['slots'].shape == (1, 16, 6) and (ref['slots'][..., 4] >
                                                  0).all()
    stats = [n for n in ref if n.endswith(('running_mean', 'running_var'))]
    assert any(n.startswith('img_backbone') for n in stats)
    for n in stats:
        assert not np.array_equal(ref[n], frozen['sd'][n].numpy()), n
    for k, want in ref.items():
        if k == 'slots' or k.endswith('seed_xyz'):
            col = np.s_[..., 5] if k == 'slots' else np.s_[...]
            for got in (port64, jax32, port32):
                np.testing.assert_array_equal(got[k][col], np.asarray(
                    want[col], got[k].dtype), err_msg=k)
            want = want[..., :5] if k == 'slots' else want
            port64[k], port32[k] = (x[k][..., :want.shape[-1]]
                                    for x in (port64, port32))
            jax32[k] = jax32[k][..., :want.shape[-1]]
        assert rel(port64[k], want) <= F64_REL, k
        assert rel(port32[k], want) <= max(OUT_REL, rel(jax32[k], want)), \
            (k, rel(port32[k], want), rel(jax32[k], want))


def test_frozen_branch_step_matches_jax(frozen):
    m = frozen
    # gt boxes on the proposals of the train-mode forward (the port's)
    probe = ImVoteNet(m['cfg'])
    probe.load_state_dict(m['sd'])
    pts, img, bb, d2i = m['args']
    with torch.no_grad():
        out = probe.train()(t(pts), None, t(img), t(bb), t(d2i))['joint']
    gt = gt_near((out['centers'] + out['raw'][..., 2:5]).numpy(), 4)
    batch = dict(points=pts, img=img, bboxes_2d=bb, depth2img=d2i, **gt)
    port = ImVoteNet(m['cfg'])
    port.load_state_dict(m['sd'])

    def inputs64(model):
        p, cond, g = imvotenet_to_device(batch, 'cpu')
        return p.double(), tuple(x.double() for x in cond), {
            k: v.double() if v.is_floating_point() else v
            for k, v in g.items()}

    metrics, worst, whole = check_step(
        m['jm'], lambda o, bt: JI.imvotenet_loss(o, bt, m['jcfg']),
        m['variables'], m['key_map'], port, jax.tree.map(jnp.asarray, batch),
        lambda bt: (bt['points'], bt['img'], bt['bboxes_2d'],
                    bt['depth2img']), imvotenet_to_device(batch, 'cpu'),
        live=('joint.head_out.weight', 'pts.vote0.weight',
              'img.prop0.weight', 'img_mlp.weight',
              'backbone.sa0.mlp0.weight'),
        f64=(JI.ImVoteNet(cfg=m['jcfg'], dtype=jnp.float64), inputs64),
        probe=True, rounding=('backbone.sa0.mlp0.weight',
                              'img_backbone.bn1.running_var'),
        compiler_options=COMPILE)
    assert metrics['joint_loss_center'] > 0 and metrics['img_loss_vote'] > 0
    print(f'port float32 step against JAX float64: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')
