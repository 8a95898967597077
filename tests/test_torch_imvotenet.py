"""ImVoteNet, its image branch and the vote fusion against the JAX
package, on the CPU.

* `vote_fusion_cues` on 2 x 256 seeds and a 50 x 70 image (odd sizes),
  with a 3 x 4 and a 4 x 4 depth2img: two live boxes of one confidence
  overlapping (their in-box ties ranked lower slot first, as
  `lax.top_k`), boxes a seed misses, pads, projections past the image
  (clipped, rounded half to even): the mask and the texture equal, the
  cues within CUE_REL 1e-6 relative L2 (measured 9e-8);
* `atss2d_decode` at 50 x 70 (level sizes ceil(h / s), ceil(w / s) for
  strides 8-128) on level outputs quantised so that confidences tie: the
  slots' order, confidences and classes equal, the boxes within 1e-5;
* the image branch (`LIGAResNet` in its ResNet-18 form with the
  max-pool, the 64-channel 5-level FPN, the one-conv ATSS head) at 130 x
  170 (no stride divides it; its coarsest level 2 x 2, where each of the
  head's GroupNorm groups holds 8 values: at 1 x 1 a group holds 2, and
  E[x^2] - E[x]^2 of the raw image's large activations can round below
  0 in either package): each level of each module within OUT_REL 1e-5
  relative L2, the decoded slots' order equal;
* an ImVoteNet of small heads (16 proposals, 4 classes, 3 heading bins;
  the fixed SSG backbone, the image branch at 16 slots) on 2 x 2,500
  points in a 2 m cube with the height feature, a 50 x 70 image and 6
  2D box slots, without and with the image branch, eval mode: every
  leaf carried by the key map, the seeds equal, each tower's votes,
  centres and raw head within OUT_REL (measured 5e-7);
* `imvotenet_loss` (both modes; with a trainable branch and 2D targets
  the ATSS 2D terms too) within TERM_RTOL 1e-5 and `imvotenet_predict`
  within 1e-6 (labels equal);
* one training step without the image branch (the boxes as input: what
  the frozen branch gives the step, as JAX's stop_gradient) against
  JAX's float64 `make_train_step` by `torch_lidar_common.check_step`
  with `f64` and `probe` (as VoteNet's; measured worst parameter
  5.6e-3, JAX's own float32 step 1.06e-1 for it); the port's step of the
  frozen branch: no gradient reaches the branch, its BatchNorms still
  update (the steps with the branch against JAX:
  tests/test_torch_imvotenet_step.py);
* `imvotenet_synth` equals JAX's ImVoteNet batch; `tools.test` /
  `tools.train` with `--synthetic`; both CLIs exit 2 on SUN RGB-D data
  (no image inputs), where JAX's indoor route raises (ROADMAP.md §3).
"""

import contextlib
import io
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.imvotenet as JI
from dfm_tpu.models.backbones.liga_resnet import LIGAResNet as JLIGA
from dfm_tpu.models.heads import atss2d as JA
from dfm_tpu.models.necks.fpn import FPN as JFPN
from dfm_tpu_torch.models.detectors.imvotenet import (
    ImVoteNet, ImVoteNetConfig, img_atss_config, imvotenet_loss,
    imvotenet_predict, vote_fusion_cues)
from dfm_tpu_torch.models.heads import atss2d as A
from dfm_tpu_torch.runtime.adapters import (imvotenet_synth,
                                            imvotenet_to_device)
from dfm_tpu_torch.tools import create_data
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import random_variables
from torch_lidar_common import check_step, jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic SUN RGB-D tree)

B, N, G, M = 2, 2500, 5, 6
IMG_HW = (50, 70)
BRANCH_HW = (130, 170)     # the image branch's own test
CUE_REL = 1e-6
OUT_REL = 1e-5
TERM_RTOL = 1e-5
MEANS = ((0.8, 0.8, 0.9), (1.8, 1.8, 1.2), (0.6, 0.6, 0.7), (1.4, 1.5, 0.8))
TINY = dict(num_classes=4, num_heading_bins=3, num_proposals=16,
            mean_sizes=MEANS, img_max_boxes=16)
CONFIG = os.path.join(ROOT, 'configs', 'imvotenet_sunrgbd.py')
CLI_TINY = ['model.num_proposals=16', 'data.batch_size_per_chip=1']
COMPILE = {'xla_llvm_disable_expensive_passes': True}


def scene(seed):
    """(B, N, 4) points in a 2 m cube with a height column."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(B, N, 3) * 2
    return np.concatenate([pts, pts[..., 2:] - 0.1], -1).astype(np.float32)


def depth2img(rows=3):
    """A camera looking down +y from 0.5 m behind the cube, f = 20 px, the
    principal point at the image centre: u = 35 + 20 (x - 1) / (y + 0.5),
    v = 25 + 20 (1 - z) / (y + 0.5) (past the image near the camera)."""
    d2i = np.array([[20.0, 35.0, 0.0, 17.5 - 20.0],
                    [0.0, 25.0, -20.0, 12.5 + 20.0],
                    [0.0, 1.0, 0.0, 0.5], [0.0, 0.0, 0.0, 1.0]], np.float32)
    return np.tile(d2i[None, :rows], (B, 1, 1))


def boxes2d(seed):
    """(B, M, 6) slots: live boxes 0, 1 (one confidence, overlapping) and
    3, pads 2, 4, 5."""
    rng = np.random.RandomState(seed)
    bb = np.zeros((B, M, 6), np.float32)
    for i in range(B):
        bb[i, 0] = (10, 8, 45, 40, 0.6, 1)
        bb[i, 1] = (20, 12, 60, 44, 0.6, 3)
        bb[i, 3] = (*rng.uniform(0, 20, 2), *rng.uniform(30, 60, 2),
                    rng.uniform(0.3, 0.9), rng.randint(0, 4))
    return bb


def image(seed, hw=IMG_HW):
    return np.random.RandomState(seed).randint(
        0, 256, (B,) + hw + (3,)).astype(np.float32)


def gt_near(centers, seed):
    """Boxes within 0.2 m of proposals 0, 2, 4 of each sample and one 5 m
    away (gravity-centre z, as votenet_loss reads it), the last padded."""
    rng = np.random.RandomState(seed)
    b = len(centers)
    boxes = np.zeros((b, G, 7), np.float32)
    labels = rng.randint(0, 4, (b, G))
    mask = np.ones((b, G), bool)
    mask[:, -1] = False
    for i in range(b):
        for j in range(G - 1):
            ctr = centers[i, 2 * j] + rng.uniform(-0.12, 0.12, 3) \
                if j < G - 2 else np.array([5.0, 5.0, 1.0])
            boxes[i, j] = (*ctr, *rng.uniform(0.5, 1.5, 3),
                           rng.uniform(-np.pi, np.pi))
    return dict(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)


def test_vote_fusion_cues_match_jax():
    seeds = scene(3)[:, :256, :3]
    seeds[:, 0] = (1.0, -0.45, 1.0)             # depth 0.05: far outside
    bb, img = boxes2d(4), image(5)
    for rows in (3, 4):
        d2i = depth2img(rows)
        want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
            lambda s, b, im, d: JI.vote_fusion_cues(s, b, im, d, 4, 3)))(
                seeds, bb, img, d2i))
        got = vote_fusion_cues(t(seeds), t(bb), t(img), t(d2i), 4, 3)
        np.testing.assert_array_equal(got[2].numpy(), want[2])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert rel(got[0].numpy(), want[0]) <= CUE_REL
        # both tied boxes hold some seeds, some seeds miss every box
        assert (want[2][..., :2].all(-1)).any() and (~want[2]).all(-1).any()


def _level_outs(rng, b):
    """ATSS level outputs (B, h, w, X) of a 50 x 70 image, the logits in
    steps of 0.5 (so that confidences tie)."""
    outs = []
    for s in (8, 16, 32, 64, 128):
        h, w = -(-IMG_HW[0] // s), -(-IMG_HW[1] // s)
        outs.append(dict(
            cls_score=np.round(rng.randn(b, h, w, 4) * 2) / 2,
            bbox_pred=rng.randn(b, h, w, 4),
            centerness=np.round(rng.randn(b, h, w, 1) * 2) / 2))
    return jax.tree.map(lambda x: x.astype(np.float32), outs)


def test_atss2d_decode_matches_jax():
    cfg = img_atss_config(ImVoteNetConfig(num_classes=4))
    jcfg = JA.ATSS2DConfig(num_classes=4, in_channels=64, feat_channels=64,
                           stacked_convs=1, strides=(8, 16, 32, 64, 128))
    outs = _level_outs(np.random.RandomState(6), B)
    want = np.asarray(jax.jit(lambda o: JA.atss2d_decode(
        o, IMG_HW, jcfg, 16))(outs))
    got = A.atss2d_decode(jax.tree.map(t, outs), IMG_HW, cfg, 16).numpy()
    assert len(np.unique(want[..., 4])) < want[..., 4].size   # ties
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope='module')
def models():
    """JAX and port ImVoteNets without and with the image branch, their
    seeded variables and eval outputs, on the first sample of one
    scene."""
    pts, img, bb, d2i = (x[:1] for x in (scene(0), image(1), boxes2d(2),
                                         depth2img(4)))
    out = {}
    for branch in (False, True):
        kw = dict(TINY, with_img_branch=branch)
        jcfg, cfg = JI.ImVoteNetConfig(**kw), ImVoteNetConfig(**kw)
        jm = JI.ImVoteNet(cfg=jcfg)
        args = [pts, img, bb, d2i]
        variables = random_variables(jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), *args)), 1)
        key_map = W.imvotenet_key_map(cfg)
        want, _ = jax_apply(jm, variables, args, False)
        out[branch] = dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables,
                           key_map=key_map, want=want, args=args,
                           sd=W.state_dict_from_jax(variables, key_map))
    return out


@pytest.mark.parametrize('branch', [False, True])
def test_key_map_and_forward_match_jax(models, branch):
    m = models[branch]
    assert len(m['sd']) == len(jax.tree.leaves(m['variables']))
    port = ImVoteNet(m['cfg'])
    port.load_state_dict(m['sd'], strict=True)
    pts, img, bb, d2i = (t(x) for x in m['args'])
    with torch.no_grad():
        got = port.eval()(pts, None, img, bb, d2i)
    want = m['want']
    assert set(got) == set(want) == {'joint', 'pts', 'img'}
    for tower in want:
        np.testing.assert_array_equal(got[tower]['seed_xyz'].numpy(),
                                      want[tower]['seed_xyz'])
        for k in ('vote_xyz', 'centers', 'raw'):
            assert rel(got[tower][k].numpy(), want[tower][k]) <= OUT_REL, \
                (tower, k)


def _sub(variables, name):
    return {c: variables[c][name] for c in ('params', 'batch_stats')
            if name in variables.get(c, {})}


def test_image_branch_at_odd_size_matches_jax(models):
    """Each module of the branch alone on a 130 x 170 image, eval mode:
    the ResNet's 3 stages (17x22, 9x11, 5x6), the FPN's 5 levels (the
    top-down sums cropped), the head's outputs and the decoded slots."""
    m = models[True]
    v, img = m['variables'], image(9, BRANCH_HW)
    jcfg = JA.ATSS2DConfig(num_classes=4, in_channels=64, feat_channels=64,
                           stacked_convs=1, strides=(8, 16, 32, 64, 128))

    def branch(x):
        feats = JLIGA(
            depth=18, strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
            num_channels_factor=(1, 2, 4, 8), out_indices=(1, 2, 3),
            with_max_pool=True, norm='bn').apply(_sub(v, 'img_backbone'), x)
        fpn = JFPN(out_channels=64, num_outs=5).apply(_sub(v, 'img_neck'),
                                                      feats)
        head = JA.ATSS2DHead(cfg=jcfg).apply(_sub(v, 'img_bbox_head'), fpn)
        return feats, fpn, head, JA.atss2d_decode(head, BRANCH_HW, jcfg, 16)

    feats, fpn, head, dec = jax.tree.map(np.asarray, jax.jit(branch)(img))
    port = ImVoteNet(m['cfg'])
    port.load_state_dict(m['sd'])
    port.eval()
    with torch.no_grad():
        x = t(img).permute(0, 3, 1, 2)
        pf = port.img_backbone(x)
        pn = port.img_neck(pf)
        ph, pdec = port.image_branch(t(img))
    assert [tuple(f.shape[1:3]) for f in feats] == [(17, 22), (9, 11),
                                                    (5, 6)]
    assert [tuple(f.shape[1:3]) for f in fpn][3:] == [(3, 3), (2, 2)]
    for got, want in ((pf, feats), (pn, fpn)):
        for g, w in zip(got, want):
            assert rel(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) <= \
                OUT_REL
    for g, w in zip(ph, head):
        for k in w:
            assert rel(g[k].numpy(), np.asarray(w[k])) <= OUT_REL, k
    np.testing.assert_array_equal(pdec[..., 5].numpy(), dec[..., 5])
    np.testing.assert_allclose(pdec[..., :5].numpy(), dec[..., :5],
                               rtol=1e-5, atol=1e-4)


def _jax_loss(jcfg, out, gt):
    return jax.tree.map(float, jax.jit(lambda o, b: JI.imvotenet_loss(
        o, dict(b, img_hw=IMG_HW), jcfg))(jax.tree.map(jnp.asarray, out),
                                          jax.tree.map(jnp.asarray, gt))[1])


def _port_out(out):
    return jax.tree.map(t, out)


@pytest.mark.parametrize('trainable', [False, True])
def test_loss_and_predict_match_jax(models, trainable):
    """Both modes; `trainable`: the branch not frozen (the stage-1 path),
    its outputs kept and the ATSS 2D loss on 2D targets."""
    m = models[trainable]
    jcfg, cfg = m['jcfg'], m['cfg']
    out = dict(m['want'])
    raw = out['joint']['raw']
    gt = gt_near(out['joint']['centers'] + raw[..., 2:5], 3)
    if trainable:
        kw = dict(TINY, with_img_branch=True, freeze_img_branch=False)
        jcfg, cfg = JI.ImVoteNetConfig(**kw), ImVoteNetConfig(**kw)
        out['outs_2d'] = _level_outs(np.random.RandomState(9), 1)
        rng = np.random.RandomState(8)
        xy = rng.uniform(5, 30, (1, G, 2))
        gt['gt_bboxes2d'] = np.concatenate(
            [xy, xy + rng.uniform(8, 30, (1, G, 2))], -1).astype(np.float32)
        gt['centers2d'] = (xy + 4).astype(np.float32)
    jterms = _jax_loss(jcfg, out, gt)
    _, terms = imvotenet_loss(_port_out(out), dict(
        {k: t(v) for k, v in gt.items()}, img_hw=IMG_HW), cfg)
    assert set(terms) == set(jterms)
    assert ('loss_cls2d' in terms) == trainable
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), jterms[k],
                                   rtol=TERM_RTOL, atol=1e-9, err_msg=k)
    assert terms['joint_loss_center'] > 0 and terms['img_loss_vote'] > 0
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JI.imvotenet_predict(
        o, jcfg))(jax.tree.map(jnp.asarray, out)))
    got = imvotenet_predict(_port_out(out), cfg)
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_train_step_matches_jax(models):
    """The boxes as input (the branch's frozen boxes are constants of the
    step)."""
    m = models[False]
    kw = dict(TINY, with_img_branch=False)
    jm = JI.ImVoteNet(cfg=m['jcfg'])
    args = m['args']
    # gt boxes on the proposals of the train-mode forward (the port's)
    probe = ImVoteNet(ImVoteNetConfig(**kw))
    probe.load_state_dict(m['sd'])
    with torch.no_grad():
        out = probe.train()(*[t(x) for x in args[:1]], None,
                            *[t(x) for x in args[1:]])['joint']
    gt = gt_near((out['centers'] + out['raw'][..., 2:5]).numpy(), 4)
    pts, img, bb, d2i = args
    batch = dict(points=pts, img=img, bboxes_2d=bb, depth2img=d2i, **gt)
    port = ImVoteNet(ImVoteNetConfig(**kw))
    port.load_state_dict(m['sd'])

    def inputs64(model):
        p, cond, g = imvotenet_to_device(batch, 'cpu')
        return p.double(), tuple(x.double() for x in cond), {
            k: v.double() if v.is_floating_point() else v
            for k, v in g.items()}

    metrics, worst, whole = check_step(
        jm, lambda o, bt: JI.imvotenet_loss(o, bt, m['jcfg']),
        m['variables'], m['key_map'], port, jax.tree.map(jnp.asarray, batch),
        lambda bt: (bt['points'], bt['img'], bt['bboxes_2d'],
                    bt['depth2img']), imvotenet_to_device(batch, 'cpu'),
        live=('joint.head_out.weight', 'pts.vote0.weight',
              'img.prop0.weight', 'img_mlp.weight',
              'backbone.sa0.mlp0.weight'),
        f64=(JI.ImVoteNet(cfg=m['jcfg'], dtype=jnp.float64), inputs64),
        probe=True, compiler_options=COMPILE)
    assert metrics['joint_loss_center'] > 0 and metrics['joint_loss_size'] > 0
    print(f'port float32 step against JAX float64: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')


def test_frozen_branch_gets_no_gradient(models):
    """The port's step of the frozen branch: no gradient reaches the image
    branch, whose BatchNorms still take the batch's moments."""
    m = models[True]
    port = ImVoteNet(m['cfg'])
    port.load_state_dict(m['sd'])
    before = port.img_backbone.bn1.running_mean.clone()
    pts, img, bb, d2i = (t(x) for x in m['args'])
    total, _ = port.train().forward_train(
        pts, (img, bb, d2i), {k: t(v) for k, v in gt_near(
            m['want']['joint']['centers'], 5).items()})
    total.backward()
    for name, p in port.named_parameters():
        branch = name.startswith(('img_backbone', 'img_neck', 'img_bbox'))
        assert (p.grad is None) == branch, name
    assert not torch.equal(port.img_backbone.bn1.running_mean, before)


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    want = get_adapter('ImVoteNet').synthetic_batch(
        types.SimpleNamespace(cfg=JI.ImVoteNetConfig(num_classes=10)), 2, 3)
    got = imvotenet_synth(ImVoteNetConfig(num_classes=10), 2, 3)
    assert set(got) == set(want) and got['img'].shape == (2, 48, 64, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _main(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_synthetic_and_real_data(tmp_path):
    rc, text, _ = _main(test_cli, [CONFIG, '--device', 'cpu', '--dtype',
                                   'float32', '--synthetic', '--cfg-options']
                        + CLI_TINY)
    assert rc == 0 and '[synthetic-eval] ImVoteNet: decoded 3 output ' \
        'arrays, finite=True' in text, text
    rc, text, _ = _main(train_cli, [CONFIG, '--device', 'cpu', '--synthetic',
                                    '--work-dir', str(tmp_path),
                                    '--max-steps', '1', '--cfg-options']
                        + CLI_TINY)
    assert rc == 0 and 'joint_loss_vote=' in text, text
    for cli, extra in ((test_cli, []),
                       (train_cli, ['--work-dir', str(tmp_path)])):
        rc, _, err = _main(cli, [CONFIG, '--device', 'cpu'] + extra + [
            '--cfg-options', f'data.data_root={tmp_path}'])
        assert rc == 2 and 'bboxes_2d' in err and 'depth2img' in err, err


def test_jax_indoor_route_raises(tmp_path):
    """JAX's `indoor_real_eval` (tools/test.py:234-283) initialises the
    model on the points alone (ImVoteNet also needs img, bboxes_2d,
    depth2img, which `SUNRGBDDataset.get_sample` does not give)."""
    import tools.test as jtest
    from dfm_tpu.models import build_detector as j_build
    from dfm_tpu.runtime.adapters import get_adapter
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    root = str(tmp_path)
    chip_smoke.write_sunrgbd_tree(root, points=600)
    rc, _, _ = _main(create_data, ['sunrgbd', '--root', root, '--splits',
                                   'val'])
    assert rc == 0
    cfg = j_merge_options(j_load_config(CONFIG), [
        f'data.data_root={root}', 'data.num_points=300'])
    handle = j_build(cfg.model.to_dict())
    args = types.SimpleNamespace(checkpoint=None, max_samples=1, out=None,
                                 fuse_conv_bn=False)
    from dfm_tpu.data.indoor import SUNRGBDDataset
    sample = SUNRGBDDataset(root, os.path.join(root, 'sunrgbd_infos_val.pkl'),
                            train=False, num_points=300).get_sample(0)
    assert not {'img', 'bboxes_2d', 'depth2img'} & set(sample)
    with pytest.raises(TypeError, match='img'), \
            contextlib.redirect_stdout(io.StringIO()):
        jtest.indoor_real_eval(args, cfg, handle, get_adapter(handle.type))
