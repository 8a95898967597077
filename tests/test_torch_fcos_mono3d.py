"""FCOS3D and PGD (the mono family) in the port against the JAX package,
on the CPU.

Tiny configs: ResNet-18, FPN and head width 64 (two channels a GroupNorm
group), B 2 of 160x256 images (levels 20x32 down to 2x2), `mono_synth`'s
batch (the JAX adapter's `_mono_synth` draws, checked bit for bit). The
same seeded numpy inputs and seeded flax variables (carried over by
`utils/weights.py:mono_key_map`) go through both packages in float32,
torch in one thread. PGD's log-variance conv is scaled by 0.1 so that
the uncertain depth term does not swamp the others. Tolerances:

* the head alone and the whole models' level outputs: relative L2 1e-4
  per output (XLA's and PyTorch's CPU convolutions sum in other orders
  through 20 layers);
* `fcos3d_targets`: labels, positives and the assigned gt exactly (ties
  in distance go to the first gt, as JAX's `argmin`), the box and
  centerness targets atol 1e-5;
* every loss term of `fcos3d_loss` / `pgd_loss` on the same head
  outputs: rtol 1e-5 (float32 sums in another order);
* `fcos3d_get_bboxes` on the same outputs with the class scores raised
  (live boxes): the kept mask and labels exactly, scores and boxes atol
  1e-4 + rtol 1e-5 (exp and a 4x4 solve of the same float32 values);
* one training step (train-mode BatchNorm) against `jax.value_and_grad`
  of JAX's loss: every term rtol 2e-4, every parameter's gradient by
  relative L2 1e-2 and the whole vector 2e-3 (the tests/test_torch_train_
  step.py rules: BatchNorm over 2 x 2 cells at the coarsest level);
* the decode's velocity and attributes, where a config has them (tests/
  test_torch_mono_options.py): atol 1e-4 + rtol 1e-5, and exactly;
* every option of `FCOS3DConfig` / `PGDConfig` builds, runs, gives a
  finite loss and decodes in the port; the two packages' configs have the
  same fields and defaults; `pgd_loss` refuses the keypoint or 2D box
  branch without the depth classifier;
* PGD with no positive point (every gt masked): every gradient finite;
* `corners_cam` and the camera <-> pseudo-LiDAR box conversions: atol
  1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models.detectors.fcos_mono3d import FCOSMono3D as JFCOS
from dfm_tpu.models.detectors.fcos_mono3d import (fcos_mono3d_loss as
                                                  j_fcos_loss)
from dfm_tpu.models.detectors.fcos_mono3d import (fcos_mono3d_predict as
                                                  j_predict)
from dfm_tpu.models.detectors.fcos_mono3d import (mono_level_points as
                                                  j_level_points)
from dfm_tpu.models.detectors.pgd_mono3d import PGDMono3D as JPGD
from dfm_tpu.models.detectors.pgd_mono3d import pgd_mono3d_loss as j_pgd_loss
from dfm_tpu.models.heads import fcos_mono3d as JH
from dfm_tpu.models.heads.pgd import PGDConfig as JPGDConfig
from dfm_tpu.models.heads.pgd import PGDHead as JPGDHead
from dfm_tpu.runtime.adapters import _mono_synth as j_mono_synth
from dfm_tpu_torch.models.builder import build_detector, mono_model
from dfm_tpu_torch.models.detectors.fcos_mono3d import (FCOSMono3D,
                                                        fcos_mono3d_loss,
                                                        fcos_mono3d_predict,
                                                        mono_level_points)
from dfm_tpu_torch.models.detectors.pgd_mono3d import (PGDMono3D,
                                                       pgd_mono3d_loss)
from dfm_tpu_torch.models.heads import fcos_mono3d as PH
from dfm_tpu_torch.models.heads.pgd import PGDConfig, PGDHead
from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.weights import init_weights

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_layers import submap
from test_torch_multiview_dfm import flax_variables

torch.set_num_threads(1)    # from import on; the workers share the cores

B, H, WID = 2, 160, 256
DEPTH = 18
WIDTH = dict(in_channels=64, feat_channels=64, nms_pre=200, max_num=20)
PGD_EXTRA = dict(depth_branch=(16,))
REL_L2 = 1e-4
TGT_ATOL = 1e-5
LOSS_RTOL = 1e-5
DET_TOL = dict(atol=1e-4, rtol=1e-5)
STEP_RTOL = 2e-4
GRAD_REL_L2 = 1e-2
GRAD_REL_L2_ALL = 2e-3
KINDS = ('FCOSMono3D', 'PGD')
PAIRS = {'FCOSMono3D': 'fcos_pair', 'PGD': 'pgd_pair'}
FCOS_TERMS = ('loss_cls', 'loss_offset', 'loss_depth', 'loss_size',
              'loss_rotsin', 'loss_dir', 'loss_centerness')
PGD_TERMS = FCOS_TERMS + ('loss_depth_uncertain', 'loss_bbox2d',
                          'loss_kpts', 'loss_consistency')


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def configs(kind, **kw):
    extra = dict(WIDTH, **(PGD_EXTRA if kind == 'PGD' else {}), **kw)
    if kind == 'PGD':
        return JPGDConfig(**extra), PGDConfig(**extra)
    return JH.FCOS3DConfig(**extra), PH.FCOS3DConfig(**extra)


def nus_gt(batch, seed=11):
    """`batch` with seeded velocities and attribute labels in place of
    `mono_synth`'s zeros."""
    rng = np.random.RandomState(seed)
    g = batch['gt_labels'].shape
    return dict(batch, gt_velocities=rng.randn(*g, 2).astype(np.float32),
                gt_attr_labels=rng.randint(0, 9, g).astype(np.int32))


def tensors(level_outs):
    return [{k: torch.from_numpy(np.array(v)) for k, v in o.items()}
            for o in level_outs]


def jax_loss(kind, jcfg, outs, batch):
    if kind == 'PGD':
        return j_pgd_loss(outs, (H, WID), batch, jcfg,
                          cam2img=batch['cam2img'])
    return j_fcos_loss(outs, (H, WID), batch, jcfg)


def port_loss(kind, pcfg, outs, gt, cam2img):
    if kind == 'PGD':
        return pgd_mono3d_loss(outs, (H, WID), gt, pcfg, cam2img)
    return fcos_mono3d_loss(outs, (H, WID), gt, pcfg)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(
        *args)


def _pair(kind, **opts):
    """One kind's JAX model and port model on the same weights, the batch,
    both forwards (eval), the losses on JAX's outputs, the decode of live
    scores and one train-mode step's gradients."""
    jcfg, pcfg = configs(kind, **opts)
    jm = (JPGD if kind == 'PGD' else JFCOS)(cfg=jcfg, backbone_depth=DEPTH)
    batch = mono_synth(B, 3, h=H, w=WID, kpts=kind == 'PGD' or bool(opts))
    if opts:
        batch = nus_gt(batch)
    variables = flax_variables(jm, batch['img'], seed=1)
    if kind == 'PGD':
        node = variables['params']['bbox_head']['conv_weight0']
        node['kernel'] = node['kernel'] * np.float32(0.1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jout = jax.tree.map(np.asarray, _jit(
        lambda v, i: jm.apply(v, i, train=False), variables, batch['img']))
    port = (PGDMono3D if kind == 'PGD' else FCOSMono3D)(pcfg, DEPTH)
    port.load_state_dict(W.state_dict_from_jax(
        variables, W.mono_key_map(pcfg, DEPTH)), strict=True)
    port.eval()
    img, cam2img, gt = mono_to_device(batch, 'cpu')
    with torch.no_grad():
        pout = port(img)
    jterms = {k: float(v) for k, v in _jit(
        lambda o, b: jax_loss(kind, jcfg, o, b)[1], jout, jbatch).items()}
    pterms = {k: float(v) for k, v in port_loss(
        kind, pcfg, tensors(jout), gt, cam2img)[1].items()}
    live = [dict(o, cls_score=o['cls_score'] + np.float32(3.0))
            for o in jout]
    jdet = jax.tree.map(np.asarray, _jit(
        lambda o, c: j_predict(o, (H, WID), c, jcfg), live,
        jbatch['cam2img']))
    pdet = {k: v.numpy() for k, v in fcos_mono3d_predict(
        tensors(live), (H, WID), cam2img, pcfg).items()}

    def step_loss(params, stats):
        out, _ = jm.apply({'params': params, 'batch_stats': stats},
                          jbatch['img'], train=True, mutable=['batch_stats'])
        return jax_loss(kind, jcfg, out, jbatch)

    (jtotal, jstep), jgrad = _jit(jax.value_and_grad(step_loss, has_aux=True),
                                  variables['params'],
                                  variables['batch_stats'])
    port.train()
    total, terms = port.forward_train(img, cam2img, gt)
    total.backward()
    return dict(
        kind=kind, jcfg=jcfg, pcfg=pcfg, variables=variables, batch=batch,
        jout=jout, pout=pout, jterms=jterms, pterms=pterms, jdet=jdet,
        pdet=pdet, jstep=dict({k: float(v) for k, v in jstep.items()},
                              loss=float(jtotal)),
        pstep=dict({k: float(v.detach()) for k, v in terms.items()},
                   loss=float(total.detach())),
        jgrad=W.state_dict_from_jax({'params': jax.tree.map(
            np.asarray, jgrad)}, W.mono_key_map(pcfg, DEPTH)),
        pgrad={n: p.grad.clone() for n, p in port.named_parameters()})


@pytest.fixture(scope='module')
def fcos_pair():
    return _pair('FCOSMono3D')


@pytest.fixture(scope='module')
def pgd_pair():
    return _pair('PGD')


@pytest.fixture(params=KINDS)
def pair(request):
    return request.getfixturevalue(PAIRS[request.param])


def test_adapter_batch_matches_jax():
    """`mono_synth` draws JAX's `_mono_synth` batch bit for bit."""
    for kpts in (False, True):
        want = j_mono_synth(None, B, 5, h=H, w=WID, kpts=kpts)
        got = mono_synth(B, 5, h=H, w=WID, kpts=kpts)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


def test_level_points_match_jax():
    for hw in ((H, WID), (384, 1280), (64, 96), (375, 1242)):
        cfg = PH.FCOS3DConfig()
        for got, want in zip(mono_level_points(hw, cfg),
                             j_level_points(hw, JH.FCOS3DConfig())):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('kind', KINDS)
def test_head_level_outputs_match_jax(kind):
    """The head alone on seeded FPN features at the five level sizes."""
    jcfg, pcfg = configs(kind)
    rng = np.random.RandomState(7)
    feats = [rng.randn(B, h, w, 64).astype(np.float32)
             for h, w in ((20, 32), (10, 16), (5, 8), (3, 4), (2, 2))]
    jhead = JPGDHead(cfg=jcfg) if kind == 'PGD' else \
        JH.FCOSMono3DHead(cfg=jcfg)
    variables = flax_variables(jhead, feats, seed=2)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, f: jhead.apply(v, f, train=False))(variables, feats))
    head = PGDHead(pcfg) if kind == 'PGD' else PH.FCOSMono3DHead(pcfg)
    head.load_state_dict(W.state_dict_from_jax(variables, submap(
        W.mono_key_map(pcfg, DEPTH), 'bbox_head', ('bbox_head',))),
        strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(np.moveaxis(f, -1, 1).copy())
                    for f in feats])
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.float32
            r = rel_l2(g[k].numpy(), w[k])
            assert r <= REL_L2, (lvl, k, r)


def test_forward_matches_jax(pair):
    check_forward(pair)


def check_forward(pair):
    for lvl, (g, w) in enumerate(zip(pair['pout'], pair['jout'])):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, (lvl, k)
            r = rel_l2(g[k].numpy(), w[k])
            assert r <= REL_L2, (lvl, k, r)


def _targets_case(kind):
    """(points per level, gt dict) of the batch, or of a gt pair whose
    centres lie 3 px either side of a level-0 point: equal distances."""
    cfg = PH.FCOS3DConfig()
    pts = mono_level_points((H, WID), cfg)
    if kind == 'synthetic':
        b = mono_synth(B, 3, h=H, w=WID)
        gt = {k: b[k] for k in ('gt_bboxes2d', 'centers2d', 'gt_depths',
                                'gt_boxes_cam', 'gt_labels', 'gt_mask')}
        return pts, gt
    x0, y0 = pts[0][45]                     # a stride-8 point
    c = np.array([[[x0 - 3, y0], [x0 + 3, y0], [x0, y0 - 3], [0, 0]]],
                 np.float32).repeat(B, 0)
    box = np.concatenate([c - 6, c + 6], -1)
    cam = np.array([[1.0, 1.5, 20.0, 3.9, 1.6, 1.5, 0.3]] * 4, np.float32)
    mask = np.array([[True, True, True, False], [True, True, False, False]])
    return pts, dict(gt_bboxes2d=box, centers2d=c,
                     gt_depths=cam[None, :, 2].repeat(B, 0),
                     gt_boxes_cam=cam[None].repeat(B, 0),
                     gt_labels=np.array([[2, 1, 0, 0]] * B, np.int32),
                     gt_mask=mask)


@pytest.mark.parametrize('case', ['synthetic', 'ties'])
def test_targets_match_jax(case):
    pts, gt = _targets_case(case)
    jcfg, pcfg = JH.FCOS3DConfig(), PH.FCOS3DConfig()
    points, strides, lo, hi = (t.numpy() for t in PH.point_tables(
        pts, pcfg, 'cpu'))
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda *g: JH.fcos3d_targets_single(points, strides, lo, hi, *g,
                                            jcfg)))(
        gt['gt_bboxes2d'], gt['centers2d'], gt['gt_depths'],
        gt['gt_boxes_cam'], gt['gt_labels'], gt['gt_mask']))
    got = [t.numpy() for t in PH.fcos3d_targets(
        *PH.point_tables(pts, pcfg, 'cpu'),
        *(torch.from_numpy(gt[k]) for k in (
            'gt_bboxes2d', 'centers2d', 'gt_depths', 'gt_boxes_cam',
            'gt_labels', 'gt_mask')), pcfg)]
    labels, tgt, ctr, pos, argmin = got
    assert pos.sum() > 0
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_array_equal(pos, want[3])
    np.testing.assert_array_equal(argmin, want[4])
    np.testing.assert_allclose(tgt, want[1], rtol=0, atol=TGT_ATOL)
    np.testing.assert_allclose(ctr, want[2], rtol=0, atol=TGT_ATOL)
    if case == 'ties':
        # the point between gts 0 and 1 (equal distances) takes gt 0
        assert argmin[0, 45] == 0 and pos[0, 45] and labels[0, 45] == 2


@pytest.mark.parametrize('kind,term', [('FCOSMono3D', t) for t in FCOS_TERMS]
                         + [('PGD', t) for t in PGD_TERMS])
def test_loss_terms_match_jax(request, kind, term):
    check_loss_term(request.getfixturevalue(PAIRS[kind]), term)


def check_loss_term(pair, term):
    assert set(pair['pterms']) == set(pair['jterms'])
    want = pair['jterms'][term]
    assert want > 0, f'{term}: the batch does not reach it'
    np.testing.assert_allclose(pair['pterms'][term], want, rtol=LOSS_RTOL)


def test_get_bboxes_match_jax(pair):
    check_decode(pair)


def check_decode(pair):
    got, want = pair['pdet'], pair['jdet']
    assert set(got) == set(want)
    assert want['mask'].sum() > 0
    np.testing.assert_array_equal(got['mask'], want['mask'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    for k in ('scores', 'boxes3d', 'velocity'):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **DET_TOL)
    if 'attrs' in want:
        np.testing.assert_array_equal(got['attrs'], want['attrs'])
    assert ('velocity' in got) == pair['pcfg'].pred_velo


def test_step_matches_jax(pair):
    check_step(pair)


def check_step(pair):
    """One train-mode forward + backward: every term and the total, each
    parameter's gradient and the whole vector."""
    got, want = pair['pstep'], pair['jstep']
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=STEP_RTOL, err_msg=k)
    bad, flat_g, flat_w = {}, [], []
    for name, g in pair['pgrad'].items():
        g, w = g.numpy(), pair['jgrad'][name].numpy()
        assert np.isfinite(g).all(), name
        if rel_l2(g, w) > GRAD_REL_L2:
            bad[name] = rel_l2(g, w)
        flat_g.append(g.ravel())
        flat_w.append(w.ravel())
    assert not bad, f'gradients off (relative L2): {bad}'
    assert rel_l2(np.concatenate(flat_g), np.concatenate(flat_w)) <= \
        GRAD_REL_L2_ALL
    for prefix in ('backbone.', 'neck.extra_conv4', 'bbox_head.'):
        assert any(k.startswith(prefix) and np.abs(v.numpy()).any()
                   for k, v in pair['pgrad'].items()), prefix


def test_configs_have_jax_fields():
    for jc, pc in ((JH.FCOS3DConfig, PH.FCOS3DConfig),
                   (JPGDConfig, PGDConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jc)}
        pf = {f.name: f.default for f in dataclasses.fields(pc)}
        assert jf == pf
    assert PGDConfig().num_depth_cls == JPGDConfig().num_depth_cls == 8


OPTIONS = [('FCOSMono3D', {}), ('FCOSMono3D', dict(pred_attrs=True)),
           ('FCOSMono3D', dict(pred_velo=True)),
           ('FCOSMono3D', dict(pred_attrs=True, pred_velo=True,
                               num_attrs=5, attr_branch_channels=16)),
           ('FCOSMono3D', dict(diff_rad_by_sin=False, norm_on_bbox=False,
                               stacked_convs=1, num_classes=10,
                               center_sample_radius=2.5,
                               loss_weights=dict(cls=1.0))),
           ('PGD', dict(use_depth_classifier=False, pred_keypoints=False,
                        pred_bbox2d=False)),
           ('PGD', dict(pred_keypoints=False)),
           ('PGD', dict(pred_bbox2d=False)),
           ('PGD', dict(pred_keypoints=False, pred_bbox2d=False,
                        weight_dim=2, depth_branch=(8, 16),
                        depth_range=(1.0, 51.0), depth_unit=5.0)),
           ('PGD', dict(pred_attrs=True, pred_velo=True, weight_dim=0))]


@pytest.mark.parametrize('kind,opts', OPTIONS)
def test_every_option_runs(kind, opts):
    """Each option through `build_detector`, the model, the loss (with
    the nuScenes keys) and the decode: finite, with the option's
    outputs."""
    cfg = build_detector(dict(type=kind, backbone_depth=DEPTH, **WIDTH,
                              **opts))
    model = init_weights(mono_model(dict(type=kind, backbone_depth=DEPTH,
                                         **WIDTH, **opts)), 3)
    b = mono_synth(B, 4, h=64, w=96, kpts=True)
    img, cam2img, gt = mono_to_device(b, 'cpu')
    total, terms = model.train().forward_train(img, cam2img, gt)
    assert torch.isfinite(total), terms
    total.backward()
    if cfg.pred_velo:
        assert 'loss_velo' in terms
    if cfg.pred_attrs:
        assert 'loss_attr' in terms
    with torch.no_grad():
        det = fcos_mono3d_predict(model.eval()(img), (64, 96), cam2img, cfg)
    assert det['boxes3d'].shape == (B, cfg.max_num, 7)
    assert ('velocity' in det) == cfg.pred_velo
    assert ('attrs' in det) == cfg.pred_attrs
    for v in det.values():
        assert torch.isfinite(v.float()).all()


def test_pgd_loss_refuses_branches_without_depth_classifier():
    """Without the depth classifier the head makes no keypoint or 2D box
    outputs: a config that asks for their terms is refused, not run
    without them."""
    b = mono_synth(B, 4, h=64, w=96, kpts=True)
    img, cam2img, gt = mono_to_device(b, 'cpu')
    for opts in (dict(pred_bbox2d=False), dict(pred_keypoints=False), {}):
        model = init_weights(mono_model(dict(
            type='PGD', backbone_depth=DEPTH, use_depth_classifier=False,
            **WIDTH, **opts)), 3)
        with pytest.raises(ValueError, match='depth classifier'):
            model.train().forward_train(img, cam2img, gt)


def test_pgd_without_positives_has_finite_gradients():
    """Every point gets the dummy inputs: the masked branches give no
    NaN to any gradient."""
    _, pcfg = configs('PGD')
    model = init_weights(PGDMono3D(pcfg, DEPTH), 5).train()
    b = mono_synth(B, 6, h=64, w=96, kpts=True)
    b['gt_mask'][:] = False
    img, cam2img, gt = mono_to_device(b, 'cpu')
    total, terms = model.forward_train(img, cam2img, gt)
    total.backward()
    assert torch.isfinite(total)
    for n, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), n


def test_box_conversions_match_jax():
    """`corners_cam` and the camera <-> pseudo-LiDAR box conversions on
    seeded boxes (yaw across +-2 pi): atol 1e-5 (sin / cos of the same
    float32 angles)."""
    from dfm_tpu.core import boxes as JB
    from dfm_tpu_torch.core import boxes as PB
    rng = np.random.RandomState(8)
    boxes = np.concatenate([rng.randn(2, 5, 3) * 10, rng.rand(2, 5, 3) * 4
                            + 0.5, rng.uniform(-7, 7, (2, 5, 1))],
                           -1).astype(np.float32)
    t = torch.from_numpy(boxes)
    for name in ('corners_cam', 'cam_to_pseudo_lidar_boxes',
                 'pseudo_lidar_to_cam_boxes'):
        got = getattr(PB, name)(t).numpy()
        want = np.asarray(getattr(JB, name)(jnp.asarray(boxes)))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)
