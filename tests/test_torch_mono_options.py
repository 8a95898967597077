"""The mono family's options beyond the KITTI configs, in the port
against the JAX package on the CPU (the sizes, weights and rules of
tests/test_torch_fcos_mono3d.py):

* FCOS3D with nuScenes' `pred_velo` and `pred_attrs`, on a batch with
  seeded velocities and attribute labels: the whole model's level
  outputs (relative L2 1e-4), every loss term (rtol 1e-5), the decode
  (the kept mask, labels and attributes exactly; scores, boxes and
  velocities atol 1e-4 + rtol 1e-5) and one training step against
  `jax.value_and_grad` (terms rtol 2e-4, gradients relative L2 1e-2 each
  and 2e-3 in all);
* PGD at the options where JAX's own PGD fails end to end (ROADMAP §3),
  on the head alone against the JAX functions that do run them: level
  outputs relative L2 1e-4, every loss term rtol 1e-5.
  - without the depth classifier (and so without the keypoint and 2D
    box branches): the outputs against JAX's head, the loss against
    JAX's `fcos3d_loss`;
  - `weight_dim=0`: the outputs against JAX's head of `weight_dim=1`
    without its 'weight', the loss against JAX's `pgd_loss` at 0 (which
    reads no 'weight');
  - `pred_velo` + `pred_attrs`: the outputs against JAX's head, the loss
    against JAX's `pgd_loss` on the first 7 box channels with
    `loss_velo` from JAX's `fcos3d_loss` on all 9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models.detectors.fcos_mono3d import (mono_level_points as
                                                  j_level_points)
from dfm_tpu.models.heads import fcos_mono3d as JH
from dfm_tpu.models.heads.pgd import PGDHead as JPGDHead
from dfm_tpu.models.heads.pgd import pgd_loss as j_pgd_loss
from dfm_tpu_torch.models.heads.pgd import PGDHead, pgd_loss
from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
from dfm_tpu_torch.utils import weights as W

from test_torch_fcos_mono3d import (B, DEPTH, FCOS_TERMS, H, LOSS_RTOL,
                                    REL_L2, WID, _pair, check_decode,
                                    check_forward, check_loss_term,
                                    check_step, configs, nus_gt, rel_l2,
                                    tensors)
from test_torch_fcos_mono3d import one_thread  # noqa: F401 (autouse)
from test_torch_layers import submap
from test_torch_multiview_dfm import flax_variables

NUS = dict(pred_velo=True, pred_attrs=True)
NUS_TERMS = FCOS_TERMS + ('loss_velo', 'loss_attr')


@pytest.fixture(scope='module')
def nus_pair():
    return _pair('FCOSMono3D', **NUS)


def test_nus_forward_matches_jax(nus_pair):
    check_forward(nus_pair)


@pytest.mark.parametrize('term', NUS_TERMS)
def test_nus_loss_terms_match_jax(nus_pair, term):
    check_loss_term(nus_pair, term)


def test_nus_get_bboxes_match_jax(nus_pair):
    assert {'velocity', 'attrs'} <= set(nus_pair['jdet'])
    check_decode(nus_pair)


def test_nus_step_matches_jax(nus_pair):
    check_step(nus_pair)


def _strip(level_outs, keep_code=None, drop=()):
    """JAX level outputs without the keys in `drop`, 'bbox_pred' cut to
    its first `keep_code` channels."""
    return [{k: (v[..., :keep_code] if k == 'bbox_pred' and keep_code
                 else v) for k, v in o.items() if k not in drop}
            for o in level_outs]


def _pgd_option_reference(case, jcfg, jouts, batch, pts):
    """(JAX head outputs the port's head must give, JAX's loss terms) of
    a PGD option JAX's own PGD does not run end to end."""
    def run(fn, *args):
        return {k: float(v) for k, v in jax.jit(fn)(*args).items()}

    cam = jnp.asarray(batch['cam2img'])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if case == 'no_depth_classifier':
        return jouts, run(lambda o, b: JH.fcos3d_loss(o, pts, jcfg, b),
                          jouts, jb)
    if case == 'weight_dim0':
        outs = _strip(jouts, drop=('weight',))
        cfg0 = dataclasses.replace(jcfg, weight_dim=0)
        return outs, run(lambda o, b: j_pgd_loss(o, pts, cfg0, b, cam),
                         outs, jb)
    # pred_velo: JAX's pgd_loss on the first 7 box channels, loss_velo
    # from JAX's fcos3d_loss on all 9
    cfg7 = dataclasses.replace(jcfg, pred_velo=False)
    terms = run(lambda o, b: j_pgd_loss(o, pts, cfg7, b, cam),
                _strip(jouts, keep_code=7), jb)
    terms['loss_velo'] = run(lambda o, b: JH.fcos3d_loss(o, pts, jcfg, b),
                             jouts, jb)['loss_velo']
    return jouts, terms


PGD_OPTION_CASES = {
    'no_depth_classifier': dict(use_depth_classifier=False,
                                pred_keypoints=False, pred_bbox2d=False),
    'weight_dim0': dict(weight_dim=0),
    'velo_attrs': dict(NUS),
}


@pytest.mark.parametrize('case', list(PGD_OPTION_CASES))
def test_pgd_option_matches_jax(case):
    """PGD's head and loss at an option JAX's PGD fails at end to end,
    against the JAX functions that do run it (the module docstring)."""
    opts = PGD_OPTION_CASES[case]
    # JAX's head concatenates no 'weight' channels at weight_dim 0
    jcfg, pcfg = configs('PGD', **opts)
    jhead = JPGDHead(cfg=dataclasses.replace(jcfg, weight_dim=1)
                     if case == 'weight_dim0' else jcfg)
    rng = np.random.RandomState(9)
    feats = [rng.randn(B, h, w, 64).astype(np.float32)
             for h, w in ((20, 32), (10, 16), (5, 8), (3, 4), (2, 2))]
    variables = flax_variables(jhead, feats, seed=4)
    jouts = jax.tree.map(np.asarray, jax.jit(
        lambda v, f: jhead.apply(v, f, train=False))(variables, feats))
    batch = nus_gt(mono_synth(B, 3, h=H, w=WID, kpts=True))
    pts = j_level_points((H, WID), jcfg)
    want_outs, want = _pgd_option_reference(case, jcfg, jouts, batch, pts)

    head = PGDHead(pcfg)
    head.load_state_dict(W.state_dict_from_jax(variables, submap(
        W.mono_key_map(pcfg, DEPTH), 'bbox_head', ('bbox_head',))),
        strict=True)
    with torch.no_grad():
        outs = head([torch.from_numpy(np.moveaxis(f, -1, 1).copy())
                     for f in feats])
    for lvl, (g, w) in enumerate(zip(outs, want_outs)):
        assert set(g) == set(w), lvl
        for k in w:
            r = rel_l2(g[k].numpy(), w[k])
            assert r <= REL_L2, (lvl, k, r)
    _, cam2img, gt = mono_to_device(batch, 'cpu')
    got = pgd_loss(tensors(want_outs), pts, pcfg, gt, cam2img)
    assert set(got) == set(want)
    for k, v in want.items():
        assert v > 0, f'{k}: the batch does not reach it'
        np.testing.assert_allclose(float(got[k]), v, rtol=LOSS_RTOL,
                                   err_msg=k)
