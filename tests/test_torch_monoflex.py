"""MonoFlex (DLA-34 + DLANeck with DCNv2 + MonoFlexHead, edge fusion on and
off) in the port against the JAX package, and its CLIs, on the CPU.

B 2 of 64x96 images (`mono_synth(..., flex=True)`, JAX's `_mono_synth`
draws bit for bit), float32, torch in one thread, JAX compiled once per
function with the fast options, the neck's `conv_offset`s live
(`test_torch_dla.live_offsets`), weights carried over by
`utils/weights.py:mono_key_map`. Tolerances:

* with edge fusion: each stage on the same inputs within 1e-5 relative L2
  (the trunk, the neck, the head's ten outputs), the whole model 1e-4;
  without it, the head alone within 1e-5;
* `EdgeFusion` alone within 1e-5; each corner pixel of the map gets both
  of its path entries' contributions (the path lists it twice), within
  1e-6;
* `monoflex_targets` (a synthetic batch, and one with masked gts and
  centres off the map): cells and mask exactly, the rest atol 1e-6;
* every term of `monoflex_loss` on the same (JAX's) outputs: rtol 1e-5;
* `monoflex_predict` on the same outputs: wherever JAX's score is above
  0, the same label, the score within 1e-6, the box within 1e-4 (and 1e-4
  x |value| for depths past 10 m); the port's mask exactly JAX's
  score > 0;
* one training step against `jax.value_and_grad`, judged as
  tests/test_torch_smoke.py judges it (`check_step`: fixed bounds or 3x
  JAX's own step on the batch in reverse order);
* the BatchNorm fold (57 pairs: DLA's, the neck's DCN -> BatchNorm, the
  edge fusion's 1D conv -> BatchNorm): the whole model's outputs within
  1e-4 relative L2 of the unfused model's;
* the CLIs: `tools.train --synthetic` for 2 steps and a resume to 3;
  without `--synthetic` both CLIs exit 2 (no real-data source or
  evaluation in either package).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.models.detectors.monoflex import MonoFlex as JMonoFlex
from dfm_tpu.models.detectors.monoflex import (monoflex_predict as
                                               j_monoflex_predict)
from dfm_tpu.models.heads import monoflex as JH
from dfm_tpu.runtime.adapters import _mono_synth as j_mono_synth
from dfm_tpu_torch.models.builder import build_detector, unused_keys
from dfm_tpu_torch.models.detectors.monoflex import MonoFlex, monoflex_predict
from dfm_tpu_torch.models.heads import monoflex as PH
from dfm_tpu_torch.models.layers import BatchNorm
from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
from dfm_tpu_torch.runtime.checkpoint import CheckpointManager
from dfm_tpu_torch.runtime.config import load_config
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn

from test_torch_dla import live_offsets, nchw, nhwc, rel_l2
from test_torch_kitti_mono import _main
from test_torch_layers import submap
from test_torch_multiview_dfm import flax_variables
from test_torch_smoke import (MONOFLEX, _jit, check_step, stage_outputs,
                              step_pair, tensors)

torch.set_num_threads(1)    # from import on; the workers share the cores

B, H, WID = 2, 64, 96
REL_L2 = 1e-5
MODEL_REL_L2 = 1e-4
CORNER_ATOL = 1e-6
TGT_ATOL = 1e-6
LOSS_RTOL = 1e-5
SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4
TERMS = ('loss_heatmap', 'loss_offset', 'loss_kpts', 'loss_dims',
         'loss_ori', 'loss_depth')


def jax_loss(jcfg):
    return lambda o, b: JH.monoflex_loss(o, b, jcfg, b['cam2img'][0])


@pytest.fixture(scope='module')
def pair():
    jcfg = JH.MonoFlexConfig(use_edge_fusion=True)
    pcfg = PH.MonoFlexConfig(use_edge_fusion=True)
    jm = JMonoFlex(cfg=jcfg)
    batch = mono_synth(B, 3, h=H, w=WID, flex=True)
    base = flax_variables(jm, batch['img'], seed=1)
    v = live_offsets(base, seed=3)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    jout, inter = _jit(lambda v, i: jm.apply(
        v, i, train=False, capture_intermediates=True,
        mutable=['intermediates']), v, batch['img'])
    jout = jax.tree.map(np.asarray, jout)
    key_map = W.mono_key_map(pcfg)
    port = MonoFlex(pcfg)
    port.load_state_dict(W.state_dict_from_jax(v, key_map), strict=True)
    port.eval()
    img, cam2img, gt = mono_to_device(batch, 'cpu')
    with torch.no_grad():
        pout = port(img)
    jterms = {k: float(x) for k, x in _jit(jax_loss(jcfg), jout,
                                           jbatch).items()}
    pterms = {k: float(x) for k, x in PH.monoflex_loss(
        tensors(jout), gt, pcfg, cam2img).items()}
    # decode scores straddling the threshold
    live = dict(jout, heatmap=jout['heatmap'] * np.float32(0.5))
    jdet = jax.tree.map(np.asarray, _jit(
        lambda o, c: j_monoflex_predict(o, c, jcfg), live,
        jbatch['cam2img']))
    pdet = {k: x.numpy() for k, x in monoflex_predict(
        tensors(live), cam2img, pcfg).items()}
    return dict(
        jcfg=jcfg, pcfg=pcfg, v=v, key_map=key_map, img=img, port=port,
        stages=stage_outputs(inter['intermediates']), jout=jout, pout=pout,
        jterms=jterms, pterms=pterms, jdet=jdet, pdet=pdet,
        step=step_pair(jm, MonoFlex, pcfg, jax_loss(jcfg), base, batch))


@pytest.mark.parametrize('kpts,flex', [(False, True), (True, False),
                                       (False, False)])
def test_adapter_batch_matches_jax(kpts, flex):
    want = j_mono_synth(None, B, 5, h=H, w=WID, kpts=kpts, flex=flex)
    got = mono_synth(B, 5, h=H, w=WID, kpts=kpts, flex=flex)
    assert set(got) == set(want)
    for k, x in got.items():
        np.testing.assert_array_equal(x, np.asarray(want[k]), err_msg=k)


def test_config_and_builder():
    jf = {f.name: f.default for f in dataclasses.fields(JH.MonoFlexConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(PH.MonoFlexConfig)}
    assert jf == pf
    mc = load_config(MONOFLEX).model
    assert isinstance(build_detector(mc), PH.MonoFlexConfig)
    assert unused_keys(mc) == ['type']
    for ny, nx in ((16, 24), (1, 3), (5, 1)):
        np.testing.assert_array_equal(PH.edge_path(ny, nx),
                                      JH.edge_path(ny, nx))


def test_stage_outputs_match_jax(pair):
    port, (levels, neck) = pair['port'], pair['stages']
    with torch.no_grad():
        got = port.backbone(pair['img'].permute(0, 3, 1, 2))
        for i, (g, w) in enumerate(zip(got, levels)):
            assert rel_l2(nhwc(g), w) <= REL_L2, (i, rel_l2(nhwc(g), w))
        got = port.neck([nchw(x) for x in levels])
        assert rel_l2(nhwc(got), neck) <= REL_L2
        head = port.bbox_head(nchw(neck))
    assert set(head) == set(pair['jout'])
    for k, want in pair['jout'].items():
        assert head[k].shape == want.shape, k
        assert rel_l2(head[k].numpy(), want) <= REL_L2, k
        assert rel_l2(pair['pout'][k].numpy(), want) <= MODEL_REL_L2, k


def test_head_without_edge_fusion_matches_jax():
    jcfg, pcfg = JH.MonoFlexConfig(), PH.MonoFlexConfig()
    feat = np.random.RandomState(4).randn(B, 16, 24, 64).astype(np.float32)
    jhead = JH.MonoFlexHead(cfg=jcfg)
    v = flax_variables(jhead, feat, seed=5)
    want = jax.tree.map(np.asarray, _jit(
        lambda v, f: jhead.apply(v, f, train=False), v, feat))
    head = PH.MonoFlexHead(pcfg)
    head.load_state_dict(W.state_dict_from_jax(v, submap(
        W.mono_key_map(pcfg), 'bbox_head', ('bbox_head',))), strict=True)
    assert not hasattr(head, 'edge_cls')
    with torch.no_grad():
        got = head(nchw(feat))
    for k, x in want.items():
        assert rel_l2(got[k].numpy(), x) <= REL_L2, k


def test_edge_fusion_adds_both_corner_contributions():
    """JAX's `.at[:, py, px, :].add(e)` sums both path entries of a corner
    pixel; the port's `index_add` does too."""
    rng = np.random.RandomState(6)
    feat = rng.randn(B, 5, 7, 8).astype(np.float32)
    out = rng.randn(B, 5, 7, 3).astype(np.float32)
    jef = JH.EdgeFusion(3, 8)
    v = flax_variables(jef, feat, jnp.asarray(out), seed=7)
    want = np.asarray(_jit(lambda v, f, o: jef.apply(v, f, o, train=False),
                           v, feat, out))
    ef = PH.EdgeFusion(3, 8)
    ef.load_state_dict(W.state_dict_from_jax(v, [
        ('edge_conv', ('edge_conv',), 'conv1d'),
        ('edge_bn', ('BatchNorm_0',), 'bn'),
        ('edge_out', ('edge_out',), 'conv1d')]), strict=True)
    seq = []
    ef.edge_out.register_forward_hook(lambda m, i, o: seq.append(o))
    with torch.no_grad():
        got = ef.eval()(nchw(feat), nchw(out))
    assert rel_l2(nhwc(got), want) <= REL_L2
    path = PH.edge_path(5, 7)
    delta = (got - nchw(out)).numpy()
    for x, y in ((0, 0), (6, 0), (0, 4), (6, 4)):
        hits = np.flatnonzero((path[:, 0] == x) & (path[:, 1] == y))
        assert len(hits) == 2
        both = seq[0][..., hits].sum(-1).numpy()
        np.testing.assert_allclose(delta[..., y, x], both, rtol=0,
                                   atol=CORNER_ATOL)
        assert np.abs(seq[0][..., hits[1]].numpy()).min() > 1e-3


def _targets_case(case):
    b = mono_synth(B, 3, h=H, w=WID, flex=True)
    if case == 'masked':
        b['gt_mask'][0, 1] = False
        b['centers2d'][1, 2] = (-9.0, 5.0)
    return b


@pytest.mark.parametrize('case', ['synthetic', 'masked'])
def test_targets_match_jax(case):
    b = _targets_case(case)
    keys = ('gt_boxes_cam', 'centers2d', 'kpts2d', 'gt_labels', 'gt_mask')
    cfg = JH.MonoFlexConfig()
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda *g: JH.monoflex_targets(*g, (H // 4, WID // 4), cfg)))(
            *(b[k] for k in keys)))
    got = {k: x.numpy() for k, x in PH.monoflex_targets(
        *(torch.from_numpy(b[k]) for k in keys), (H // 4, WID // 4),
        PH.MonoFlexConfig()).items()}
    assert set(got) == set(want)
    for k in ('inds', 'mask'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('heatmap', 'offset', 'kpts'):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TGT_ATOL,
                                   err_msg=k)
    assert got['mask'].sum() == (8 if case == 'synthetic' else 6)


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_jax(pair, term):
    assert set(pair['pterms']) == set(pair['jterms']) == set(TERMS)
    want = pair['jterms'][term]
    assert want > 0
    np.testing.assert_allclose(pair['pterms'][term], want, rtol=LOSS_RTOL)


def test_predict_matches_jax(pair):
    got, want = pair['pdet'], pair['jdet']
    live = want['scores_3d'] > 0
    assert live.sum() > 10 and (~live).sum() > 0
    np.testing.assert_array_equal(got['mask'], live)
    np.testing.assert_array_equal(got['labels'][live],
                                  want['labels_3d'][live])
    np.testing.assert_allclose(got['scores'], want['scores_3d'], rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got['boxes3d'][live], want['boxes_3d'][live],
                               rtol=BOX_ATOL, atol=BOX_ATOL)


def test_step_matches_jax(pair):
    check_step(pair['step'], ('backbone.base_layer',
                              'neck.ida_up.node1.dcn.conv_offset',
                              'bbox_head.edge_cls.edge_conv',
                              'bbox_head.depth_unc_out'))


def test_fold_matches_unfused(pair):
    port = MonoFlex(pair['pcfg'])
    port.load_state_dict(W.state_dict_from_jax(pair['v'], pair['key_map']))
    port.eval()
    assert fuse_conv_bn(port) == 57
    assert not any(isinstance(m, BatchNorm) for m in port.modules())
    with torch.no_grad():
        fused = port(pair['img'])
    for k, want in pair['pout'].items():
        assert rel_l2(fused[k].numpy(), want.numpy()) <= MODEL_REL_L2, k


@pytest.fixture(scope='module')
def clis(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('cli'))
    work = os.path.join(d, 'w')
    train = [MONOFLEX, '--device', 'cpu', '--work-dir', work, '--synthetic',
             '--cfg-options', 'data.batch_size_per_chip=2']
    out = dict(train=_main(train_cli, train + ['--max-steps', '2']))
    ck = CheckpointManager(os.path.join(work, 'ckpts'))
    out['digest'] = train_cli.optimizer_digest(ck.load()['optimizer'])
    out['resume'] = _main(train_cli, train + ['--max-steps', '3',
                                              '--auto-resume'])
    out['steps'] = ck.latest_step()
    out['refused'] = (
        test_cli.main([MONOFLEX, '--device', 'cpu', '--checkpoint',
                       ck.path(3)]),
        train_cli.main([MONOFLEX, '--device', 'cpu', '--work-dir',
                        os.path.join(d, 'r')]))
    return out


def test_tools_train_monoflex_synthetic(clis):
    (rc, text), (rc2, text2) = clis['train'], clis['resume']
    assert rc == 0 and rc2 == 0
    for key in TERMS:
        assert re.search(rf' {key}=[-0-9.]+ ', text), key
    assert f'resumed from step 2 (optimizer state sha1 {clis["digest"]})' \
        in text2 and 'step 3/3' in text2
    assert clis['steps'] == 3


def test_monoflex_without_synthetic_is_refused(clis, capsys):
    assert clis['refused'] == (2, 2)
