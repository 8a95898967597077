"""SMOKE (DLA-34 + DLANeck with DCNv2 + SMOKEHead) in the port against the
JAX package, and its CLIs, on the CPU.

B 2 of 64x96 images (`mono_synth`'s batch, as tests/test_smoke_dla.py
sizes them; the head's map 16x24), float32, torch in one thread, JAX
compiled once per function with the fast options. The flax variables are
seeded (`flax_variables`), the neck's `conv_offset`s live
(`test_torch_dla.live_offsets`), and carried over by
`utils/weights.py:mono_key_map`. Tolerances:

* eval mode, each stage on the same inputs (the trunk's six levels, the
  neck on JAX's levels, the head on JAX's neck map): relative L2 1e-5
  per output; the whole model's dense outputs 1e-4 (some 60 layers);
* `smoke_targets` (a synthetic batch, and one with masked gts and centres
  off the map): cells, order and mask exactly, the heatmap atol 1e-6;
* `smoke_loss`'s terms on the same (JAX's) outputs: rtol 1e-5;
* `smoke_predict` on the same outputs: wherever JAX's score is above 0,
  the port's detection has the same label, its score within 1e-6 and its
  box within 1e-4; the port's mask is exactly JAX's score > 0, on every
  sample (JAX decodes sample 0 alone, so each sample is fed to it apart);
* one training step (train-mode BatchNorm) against `jax.value_and_grad`
  (`check_step`): the terms within rtol 2e-4, every parameter's gradient
  within relative L2 1e-2 and the whole vector 2e-3
  (tests/test_torch_train_step.py's rules), or, where more, within 3x
  the distance of JAX's own step on the batch in reverse order from
  JAX's (the probe: BatchNorm's E[x^2] - E[x]^2 rounds by summation
  order, and the deformable layers carry that rounding into their
  sample points: with offsets of +-3 px JAX's probe moves the gradients
  by 125 % at this size, so the step runs with the offset convs at an
  eighth of `live_offsets`' scale, where the probe moves them by some
  4 %; the op's gradients with +-3 px offsets are held at 1e-5 in
  tests/test_torch_dla.py);
* the BatchNorm fold (55 pairs, DCN -> BatchNorm among them): the dense
  outputs within 1e-4 relative L2 of the unfused model;
* the CLIs on the synthetic KITTI tree of `chip_smoke.write_kitti_tree`
  with `data.type=KittiMono` at 96x320: `tools.test` with a live
  checkpoint to the 36 AP lines, with `--fuse-conv-bn` the same
  detections (`chip_smoke._annos_match`), `--synthetic` on both shipped
  DLA configs, the shipped SMOKE config (data type 'KittiDataset')
  refused by both CLIs, `tools.train` for 2 steps, a resume to 3 and
  `tools.test` on its checkpoint, `tools.train --synthetic` for a step.
  JAX's own KITTI evaluation of SMOKE fails on the same decode
  (ROADMAP.md section 3).
"""

import dataclasses
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfm_tpu.evaluation.results import (cam_detections_to_kitti_annos as
                                        j_cam_annos)
from dfm_tpu.models.detectors import smoke as J
from dfm_tpu_torch.models.builder import build_detector, unused_keys
from dfm_tpu_torch.models.detectors import smoke as P
from dfm_tpu_torch.models.layers import BatchNorm
from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
from dfm_tpu_torch.runtime.checkpoint import CheckpointManager
from dfm_tpu_torch.runtime.config import load_config
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W
from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
from dfm_tpu_torch.utils.weights import init_weights

from test_torch_dfm_full_train import FAST_COMPILE
from test_torch_dla import live_offsets, nchw, nhwc, rel_l2
from test_torch_kitti_mono import _ap_lines, _main
from test_torch_multiview_dfm import flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic KITTI tree, live weights)

B, H, WID = 2, 64, 96
REL_L2 = 1e-5
MODEL_REL_L2 = 1e-4
STEP_OFFSET_SCALE = 1.0
TGT_ATOL = 1e-6
LOSS_RTOL = 1e-5
SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4
STEP_RTOL = 2e-4
GRAD_REL_L2 = 1e-2
GRAD_REL_L2_ALL = 2e-3
SMOKE = os.path.join(ROOT, 'configs', 'smoke_dla34_kitti.py')
MONOFLEX = os.path.join(ROOT, 'configs', 'monoflex_dla34_kitti.py')
CLI_OPTS = ['data.type=KittiMono', 'data.img_hw=(96,320)',
            'data.batch_size_per_chip=2']
TERMS = ('loss_cls', 'loss_bbox')


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # small ops; the suite's workers share cores
    yield
    torch.set_num_threads(threads)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(
        *args)


def tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def jax_sample_decode(jout, cam2img, jcfg):
    """JAX's `smoke_predict` of every sample (it decodes sample 0 of what
    it is given), stacked."""
    fn = jax.jit(lambda o, c: J.smoke_predict(o, c, jcfg))
    dets = [jax.tree.map(np.asarray, fn(
        {k: v[i:i + 1] for k, v in jout.items()}, cam2img[i:i + 1]))
        for i in range(cam2img.shape[0])]
    return {k: np.stack([d[k] for d in dets]) for k in dets[0]}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def stage_outputs(inter):
    """JAX's backbone levels and neck map from `capture_intermediates`."""
    return ([np.asarray(x) for x in inter['backbone']['__call__'][0]],
            np.asarray(inter['neck']['__call__'][0]))


def step_pair(jm, port_cls, pcfg, jloss, base, batch):
    """One train-mode step of both packages on `base` with live offsets at
    STEP_OFFSET_SCALE, and JAX's step on the batch in reverse order (the
    probe): the loss terms and every gradient (the port's in its keys)."""
    v = live_offsets(base, scale=STEP_OFFSET_SCALE, seed=2)
    key_map = W.mono_key_map(pcfg)

    def step_loss(params, stats, b):
        out, _ = jm.apply({'params': params, 'batch_stats': stats}, b['img'],
                          train=True, mutable=['batch_stats'])
        terms = jloss(out, b)
        return sum(terms.values()), terms

    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    rev = {k: x[::-1] for k, x in jb.items()}
    fn = _compiled(jax.value_and_grad(step_loss, has_aux=True),
                   v['params'], v['batch_stats'], jb)
    runs = {}
    for name, b in (('jax', jb), ('probe', rev)):
        (total, terms), grad = fn(v['params'], v['batch_stats'], b)
        runs[name] = (dict({k: float(x) for k, x in terms.items()},
                           loss=float(total)),
                      W.state_dict_from_jax({'params': jax.tree.map(
                          np.asarray, grad)}, key_map))
    port = port_cls(pcfg)
    port.load_state_dict(W.state_dict_from_jax(v, key_map), strict=True)
    img, cam2img, gt = mono_to_device(batch, 'cpu')
    total, terms = port.train().forward_train(img, cam2img, gt)
    total.backward()
    # (the unread projections of the Trees with two levels get none: zero,
    # as JAX's gradient of them and TrainStep.reduce make it)
    runs['port'] = (
        dict({k: float(x.detach()) for k, x in terms.items()},
             loss=float(total.detach())),
        {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
         for n, p in port.named_parameters()})
    return runs


def check_step(runs, prefixes):
    """The port's step against JAX's: each loss term within STEP_RTOL or 3x
    the probe's distance from JAX, each gradient within GRAD_REL_L2 or 3x
    the probe's relative L2 from JAX (the whole vector GRAD_REL_L2_ALL or
    3x); the gradients finite and reaching every stage."""
    (jt, jg), (qt, qg), (pt, pg) = runs['jax'], runs['probe'], runs['port']
    assert set(pt) == set(jt)
    for k, x in jt.items():
        tol = max(STEP_RTOL * abs(x), 3 * abs(qt[k] - x))
        assert abs(pt[k] - x) <= tol, (k, pt[k], x, qt[k])
    bad, flat = {}, {'port': [], 'jax': [], 'probe': []}
    for name, g in pg.items():
        g, w, q = g.numpy(), jg[name].numpy(), qg[name].numpy()
        assert np.isfinite(g).all(), name
        if rel_l2(g, w) > max(GRAD_REL_L2, 3 * rel_l2(q, w)):
            bad[name] = (rel_l2(g, w), rel_l2(q, w))
        for key, x in (('port', g), ('jax', w), ('probe', q)):
            flat[key].append(x.ravel())
    assert not bad, f'gradients off (relative L2, probe): {bad}'
    flat = {k: np.concatenate(x) for k, x in flat.items()}
    assert rel_l2(flat['port'], flat['jax']) <= max(
        GRAD_REL_L2_ALL, 3 * rel_l2(flat['probe'], flat['jax']))
    for prefix in prefixes:
        assert any(k.startswith(prefix) and np.abs(x.numpy()).any()
                   for k, x in pg.items()), prefix


@pytest.fixture(scope='module')
def pair():
    jcfg, pcfg = J.SMOKEConfig(), P.SMOKEConfig()
    jm = J.SMOKEMono3D(cfg=jcfg)
    batch = mono_synth(B, 3, h=H, w=WID)
    base = flax_variables(jm, batch['img'], seed=1)
    v = live_offsets(base, seed=2)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    jout, inter = _jit(lambda v, i: jm.apply(
        v, i, train=False, capture_intermediates=True,
        mutable=['intermediates']), v, batch['img'])
    jout = jax.tree.map(np.asarray, jout)
    key_map = W.mono_key_map(pcfg)
    port = P.SMOKEMono3D(pcfg)
    port.load_state_dict(W.state_dict_from_jax(v, key_map), strict=True)
    port.eval()
    img, cam2img, gt = mono_to_device(batch, 'cpu')
    with torch.no_grad():
        pout = port(img)
    jterms = {k: float(x) for k, x in _jit(
        lambda o, b: J.smoke_loss(o, b, jcfg, b['cam2img']), jout,
        jbatch).items()}
    pterms = {k: float(x) for k, x in P.smoke_loss(
        tensors(jout), gt, pcfg, cam2img).items()}
    # decode scores straddling the threshold
    live = dict(jout, heatmap=jout['heatmap'] * np.float32(0.5))
    jdet = jax_sample_decode(live, batch['cam2img'], jcfg)
    pdet = {k: x.numpy() for k, x in P.smoke_predict(
        tensors(live), cam2img, pcfg).items()}
    return dict(
        jcfg=jcfg, pcfg=pcfg, v=v, key_map=key_map, batch=batch, img=img,
        port=port, stages=stage_outputs(inter['intermediates']), jout=jout,
        pout=pout, jterms=jterms, pterms=pterms, jdet=jdet, pdet=pdet,
        step=step_pair(jm, P.SMOKEMono3D, pcfg, lambda o, b: J.smoke_loss(
            o, b, jcfg, b['cam2img']), base, batch))


def test_config_and_builder():
    """The two packages' configs have the same fields and defaults; the
    shipped config builds with every key a field but the type."""
    jf = {f.name: f.default for f in dataclasses.fields(J.SMOKEConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(P.SMOKEConfig)}
    assert jf == pf
    mc = load_config(SMOKE).model
    cfg = build_detector(mc)
    assert isinstance(cfg, P.SMOKEConfig) and cfg.max_objs == 100
    assert unused_keys(mc) == ['type']


def test_stage_outputs_match_jax(pair):
    """Each stage on the same inputs (the trunk on the image, the neck on
    JAX's levels, the head on JAX's neck map), eval mode: relative L2
    REL_L2; the whole model's dense outputs MODEL_REL_L2."""
    port, (levels, neck) = pair['port'], pair['stages']
    with torch.no_grad():
        got = port.backbone(pair['img'].permute(0, 3, 1, 2))
        for i, (g, w) in enumerate(zip(got, levels)):
            assert rel_l2(nhwc(g), w) <= REL_L2, (i, rel_l2(nhwc(g), w))
        got = port.neck([nchw(x) for x in levels])
        assert rel_l2(nhwc(got), neck) <= REL_L2, rel_l2(nhwc(got), neck)
        head = port.bbox_head(nchw(neck))
    for k, want in pair['jout'].items():
        assert head[k].shape == want.shape == (
            B, H // 4, WID // 4, 3 if k == 'heatmap' else 8)
        assert rel_l2(head[k].numpy(), want) <= REL_L2, k
        assert rel_l2(pair['pout'][k].numpy(), want) <= MODEL_REL_L2, k


def _targets_case(case):
    b = mono_synth(B, 3, h=H, w=WID)
    if case == 'masked':
        b['gt_mask'][0, 1] = False
        b['gt_mask'][1, 0] = False
        b['centers2d'][0, 2] = (-9.0, 5.0)          # off the map
        b['centers2d'][1, 3] = (30.0, 70.0)
    return b


@pytest.mark.parametrize('case', ['synthetic', 'masked'])
def test_targets_match_jax(case):
    b = _targets_case(case)
    cfg = J.SMOKEConfig()
    keys = ('gt_boxes_cam', 'centers2d', 'gt_labels', 'gt_mask')
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda *g: J.smoke_targets(*g, (H // 4, WID // 4), cfg)))(
            *(b[k] for k in keys)))
    got = [t.numpy() for t in P.smoke_targets(
        *(torch.from_numpy(b[k]) for k in keys), (H // 4, WID // 4),
        P.SMOKEConfig())]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TGT_ATOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert got[2].sum() == (8 if case == 'synthetic' else 4)


@pytest.mark.parametrize('term', TERMS)
def test_loss_terms_match_jax(pair, term):
    assert set(pair['pterms']) == set(pair['jterms']) == set(TERMS)
    want = pair['jterms'][term]
    assert want > 0
    np.testing.assert_allclose(pair['pterms'][term], want, rtol=LOSS_RTOL)


def test_predict_matches_jax(pair):
    got, want = pair['pdet'], pair['jdet']
    assert set(got) == {'boxes3d', 'scores', 'labels', 'mask'}
    live = want['scores'] > 0
    assert live.sum() > 10 and (~live).sum() > 0
    np.testing.assert_array_equal(got['mask'], live)
    np.testing.assert_array_equal(got['labels'][live], want['labels'][live])
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got['boxes3d'][live], want['boxes_cam'][live],
                               rtol=0, atol=BOX_ATOL)


def test_step_matches_jax(pair):
    check_step(pair['step'], ('backbone.base_layer',
                              'neck.ida_up.node1.dcn.conv_offset',
                              'bbox_head.reg_out'))


def test_fold_matches_unfused(pair):
    port = P.SMOKEMono3D(pair['pcfg'])
    port.load_state_dict(W.state_dict_from_jax(pair['v'], pair['key_map']))
    port.eval()
    assert fuse_conv_bn(port) == 55
    assert not any(isinstance(m, BatchNorm) for m in port.modules())
    with torch.no_grad():
        fused = port(pair['img'])
    for k, want in pair['pout'].items():
        assert rel_l2(fused[k].numpy(), want.numpy()) <= MODEL_REL_L2, k


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    from dfm_tpu_torch.data.kitti import build_kitti_infos
    root = str(tmp_path_factory.mktemp('kitti'))
    ids = chip_smoke.write_kitti_tree(root)
    infos = build_kitti_infos(root, ids)
    for split in ('train', 'val'):
        with open(os.path.join(root, f'kitti_infos_{split}.pkl'), 'wb') as f:
            pickle.dump(infos, f)
    return root, infos


@pytest.fixture(scope='module')
def clis(tree, tmp_path_factory):
    """tools.test (live checkpoint, unfused and fused), --synthetic on
    both DLA configs, the shipped config's refusals, tools.train (2 steps,
    the resume to 3) and tools.test on its checkpoint."""
    root, _ = tree
    d = str(tmp_path_factory.mktemp('cli'))
    opts = ['--cfg-options', f'data.data_root={root}', *CLI_OPTS]
    from dfm_tpu_torch.models.builder import mono_model
    model = chip_smoke._live_weights(init_weights(mono_model(
        load_config(SMOKE).model)), 3, 0.0)
    live = os.path.join(d, 'live.pth')
    torch.save(model.state_dict(), live)
    out = {}
    base = [SMOKE, '--device', 'cpu', '--dtype', 'float32', '--checkpoint',
            live]
    for name, extra in (('plain', []), ('fused', ['--fuse-conv-bn'])):
        pkl = os.path.join(d, f'{name}.pkl')
        rc, text = _main(test_cli, base + ['--out', pkl] + extra + opts)
        with open(pkl, 'rb') as f:
            out[name] = (rc, text, pickle.load(f))
    out['synthetic'] = {c: _main(test_cli, [
        c, '--device', 'cpu', '--dtype', 'float32', '--synthetic'])
        for c in (SMOKE, MONOFLEX)}
    shipped = ['--cfg-options', f'data.data_root={root}']
    out['refused'] = (test_cli.main([SMOKE, '--device', 'cpu'] + shipped),
                      train_cli.main([SMOKE, '--device', 'cpu', '--work-dir',
                                      os.path.join(d, 'r')] + shipped))
    out['synthetic_train'] = _main(train_cli, [
        SMOKE, '--device', 'cpu', '--synthetic', '--max-steps', '1',
        '--work-dir', os.path.join(d, 's'), '--cfg-options',
        'data.batch_size_per_chip=2'])
    work = os.path.join(d, 'w')
    train = [SMOKE, '--device', 'cpu', '--work-dir', work] + opts
    out['train'] = _main(train_cli, train + ['--max-steps', '2'])
    ck = CheckpointManager(os.path.join(work, 'ckpts'))
    out['digest'] = train_cli.optimizer_digest(ck.load()['optimizer'])
    out['resume'] = _main(train_cli, train + ['--max-steps', '3',
                                              '--auto-resume'])
    out['steps'] = ck.latest_step()
    out['trained'] = _main(test_cli, [SMOKE, '--device', 'cpu', '--dtype',
                                      'float32', '--checkpoint', ck.path(3)]
                           + opts)
    return out


def test_tools_test_smoke_to_ap(clis):
    rc, text, annos = clis['plain']
    assert rc == 0 and len(annos) == 4
    assert sum(len(a['name']) for a in annos) > 0
    _ap_lines(text)


def test_tools_test_smoke_fuse_conv_bn(clis):
    (rc, text, fused), (_, _, plain) = clis['fused'], clis['plain']
    assert rc == 0 and '[fuse] 55 BatchNorm(s) folded' in text
    _ap_lines(text)
    for f, p in zip(fused, plain):
        chip_smoke._annos_match('fused', f, p)


@pytest.mark.parametrize('config', ['smoke', 'monoflex'])
def test_tools_test_synthetic(clis, config):
    rc, text = clis['synthetic'][SMOKE if config == 'smoke' else MONOFLEX]
    assert rc == 0 and 'finite=True' in text, text
    assert 'boxes3d: shape=(1, 100, 7)' in text


def test_shipped_config_is_refused_without_kitti_mono(clis):
    """The shipped config says type='KittiDataset': both CLIs exit 2, as
    for any mono type whose data type is wrong."""
    assert clis['refused'] == (2, 2)


def test_tools_train_smoke(clis):
    (rc, text), (rc2, text2) = clis['train'], clis['resume']
    assert rc == 0 and rc2 == 0
    for key in TERMS + ('grad_norm',):
        assert re.search(rf' {key}=[-0-9.]+', text), key
    assert f'resumed from step 2 (optimizer state sha1 {clis["digest"]})' \
        in text2 and 'step 3/3' in text2
    assert clis['steps'] == 3 and clis['trained'][0] == 0
    _ap_lines(clis['trained'][1])


def test_tools_train_smoke_synthetic(clis):
    rc, text = clis['synthetic_train']
    assert rc == 0 and re.search(r'^step 1/1 .* loss_bbox=[-0-9.]+', text,
                                 re.M), text[-1000:]


def test_jax_smoke_kitti_eval_fails_where_port_gives_ap(pair, clis):
    """JAX's `kitti_mono_eval` (tools/test.py:139-148) takes sample 0 of
    each leaf of `smoke_predict`'s output and reads its 'mask': the
    unbatched dict has none (nor 'boxes3d'). The port's padded dict gives
    annos, and its CLI the AP lines (`test_tools_test_smoke_to_ap`)."""
    det = jax.tree.map(lambda x: np.asarray(x)[0], jax.tree.map(
        np.asarray, J.smoke_predict(pair['jout'],
                                    pair['batch']['cam2img'],
                                    pair['jcfg'])))
    p2 = np.asarray(pair['batch']['cam2img'][0])[:3]
    with pytest.raises(KeyError, match='mask'):
        j_cam_annos(det, p2, (H, WID))
    assert clis['plain'][0] == 0
    pdet = {k: v[0] for k, v in pair['pdet'].items()}
    assert len(j_cam_annos(pdet, p2, (H, WID))['name']) > 0
