"""H3DNet against the JAX package, on the CPU.

* `box_surface_line_centers` of yawed boxes: within 1e-6;
* an H3DNet of small heads (16 proposals, 4 classes, 3 heading bins; two
  of the fixed SSG backbone towers) on 2,500 points in a 2 m cube with
  the height feature, without and with the cues (the shipped config's
  matching), eval mode: every leaf carried by the key map, the seeds
  equal, the initial and refined proposals, the three primitive heads
  and the cue outputs within OUT_REL 1e-5 relative L2 (measured 5e-7);
* `h3dnet_loss` (both modes: the initial and refined VoteNet terms, the
  primitives' existence and centre terms and the cues' objectness and
  class) within TERM_RTOL 1e-5 and `h3dnet_predict` within 1e-6 (labels
  equal);
* `lidar_synth` equals JAX's H3DNet batch (VoteNet's); `tools.test`
  with `--synthetic`, `tools.test` and `tools.train` on a ScanNet tree
  (finite mAP / mAR lines, 2 steps on `IndoorSource`, one tower). JAX's
  indoor route raises KeyError for H3DNet as for VoteNet: its predict is
  `votenet_predict`, whose 'boxes_3d' JAX reads as 'boxes3d'
  (tests/test_torch_indoor.py, ROADMAP.md §3).

The training step: tests/test_torch_h3dnet_step.py.
"""

import contextlib
import io
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfm_tpu.models.detectors.h3dnet as JH
from dfm_tpu_torch.models.detectors.h3dnet import (H3DNet, H3DNetConfig,
                                                   box_surface_line_centers,
                                                   h3dnet_loss,
                                                   h3dnet_predict)
from dfm_tpu_torch.models.detectors.votenet import VoteNetConfig
from dfm_tpu_torch.runtime.adapters import lidar_synth
from dfm_tpu_torch.tools import create_data
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_imvotenet import gt_near, scene
from test_torch_train_step import random_variables
from torch_lidar_common import jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic ScanNet tree)

OUT_REL = 1e-5
TERM_RTOL = 1e-5
MEANS = ((0.8, 0.8, 0.9), (1.8, 1.8, 1.2), (0.6, 0.6, 0.7), (1.4, 1.5, 0.8))
TINY = dict(num_classes=4, num_heading_bins=3, num_proposals=16,
            mean_sizes=MEANS, num_backbones=2)
CONFIG = os.path.join(ROOT, 'configs', 'h3dnet_scannet.py')
CLI_TINY = ['model.num_proposals=16', 'model.num_backbones=1',
            'data.batch_size_per_chip=1', 'data.num_points=2000']
AP_LINE = re.compile(r'^(mA[PR]_0\.(?:25|50)): (\S+)$', re.M)


def test_box_surface_line_centers_match_jax():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.randn(2, 5, 3), rng.uniform(0.3, 2, (2, 5, 3)),
                            rng.uniform(-np.pi, np.pi, (2, 5, 1))],
                           -1).astype(np.float32)
    want = jax.jit(JH.box_surface_line_centers)(boxes)
    got = box_surface_line_centers(t(boxes))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.fixture(scope='module')
def models():
    """JAX and port H3DNets without and with the cues, their seeded
    variables and eval outputs, on the first sample of one scene."""
    pts = scene(0)[:1]
    out = {}
    for cues in (False, True):
        kw = dict(TINY, with_cues=cues)
        jcfg, cfg = JH.H3DNetConfig(**kw), H3DNetConfig(**kw)
        jm = JH.H3DNet(cfg=jcfg)
        variables = random_variables(jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), pts)), 1)
        key_map = W.h3dnet_key_map(cfg)
        want, _ = jax_apply(jm, variables, [pts], False)
        out[cues] = dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables,
                         key_map=key_map, want=want, pts=pts,
                         sd=W.state_dict_from_jax(variables, key_map))
    return out


@pytest.mark.parametrize('cues', [False, True])
def test_key_map_and_forward_match_jax(models, cues):
    m = models[cues]
    assert len(m['sd']) == len(jax.tree.leaves(m['variables']))
    port = H3DNet(m['cfg'])
    port.load_state_dict(m['sd'], strict=True)
    with torch.no_grad():
        got = port.eval()(t(m['pts']))
    want = m['want']
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['seed_xyz'].numpy(), want['seed_xyz'])
    for stage in ('initial', 'refined'):
        assert set(got[stage]) == set(want[stage])
        for k in ('vote_xyz', 'centers', 'raw'):
            assert rel(got[stage][k].numpy(), want[stage][k]) <= OUT_REL, \
                (stage, k)
    for mode in ('z', 'xy', 'line'):
        for g, w in zip(got['prims'][mode], want['prims'][mode]):
            assert rel(g.numpy(), w) <= OUT_REL, mode
    for k in ('cues_obj', 'cues_sem', 'kp_xyz'):
        assert (k in got) == cues
        if cues:
            assert rel(got[k].numpy(), want[k]) <= OUT_REL, k


def _port_out(out):
    return jax.tree.map(t, out)


def _targets(out):
    """Centres to put gt boxes near (`gt_near`'s proposals 0, 2, 4): the
    initial proposals' decoded centres, the refined one's at 2."""
    ini, ref = out['initial'], out['refined']
    ctr = np.array(ini['centers'] + ini['raw'][..., 2:5])
    ctr[:, 2] = (ref['centers'] + ref['raw'][..., 2:5])[:, 2]
    return ctr


@pytest.mark.parametrize('cues', [False, True])
def test_loss_and_predict_match_jax(models, cues):
    m = models[cues]
    out = m['want']
    gt = gt_near(_targets(out), 3)
    jterms = jax.tree.map(float, jax.jit(lambda o, b: JH.h3dnet_loss(
        o, b, m['jcfg']))(jax.tree.map(jnp.asarray, out),
                          jax.tree.map(jnp.asarray, gt))[1])
    _, terms = h3dnet_loss(_port_out(out), {k: t(v) for k, v in gt.items()},
                           m['cfg'])
    assert set(terms) == set(jterms)
    assert ('cues_objectness' in terms) == cues
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), jterms[k],
                                   rtol=TERM_RTOL, atol=1e-9, err_msg=k)
    for k in ('init_loss_center', 'ref_loss_center', 'prim_z_center',
              'prim_line_flag') + (('cues_objectness', 'cues_semantic')
                                   if cues else ()):
        assert jterms[k] > 0, k
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JH.h3dnet_predict(
        o, m['jcfg']))(jax.tree.map(jnp.asarray, out)))
    got = h3dnet_predict(_port_out(out), m['cfg'])
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    want = get_adapter('H3DNet').synthetic_batch(
        types.SimpleNamespace(cfg=JH.H3DNetConfig(num_classes=18)), 2, 3)
    got = lidar_synth(H3DNetConfig(num_classes=18), 2, 3)
    votenet = lidar_synth(VoteNetConfig(num_classes=18), 2, 3)
    assert set(got) == set(want) and got['points'].shape == (2, 256, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], votenet[k], err_msg=k)


def _main(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope='module')
def scannet(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('scannet'))
    chip_smoke.write_scannet_tree(root, seed=5)
    rc, text = _main(create_data, ['scannet', '--root', root, '--splits',
                                   'train', 'val'])
    assert rc == 0 and text.count('wrote 2 infos') == 2
    return root


def test_cli_synthetic_and_scannet(scannet, tmp_path):
    rc, text = _main(test_cli, [CONFIG, '--device', 'cpu', '--dtype',
                                'float32', '--synthetic', '--cfg-options']
                     + CLI_TINY)
    assert rc == 0 and '[synthetic-eval] H3DNet: decoded 3 output ' \
        'arrays, finite=True' in text, text
    opts = ['--cfg-options', f'data.data_root={scannet}'] + CLI_TINY
    rc, text = _main(test_cli, [CONFIG, '--device', 'cpu', '--dtype',
                                'float32'] + opts)
    lines = dict(AP_LINE.findall(text))
    assert rc == 0 and len(lines) == 4 and '[2/2] dets=16' in text, text
    assert all(np.isfinite(float(v)) for v in lines.values())
    rc, text = _main(train_cli, [CONFIG, '--device', 'cpu', '--work-dir',
                                 str(tmp_path), '--max-steps', '2'] + opts)
    assert rc == 0 and 'step 2/2' in text and 'cues_semantic=' in text, text
