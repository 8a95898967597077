"""Group-Free 3D and the PointNet++ FP decoder against the JAX package, on
the CPU.

* a GroupFree3D of small widths (4 SA levels of 256, 128, 64, 32 centres
  and 2 FP steps, 48 seed features, 16 proposals, 2 decoder layers of 32
  channels in 4 heads, 4 classes) on 2 x 1,000 points in a 2 m cube with
  the height feature, eval mode: the key map takes every leaf (the
  attention kernels reshaped, the LayerNorms' scale), the seeds, the KPS
  candidates' indices and xyz equal, the seeds' objectness logits and
  each stage's outputs (its keys together) within OUT_REL 1e-5 relative
  L2 (measured 4e-7);
* `PointNet2SASSG` with an FP decoder (three FP steps, the last onto the
  input points without features) within OUT_REL, and FPS asked for more
  points than it is given (2,048 of JAX's synthetic 1,024: the rest repeat
  index 0) equal to JAX's indices;
* `groupfree3d_loss` on JAX's outputs with bottom-centre gt boxes around
  candidates (a padded row), and on made outputs where each gt's 4
  sampling seeds include seeds it does not own (ranked on the 100.0
  ties: lowest index first): every term within TERM_RTOL 1e-5 (measured
  2e-7); `groupfree3d_predict` within 1e-6 (labels equal);
* one training step against JAX's float64 `make_train_step` on gt boxes
  around the train-mode candidates (`torch_lidar_common.check_step` with
  `f64` and `probe`, as VoteNet's: FPS, ball groups and the KPS top-k on
  float32 values make JAX's own float32 step land far from its float64
  one). The weights are `random_variables` seed 2 (measured worst
  parameter 3.9e-5); the weights of other seeds, where the float32
  steps of both packages can lie beyond check_step's rules, in
  tests/test_torch_groupfree3d_seeds.py;
* `lidar_synth` equals JAX's GroupFree3D batch; `tools.test` /
  `tools.train` with `--synthetic` and on a ScanNet tree (finite mAP /
  mAR lines, 2 steps on `IndoorSource`); JAX's indoor route raises
  KeyError ('boxes3d', ROADMAP.md §3) where the port prints the AP lines.
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

import dfm_tpu.models.backbones.pointnet2 as JP
import dfm_tpu.models.detectors.groupfree3d as JG
from dfm_tpu_torch.models.backbones import pointnet2 as P2
from dfm_tpu_torch.models.detectors.groupfree3d import (
    GroupFree3DConfig, GroupFree3DNet, groupfree3d_loss, groupfree3d_predict)
from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
from dfm_tpu_torch.tools import create_data
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_train_step import random_variables
from torch_lidar_common import check_step, jax_apply, rel, t

torch.set_num_threads(1)    # from import on; the workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the synthetic ScanNet tree)

B, N, G = 2, 1000, 4
OUT_REL = 1e-5
TERM_RTOL = 1e-5
MEANS = ((0.8, 0.8, 0.9), (1.8, 1.8, 1.2), (0.6, 0.6, 0.7), (1.4, 1.5, 0.8))
TINY = dict(num_classes=4, num_proposal=16, num_decoder_layers=2,
            embed_dims=32, num_heads=4, ffn_channels=64, mean_sizes=MEANS,
            sa_points=(256, 128, 64, 32), sa_ks=(16, 8, 8, 8),
            sa_mlps=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
            fp_channels=((64, 64), (64, 48)), max_num=16)
CONFIG = os.path.join(ROOT, 'configs', 'groupfree3d_scannet.py')
CLI_TINY = ['model.num_proposal=16', 'model.num_decoder_layers=2',
            'model.embed_dims=32', 'model.num_heads=4',
            'model.ffn_channels=64', 'model.sa_points=(256,128,64,32)',
            'model.sa_ks=(16,8,8,8)',
            'model.sa_mlps=((16,16,32),(32,32,64),(32,32,64),(32,32,64))',
            'model.fp_channels=((64,64),(64,48))',
            'data.batch_size_per_chip=2', 'data.num_points=2000']
AP_LINE = re.compile(r'^(mA[PR]_0\.(?:25|50)): (\S+)$', re.M)


def scene(seed, n=N):
    """(B, n, 4) points in a 2 m cube with a height column."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(B, n, 3) * 2
    return np.concatenate([pts, pts[..., 2:] - 0.1], -1).astype(np.float32)


def gt_around(xyz, seed):
    """Bottom-centre axis-aligned boxes (G, yaw 0) around candidates 0, 3
    and 6 of each sample (each candidate inside, so some seeds lie in
    them), the last row padded."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, G, 7), np.float32)
    labels = rng.randint(0, 4, (B, G))
    mask = np.ones((B, G), bool)
    mask[:, -1] = False
    for i in range(B):
        for j in range(G - 1):
            dims = rng.uniform(0.4, 0.8, 3)
            ctr = xyz[i, 3 * j] + rng.uniform(-0.1, 0.1, 3)
            boxes[i, j] = (ctr[0], ctr[1], ctr[2] - dims[2] / 2, *dims, 0.0)
    return dict(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)


@pytest.fixture(scope='module')
def models():
    jcfg, cfg = JG.GroupFree3DConfig(**TINY), GroupFree3DConfig(**TINY)
    pts = scene(0)
    jm = JG.GroupFree3DNet(cfg=jcfg)
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts)), 2)
    key_map = W.groupfree3d_key_map(cfg)
    want, _ = jax_apply(jm, variables, [pts], False)
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, variables=variables, pts=pts,
                key_map=key_map, want=want,
                sd=W.state_dict_from_jax(variables, key_map))


def _stage_rel(got, want):
    """The relative L2 of a stage's outputs, all keys flattened together
    (a key near 0, as a late stage's objectness can be, keeps only its
    rounding)."""
    return rel(np.concatenate([got[k].numpy().ravel() for k in sorted(want)]),
               np.concatenate([want[k].ravel() for k in sorted(want)]))


def test_key_map_and_forward_match_jax(models):
    assert len(models['sd']) == len(jax.tree.leaves(models['variables']))
    port = GroupFree3DNet(models['cfg'])
    port.load_state_dict(models['sd'], strict=True)
    with torch.no_grad():
        got = port.eval()(t(models['pts']))
    want = models['want']
    assert set(got) == set(want)
    for k in ('seed_points', 'query_points_xyz', 'candidate_idx'):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert rel(got['seeds_obj_cls_logits'].numpy(),
               want['seeds_obj_cls_logits']) <= OUT_REL
    assert len(got['stages']) == len(want['stages']) == 3
    for i, (g, w) in enumerate(zip(got['stages'], want['stages'])):
        assert set(g) == set(w)
        assert _stage_rel(g, w) <= OUT_REL, i


def test_fp_decoder_and_fps_past_the_cloud_match_jax():
    """Three FP steps back to the raw xyz points (no skip features), eval
    mode, and FPS of 2,048 of 1,024 points."""
    kw = dict(sa_points=(64, 32, 16), sa_radii=(0.4, 0.8, 1.2),
              sa_ks=(8, 8, 8), sa_mlps=((8, 16), (16, 32), (16, 32)),
              fp_channels=((32,), (32, 24), (24, 16)))
    jm = JP.PointNet2SASSG(**kw)
    pts = scene(5, 300)[..., :3]
    variables = random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), pts)), 2)
    port = P2.PointNet2SASSG(3, **kw)
    port.load_state_dict(W.state_dict_from_jax(
        variables, W._dense_key_map(port)), strict=True)
    (xyz, feats), _ = jax_apply(jm, variables, [pts], False)
    with torch.no_grad():
        got = port.eval()(t(pts))
    np.testing.assert_array_equal(got[0].numpy(), xyz)
    assert xyz.shape == (B, 300, 3) and feats.shape == (B, 300, 16)
    assert rel(got[1].numpy(), feats) <= OUT_REL
    synth = lidar_synth(GroupFree3DConfig(num_classes=4), 2, 0)['points']
    want = np.asarray(jax.jit(lambda x: JP.batched_fps(x, 2048))(synth))
    got = P2.farthest_point_sample(t(synth), 2048).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[:, 1024:] == 0).all() and len(np.unique(want[0])) == 1024


def _jax_terms(jcfg, out, gt):
    return jax.tree.map(float, jax.jit(lambda o, b: JG.groupfree3d_loss(
        o, b, jcfg))(jax.tree.map(jnp.asarray, out),
                     jax.tree.map(jnp.asarray, gt))[1])


def _port_out(out):
    return {k: [{kk: t(vv) for kk, vv in s.items()} for s in v]
            if k == 'stages' else t(v) for k, v in out.items()}


def _check_terms(terms, jterms, live=True):
    assert set(terms) == set(jterms)
    for k in terms:
        if live:
            assert jterms[k] > 0, k
        np.testing.assert_allclose(float(terms[k]), jterms[k],
                                   rtol=TERM_RTOL, atol=1e-9, err_msg=k)


def test_loss_and_predict_match_jax(models):
    out = models['want']
    gt = gt_around(out['query_points_xyz'], 2)
    _, terms = groupfree3d_loss(_port_out(out), {k: t(v) for k, v in
                                                 gt.items()}, models['cfg'])
    _check_terms(terms, _jax_terms(models['jcfg'], out, gt))
    want = jax.tree.map(np.asarray, jax.jit(lambda o: JG.groupfree3d_predict(
        o, models['jcfg']))(jax.tree.map(jnp.asarray, out)))
    got = groupfree3d_predict(_port_out(out), models['cfg'])
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['labels_3d'].numpy(),
                                  want['labels_3d'])
    for k in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    assert (want['scores_3d'] > 0).any()


def test_sampling_targets_rank_ties_as_jax():
    """Made outputs: seeds 0-6 in box A (3-6 near its centre, its 4
    sampling seeds; 0-2 near its corners), seed 10 alone in box B: B's 4
    sampling seeds are seed 10 and three of the 100.0 ties, seeds 0, 1, 2
    (owned by A, so marked), as `lax.top_k(-comp.T)` ranks them; another
    order among the ties marks seeds in no box (then zeroed)."""
    rng = np.random.RandomState(7)
    s, p, c = 24, 6, 4
    seeds = rng.uniform(3, 5, (1, s, 3)).astype(np.float32)
    seeds[0, :7] = [[0.0, 0.0, 0.05], [0.3, 0.0, 0.55], [0.0, 0.3, 0.05],
                    [0.15, 0.15, 0.3], [0.16, 0.15, 0.3], [0.15, 0.16, 0.3],
                    [0.15, 0.15, 0.31]]
    seeds[0, 10] = [1.5, 1.5, 0.5]
    boxes = np.array([[[0.15, 0.15, 0.0, 0.4, 0.4, 0.6, 0.0],
                       [1.5, 1.5, 0.3, 0.2, 0.2, 0.4, 0.0],
                       [9.0, 9.0, 0.0, 1.0, 1.0, 1.0, 0.0]]], np.float32)
    gt = dict(gt_boxes=boxes, gt_labels=np.array([[1, 2, 0]]),
              gt_mask=np.array([[True, True, False]]))

    def stage():
        return dict(obj_scores=rng.randn(1, p, 1), sem_scores=rng.randn(
            1, p, c), center_residual=rng.randn(1, p, 3),
            center=rng.rand(1, p, 3), size_class=rng.randn(1, p, c),
            size_res_norm=rng.randn(1, p, c, 3) * 0.2)

    out = dict(seeds_obj_cls_logits=rng.randn(1, s), seed_points=seeds,
               query_points_xyz=seeds[:, [0, 10, 3, 5, 7, 9]],
               candidate_idx=np.array([[0, 10, 3, 5, 7, 9]]),
               stages=[stage(), stage()])
    out = jax.tree.map(lambda x: np.asarray(x, np.float32)
                       if x.dtype == np.float64 else x, out)
    cfg = GroupFree3DConfig(num_classes=c, mean_sizes=MEANS)
    _, terms = groupfree3d_loss(_port_out(out), {k: t(v) for k, v in
                                                 gt.items()}, cfg)
    jterms = _jax_terms(JG.GroupFree3DConfig(num_classes=c,
                                             mean_sizes=MEANS), out, gt)
    _check_terms(terms, jterms, live=False)
    # the targets themselves: seeds 3-6 (A's 4 nearest), 10 (B's) and 0,
    # 1, 2 (B's ties)
    from dfm_tpu_torch.models.detectors.groupfree3d import _targets
    samp = _targets(t(seeds), t(out['candidate_idx']), t(boxes),
                    t(gt['gt_labels']), t(gt['gt_mask']),
                    torch.tensor(MEANS), 4)[0]
    assert np.flatnonzero(samp.numpy()[0]).tolist() == [0, 1, 2, 3, 4, 5, 6,
                                                        10]


def test_train_step_matches_jax(models):
    jm, variables = models['jm'], models['variables']
    out, _ = jax_apply(jm, variables, [models['pts']], True)
    gt = gt_around(out['query_points_xyz'], 4)
    batch = dict(points=models['pts'], **gt)
    port = GroupFree3DNet(models['cfg'])
    port.load_state_dict(models['sd'])

    def inputs64(model):
        pts, mask, g = lidar_to_device(batch, 'cpu')
        return pts.double(), mask, {k: v.double() if v.is_floating_point()
                                    else v for k, v in g.items()}

    metrics, worst, whole = check_step(
        jm, lambda o, bt: JG.groupfree3d_loss(o, bt, models['jcfg']),
        variables, models['key_map'], port, jax.tree.map(jnp.asarray, batch),
        lambda bt: (bt['points'],), lidar_to_device(batch, 'cpu'),
        live=('head_s1.cls_out', 'head_s1.reg_out',
              'decoder0.cross_attn.value.weight', 'points_obj_cls',
              'backbone.fp1.mlp0.weight', 'backbone.sa0.mlp0.weight'),
        f64=(JG.GroupFree3DNet(cfg=models['jcfg'], dtype=jnp.float64),
             inputs64),
        probe=True,
        compiler_options={'xla_llvm_disable_expensive_passes': True})
    assert metrics['loss_s1_center'] > 0 and metrics['loss_s1_size_res'] > 0
    print(f'port float32 step against JAX float64: worst parameter '
          f'{worst:.3g}, whole vector {whole:.3g}')


def test_synthetic_batch_matches_jax():
    from dfm_tpu.runtime.adapters import get_adapter
    want = get_adapter('GroupFree3DNet').synthetic_batch(
        types.SimpleNamespace(cfg=JG.GroupFree3DConfig()), 2, 3)
    got = lidar_synth(GroupFree3DConfig(), 2, 3)
    assert set(got) == set(want) and got['points'].shape == (2, 1024, 3)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _main(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope='module')
def scannet(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('scannet'))
    chip_smoke.write_scannet_tree(root, seed=4)
    rc, text = _main(create_data, ['scannet', '--root', root, '--splits',
                                   'train', 'val'])
    assert rc == 0 and text.count('wrote 2 infos') == 2
    return root


def test_cli_synthetic(tmp_path):
    rc, text = _main(test_cli, [CONFIG, '--device', 'cpu', '--dtype',
                                'float32', '--synthetic', '--cfg-options']
                     + CLI_TINY)
    assert rc == 0 and '[synthetic-eval] GroupFree3DNet: decoded 3 output ' \
        'arrays, finite=True' in text, text
    rc, text = _main(train_cli, [CONFIG, '--device', 'cpu', '--synthetic',
                                 '--work-dir', str(tmp_path), '--max-steps',
                                 '1', '--cfg-options'] + CLI_TINY)
    assert rc == 0 and 'loss_sampling_obj=' in text, text


def test_cli_scannet_to_indoor_ap(scannet, tmp_path):
    opts = ['--cfg-options', f'data.data_root={scannet}'] + CLI_TINY
    rc, text = _main(test_cli, [CONFIG, '--device', 'cpu', '--dtype',
                                'float32'] + opts)
    lines = dict(AP_LINE.findall(text))
    assert rc == 0 and len(lines) == 4 and '[2/2] dets=16' in text, text
    assert all(np.isfinite(float(v)) for v in lines.values())
    rc, text = _main(train_cli, [CONFIG, '--device', 'cpu', '--work-dir',
                                 str(tmp_path), '--max-steps', '2'] + opts)
    assert rc == 0 and 'step 2/2' in text and 'loss_s1_sem=' in text, text


def test_jax_indoor_route_raises_key_error(scannet):
    """JAX's `indoor_real_eval` (tools/test.py:234-283) reads
    det0['boxes3d'] of `groupfree3d_predict`'s output
    (groupfree3d.py:324), which names it 'boxes_3d'."""
    import tools.test as jtest
    from dfm_tpu.models import build_detector as j_build
    from dfm_tpu.runtime.adapters import get_adapter
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    cfg = j_merge_options(j_load_config(CONFIG), [
        f'data.data_root={scannet}', 'data.num_points=300'] + CLI_TINY[:-2])
    handle = j_build(cfg.model.to_dict())
    # its init gives seeded variables of the same tree (flax's eager init
    # runs op by op: ~20 s)
    variables = random_variables(jax.eval_shape(lambda: handle.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 300, 4)), train=False)), 0)
    carried = types.SimpleNamespace(init=lambda *a, **k: variables,
                                    apply=handle.module.apply)
    args = types.SimpleNamespace(checkpoint=None, max_samples=1, out=None,
                                 fuse_conv_bn=False)
    with pytest.raises(KeyError, match='boxes3d'), \
            contextlib.redirect_stdout(io.StringIO()):
        jtest.indoor_real_eval(args, cfg, types.SimpleNamespace(
            type=handle.type, cfg=handle.cfg, module=carried),
            get_adapter(handle.type))

