"""nuScenes-mono in the port against the JAX package, on the CPU.

On a tree the tests write (three 90x160 camera images, 90 not a multiple
of 32 as nuScenes' 900 is not, encoded by `cv2.imencode` as 4:2:0
JPEGs; an infos pickle a model):

* `NuScenesMonoDataset` samples against JAX's `get_sample`, key for key
  exactly (the port reads the JPEGs with `data/jpeg.py`, JAX with
  `cv2.imread`), `len` and `get_cat_ids` alike;
* `nuscenes_detection_metrics` against JAX's on seeded detections and
  GTs (near matches, misses, other classes, attributes), every key
  within 1e-6, and `evaluate` with padding masks;
* `tools.test` to the NDS lines against JAX's `nuscenes_real_eval`
  (`tools/test.py:348-404`) on the same carried weights, for FCOS3D
  (`configs/fcos3d_r101_nus_mono.py`) and PGD
  (`configs/pgd_r101_nus_mono_1x.py`), both with `pred_velo` and
  `pred_attrs`, cut to ResNet-18 and width 32, float32: the same
  detection counts per image and every printed metric within 1e-4 (the
  lines are printed to 4 decimals). Each raw image goes into both
  models unnormalised and unresized, as JAX's CLI gives it (ROADMAP.md
  §3); the backbone's first BatchNorm is given running statistics of
  that scale so that the decode stays finite. The GT of each image is
  made from the port's own detections on it (moved, a few dropped, a
  foreign class added), so that every threshold matches some boxes.
  The FPN's top-down sizes at 90 rows (23, 12, 6, 3 at the levels from
  stride 4) are JAX's: the same counts of boxes come out.
* `tools.train` on the nuScenes config exits 2 and names `--synthetic`
  (JAX wires no nuScenes source).
"""

import contextlib
import io
import os
import pickle
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from dfm_tpu.data import nuscenes as J
from dfm_tpu_torch.data import nuscenes as P
from dfm_tpu_torch.models.builder import build_detector, mono_model
from dfm_tpu_torch.runtime.config import load_config, merge_options
from dfm_tpu_torch.tools import test as test_cli
from dfm_tpu_torch.tools import train as train_cli
from dfm_tpu_torch.utils import weights as W

from test_torch_multiview_dfm import flax_variables

torch.set_num_threads(1)    # from import on; the workers share the cores

cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
HW = (90, 160)
N_IMG = 3
METRIC_TOL = 1e-6
LINE_TOL = 1e-4
CONFIGS = {'FCOSMono3D': 'configs/fcos3d_r101_nus_mono.py',
           'PGD': 'configs/pgd_r101_nus_mono_1x.py'}
TINY_OPTS = ['model.backbone_depth=18', 'model.in_channels=32',
             'model.feat_channels=32', 'model.nms_pre=100',
             'model.max_num=20', 'model.depth_branch=(16,)']
METRIC_LINE = re.compile(r'^([A-Za-z_]+): (-?[0-9.]+|nan)$', re.M)


def scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x / w * 200 + 20, y / h * 180 + 40,
                    (x + y) / (h + w) * 150 + 60], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0,
                   255).astype(np.uint8)


def cam2img(i):
    return np.array([[80.0 + 5 * i, 0, 80.0, 0], [0, 80.0 + 5 * i, 45.0, 0],
                     [0, 0, 1, 0]], np.float32)


def write_infos(root, name, gts):
    """An infos pickle: one dict an image, its GT (G, 9) boxes, names
    and attributes from `gts`."""
    infos = [dict(token=f'tok{i}', img_path=f'samples/CAM_FRONT/{i}.jpg',
                  cam2img=cam2img(i)[:3, :3], width=HW[1], height=HW[0],
                  gt_boxes=g['boxes'], gt_names=g['names'],
                  gt_attrs=g['attrs']) for i, g in enumerate(gts)]
    with open(os.path.join(root, name), 'wb') as f:
        pickle.dump(infos, f)
    return infos


def seeded_gts(seed, n=N_IMG):
    rng = np.random.default_rng(seed)
    gts = []
    for _ in range(n):
        g = int(rng.integers(2, 6))
        boxes = np.concatenate([rng.uniform(-8, 8, (g, 2)),
                                rng.uniform(-1, 1, (g, 1)),
                                rng.uniform(0.5, 4, (g, 3)),
                                rng.uniform(-np.pi, np.pi, (g, 1)),
                                rng.normal(0, 2, (g, 2))], 1)
        names = [P.NUS_CLASSES[k] for k in rng.integers(0, 10, g)]
        names[-1] = 'animal' if g > 3 else names[-1]      # not a class
        gts.append(dict(boxes=boxes.astype(np.float32), names=names,
                        attrs=rng.integers(0, 9, g)))
    return gts


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nus'))
    os.makedirs(os.path.join(root, 'samples', 'CAM_FRONT'))
    for i in range(N_IMG):
        ok, buf = cv2.imencode('.jpg', scene(*HW, i),
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        with open(os.path.join(root, 'samples', 'CAM_FRONT', f'{i}.jpg'),
                  'wb') as f:
            f.write(buf.tobytes())
    write_infos(root, 'nuscenes_infos_mono_val.pkl', seeded_gts(0))
    return root


def test_samples_match_jax(tree):
    want = J.NuScenesMonoDataset(tree, 'nuscenes_infos_mono_val.pkl')
    got = P.NuScenesMonoDataset(tree, 'nuscenes_infos_mono_val.pkl')
    assert len(got) == len(want) == N_IMG
    for i in range(N_IMG):
        assert got.get_cat_ids(i) == want.get_cat_ids(i)
        s, w = got.get_sample(i), want.get_sample(i)
        assert set(s) == set(w)
        for k in w:
            if k == 'info':
                assert s[k] is got.infos[i]
                continue
            assert s[k].dtype == w[k].dtype and s[k].shape == w[k].shape, k
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)
        assert s['img'].shape == HW + (3,)
        assert s['gt_mask'].sum() == len(got.get_cat_ids(i)) or \
            s['gt_mask'].sum() >= 1


def seeded_case(seed):
    """Detections near some GT boxes and away from others, per image."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(4):
        g = int(rng.integers(0, 7))
        gb = np.concatenate([rng.uniform(-20, 20, (g, 2)),
                             rng.uniform(-2, 2, (g, 1)),
                             rng.uniform(0.5, 5, (g, 3)),
                             rng.uniform(-np.pi, np.pi, (g, 1)),
                             rng.normal(0, 3, (g, 2))], 1)
        gl = rng.integers(0, 10, g)
        pick = rng.random(g) < 0.7
        pb = gb[pick] + rng.normal(0, [0.8] * 2 + [0.1] * 4 + [0.3] * 3,
                                   (int(pick.sum()), 9))
        extra = int(rng.integers(0, 4))
        pb = np.concatenate([pb, np.concatenate([
            rng.uniform(-20, 20, (extra, 2)), rng.uniform(-2, 2, (extra, 1)),
            rng.uniform(0.5, 5, (extra, 3)),
            rng.uniform(-np.pi, np.pi, (extra, 1)),
            rng.normal(0, 3, (extra, 2))], 1)])
        pl = np.concatenate([gl[pick], rng.integers(0, 10, extra)])
        flip = rng.random(len(pl)) < 0.1
        pl = np.where(flip, (pl + 1) % 10, pl)
        preds.append(dict(boxes=pb.astype(np.float32),
                          scores=rng.random(len(pl)).astype(np.float32),
                          labels=pl, attrs=rng.integers(0, 9, len(pl))))
        gts.append(dict(boxes=gb.astype(np.float32), labels=gl,
                        attrs=rng.integers(0, 9, g)))
    return preds, gts


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_detection_metrics_match_jax(seed):
    preds, gts = seeded_case(seed)
    want = J.nuscenes_detection_metrics(preds, gts)
    got = P.nuscenes_detection_metrics(preds, gts)
    assert set(got) == set(want)
    assert want['NDS'] > 0 and want['mAP'] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=METRIC_TOL, err_msg=k)


def test_evaluate_matches_jax(tree):
    """`evaluate` with padded detections (the 'mask' drops rows)."""
    rng = np.random.default_rng(5)
    ds = P.NuScenesMonoDataset(tree, 'nuscenes_infos_mono_val.pkl')
    jds = J.NuScenesMonoDataset(tree, 'nuscenes_infos_mono_val.pkl')
    results = []
    for info in ds.infos:
        gb = np.asarray(info['gt_boxes'])
        boxes = np.concatenate([gb + rng.normal(0, 0.3, gb.shape),
                                rng.normal(0, 5, (4, 9))]).astype(np.float32)
        results.append(dict(
            boxes=boxes, scores=rng.random(len(boxes)).astype(np.float32),
            labels=rng.integers(0, 10, len(boxes)),
            attrs=rng.integers(0, 9, len(boxes)),
            mask=rng.random(len(boxes)) < 0.8))
    want, got = jds.evaluate(results), ds.evaluate(results)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_TOL,
                                   err_msg=k)


def live_variables(kind, jcfg, jm):
    """Seeded flax variables of the tiny model at the tree's image size:
    class bias raised (live boxes), the first BatchNorm's running
    statistics at the scale of a raw 0-255 image."""
    variables = flax_variables(jm, np.zeros((1,) + HW + (3,), np.float32),
                               seed=7)
    head = variables['params']['bbox_head']
    head = head['fcos3d'] if kind == 'PGD' else head
    head['conv_cls']['bias'] = np.full_like(head['conv_cls']['bias'], 1.0)
    bn = variables['batch_stats']['backbone']['BatchNorm_0']
    bn['mean'] = np.full_like(bn['mean'], 30.0)
    bn['var'] = np.full_like(bn['var'], 4e4)
    return variables


def metric_lines(text):
    return {m.group(1): float(m.group(2))
            for m in METRIC_LINE.finditer(text)}


def dets_lines(text):
    return re.findall(r'^\[\d+/\d+\] dets=\d+$', text, re.M)


@pytest.fixture(scope='module')
def cli_runs(tree, tmp_path_factory):
    """For FCOS3D and PGD: the port's detections make the GT of an
    infos file of the model's own; then JAX's `nuscenes_real_eval` and
    the port's `tools.test` on it, the same carried weights."""
    import tools.test as jtest
    from dfm_tpu.models import build_detector as j_build
    from dfm_tpu.runtime.adapters import get_adapter
    from dfm_tpu.runtime.config import load_config as j_load_config
    from dfm_tpu.runtime.config import merge_options as j_merge_options
    from dfm_tpu_torch.apis import detect_mono
    tmp = tmp_path_factory.mktemp('nus_ckpt')
    runs = {}
    for kind, config in CONFIGS.items():
        ann = f'infos_{kind}.pkl'
        opts = TINY_OPTS + [f'data.data_root={tree}', f'data.ann_file={ann}']
        jcfg_all = j_merge_options(j_load_config(config), opts)
        handle = j_build(jcfg_all.model.to_dict())
        variables = live_variables(kind, handle.cfg, handle.module)
        pcfg = merge_options(load_config(config), opts)
        model = mono_model(pcfg.model)
        sd = W.state_dict_from_jax(variables, W.mono_key_map(
            build_detector(pcfg.model), 18))
        model.load_state_dict(sd, strict=True)
        model.eval()
        ckpt = str(tmp / f'{kind}.pth')
        torch.save(sd, ckpt)
        # the GT: the port's own detections, moved; the first dropped
        phandle = dict(model=model, device=torch.device('cpu'),
                       infer=lambda img, cam: model.predict(
                           model(img), tuple(img.shape[1:3]), cam))
        rng = np.random.default_rng(1)
        gts = []
        for i in range(N_IMG):
            img = cv2.imread(os.path.join(tree, 'samples', 'CAM_FRONT',
                                          f'{i}.jpg')).astype(np.float32)
            with torch.no_grad():
                det = detect_mono(phandle, img, cam2img(i))
            m = det['mask'].astype(bool)
            boxes = np.concatenate([det['boxes3d'][m],
                                    det['velocity'][m]], 1)[1:8]
            boxes = boxes + rng.normal(0, 0.2, boxes.shape)
            names = [P.NUS_CLASSES[k] for k in det['labels'][m][1:8]]
            attrs = det['attrs'][m][1:8]
            gts.append(dict(
                boxes=np.concatenate([boxes, rng.normal(
                    0, 5, (1, 9))]).astype(np.float32),
                names=names + ['animal'], attrs=np.append(attrs, 8)))
        write_infos(tree, ann, gts)
        # JAX's route, its init and restore giving the carried variables
        # (flax's eager init of the model compiles op by op: ~50 s)
        args = types.SimpleNamespace(checkpoint=None, max_samples=None,
                                     out=None, fuse_conv_bn=False)
        carried = types.SimpleNamespace(
            init=lambda *a, **k: variables, apply=handle.module.apply)
        out = io.StringIO()
        orig = jtest.restore_variables
        jtest.restore_variables = lambda a, v: v
        try:
            with contextlib.redirect_stdout(out):
                jtest.nuscenes_real_eval(
                    args, jcfg_all, types.SimpleNamespace(
                        type=handle.type, cfg=handle.cfg, module=carried),
                    get_adapter(handle.type))
        finally:
            jtest.restore_variables = orig
        port_out = io.StringIO()
        with contextlib.redirect_stdout(port_out):
            rc = test_cli.main([config, '--checkpoint', ckpt, '--device',
                                'cpu', '--dtype', 'float32',
                                '--cfg-options'] + opts)
        runs[kind] = dict(jax=out.getvalue(), port=port_out.getvalue(),
                          rc=rc)
    return runs


@pytest.mark.parametrize('kind', list(CONFIGS))
def test_cli_nds_lines_match_jax(cli_runs, kind):
    run = cli_runs[kind]
    assert run['rc'] == 0
    want, got = metric_lines(run['jax']), metric_lines(run['port'])
    assert 'NDS' in want and 'mTRANS_ERR' in want and len(want) == 17
    assert set(got) == set(want)
    assert dets_lines(run['port']) == dets_lines(run['jax'])
    assert len(dets_lines(run['jax'])) == N_IMG
    assert want['mAP'] > 0 and want['NDS'] > 0
    for k in want:
        assert abs(got[k] - want[k]) <= LINE_TOL, (k, got[k], want[k])


def test_train_cli_refuses_without_synthetic(tree, tmp_path, capsys):
    opts = TINY_OPTS + [f'data.data_root={tree}']
    assert train_cli.main([CONFIGS['FCOSMono3D'], '--device', 'cpu',
                           '--work-dir', str(tmp_path),
                           '--cfg-options'] + opts) == 2
    assert '--synthetic' in capsys.readouterr().err


def test_fpn_sizes_at_odd_rows():
    """900 and 90 rows through the FCOS3D trunk: the port's FPN levels
    have JAX's sizes (the top-down sum crops the upsampled map)."""
    import jax.numpy as jnp
    from dfm_tpu.models.backbones.resnet import ResNet as JResNet
    from dfm_tpu.models.necks.fpn import FPN as JFPN
    from dfm_tpu_torch.models.backbones.resnet import ResNet
    from dfm_tpu_torch.models.necks.fpn import FPN
    for h, w in ((90, 160), (900, 48)):
        x = jnp.zeros((1, h, w, 3))
        jshapes = jax.eval_shape(lambda v: JFPN(
            out_channels=8, num_outs=5, start_level=1).init_with_output(
            jax.random.PRNGKey(0), JResNet(depth=18).init_with_output(
                jax.random.PRNGKey(0), v, False)[0], False)[0], x)
        with torch.no_grad():
            feats = FPN([64, 128, 256, 512], 8, num_outs=5, start_level=1)(
                ResNet(18)(torch.zeros(1, 3, h, w)))
        assert [tuple(f.shape[2:]) for f in feats] == [
            tuple(s.shape[1:3]) for s in jshapes]
