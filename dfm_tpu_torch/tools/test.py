"""Evaluation of a DfM or mono (FCOS3D, PGD, SMOKE) config on KITTI, of a
MultiViewDfM config on Waymo, of FCOS3D / PGD on nuScenes-mono, or of
VoteNet, GroupFree3D and H3DNet on ScanNet / SUN RGB-D, with the port.

    python -m dfm_tpu_torch.tools.test CONFIG \\
        [--checkpoint X.pth] [--cfg-options key=value ...] \\
        [--max-samples N] [--out P.pkl] [--eval kitti|waymo|none] \\
        [--waymo-gt-bin GT.bin] [--dtype float32] [--device cpu] \\
        [--fuse-conv-bn] [--synthetic]

Port of `tools/test.py:41-47, 64-91` (`--fuse-conv-bn`, `--synthetic`),
`:93-162` (`kitti_mono_eval`), `:163-231` (`kitti_dfm_eval`), `:234-283`
(`indoor_real_eval`), `:286-343` (`waymo_real_eval`) and the branches of
its `main` that reach them.

KITTI (DfM, DfMFull): config -> `kitti_infos_val.pkl` under
`data.data_root` (`python -m dfm_tpu_torch.tools.create_data kitti`
writes it) -> `KittiDataset(train=False)` -> the port's model in its
default form (bfloat16; seeded random weights, or a reference-layout
checkpoint, or one the port's train CLI wrote for DfM or DfMFull: the
student's weights, `student_state_dict`) -> KITTI annos per frame ->
`kitti_eval`, printing the AP of every moderate and every 3d entry.

Waymo (MultiViewDfM): config -> `waymo_infos_val.pkl` under
`data.data_root` -> `WaymoDataset` (load_mode 'lidar_frame', `cam_sync`
from the data config; `data/waymo.py:frames_per_sample` frames a sample:
two for the 10-sweeps config, the sweep's lidar2img rewritten by
ego-motion) -> the port's MultiViewDfM (bfloat16; seeded random
weights or a checkpoint in the port's layout) -> the kept detections of
each frame in the vehicle frame -> `format_results` -> a predictions
.bin -> `evaluate_waymo` against the GT .bin: `--waymo-gt-bin`, else
`gt.bin` under the data root, else one built from the infos
(`gt_objects_from_infos`); prints every LET mAP / mAPH / mAPL line and
the metric that computed them (`official_binary` when WAYMO_METRICS_BIN
names the official binary, `python_fallback` otherwise). The .bin files
go to a temporary directory.

KITTI mono (FCOSMono3D, PGD, SMOKEMono3D; data type 'KittiMono'), as
`tools/test.py:536-559` routes them: the val infos ->
`data/kitti_mono.py:KittiMonoDataset` (each image resized to
`data.img_hw`, P2 and the 2D boxes scaled with it) -> the port's model
(bfloat16; seeded random weights or a checkpoint in the port's layout,
such as the train CLI's) -> padded camera-frame detections -> KITTI annos
with the 2D boxes projected by the original image's P2
(`cam_detections_to_kitti_annos`) -> `kitti_eval`, the same AP lines.
Indoor (VoteNet, GroupFree3DNet, H3DNet; data type 'ScanNetDataset' or
'SUNRGBDDataset'), as `tools/test.py:543-545` routes them:
`{scannet,sunrgbd}_infos_val.pkl` under `data.data_root` (`python -m
dfm_tpu_torch.tools.create_data scannet|sunrgbd` writes it) ->
`data/indoor.py`'s dataset (`train=False`: `data.num_points` points a
scene, with the height feature) -> the model (bfloat16; seeded random
weights or a checkpoint in the port's layout) -> every proposal with its
score and class -> `indoor_eval`, printing the mAP and mAR lines at IoU
0.25 and 0.5. The boxes go in as the model gives them: VoteNet and
H3DNet, trained on the dataset's boxes, whose centres `votenet_loss`
matches to `gt_boxes[..., :3]` (the bottom centre), give bottom centres;
GroupFree3D decodes bottom-centre boxes. JAX's `indoor_real_eval` reads
`boxes3d`, `scores` and `labels` of the predict's output, which the three
name `boxes_3d`, `scores_3d`, `labels_3d`, and raises KeyError
(ROADMAP.md §3); the port reads its keys. ImVoteNet has no real-data
evaluation: the indoor datasets give no image, 2D boxes or depth2img
(JAX's neither: its indoor route calls ImVoteNet with points alone and
raises), so without `--synthetic` it exits 2 naming them.

MonoFlex and ImVoxelNet have no real-data evaluation in either package
(JAX falls back to a synthetic batch): they run with `--synthetic` only,
and exit 2 saying so without it. The outdoor LiDAR detectors (VoxelNet,
DynamicVoxelNet, SASSD, CenterPoint, PointRCNN, PartA2, SSD3DNet) and
MVX have none either; as JAX's `tools/test.py:555-557` does for them,
they run the synthetic evaluation with or without `--synthetic` (their
exit code is its own), except on a
'WaymoDataset' (CenterPoint's Waymo config): JAX routes that to its
multi-view Waymo evaluation, which raises for a LiDAR model (its samples
hold no points; ROADMAP.md §3), so the port exits 2 naming the reason,
and decodes with `--synthetic`.

nuScenes-mono (FCOSMono3D, PGD; data type 'NuScenesMonoDataset'), as
`tools/test.py:348-404, 549-551` route it: `data.ann_file` (default
`nuscenes_infos_mono_val.pkl`) under `data.data_root` ->
`data/nuscenes.py:NuScenesMonoDataset` (JPEG or PNG images, the raw BGR
image into the model, neither normalised nor resized, as JAX's CLI gives
it) -> the kept camera-frame boxes with their velocity (zeros without
one) and attributes -> `nuscenes_detection_metrics`, printing every AP,
the five TP errors, mAP and NDS. A mono model on a 'WaymoDataset' (the
PGD-Waymo configs) exits 2 naming the reason: JAX's route for it fails
(tests/test_torch_waymo_cam.py).

`--fuse-conv-bn` folds every BatchNorm into the convolution before it
after the weights are loaded (`utils/fuse_conv_bn.py`; DfM's GroupNorm
trunks keep their norms; DLA's convs, its neck's DCNv2 and MonoFlex's
edge-fusion 1D convs fold too). `--synthetic` needs no data: one forward
and decode of a batch of one from the train adapters' synthetic batches
(`runtime/adapters.py`: `dfm_synth`, `mv_synth`, `imvoxel_synth`,
`mono_synth`, `lidar_synth`, `mvx_synth`, `imvotenet_synth`), for every
ported type; it prints the decoded arrays' shapes and whether they are
finite, and exits 1 when one is not.

Another model type, or a data root without its info file, exits with a
message and code 2. Runs on the CUDA card unless `--device cpu`, in
bfloat16 unless `--dtype float32`.

Under `torchrun --nproc_per_node=N` (`parallel/dist.py`) each rank loads
the weights and infers frames r, r + N, ... on the card LOCAL_RANK (the
CPU with `--device cpu`); the results are gathered in dataset order
(`apis.allgather_pickled`), and rank 0 alone writes `--out`, evaluates
and prints the metric lines, which equal a one-process run's.
"""

import argparse
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

from ..apis import (_sharded, detect_mono, detect_multiview_sample,
                    detect_sample, init_dfm_model, init_imvoxelnet_model,
                    init_lidar_model, init_mono_model, init_mvdfm_model)
from ..data.indoor import INDOOR_DATASETS, indoor_split
from ..data.kitti import KittiDataset
from ..data.kitti_mono import (KittiMonoDataset, load_mono_image,
                               mono_info_from_native)
from ..data.nuscenes import NuScenesMonoDataset
from ..data.waymo import WaymoDataset, frames_per_sample
from ..evaluation.kitti_eval import kitti_eval
from ..evaluation.results import (cam_detections_to_kitti_annos,
                                  detections_to_kitti_annos)
from ..evaluation.waymo_eval import gt_annos_to_bin, gt_objects_from_infos
from ..models.builder import (IMVOTE_TYPES, INDOOR_TYPES, LIDAR_TYPES,
                              MONO_TYPES, MVX_TYPES, build_detector,
                              mono_backbone_depth, unused_keys)
from ..parallel import dist as D
from ..runtime.adapters import (dfm_synth, imvotenet_synth,
                                imvotenet_to_device, imvoxel_synth,
                                lidar_synth, lidar_to_device, mono_synth,
                                mono_to_device, mv_synth, mv_to_device,
                                mvx_synth, mvx_to_device,
                                synth_point_channels, to_device)
from ..runtime.config import load_config, merge_options
from ..utils.fuse_conv_bn import fuse_conv_bn
from ..utils.weights import load_reference_state_dict, read_checkpoint

INFO_FILE = 'kitti_infos_val.pkl'
WAYMO_INFO_FILE = 'waymo_infos_val.pkl'
NUS_INFO_FILE = 'nuscenes_infos_mono_val.pkl'


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None,
                   help='reference-layout torch checkpoint (.pth), or '
                        "one of the port's train CLI; seeded random weights "
                        'if omitted')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--eval', default=None, choices=['kitti', 'waymo', 'none'],
                   help="the dataset's own metric if omitted")
    p.add_argument('--max-samples', type=int, default=None)
    p.add_argument('--out', default=None,
                   help='pkl of the KITTI annos or the Waymo detections')
    p.add_argument('--waymo-gt-bin', default=None,
                   help='GT Objects .bin; gt.bin under the data root, or '
                        'one built from the infos, if omitted')
    p.add_argument('--dtype', default='bfloat16',
                   choices=['bfloat16', 'float32'])
    p.add_argument('--device', default=None,
                   help="torch device; the CUDA card if omitted, 'cpu' "
                        'to run the plain versions on the CPU')
    p.add_argument('--fuse-conv-bn', action='store_true',
                   help='fold BatchNorm into the convolutions before '
                        'inference (a no-op for the GroupNorm trunks)')
    p.add_argument('--synthetic', action='store_true',
                   help='decode one synthetic batch (no dataset needed)')
    return p.parse_args(argv)


def init_handle(args, cfg, point_channels=None):
    """The inference handle of the config's type, its checkpoint loaded
    (`student_state_dict` for the DfM family) and its BatchNorms folded
    if asked; `point_channels` for a point-based model whose points are
    not of its default width."""
    kind = cfg.model.type
    mcfg = build_detector(cfg.model)
    dtype = getattr(torch, args.dtype)
    if kind == 'MultiViewDfM':
        handle = init_mvdfm_model(mcfg, dtype, args.device)
    elif kind == 'ImVoxelNet':
        handle = init_imvoxelnet_model(mcfg, dtype, args.device)
    elif kind in LIDAR_TYPES + MVX_TYPES + IMVOTE_TYPES:
        handle = init_lidar_model(mcfg, dtype, args.device, point_channels)
    elif kind in MONO_TYPES:
        handle = init_mono_model(mcfg, mono_backbone_depth(cfg.model), dtype,
                                 args.device)
    else:
        handle = init_dfm_model(mcfg, dtype, args.device)
    if args.checkpoint:
        if kind in ('DfM', 'DfMFull'):
            rest = load_reference_state_dict(
                handle['model'], student_state_dict(read_checkpoint(
                    args.checkpoint)))
            why = ' (teacher, ATSS head, num_batches_tracked)'
        else:
            rest, why = handle['load_checkpoint'](args.checkpoint), ''
        print(f'[checkpoint] {args.checkpoint}: {len(rest)} keys not '
              f'taken{why}', flush=True)
    if args.fuse_conv_bn:
        n = fuse_conv_bn(handle['model'])
        print(f'[fuse] {n} BatchNorm(s) folded into their convolutions',
              flush=True)
    return handle


def student_state_dict(ckpt):
    """The weights to evaluate of a checkpoint dict: a DfMFull checkpoint
    of the port's train CLI holds its student under 'dfm.', and those
    keys are taken without the prefix (the others stay, to be reported
    as not taken); any other checkpoint as it is."""
    sd = ckpt.get('state_dict', ckpt)
    if not any(k.startswith('dfm.') for k in sd):
        return sd
    return {k[len('dfm.'):] if k.startswith('dfm.') else k: v
            for k, v in sd.items()}


def print_ap(res):
    for k in sorted(res):
        if 'moderate' in k or '3d' in k:
            print(f'{k}: {res[k]:.4f}')


def kitti_dfm_eval(args, cfg):
    """Build -> load -> infer -> KITTI AP on the val split."""
    handle = init_handle(args, cfg)
    print(f'[model] {cfg.model.type} on {handle["device"]}; config keys '
          f'not used at inference: {unused_keys(cfg.model)}', flush=True)

    d = cfg.data
    ds = KittiDataset(
        d.data_root, os.path.join(d.data_root, INFO_FILE), train=False,
        pipeline_kwargs=dict(crop_size=tuple(d.crop_size), max_gt=d.max_gt))
    rng = np.random.default_rng(0)
    n = min(len(ds), args.max_samples or len(ds))

    def infer(i):
        info = ds.infos[i]
        det = detect_sample(handle, ds.get_sample(i, rng))
        anno = detections_to_kitti_annos(
            det, np.asarray(info['calib']['P2'])[:3],
            info.get('image', {}).get('image_shape', (375, 1242)))
        print(f'[{i + 1}/{n}] dets={len(anno["name"])}', flush=True)
        return anno

    dt_annos = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(dt_annos, f)
    if args.eval != 'none':
        res = kitti_eval(ds.gt_annos()[:n], dt_annos)
        print_ap(res)
        return res
    return None


def kitti_mono_eval(args, cfg):
    """Build -> load -> infer each resized image -> camera-frame boxes ->
    KITTI AP on the val split, the 2D boxes projected with the original
    image's P2 (`tools/test.py:93-162`)."""
    handle = init_handle(args, cfg)
    print(f'[model] {cfg.model.type} on {handle["device"]}; config keys '
          f'not used at inference: {unused_keys(cfg.model)}', flush=True)
    d = cfg.data
    img_hw = tuple(d.get('img_hw', (384, 1280)))
    with open(os.path.join(d.data_root, INFO_FILE), 'rb') as f:
        infos = pickle.load(f)
    infos = infos['infos'] if isinstance(infos, dict) else infos
    ds = KittiMonoDataset(
        [mono_info_from_native(i, d.data_root, img_hw) for i in infos],
        max_gt=d.get('max_gt', 32))
    n = min(len(ds), args.max_samples or len(ds))

    def infer(i):
        s = ds.get_sample(i)
        det = detect_mono(handle, load_mono_image(s['img_path'], img_hw),
                          s['cam2img'])
        anno = cam_detections_to_kitti_annos(
            det, np.asarray(infos[i]['calib']['P2'])[:3],
            infos[i].get('image', {}).get('image_shape', (375, 1242)))
        print(f'[{i + 1}/{n}] dets={len(anno["name"])}', flush=True)
        return anno

    dt_annos = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(dt_annos, f)
    if args.eval != 'none':
        res = kitti_eval([dict(i.get('annos_eval') or i['annos'])
                          for i in infos[:n]], dt_annos)
        print_ap(res)
        return res
    return None


def nuscenes_mono_eval(args, cfg):
    """Build -> load -> infer each image -> NDS metrics
    (`tools/test.py:348-404`, `nuscenes_real_eval`): each raw image goes
    to the model as JAX's CLI gives it, neither normalised nor resized;
    the kept boxes get their predicted velocity (zeros for a model
    without one) as columns 7-8."""
    handle = init_handle(args, cfg)
    print(f'[model] {cfg.model.type} on {handle["device"]}; config keys '
          f'not used at inference: {unused_keys(cfg.model)}', flush=True)
    d = cfg.data
    ds = NuScenesMonoDataset(d.data_root, d.get('ann_file', NUS_INFO_FILE),
                             max_gt=d.get('max_gt', 48))
    n = min(len(ds), args.max_samples or len(ds))

    def infer(i):
        s = ds.get_sample(i)
        det = detect_mono(handle, s['img'].astype(np.float32), s['cam2img'])
        m = det['mask'].astype(bool)
        boxes = det['boxes3d'][m]
        velo = det['velocity'][m][:, :2] if 'velocity' in det else \
            np.zeros((len(boxes), 2), boxes.dtype)
        print(f'[{i + 1}/{n}] dets={int(m.sum())}', flush=True)
        return dict(boxes=np.concatenate([boxes, velo.astype(boxes.dtype)],
                                         -1),
                    scores=det['scores'][m], labels=det['labels'][m],
                    attrs=det['attrs'][m] if 'attrs' in det else None)

    results = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.eval == 'none':
        return None
    ds.infos = ds.infos[:n]
    res = ds.evaluate(results)
    for k in sorted(res):
        if isinstance(res[k], float):
            print(f'{k}: {res[k]:.4f}')
    return res


def indoor_real_eval(args, cfg):
    """Build -> load -> infer each scene -> indoor AP at IoU 0.25 / 0.5
    (`tools/test.py:234-283`, with the predicts' keys)."""
    ds = indoor_split(cfg.data, 'val')
    n = min(len(ds), args.max_samples or len(ds))
    handle = init_handle(args, cfg, ds.get_sample(0)['points'].shape[-1])
    print(f'[model] {cfg.model.type} on {handle["device"]}; config keys '
          f'not used at inference: {unused_keys(cfg.model)}', flush=True)
    dev = handle['device']

    def infer(i):
        pts = torch.from_numpy(ds.get_sample(i)['points'])[None].to(dev)
        det = {k: v[0].cpu().numpy() for k, v in handle['infer'](pts).items()}
        res = dict(boxes3d=det['boxes_3d'], scores=det['scores_3d'],
                   labels=det['labels_3d'], mask=det['labels_3d'] >= 0)
        print(f'[{i + 1}/{n}] dets={int(res["mask"].sum())}', flush=True)
        return res

    results = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.eval == 'none':
        return None
    ds.infos = ds.infos[:n]
    res = ds.evaluate(results)
    for k in sorted(res):
        if k.startswith(('mAP', 'mAR')):
            print(f'{k}: {res[k]:.4f}')
    return res


def synthetic_eval(args, cfg):
    """One forward + decode of a synthetic batch of one (JAX's
    `synthetic_eval`); 1 when an output is not finite."""
    kind = cfg.model.type
    handle = init_handle(args, cfg, synth_point_channels(
        build_detector(cfg.model)))
    mcfg, dev = handle['cfg'], handle['device']
    if kind in ('MultiViewDfM', 'ImVoxelNet'):
        synth = mv_synth if kind == 'MultiViewDfM' else imvoxel_synth
        imgs, l2i, _ = mv_to_device(synth(mcfg, 1, 0), dev)
        det = handle['infer'](imgs, l2i)
    elif kind in LIDAR_TYPES:
        pts, mask, _ = lidar_to_device(lidar_synth(mcfg, 1, 0), dev)
        det = handle['infer'](pts, mask)
    elif kind in MVX_TYPES:
        pts, cond, _ = mvx_to_device(mvx_synth(mcfg, 1, 0), dev)
        det = handle['infer'](pts, *cond)
    elif kind in IMVOTE_TYPES:
        pts, cond, _ = imvotenet_to_device(imvotenet_synth(mcfg, 1, 0), dev)
        det = handle['infer'](pts, None, *cond)
    elif kind in MONO_TYPES:
        img, cam2img, _ = mono_to_device(mono_synth(
            1, 0, kpts=kind == 'PGD', flex=kind == 'MonoFlex'), dev)
        det = handle['infer'](img, cam2img)
    else:
        img, meta, _ = to_device(dfm_synth(mcfg, 1, 0), dev)
        det = handle['infer'](img, meta)
    det = {k: v.detach().cpu() for k, v in det.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in det.values()
                 if v.is_floating_point())
    print(f'[synthetic-eval] {kind}: decoded {len(det)} output arrays, '
          f'finite={finite}')
    for k, v in det.items():
        print(f'  {k}: shape={tuple(v.shape)}')
    return 0 if finite else 1


def waymo_mvdfm_eval(args, cfg):
    """Build -> load -> infer -> Objects .bin -> LET metrics."""
    handle = init_handle(args, cfg)
    mcfg = handle['cfg']
    d = cfg.data
    frames = frames_per_sample(d, mcfg)
    print(f'[model] MultiViewDfM on {handle["device"]}, {frames} frame(s) a '
          'sample', flush=True)
    ds = WaymoDataset(
        d.data_root, os.path.join(d.data_root, WAYMO_INFO_FILE),
        num_frames=frames,
        target_hw=tuple(d.get('target_hw', (640, 960))),
        num_views=d.get('num_views', 5), max_gt=d.get('max_gt', 64),
        load_mode=d.get('load_mode', 'lidar_frame'),
        cam_sync=d.get('cam_sync', False))
    n = min(len(ds), args.max_samples or len(ds))

    def infer(i):
        res = detect_multiview_sample(handle, ds.get_sample(i))
        print(f'[{i + 1}/{n}] dets={len(res["scores_3d"])}', flush=True)
        return res

    results = _sharded(n, infer)
    if not D.is_main():
        return None
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    if args.eval == 'none':
        return None
    ds.infos = ds.infos[:n]
    with tempfile.TemporaryDirectory() as tmp:
        gt_bin = args.waymo_gt_bin or os.path.join(d.data_root, 'gt.bin')
        if not os.path.exists(gt_bin):
            gt_bin = os.path.join(tmp, 'gt.bin')
            n_gt = gt_annos_to_bin(gt_objects_from_infos(
                ds.infos, cam_sync=d.get('cam_sync', False)), gt_bin)
            print(f'[gt] {n_gt} objects from the val infos', flush=True)
        res = ds.evaluate(results, gt_bin, tmp)
    print(f'[metric] {res["_source"]}')
    for k in sorted(res):
        if isinstance(res[k], float):
            print(f'{k}: {res[k]:.4f}')
    return res


def main(argv=None):
    args = parse_args(argv)
    cfg = merge_options(load_config(args.config), args.cfg_options)
    kind = cfg.model.get('type', '')
    try:
        build_detector(cfg.model)
    except (NotImplementedError, ValueError) as e:
        print(f'[model] {e}', file=sys.stderr)
        return 2
    data_type = cfg.data.get('type', '') if 'data' in cfg else ''
    root = cfg.data.get('data_root', '') if 'data' in cfg else ''
    if kind == 'MultiViewDfM':
        want, info, run = 'WaymoDataset', WAYMO_INFO_FILE, waymo_mvdfm_eval
    elif kind in MONO_TYPES and data_type == 'NuScenesMonoDataset':
        want, info, run = (data_type, cfg.data.get('ann_file', NUS_INFO_FILE),
                           nuscenes_mono_eval)
    elif kind in MONO_TYPES:
        want, info, run = 'KittiMono', INFO_FILE, kitti_mono_eval
    elif kind in INDOOR_TYPES:
        want = data_type if data_type in INDOOR_DATASETS else \
            'ScanNetDataset or SUNRGBDDataset'
        info = f'{INDOOR_DATASETS[data_type][0]}_infos_val.pkl' \
            if data_type in INDOOR_DATASETS else 'indoor'
        run = indoor_real_eval
    else:
        want, info, run = 'KittiDataset', INFO_FILE, kitti_dfm_eval
    if args.synthetic:
        run = synthetic_eval
    elif kind in LIDAR_TYPES and data_type == 'WaymoDataset':
        print(f'[data] {kind} on WaymoDataset is not evaluated: JAX routes '
              'it to its multi-view Waymo evaluation, which fails for a '
              "LiDAR model (its samples hold camera images and no 'points', "
              'which the LiDAR model arguments read: KeyError); --synthetic '
              'decodes a synthetic batch', file=sys.stderr)
        return 2
    elif kind in IMVOTE_TYPES:
        print(f'[data] {kind} has no real-data evaluation: the indoor '
              f'datasets (here {data_type!r}) give no img, bboxes_2d or '
              'depth2img, its image inputs (JAX\'s SUNRGBDDataset neither: '
              'its indoor route calls the model with points alone and '
              'raises); --synthetic decodes a synthetic batch',
              file=sys.stderr)
        return 2
    elif (kind in LIDAR_TYPES and kind not in INDOOR_TYPES) or \
            kind in MVX_TYPES:
        print(f'[data] {kind} has no real-data evaluation (JAX wires none '
              'either): running the synthetic evaluation', flush=True)
        run, args.synthetic = synthetic_eval, True
    elif kind in MONO_TYPES and data_type == 'WaymoDataset':
        print(f'[data] {kind} on WaymoDataset (load_mode '
              f'{cfg.data.get("load_mode", "lidar_frame")!r}) is not '
              'evaluated: JAX routes it to its multi-view Waymo evaluation, '
              'which fails for a mono model (the (1, F, V, H, W, 3) image '
              "stack reaches the (B, H, W, 3) model and the ResNet's max "
              'pool raises; it would also merge no cameras and write '
              'camera-frame boxes as vehicle-frame ones); --synthetic '
              'decodes a synthetic batch', file=sys.stderr)
        return 2
    elif kind in ('MonoFlex', 'ImVoxelNet'):
        print(f'[data] {kind} has no real-data evaluation (JAX wires none '
              'either); --synthetic decodes a synthetic batch',
              file=sys.stderr)
        return 2
    elif data_type != want or not os.path.exists(os.path.join(root, info)):
        print(f'[data] {kind} evaluates on {want} infos: no {info} under '
              f'{root!r} (dataset type {data_type!r}); --synthetic decodes '
              'a synthetic batch', file=sys.stderr)
        return 2
    args.device = D.init_from_env(args.device)
    try:
        rc = run(args, cfg)
    finally:
        D.destroy()
    return rc if args.synthetic else 0


if __name__ == '__main__':
    sys.exit(main())
