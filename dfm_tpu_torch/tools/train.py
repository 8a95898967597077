"""Train DfM, DfMFull, MultiViewDfM, ImVoxelNet, the mono types (FCOSMono3D,
PGD, SMOKEMono3D, MonoFlex), the LiDAR types (VoxelNet, DynamicVoxelNet,
CenterPoint, SASSD, PointRCNN, PartA2, SSD3DNet), MVX or the indoor types
(VoteNet, GroupFree3DNet, H3DNet, ImVoteNet) with the port, in one process
or data-parallel across processes.

    python -m dfm_tpu_torch.tools.train configs/dfm_r34_kitti_3class.py \
        [--cfg-options key=value ...] [--work-dir W] [--auto-resume] \
        [--max-steps N] [--eval-samples N] [--seed S] [--synthetic] \
        [--device cpu] [--tensorboard]
    torchrun --nproc_per_node=N -m dfm_tpu_torch.tools.train CONFIG ...

Port of the DfM / DfMFull / MultiViewDfM / mono branches of
`tools/train.py:38-158, 159-200, 427-649`: the config
(`runtime/config.py`) -> the data:
with `--synthetic`, `SyntheticSource` (`runtime/adapters.py:dfm_synth`,
the batch of step s drawn from seed + s, with teacher points and 2D
targets for DfMFull; `mv_synth` for MultiViewDfM, which has no Waymo
train source in either package and always trains on it; `imvoxel_synth`
for ImVoxelNet, which has no source in either package and exits 2 without
`--synthetic`); else
`kitti_infos_train.pkl` under `data.data_root`
(`python -m dfm_tpu_torch.tools.create_data kitti --splits train val`
writes it) -> `KittiDataset(train=True)` (flip, scale, crop and
photometric distortion from `np.random.default_rng(seed)`), after one
batch drawn and dropped, as JAX's CLI draws its init batch -> the model
of `model.type` in float32, seeded random weights, in train mode (the
banded form: the conv chain is inference-only): `DfM`, or `DfMFull`
(the student under `dfm.`, the FPN + ATSS 2D head from the config's
`atss`, the dense LiDAR teacher restored from `model.teacher_checkpoint`,
a flax msgpack tree read by `utils/msgpack_tree.py`, where that file
exists, and left out of the optimizer), or `MultiViewDfM`, or
`ImVoxelNet` -> `TrainStep` (`dfm_loss`, `dfm_full_loss`, `mvdfm_loss` or
`imvoxelnet_loss`, the gradient clip at 35,
AdamW under the config's LIGA schedule; the depth loss's pixels drawn
from a device generator seeded from (seed, step)) ->
`<work_dir>/ckpts/step_<n>.pth` (the port's state-dict layout, which
`utils/weights.py`'s key maps give for JAX trees) every
`checkpoint.interval_epochs` and at the end, `<work_dir>/metrics.jsonl`,
and, on KITTI data with `kitti_infos_val.pkl`, the KITTI eval of the
student every `schedule.eval_interval` epochs on a float32 model with the
trained weights (`dataset_inference`, `kitti_eval`). `--auto-resume`
continues from the newest checkpoint: weights, optimizer state and step.
The mono types (FCOSMono3D, PGD, SMOKEMono3D; data type 'KittiMono') train
on `KittiMonoSource` (`tools/train.py:102-158, 444-460`): the train infos as
`data/kitti_mono.py:KittiMonoDataset` samples, each image resized to
`data.img_hw`, `batch_size` indices drawn from `rng` a step (in order when
the split holds no more than a batch), the decoded images cached; with
`--synthetic`, `mono_synth` (64x96, PGD with its keypoint keys, MonoFlex
with its keypoints and observation angles). MonoFlex trains on synthetic
batches only: no KITTI source gives its `kpts2d` / `gt_alphas` (JAX's
neither, `tools/train.py:450`), so without `--synthetic` it exits 2 saying
so. Their loss is `fcos_mono3d_loss` / `pgd_mono3d_loss` (with the batch's
P2) / `smoke_loss` / `monoflex_loss`, normalised over the global batch,
under the same schedule, AdamW and clip; no per-epoch eval (JAX's EvalHook
runs for the DfM family alone). The LiDAR detectors VoxelNet,
DynamicVoxelNet, CenterPoint and SASSD on data type 'KittiDataset' train
on `KittiLidarSource`
(`tools/train.py:201-307`): each train frame's velodyne points in the
pseudo-LiDAR frame and its boxes, with ObjectSample from
`dfm_gt_database_infos.pkl` where `create_data --with-gt-db` wrote it,
then flip, rotation, scale, the range filters and a permutation of the
points, in JAX's draw order; with `--synthetic`, `lidar_synth` (512
points uniform in the range). Their losses are `voxelnet_loss` (the
anchor3d or the FreeAnchor head), `centerpoint_loss` and `sassd_loss`.
Every other LiDAR case (CenterPoint on its Waymo config, PointRCNN,
PartA2, SSD3DNet) and MVX (MVXFasterRCNN, DynamicMVXFasterRCNN) have no
train source: with `--synthetic` they train on `lidar_synth` (3DSSD's 1024
points with a zero fourth column) or `mvx_synth` (its points, a 64x96
image and lidar2img), loss `ssd3d_loss` / `mvx_loss` among them; without
it the CLI exits 2 naming the flag (JAX falls back to synthetic batches
silently, `tools/train.py:454-461`). VoteNet, GroupFree3DNet and H3DNet on
data type 'ScanNetDataset' or 'SUNRGBDDataset' train on `IndoorSource`
(`tools/train.py:357-395`: `{scannet,sunrgbd}_infos_train.pkl` under
`data.data_root` as `data/indoor.py` train samples, augmented from the
dataset's own RandomState(0), indices from a fresh permutation of `rng`
each epoch), loss `votenet_loss` / `groupfree3d_loss` / `h3dnet_loss`;
with `--synthetic`, `indoor_synth` (VoteNet, H3DNet: 256 xyz points in a
room cube) or `groupfree3d_synth` (1,024), the model built for 3 point
channels. ImVoteNet trains on `imvotenet_synth` with `--synthetic` only
(256 points, a 48x64 image, 2D boxes and depth2img; loss
`imvotenet_loss`): the indoor datasets give no image inputs (JAX's
neither, whose indoor source feeds it points alone and raises), so
without the flag it exits 2 naming them. Its frozen image branch gets
no gradient, and AdamW still decays it, as JAX's CLI freezes no prefix
of ImVoteNet.
Another model type exits with a message
and code 2, as does a KITTI data root without the train infos (without
`--synthetic`). Runs on the CUDA card unless `--device cpu`.

Under torchrun (`parallel/dist.py`) the global batch is
`data.batch_size_per_chip` x the world size, as JAX's CLI makes it over
its devices: every rank draws the whole global batch from the same
`rng` (on KITTI it decodes every sample of it: the crop draws depend on
each image's size) and the depth pixels on it, and trains on its rows
(`dist.shard_batch`); the gradients, loss terms and BatchNorm moments
are those of the global batch (`runtime/train.py`). The seed is rank
0's; rank 0 alone writes the config, checkpoints, metrics and the eval's
lines, every rank resumes from the same checkpoint, and the per-epoch
KITTI eval runs sharded (`apis.multihost_dataset_inference`). Each rank
takes the card LOCAL_RANK (`--device cpu`: the CPU, gloo).
"""

import argparse
import hashlib
import os
import pickle
import sys
import time

import numpy as np
import torch

from ..apis import init_dfm_model, multihost_dataset_inference
from ..data.collate import build_batch
from ..data.kitti import KittiDataset
from ..data.kitti_mono import (KittiMonoDataset, load_mono_image,
                               mono_info_from_native)
from ..data.waymo import frames_per_sample
from ..evaluation.kitti_eval import kitti_eval
from ..data.dbsampler import DataBaseSampler, paste_objects
from ..data.indoor import INDOOR_DATASETS, indoor_split
from ..models.builder import (IMVOTE_TYPES, INDOOR_TYPES, LIDAR_TYPES,
                              MONO_TYPES, MVX_TYPES, atss_config,
                              build_detector, lidar_class, mono_model)
from ..models.detectors.dfm import DfM
from ..models.detectors.dfm_full import DfMFull
from ..models.detectors.imvoxelnet import ImVoxelNet
from ..models.detectors.multiview_dfm import MultiViewDfM
from ..models.heads.depth_head import sample_depth_pixels
from ..parallel import dist as D
from ..parallel.multihost import broadcast_seed
from ..runtime.checkpoint import CheckpointManager
from ..runtime.config import load_config, merge_options
from ..runtime.adapters import (dfm_synth, imvotenet_synth,
                                imvotenet_to_device, imvoxel_synth,
                                lidar_synth, lidar_to_device, mono_synth,
                                mono_to_device, mv_synth, mv_to_device,
                                mvx_synth, mvx_to_device,
                                synth_point_channels, to_device)
from ..runtime.logging import MetricsLogger
from ..runtime.schedule import liga_schedule
from ..runtime.train import TrainStep, make_optimizer
from ..utils.msgpack_tree import load_msgpack_tree
from ..utils.weights import init_weights, teacher_state_dict

VOXEL_TYPES = ('MultiViewDfM', 'ImVoxelNet')
# the LiDAR types that train on KITTI velodyne points (JAX
# `tools/train.py:456-458`); every other LiDAR case has no source
KITTI_LIDAR_TYPES = ('VoxelNet', 'DynamicVoxelNet', 'CenterPoint', 'SASSD')
TRAINED_TYPES = ('DfM', 'DfMFull') + VOXEL_TYPES + MONO_TYPES + \
    LIDAR_TYPES + MVX_TYPES + IMVOTE_TYPES


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--work-dir', default='work_dirs/default')
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--auto-resume', action='store_true')
    p.add_argument('--max-steps', type=int, default=None,
                   help='cap total steps (debug)')
    p.add_argument('--eval-samples', type=int, default=None,
                   help='cap val samples per eval (debug)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--synthetic', action='store_true',
                   help='train on synthetic batches (no data needed)')
    p.add_argument('--device', default=None,
                   help="torch device; the CUDA card if omitted, 'cpu' to "
                        'run the plain versions on the CPU')
    p.add_argument('--tensorboard', action='store_true',
                   help='also write TensorBoard event files')
    return p.parse_args(argv)


def optimizer_digest(state_dict):
    """sha1 of an optimizer state dict's tensors and step counts, in
    parameter order: equal digests mean a bit-for-bit equal state."""
    h = hashlib.sha1()
    for idx in sorted(state_dict['state']):
        for k in sorted(state_dict['state'][idx]):
            v = state_dict['state'][idx][k]
            h.update(f'{idx}.{k}'.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes()
                     if torch.is_tensor(v) else repr(v).encode())
    return h.hexdigest()


def step_generator(seed, step, device):
    """The device generator of one step, seeded from (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


class KittiDfMSource:
    """KITTI video pipeline -> DfM batches, a fresh permutation of the
    frames each epoch (`tools/train.py:KittiDfMSource`)."""

    def __init__(self, cfg, batch_size, train=True):
        d = cfg.data
        split = 'train' if train else 'val'
        self.ds = KittiDataset(
            d.data_root,
            os.path.join(d.data_root, f'kitti_infos_{split}.pkl'),
            train=train,
            pipeline_kwargs=dict(crop_size=tuple(d.crop_size),
                                 scale_range=tuple(
                                     d.get('scale_range', (1.0, 1.0))),
                                 flip_ratio=d.get('flip_ratio', 0.0),
                                 max_gt=d.max_gt))
        self.batch_size = batch_size
        self.order = None
        self.cursor = 0

    @property
    def steps_per_epoch(self):
        return max(len(self.ds) // self.batch_size, 1)

    def next_samples(self, step, rng):
        """The next batch's pipeline samples, drawn from `rng` (the step
        is not used)."""
        idxs = []
        while len(idxs) < self.batch_size:
            if self.order is None or self.cursor >= len(self.order):
                self.order = rng.permutation(len(self.ds))
                self.cursor = 0
            idxs.append(int(self.order[self.cursor]))
            self.cursor += 1
        return [self.ds.get_sample(i, rng) for i in idxs]

    def next_batch(self, step, rng, device):
        return build_batch(self.next_samples(step, rng), device)


class KittiMonoSource:
    """KITTI images -> FCOSMono3D / PGD batches (`tools/train.py:
    KittiMonoSource`): each info adapted by `mono_info_from_native` (P2
    and the 2D boxes scaled for the `data.img_hw` resize), the image read,
    resized and normalised by `load_mono_image` (at most 65 kept); the
    train split's infos."""

    def __init__(self, cfg, batch_size):
        d = cfg.data
        with open(os.path.join(d.data_root, 'kitti_infos_train.pkl'),
                  'rb') as f:
            infos = pickle.load(f)
        infos = infos['infos'] if isinstance(infos, dict) else infos
        self.img_hw = tuple(d.get('img_hw', (384, 1280)))
        self.ds = KittiMonoDataset(
            [mono_info_from_native(i, d.data_root, self.img_hw)
             for i in infos], max_gt=d.get('max_gt', 32))
        self.batch_size = batch_size
        self._cache = {}

    @property
    def steps_per_epoch(self):
        return max(len(self.ds) // self.batch_size, 1)

    def next_samples(self, step, rng):
        """The batch of `step` as stacked numpy arrays: `batch_size`
        indices from `rng`, or consecutive ones when the split holds no
        more than a batch."""
        n, bs = len(self.ds), self.batch_size
        idxs = [int(i) for i in rng.integers(0, n, bs)] if n > bs else \
            [(step * bs + k) % n for k in range(bs)]
        samples = []
        for i in idxs:
            s = dict(self.ds.get_sample(i))
            path = s.pop('img_path')
            if path not in self._cache:
                if len(self._cache) > 64:
                    self._cache.clear()
                self._cache[path] = load_mono_image(path, self.img_hw)
            s['img'] = self._cache[path]
            samples.append(s)
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def next_batch(self, step, rng, device):
        return mono_to_device(self.next_samples(step, rng), device)


class KittiLidarSource:
    """KITTI velodyne points -> VoxelNet-family batches
    (`tools/train.py:KittiLidarSource`; reference
    kitti-3d-3class.py:10-50): each frame's points in the pseudo-LiDAR
    frame and its 'gt_boxes_pl', ObjectSample where the GT database
    exists (train only), then, drawn from `rng` in this order, a flip
    (y, yaw; p 0.5), a rotation in [-pi/4, pi/4) and a scale in [0.95,
    1.05); the points and the boxes' centres kept inside the config's
    point-cloud range, at most `data.max_points` points in a permuted
    order, at most `data.max_gt` boxes. JAX augments the info's own box
    array in place (`np.asarray` of a float32 array is the array), so a
    frame drawn again starts from its last augmentation; the port copies
    it (ROADMAP, faults)."""

    SAMPLE_GROUPS = dict(Car=12, Pedestrian=6, Cyclist=6)
    MIN_POINTS = dict(Car=5, Pedestrian=10, Cyclist=10)

    def __init__(self, cfg, batch_size, train=True):
        d = cfg.data
        split = 'train' if train else 'val'
        with open(os.path.join(d.data_root,
                               f'kitti_infos_{split}.pkl'), 'rb') as f:
            self.infos = pickle.load(f)
        self.ds = KittiDataset(d.data_root, self.infos, train=train)
        self.max_points = d.get('max_points', 18000)
        self.max_gt = d.get('max_gt', 40)
        self.pcr = np.asarray(cfg.model.get(
            'point_cloud_range', (0, -40, -3, 70.4, 40, 1)), np.float32)
        self.train = train
        self.batch_size = batch_size
        self.sampler = None
        db = os.path.join(d.data_root, 'dfm_gt_database_infos.pkl')
        if train and os.path.exists(db):
            self.sampler = DataBaseSampler(
                db, d.data_root, self.SAMPLE_GROUPS,
                classes=['Car', 'Pedestrian', 'Cyclist'],
                filter_by_min_points=self.MIN_POINTS)
            if D.is_main():
                print(f'[data] ObjectSample GT database: {db}', flush=True)
        self.order = None
        self.cursor = 0

    def __len__(self):
        return len(self.infos)

    @property
    def steps_per_epoch(self):
        return max(len(self.infos) // self.batch_size, 1)

    def sample(self, idx, rng):
        """One frame's dict of numpy arrays: points (max_points, 3),
        point_mask, gt_boxes (max_gt, 7), gt_labels, gt_mask."""
        info = self.infos[idx]
        pts = self.ds._load_points_pl(info)
        boxes = np.array(info['annos']['gt_boxes_pl'],
                         np.float32).reshape(-1, 7)
        labels = np.asarray(info['annos']['labels'], np.int64)
        if pts is None:
            pts = np.zeros((1, 3), np.float32)
        if self.train:
            if self.sampler is not None:
                pts, boxes, labels = paste_objects(pts, boxes, labels,
                                                   self.sampler)
            if rng.random() < 0.5:                 # horizontal flip
                pts[:, 1] = -pts[:, 1]
                boxes[:, 1] = -boxes[:, 1]
                boxes[:, 6] = -boxes[:, 6]
            rot = rng.uniform(-0.78539816, 0.78539816)
            c, s = np.cos(rot), np.sin(rot)
            mat = np.array([[c, -s], [s, c]], np.float32)
            pts[:, :2] = pts[:, :2] @ mat.T
            boxes[:, :2] = boxes[:, :2] @ mat.T
            boxes[:, 6] += rot
            scale = rng.uniform(0.95, 1.05)
            pts[:, :3] *= scale
            boxes[:, :6] *= scale
        pcr = self.pcr
        pts = pts[(pts[:, 0] >= pcr[0]) & (pts[:, 0] < pcr[3]) &
                  (pts[:, 1] >= pcr[1]) & (pts[:, 1] < pcr[4]) &
                  (pts[:, 2] >= pcr[2]) & (pts[:, 2] < pcr[5])]
        bkeep = ((boxes[:, 0] >= pcr[0]) & (boxes[:, 0] < pcr[3]) &
                 (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] < pcr[4]))
        boxes, labels = boxes[bkeep], labels[bkeep]
        out_pts = np.zeros((self.max_points, 3), np.float32)
        mask = np.zeros((self.max_points,), bool)
        sel = rng.permutation(len(pts))[:self.max_points]
        out_pts[:len(sel)] = pts[sel]
        mask[:len(sel)] = True
        g = min(len(boxes), self.max_gt)
        gt_boxes = np.zeros((self.max_gt, 7), np.float32)
        gt_labels = np.zeros((self.max_gt,), np.int64)
        gt_mask = np.zeros((self.max_gt,), bool)
        gt_boxes[:g] = boxes[:g]
        gt_labels[:g] = labels[:g]
        gt_mask[:g] = True
        return dict(points=out_pts, point_mask=mask, gt_boxes=gt_boxes,
                    gt_labels=gt_labels, gt_mask=gt_mask)

    def next_samples(self, step, rng):
        """The next batch, stacked (numpy), a fresh permutation of the
        frames each epoch (the step is not used)."""
        idxs = []
        while len(idxs) < self.batch_size:
            if self.order is None or self.cursor >= len(self.order):
                self.order = rng.permutation(len(self.infos))
                self.cursor = 0
            idxs.append(int(self.order[self.cursor]))
            self.cursor += 1
        samples = [self.sample(i, rng) for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def next_batch(self, step, rng, device):
        return lidar_to_device(self.next_samples(step, rng), device)


class IndoorSource:
    """ScanNet / SUN RGB-D -> VoteNet / GroupFree3D / H3DNet batches (`tools/train.py:357-395`):
    the split's infos as `data/indoor.py` samples (`data.num_points`
    points, `data.max_gt` boxes; train-time flips, rotation and scale from
    the dataset's own RandomState(0)), `batch_size` indices a step from a
    fresh permutation of `rng` each epoch."""

    def __init__(self, cfg, batch_size):
        self.ds = indoor_split(cfg.data, 'train')
        self.batch_size = batch_size
        self.order = None
        self.cursor = 0

    def __len__(self):
        return len(self.ds)

    @property
    def steps_per_epoch(self):
        return max(len(self.ds) // self.batch_size, 1)

    def next_samples(self, step, rng):
        """The next batch, stacked (numpy); the step is not used."""
        idxs = []
        while len(idxs) < self.batch_size:
            if self.order is None or self.cursor >= len(self.order):
                self.order = rng.permutation(len(self.ds))
                self.cursor = 0
            idxs.append(int(self.order[self.cursor]))
            self.cursor += 1
        samples = [self.ds.get_sample(i) for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def next_batch(self, step, rng, device):
        return lidar_to_device(self.next_samples(step, rng), device)


class SyntheticSource:
    """`tools/train.py:SyntheticSource`: the batch of step s is
    `dfm_synth(cfg, batch_size, seed + s, full)` for DfM / DfMFull (32x64
    images, as JAX's adapter makes them; `full` for DfMFull),
    `mv_synth(cfg, batch_size, seed + s)` for MultiViewDfM (2 views of
    32x48, `frames` frames: `data/waymo.py:frames_per_sample`),
    `imvoxel_synth` for ImVoxelNet (one 32x48 image), or
    `mono_synth(batch_size, seed + s)` for the mono types (64x96; PGD's
    with its keypoint keys, MonoFlex's with `kpts2d` and `gt_alphas`),
    `lidar_synth(cfg, batch_size, seed + s)` for the LiDAR types (VoteNet's
    and H3DNet's `indoor_synth`, GroupFree3D's `groupfree3d_synth`),
    `mvx_synth` for MVX, `imvotenet_synth` for ImVoteNet;
    `rng` is not drawn from. 16 steps an epoch."""

    steps_per_epoch = 16

    def __init__(self, mcfg, batch_size, seed, kind, frames=1):
        self.cfg, self.batch_size = mcfg, batch_size
        self.seed, self.kind, self.frames = seed, kind, frames

    def next_samples(self, step, rng):
        if self.kind == 'MultiViewDfM':
            return mv_synth(self.cfg, self.batch_size, self.seed + step,
                            frames=self.frames)
        if self.kind == 'ImVoxelNet':
            return imvoxel_synth(self.cfg, self.batch_size, self.seed + step)
        if self.kind in MONO_TYPES:
            return mono_synth(self.batch_size, self.seed + step,
                              kpts=self.kind == 'PGD',
                              flex=self.kind == 'MonoFlex')
        if self.kind in LIDAR_TYPES:
            return lidar_synth(self.cfg, self.batch_size, self.seed + step)
        if self.kind in MVX_TYPES:
            return mvx_synth(self.cfg, self.batch_size, self.seed + step)
        if self.kind in IMVOTE_TYPES:
            return imvotenet_synth(self.cfg, self.batch_size,
                                   self.seed + step)
        return dfm_synth(self.cfg, self.batch_size, self.seed + step,
                         full=self.kind == 'DfMFull')

    def next_batch(self, step, rng, device):
        to = mv_to_device if self.kind in VOXEL_TYPES else \
            mono_to_device if self.kind in MONO_TYPES else \
            lidar_to_device if self.kind in LIDAR_TYPES else \
            mvx_to_device if self.kind in MVX_TYPES else \
            imvotenet_to_device if self.kind in IMVOTE_TYPES else to_device
        return to(self.next_samples(step, rng), device)


def discard_init_draw(source, rng):
    """Draw batch 0 from `source` and `rng` and drop it. JAX's CLI draws
    the batch it initialises the model on before its loop
    (`tools/train.py:514-517`), on a resume too; the port draws it as well,
    so that one seed trains both on the same samples and augmentations."""
    source.next_samples(0, rng)


def restore_teacher(model, path):
    """JAX's teacher restore (`tools/train.py:521-537`): the flax msgpack
    tree at `path` replaces the teacher's parameters, and its running
    statistics where the tree has 'batch_stats'. Raises KeyError for a
    tree that is not a dense `LidarTeacher`'s (`teacher_state_dict`)."""
    sd = teacher_state_dict(load_msgpack_tree(path))
    missing, unexpected = model.lidar_teacher.load_state_dict(sd,
                                                              strict=False)
    bad = unexpected + [k for k in missing
                        if not k.endswith(('running_mean', 'running_var'))]
    if bad:
        raise KeyError(f'teacher file {path}: keys {bad}')


def run_eval(cfg, mcfg, model, device, max_samples):
    """The EvalHook: KITTI AP of the trained weights on the val split, a
    float32 model in its eval form, each rank inferring its shard of the
    frames; rank 0 prints the AP. Nothing without val infos."""
    d = cfg.data
    val_info = os.path.join(d.data_root, 'kitti_infos_val.pkl')
    if not os.path.exists(val_info):
        return None
    val_ds = KittiDataset(d.data_root, val_info, train=False,
                          pipeline_kwargs=dict(crop_size=tuple(d.crop_size),
                                               max_gt=d.max_gt))
    handle = init_dfm_model(mcfg, dtype=torch.float32, device=device)
    handle['model'].load_state_dict(model.student.state_dict())
    n = min(len(val_ds), max_samples or len(val_ds))
    dt_annos = multihost_dataset_inference(handle, val_ds, max_samples=n)
    if not D.is_main():
        return None
    gt_annos = []
    for info in val_ds.infos[:n]:
        a = info['annos']
        pl = np.asarray(a['gt_boxes_pl']).reshape(-1, 7)
        gt_annos.append(dict(
            name=np.asarray(a['names']), truncated=a['truncated'],
            occluded=a['occluded'], bbox=a['bbox2d'],
            dimensions=np.stack([pl[:, 3], pl[:, 5], pl[:, 4]], 1),
            location=np.stack([-pl[:, 1], -pl[:, 2], pl[:, 0]], 1),
            rotation_y=-pl[:, 6] - np.pi / 2))
    res = kitti_eval(gt_annos, dt_annos)
    for k in sorted(res):
        if '3d_moderate' in k:
            print(f'[eval] {k}: {res[k]:.4f}', flush=True)
    return res


def draw_depth_pixels(mcfg, gt, generator):
    """The depth loss's pixels of a (global) batch, drawn from `generator`
    as `dfm_loss` would draw them (None for a batch without a depth map
    or a model without the loss)."""
    if gt.get('depth_img') is None or not hasattr(mcfg,
                                                  'num_depth_sample_pixels'):
        return None
    return sample_depth_pixels(gt['depth_img'], mcfg.num_depth_sample_pixels,
                               generator, mcfg.depth_min, mcfg.depth_max)


def build_model(kind, cfg, mcfg, seed, synthetic=False):
    """The float32 model of `kind`, seeded random weights (a point-based
    model built for its synthetic points' width where they differ from
    its default: `synth_point_channels`)."""
    if kind == 'DfMFull':
        model = DfMFull(mcfg, atss_config(cfg.model))
    elif kind in MONO_TYPES:
        model = mono_model(cfg.model)
    elif kind == 'MultiViewDfM':
        model = MultiViewDfM(mcfg)
    elif kind == 'ImVoxelNet':
        model = ImVoxelNet(mcfg)
    elif kind in LIDAR_TYPES + MVX_TYPES + IMVOTE_TYPES:
        width = synth_point_channels(mcfg) if synthetic else None
        model = lidar_class(mcfg)(mcfg, **(
            {} if width is None else dict(point_channels=width)))
    else:
        model = DfM(mcfg)
    return init_weights(model, seed)


def main(argv=None):
    args = parse_args(argv)
    cfg = merge_options(load_config(args.config), args.cfg_options)
    kind = cfg.model.get('type', '')
    if kind not in TRAINED_TYPES:
        print(f'[model] training of model type {kind!r} is not ported yet '
              f'to dfm_tpu_torch (trained here: {", ".join(TRAINED_TYPES)})',
              file=sys.stderr)
        return 2
    d = cfg.get('data', {}) or {}
    multiview = kind == 'MultiViewDfM'
    if kind == 'MonoFlex' and not args.synthetic:
        print('[data] MonoFlex trains on synthetic batches only: no KITTI '
              'source gives its kpts2d / gt_alphas (JAX wires none either); '
              'pass --synthetic', file=sys.stderr)
        return 2
    if kind == 'ImVoxelNet' and not args.synthetic:
        print('[data] ImVoxelNet trains on synthetic batches only: no data '
              'source is wired for it (JAX wires none either); pass '
              '--synthetic', file=sys.stderr)
        return 2
    if kind in IMVOTE_TYPES and not args.synthetic:
        print(f'[data] {kind} trains on synthetic batches only: the indoor '
              f'datasets (here {d.get("type", "")!r}) give no img, '
              'bboxes_2d or depth2img, its image inputs (JAX\'s '
              'SUNRGBDDataset neither: its indoor source feeds the model '
              'points alone and raises); pass --synthetic', file=sys.stderr)
        return 2
    indoor = kind in INDOOR_TYPES and d.get('type', '') in INDOOR_DATASETS
    if (kind in LIDAR_TYPES + MVX_TYPES) and not args.synthetic and \
            not indoor and (kind not in KITTI_LIDAR_TYPES or
                            d.get('type', '') != 'KittiDataset'):
        print(f'[data] {kind} on dataset type {d.get("type", "")!r} has no '
              'train source (JAX wires KITTI velodyne points for VoxelNet, '
              'DynamicVoxelNet, CenterPoint and SASSD on KittiDataset alone, '
              'indoor scenes for VoteNet, GroupFree3DNet and H3DNet on '
              'ScanNetDataset / SUNRGBDDataset, '
              'and falls back to synthetic batches otherwise); pass '
              '--synthetic', file=sys.stderr)
        return 2
    want, info = ('KittiMono' if kind in MONO_TYPES else 'KittiDataset',
                  'kitti_infos_train.pkl')
    if indoor:
        want = d.type
        info = f'{INDOOR_DATASETS[want][0]}_infos_train.pkl'
    if not args.synthetic and not multiview and (
            d.get('type', '') != want or not os.path.exists(
                os.path.join(d.get('data_root', ''), info))):
        print(f'[data] {kind} trains on {want} infos: no '
              f'{info} under {d.get("data_root", "")!r} '
              f'(dataset type {d.get("type", "")!r}); --synthetic trains on '
              'synthetic batches', file=sys.stderr)
        return 2
    device = D.init_from_env(args.device)
    try:
        return train(args, cfg, kind, d, device)
    finally:
        D.destroy()


def train(args, cfg, kind, d, device):
    main_rank = D.is_main()
    say = print if main_rank else (lambda *a, **k: None)
    os.makedirs(args.work_dir, exist_ok=True)
    if main_rank:
        cfg.dump(os.path.join(args.work_dir, 'config.json'))
    seed = broadcast_seed(args.seed)
    mcfg = build_detector(cfg.model)
    full, multiview = kind == 'DfMFull', kind == 'MultiViewDfM'
    model = build_model(kind, cfg, mcfg, seed, args.synthetic)
    world = D.world_size()
    say(f'[model] {kind}, float32, on {device}'
        + (f', rank 0 of {world} ({D.backend()})' if D.is_active() else ''),
        flush=True)
    tck = cfg.model.get('teacher_checkpoint', '') if full else ''
    if tck and os.path.exists(tck):
        restore_teacher(model, tck)
        say(f'[teacher] restored from {tck}', flush=True)
    elif tck:
        say(f'[teacher] {tck!r} not found -> the frozen teacher keeps '
            'its random init (set model.teacher_checkpoint)', flush=True)
    model = model.to(device)

    # the global batch: batch_size_per_chip on each rank
    batch_size = d.get('batch_size_per_chip', 1) * world
    if multiview and not args.synthetic:
        say('[data] no Waymo train source: MultiViewDfM trains on synthetic '
            'batches (pass --synthetic to silence)', flush=True)
    if args.synthetic or kind in VOXEL_TYPES:
        source = SyntheticSource(
            mcfg, batch_size, seed, kind,
            frames_per_sample(d, mcfg) if multiview else 1)
    elif kind in MONO_TYPES:
        source = KittiMonoSource(cfg, batch_size)
    elif kind in INDOOR_TYPES:
        source = IndoorSource(cfg, batch_size)
    elif kind in LIDAR_TYPES:
        source = KittiLidarSource(cfg, batch_size)
    else:
        source = KittiDfMSource(cfg, batch_size)
    steps_per_epoch = source.steps_per_epoch
    sched_cfg = cfg.get('schedule', {}) or {}
    total_steps = steps_per_epoch * sched_cfg.get('total_epochs', 1)
    log_interval = sched_cfg.get('log_interval', 50)
    opt = cfg.get('optimizer', {}) or {}
    schedule = liga_schedule(
        opt.get('lr', 1e-3), opt.get('warmup_iters', 100),
        opt.get('warmup_ratio', 0.1),
        decay_steps=[e * steps_per_epoch
                     for e in opt.get('decay_epochs', (1000,))],
        gamma=opt.get('gamma', 0.1))
    # the reference freezes the LiDAR teacher (dfm.py:72-75): no update
    # and no decay
    optimizer = make_optimizer(model, opt.get('weight_decay', 1e-4),
                               ('lidar_teacher',) if full else ())

    ck = cfg.get('checkpoint', {}) or {}
    ckpt = CheckpointManager(os.path.join(args.work_dir, 'ckpts'),
                             max_keep=ck.get('max_keep', 10))
    start_step = 0
    if args.auto_resume and ckpt.latest_step() is not None:
        start_step = ckpt.restore(model, optimizer)
        # every rank restores, and says so
        print(('' if main_rank else f'[rank {D.rank()}] ')
              + f'resumed from step {start_step} (optimizer state sha1 '
              f'{optimizer_digest(optimizer.state_dict())})', flush=True)
    D.broadcast_module(model)
    train_step = TrainStep(model, optimizer, schedule,
                           opt.get('grad_clip_norm', 35.0), step=start_step)
    logger = MetricsLogger(args.work_dir, use_tensorboard=args.tensorboard) \
        if main_rank else None

    rng = np.random.default_rng(seed)
    discard_init_draw(source, rng)
    max_steps = args.max_steps or total_steps
    ck_interval = ck.get('interval_epochs', 1) * steps_per_epoch
    eval_interval = sched_cfg.get('eval_interval', 1) * steps_per_epoch
    step = start_step
    t0 = time.time()
    try:
        while step < max_steps:
            inputs, cond, gt = source.next_batch(step, rng, device)
            gen = step_generator(seed, step, device)
            # the depth pixels of the global batch, then this rank's rows
            # of both (the whole batch without a group)
            pix = draw_depth_pixels(mcfg, gt, gen)
            inputs, cond, gt, pix = D.shard_batch((inputs, cond, gt, pix))
            metrics = train_step(inputs, cond, gt, gen, pix)
            step += 1
            if step % log_interval == 0 or step == 1 or step == max_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m['s_per_iter'] = (time.time() - t0) / (step - start_step)
                if logger is not None:
                    logger.log(step, m)
                say(f'step {step}/{max_steps} ({m["s_per_iter"]:.2f}s/it) '
                    + ' '.join(f'{k}={v:.4f}' for k, v in m.items()),
                    flush=True)
            if step % ck_interval == 0:
                if main_rank:
                    ckpt.save(step, model, optimizer, cfg.to_dict())
                if step % eval_interval == 0 and \
                        isinstance(source, KittiDfMSource):
                    run_eval(cfg, mcfg, model, device, args.eval_samples)
        path = ckpt.save(step, model, optimizer, cfg.to_dict()) \
            if main_rank else ckpt.path(step)
        D.barrier()
    finally:
        if logger is not None:
            logger.close()
    say(f'training done: step {step}, checkpoint {path}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
