"""Synthetic batches (the train CLI's `--synthetic`) and the model-args
functions of the train step.

Port of `dfm_tpu/runtime/adapters.py:41-117` (`_gt_pack`, `_cam_matrix`,
`_dfm_meta`, `_dfm_synth`), `:149-241` (`_mono_synth` and the FCOS3D /
PGD / SMOKE / MonoFlex adapters) and `:327-372` (`_mv_synth` and the
MultiViewDfM / ImVoxelNet model arguments), `:246-262`
(`_points_synth`, the LiDAR families' points and gt) and the synthetic
batches of `_mk_votenet_adapter:293`, `_mk_ssd3d_adapter:381`,
`_mk_groupfree3d_adapter:404`, `_mk_imvotenet_adapter:455`,
`_mk_h3dnet_adapter:542` (VoteNet's batch) and
`_mk_mvx_adapter:498`: the same draws from
`np.random.default_rng(seed)` in the same order, so that one seed gives
both packages the same batch. A batch is numpy, batched, in the JAX
layout: for DfM 'img' (B, 2, H, W, 3), 'meta' (the `BatchMeta` fields),
the gt keys and, with `full`, DfMFull's teacher points and 2D targets;
for MultiViewDfM 'img' (B, F, V, H, W, 3), 'lidar2img' (B, F, V, 4, 4)
and the gt boxes (ImVoxelNet's without the F and V axes); for the mono
types 'img' (B, H, W, 3), 'cam2img' (B, 4, 4) and the camera-frame gt
(MonoFlex's with `kpts2d` and `gt_alphas`); for the LiDAR types
'points', 'point_mask' (not for PointRCNN and the indoor types) and the gt, for
MVX also 'img' (B, H, W, 3) and 'lidar2img' (B, 4, 4), for ImVoteNet
'img' (B, H, W, 3) 0-255, 'bboxes_2d' (B, M, 6) and 'depth2img' (B, 4,
4). `to_device` / `mv_to_device` / `mono_to_device` / `lidar_to_device`
/ `mvx_to_device` / `imvotenet_to_device` make the model's inputs of it
(`TrainStep`'s (inputs, cond, gt)), as JAX's `model_args_fn`.
"""

import numpy as np
import torch

from ..data.collate import FULL_KEYS, GT_KEYS
from ..models.detectors.dfm import BatchMeta
from ..models.detectors.groupfree3d import GroupFree3DConfig
from ..models.detectors.imvotenet import ImVoteNetConfig
from ..models.detectors.point_rcnn import PointRCNNConfig
from ..models.detectors.ssd3d import SSD3DConfig
from ..models.detectors.votenet import VoteNetConfig

__all__ = ['dfm_meta', 'dfm_synth', 'to_device', 'gt_pack', 'mv_synth',
           'imvoxel_synth', 'mv_to_device', 'mono_synth', 'mono_to_device',
           'lidar_synth', 'lidar_to_device', 'indoor_synth',
           'synth_point_channels', 'mvx_synth', 'mvx_to_device',
           'groupfree3d_synth', 'imvotenet_synth', 'imvotenet_to_device',
           'MONO_GT_KEYS']

MONO_GT_KEYS = ('gt_bboxes2d', 'centers2d', 'gt_depths', 'gt_boxes_cam',
                'gt_labels', 'gt_mask', 'gt_velocities', 'gt_attr_labels',
                'kpts2d', 'gt_alphas')


def dfm_meta(b, h, w):
    """The `BatchMeta` fields (numpy) of `_dfm_meta`: KITTI's focal length
    scaled to the width, the principal point at the centre, no
    augmentation, `org_w` the width."""
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 721.5 * w / 1280.0
    cam[0, 2], cam[1, 2] = w / 2.0, h / 2.0
    cam = np.tile(cam[None], (b, 1, 1))
    eye = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    return dict(ori_cam2img=cam, cam2img=cam, cur2prev=eye,
                org_w=np.full((b,), float(w), np.float32),
                flip=np.zeros((b,), np.float32),
                crop_offset=np.zeros((b, 2), np.float32),
                scale_factor=np.ones((b,), np.float32))


def dfm_synth(cfg, b, seed, h=32, w=64, full=False):
    """`_dfm_synth`: a normal image pair, one gt box on the anchor at the
    grid's centre (class 0, yaw 0.05), a uniform depth map in [3, 53) with
    every pixel foreground; with `full`, 512 teacher points uniform in the
    point-cloud range and one 2D box with its centre."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, 2, h, w, 3), dtype=np.float32)
    nz, ny, nx = cfg.voxel_grid_size()
    grid = cfg.anchor_generator().grid_anchors((ny, nx))
    a = grid[0, ny // 2, nx // 2, 0, 0]
    gt = np.concatenate([a[:6], [0.05]]).astype(np.float32)
    batch = dict(
        img=img, meta=dfm_meta(b, h, w),
        gt_boxes=np.tile(gt[None, None], (b, 1, 1)),
        gt_labels=np.zeros((b, 1), np.int32),
        gt_mask=np.ones((b, 1), bool),
        depth_img=rng.random((b, h, w), dtype=np.float32) * 50 + 3,
        depth_fgmask_img=np.ones((b, h, w), np.int32))
    if full:
        # (float64 products, as JAX's numpy, then float32 as jnp.asarray)
        pcr = np.asarray(cfg.point_cloud_range)
        pts = rng.random((b, 512, 3)).astype(np.float32) \
            * (pcr[3:] - pcr[:3]) + pcr[:3]
        batch['points'] = pts.astype(np.float32)
        batch['point_mask'] = np.ones((b, 512), bool)
        batch['gt_bboxes2d'] = np.tile(np.array(
            [[w * .3, h * .3, w * .6, h * .6]], np.float32), (b, 1, 1))
        batch['centers2d'] = np.tile(np.array([[w * .45, h * .45]],
                                              np.float32), (b, 1, 1))
    return batch


def to_device(batch, device):
    """A batch of `dfm_synth` -> (img, BatchMeta, gt dict), tensors on
    `device`."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    meta = BatchMeta(**{k: t(v) for k, v in batch['meta'].items()})
    gt = {k: t(batch[k]) for k in GT_KEYS + FULL_KEYS if k in batch}
    return t(batch['img']), meta, gt


def gt_pack(rng, b, g=4, cam_frame=False):
    """`_gt_pack`: g boxes per sample, centres uniform in x [2, 50), y
    [-20, 20), z [-2, 0) (vehicle frame), or with `cam_frame` x [-8, 8),
    y [0.5, 2), z [8, 40) (camera frame), sizes in [1.5, 4.2) x [1.4,
    1.8)^2, yaw in [-pi, pi), float32; labels in {0, 1, 2} int32; all
    valid."""
    if cam_frame:
        ctr = np.stack([rng.uniform(-8, 8, (b, g)),
                        rng.uniform(0.5, 2.0, (b, g)),
                        rng.uniform(8, 40, (b, g))], -1)
    else:
        ctr = np.stack([rng.uniform(2, 50, (b, g)),
                        rng.uniform(-20, 20, (b, g)),
                        rng.uniform(-2, 0, (b, g))], -1)
    dim = np.stack([rng.uniform(1.5, 4.2, (b, g)),
                    rng.uniform(1.4, 1.8, (b, g)),
                    rng.uniform(1.4, 1.8, (b, g))], -1)
    yaw = rng.uniform(-np.pi, np.pi, (b, g, 1))
    boxes = np.concatenate([ctr, dim, yaw], -1).astype(np.float32)
    labels = rng.integers(0, 3, (b, g)).astype(np.int32)
    return boxes, labels, np.ones((b, g), bool)


def mv_synth(cfg, b, seed, h=32, w=48, n_views=2, frames=None):
    """`_mv_synth` for MultiViewDfM: `gt_pack`'s boxes with their centres
    clipped into `cfg.voxel_range` (half a size from its faces), then
    normal images (B, F, n_views, H, W, 3), F = `frames` (the config's
    `num_frames` if None); every view the same camera (f = 30 px,
    principal point at the centre) looking down the vehicle's x axis,
    frame f's lidar2img rewritten for 0.5 * f m of forward ego-motion
    since it. For F = 1 the draws and values are JAX's (`_mv_synth` always
    makes one frame)."""
    rng = np.random.default_rng(seed)
    frames = cfg.num_frames if frames is None else frames
    rot = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                    [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 30.0
    cam[0, 2], cam[1, 2] = w / 2.0, h / 2.0
    cam = cam @ rot
    boxes, labels, mask = gt_pack(rng, b)
    img = rng.standard_normal((b, frames, n_views, h, w, 3),
                              dtype=np.float32)
    l2i = np.empty((b, frames, n_views, 4, 4), np.float32)
    l2i[:, 0] = cam
    for f in range(1, frames):
        ego = np.eye(4, dtype=np.float32)
        ego[0, 3] = 0.5 * f
        l2i[:, f] = cam @ ego
    pcr = np.asarray(cfg.voxel_range, np.float32)
    lo = pcr[:3] + boxes[..., 3:6] / 2
    hi = pcr[3:] - boxes[..., 3:6] / 2
    ctr = np.clip(boxes[..., :3], lo, np.maximum(lo, hi))
    return dict(img=img, lidar2img=l2i,
                gt_boxes=np.concatenate([ctr, boxes[..., 3:]], -1),
                gt_labels=labels, gt_mask=mask)


def imvoxel_synth(cfg, b, seed, h=32, w=48):
    """`_mv_synth`'s ImVoxelNet branch: `mv_synth`'s draws for one view of
    one frame (the same normals in the same order), the image (B, H, W,
    3) and lidar2img (B, 4, 4) without the frame and view axes."""
    batch = mv_synth(cfg, b, seed, h, w, n_views=1, frames=1)
    return dict(batch, img=batch['img'][:, 0, 0],
                lidar2img=batch['lidar2img'][:, 0, 0])


def mv_to_device(batch, device):
    """A batch of `mv_synth` (or of Waymo samples stacked the same way) ->
    (imgs, lidar2img, gt dict), tensors on `device`."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(batch['img']), t(batch['lidar2img']), {
        k: t(batch[k]) for k in ('gt_boxes', 'gt_labels', 'gt_mask')}


def mono_synth(b, seed, h=64, w=96, kpts=False, flex=False):
    """`_mono_synth`: normal images (B, H, W, 3), `gt_pack`'s camera-frame
    boxes, a camera of f = 60 px with the principal point at the centre,
    each box's projected centre (clipped 2 px inside the image) as its 2D
    centre with a 20 x 20 px 2D box around it, the centre's depth; with
    `kpts` (the PGD adapter) zero velocities and attributes and 10 uniform
    keypoints a box; with `flex` (the MonoFlex adapter) 10 uniform
    keypoints a box, then an observation angle uniform in [-pi, pi)."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, h, w, 3), dtype=np.float32)
    boxes, labels, mask = gt_pack(rng, b, cam_frame=True)
    g = boxes.shape[1]
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 60.0
    cam[0, 2], cam[1, 2] = w / 2.0, h / 2.0
    uv = np.stack([boxes[..., 0] / boxes[..., 2] * cam[0, 0] + cam[0, 2],
                   boxes[..., 1] / boxes[..., 2] * cam[1, 1] + cam[1, 2]],
                  -1).astype(np.float32)
    uv = np.clip(uv, 2, [w - 3, h - 3]).astype(np.float32)
    wh = np.full((b, g, 2), 10.0, np.float32)
    batch = dict(img=img, cam2img=np.tile(cam[None], (b, 1, 1)),
                 gt_boxes_cam=boxes, gt_labels=labels, gt_mask=mask,
                 centers2d=uv, gt_bboxes2d=np.concatenate([uv - wh, uv + wh],
                                                          -1),
                 gt_depths=boxes[..., 2].copy())
    if kpts:
        batch['gt_velocities'] = np.zeros((b, g, 2), np.float32)
        batch['gt_attr_labels'] = np.zeros((b, g), np.int32)
        batch['kpts2d'] = rng.random((b, g, 10, 2), dtype=np.float32) * \
            np.array([w - 1, h - 1], np.float32)
    if flex:
        batch['kpts2d'] = rng.random((b, g, 10, 2), dtype=np.float32) * \
            np.array([w - 1, h - 1], np.float32)
        batch['gt_alphas'] = rng.uniform(-np.pi, np.pi,
                                         (b, g)).astype(np.float32)
    return batch


def mono_to_device(batch, device):
    """A batch of `mono_synth` (or of KITTI mono samples stacked the same
    way) -> (img, cam2img, gt dict), tensors on `device`."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(batch['img']), t(batch['cam2img']), {
        k: t(batch[k]) for k in MONO_GT_KEYS if k in batch}


def lidar_synth(cfg, b, seed, n=None):
    """`_points_synth`: `n` points a sample uniform in the config's
    point-cloud range (all valid), then `gt_pack`'s boxes with their
    centres clipped half a size inside the range. `n` defaults to 512, to
    4096 for PointRCNN, whose batch has no 'point_mask' (JAX's PointRCNN
    adapter), and to 1024 for 3DSSD, whose points get a zero fourth
    column (JAX's SSD3D adapter); VoteNet's and H3DNet's is
    `indoor_synth`, GroupFree3D's `groupfree3d_synth`, ImVoteNet's
    `imvotenet_synth`."""
    if isinstance(cfg, ImVoteNetConfig):
        return imvotenet_synth(cfg, b, seed, n or 256)
    if isinstance(cfg, VoteNetConfig):
        return indoor_synth(cfg, b, seed, n or 256)
    if isinstance(cfg, GroupFree3DConfig):
        return groupfree3d_synth(cfg, b, seed, n or 1024)
    point_rcnn = isinstance(cfg, PointRCNNConfig)
    ssd3d = isinstance(cfg, SSD3DConfig)
    n = n or (4096 if point_rcnn else 1024 if ssd3d else 512)
    rng = np.random.default_rng(seed)
    pcr = np.asarray(cfg.point_cloud_range, np.float32)
    pts = rng.random((b, n, 3)).astype(np.float32) * (pcr[3:] - pcr[:3]) \
        + pcr[:3]
    boxes, labels, mask = gt_pack(rng, b)
    lo = pcr[:3] + boxes[..., 3:6] / 2
    hi = pcr[3:] - boxes[..., 3:6] / 2
    ctr = np.clip(boxes[..., :3], lo, np.maximum(lo, hi))
    if ssd3d:
        pts = np.concatenate([pts, np.zeros((b, n, 1), np.float32)], -1)
    batch = dict(points=pts, point_mask=np.ones((b, n), bool),
                 gt_boxes=np.concatenate([ctr, boxes[..., 3:]], -1),
                 gt_labels=labels, gt_mask=mask)
    if point_rcnn:
        del batch['point_mask']
    return batch


def indoor_synth(cfg, b, seed, n=256):
    """JAX's VoteNet batch: `n` xyz points a sample uniform in a 6 m room
    cube, 4 boxes (centres in [0.5, 5.5), sizes in [0.5, 1.2), yaw in
    [-pi, pi)) of classes below `cfg.num_classes`, all valid; no
    'point_mask' and no height feature."""
    rng = np.random.default_rng(seed)
    pts = rng.random((b, n, 3)).astype(np.float32) * 6.0
    g = 4
    ctr = rng.random((b, g, 3)).astype(np.float32) * 5.0 + 0.5
    dim = rng.uniform(0.5, 1.2, (b, g, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (b, g, 1)).astype(np.float32)
    return dict(points=pts, gt_boxes=np.concatenate([ctr, dim, yaw], -1),
                gt_labels=rng.integers(0, cfg.num_classes, (b, g)).astype(
                    np.int32),
                gt_mask=np.ones((b, g), bool))


def groupfree3d_synth(cfg, b, seed, n=1024):
    """JAX's GroupFree3D batch: `n` xyz points a sample uniform in a 6 m
    room cube, 4 axis-aligned bottom-centre boxes (centres in [0.5, 5.5),
    sizes in [0.5, 1.5)) of classes below `cfg.num_classes`, all valid.
    At its 1,024 points the first SA level samples more points than the
    cloud holds: FPS repeats index 0, as JAX's does."""
    rng = np.random.default_rng(seed)
    pts = rng.random((b, n, 3)).astype(np.float32) * 6.0
    g = 4
    ctr = rng.random((b, g, 3)).astype(np.float32) * 5.0 + 0.5
    dim = rng.uniform(0.5, 1.5, (b, g, 3)).astype(np.float32)
    boxes = np.concatenate([ctr - dim * [0, 0, 0.5], dim,
                            np.zeros((b, g, 1), np.float32)], -1)
    return dict(points=pts, gt_boxes=boxes.astype(np.float32),
                gt_labels=rng.integers(0, cfg.num_classes, (b, g)).astype(
                    np.int32),
                gt_mask=np.ones((b, g), bool))


def imvotenet_synth(cfg, b, seed, n=256, h=48, w=64, m=6):
    """JAX's ImVoteNet batch: `indoor_synth`'s room (`n` xyz points, 4
    yawed boxes of sizes in [0.5, 1.2)) drawn in its order with a 0-255
    image (B, h, w, 3) between, `m` 2D box slots of which the first 3 are
    live (20 px boxes from [0, 20), confidence in [0.3, 0.9), a class)
    and a pinhole depth2img of focal 50 at the image centre."""
    rng = np.random.default_rng(seed)
    pts = rng.random((b, n, 3)).astype(np.float32) * 6.0
    g = 4
    ctr = rng.random((b, g, 3)).astype(np.float32) * 5.0 + 0.5
    dim = rng.uniform(0.5, 1.2, (b, g, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (b, g, 1)).astype(np.float32)
    img = rng.integers(0, 255, (b, h, w, 3)).astype(np.float32)
    boxes2d = np.zeros((b, m, 6), np.float32)
    boxes2d[:, :3, :4] = rng.uniform(0, 20, (b, 3, 4))
    boxes2d[:, :3, 2:4] += 20
    boxes2d[:, :3, 4] = rng.uniform(0.3, 0.9, (b, 3))
    boxes2d[:, :3, 5] = rng.integers(0, cfg.num_classes, (b, 3))
    d2i = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    d2i[:, 0, 0] = d2i[:, 1, 1] = 50.0
    d2i[:, 0, 2] = w / 2
    d2i[:, 1, 2] = h / 2
    return dict(points=pts, img=img, bboxes_2d=boxes2d, depth2img=d2i,
                gt_boxes=np.concatenate([ctr, dim, yaw], -1),
                gt_labels=rng.integers(0, cfg.num_classes, (b, g)).astype(
                    np.int32),
                gt_mask=np.ones((b, g), bool))


def synth_point_channels(cfg):
    """The width of a point-based config's synthetic points where it is
    not its model's default (the indoor types: 3, xyz without the
    datasets' height), else None."""
    return 3 if isinstance(cfg, (VoteNetConfig, GroupFree3DConfig)) \
        else None


def mvx_synth(cfg, b, seed, n=512, h=64, w=96):
    """JAX's MVX batch: `lidar_synth`'s points and gt, then from
    `default_rng(seed + 7)` images uniform in [0, 1) (B, h, w, 3) and a
    lidar2img of focal 40 with the principal point at the image centre
    and no rotation."""
    batch = lidar_synth(cfg, b, seed, n)
    rng = np.random.default_rng(seed + 7)
    batch['img'] = rng.random((b, h, w, 3)).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    l2i[:, 0, 0] = l2i[:, 1, 1] = 40.0
    l2i[:, 0, 3] = w / 2
    l2i[:, 1, 3] = h / 2
    batch['lidar2img'] = l2i
    return batch


def lidar_to_device(batch, device):
    """A batch of `lidar_synth` (or of `KittiLidarSource`) -> (points,
    point_mask (None for a batch without one: PointRCNN's), gt dict),
    tensors on `device`."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    mask = batch.get('point_mask')
    return t(batch['points']), None if mask is None else t(mask), {
        k: t(batch[k]) for k in ('gt_boxes', 'gt_labels', 'gt_mask')}


def mvx_to_device(batch, device):
    """A batch of `mvx_synth` -> (points, (point_mask, img, lidar2img), gt
    dict), tensors on `device`: MVX's `forward_train` arguments."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(batch['points']), tuple(t(batch[k]) for k in (
        'point_mask', 'img', 'lidar2img')), {
        k: t(batch[k]) for k in ('gt_boxes', 'gt_labels', 'gt_mask')}


def imvotenet_to_device(batch, device):
    """A batch of `imvotenet_synth` -> (points, (img, bboxes_2d,
    depth2img), gt dict), tensors on `device`: ImVoteNet's
    `forward_train` arguments."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return t(batch['points']), tuple(t(batch[k]) for k in (
        'img', 'bboxes_2d', 'depth2img')), {
        k: t(batch[k]) for k in ('gt_boxes', 'gt_labels', 'gt_mask')}
