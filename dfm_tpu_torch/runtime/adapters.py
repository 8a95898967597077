"""Synthetic DfM / DfMFull batches (the train CLI's `--synthetic`).

Port of the DfM part of `dfm_tpu/runtime/adapters.py:74-117`
(`_dfm_meta`, `_dfm_synth`): the same draws from
`np.random.default_rng(seed)` in the same order, so that one seed gives
both packages the same batch. The batch is numpy, batched, in the JAX
layout: 'img' (B, 2, H, W, 3), 'meta' (the `BatchMeta` fields), the gt
keys and, with `full`, DfMFull's teacher points and 2D targets;
`to_device` makes the model's inputs of it.
"""

import numpy as np
import torch

from ..data.collate import FULL_KEYS, GT_KEYS
from ..models.detectors.dfm import BatchMeta

__all__ = ['dfm_meta', 'dfm_synth', 'to_device']


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
