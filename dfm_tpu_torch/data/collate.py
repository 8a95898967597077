"""Pipeline samples -> the model's batch, on the model's device.

Port of `tools/train.py:59-83` `build_batch` for the DfM family.
"""

import numpy as np
import torch

from ..models.detectors.dfm import BatchMeta

__all__ = ['build_batch']

META_KEYS = ('ori_cam2img', 'cam2img', 'cur2prev', 'org_w', 'flip',
             'crop_offset', 'scale_factor')
GT_KEYS = ('gt_boxes', 'gt_labels', 'gt_mask', 'depth_img',
           'depth_fgmask_img')
# DfMFull's teacher points and 2D targets, taken where a sample has them
# (`tools/train.py:80`)
FULL_KEYS = ('points', 'point_mask', 'gt_bboxes2d', 'centers2d')


def build_batch(samples, device):
    """`load_video_sample` dicts -> (img (B, 2, H, W, 3) float32,
    BatchMeta, gt dict of the GT_KEYS tensors and of the FULL_KEYS the
    samples hold), every tensor on `device`."""
    def stack(k):
        return torch.from_numpy(np.stack([s[k] for s in samples])).to(device)

    meta = BatchMeta(**{k: stack(k) for k in META_KEYS})
    keys = GT_KEYS + tuple(k for k in FULL_KEYS if k in samples[0])
    return stack('img'), meta, {k: stack(k) for k in keys}
