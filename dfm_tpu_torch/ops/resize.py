"""Linear resize as per-axis interpolation matrices, and average pooling.

Port of `dfm_tpu/ops/resize.py`. The interpolation matrix is built in
numpy exactly as the JAX package builds it (the `align_corners=False`
branch clamps the source index to [0, in-1]), so the resize does not
depend on `F.interpolate`'s own edge handling.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['interp_matrix', 'resize_linear', 'avg_pool_2d']


@functools.lru_cache(maxsize=128)
def _interp_matrix_np(in_size, out_size, align_corners=True):
    w = np.zeros((out_size, in_size), np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    if align_corners:
        src = np.arange(out_size) * (in_size - 1) / max(out_size - 1, 1)
    else:
        scale = in_size / out_size
        src = np.maximum((np.arange(out_size) + 0.5) * scale - 0.5, 0)
        src = np.minimum(src, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    w[np.arange(out_size), lo] += 1 - frac
    w[np.arange(out_size), hi] += frac
    return w


def interp_matrix(in_size, out_size, align_corners=True,
                  dtype=torch.float32, device=None):
    """(out_size, in_size) linear interpolation matrix."""
    return torch.as_tensor(_interp_matrix_np(in_size, out_size,
                                             align_corners),
                           dtype=dtype, device=device)


def resize_linear(x, out_sizes, dims, align_corners=True):
    """Resize `x` linearly along `dims` to `out_sizes` (one matmul per
    dim, in the dtype of `x`)."""
    for dim, out_size in zip(dims, out_sizes):
        in_size = x.shape[dim]
        if in_size == out_size:
            continue
        w = interp_matrix(in_size, out_size, align_corners, x.dtype,
                          x.device)
        x = torch.movedim(torch.tensordot(w, torch.movedim(x, dim, 0),
                                          dims=([1], [0])), 0, dim)
    return x


def avg_pool_2d(x, window):
    """Average pooling over H, W of an NCHW tensor (VALID padding,
    stride = window)."""
    return F.avg_pool2d(x, window, stride=window)
