"""The dense depth loss of DfM.

Port of `dfm_tpu/models/heads/depth_head.py:30-164` (the reference's
`DepthHead`, mmdet3d/models/dense_heads/depth_head.py:14-212): the loss
over the x`up_factor` upsampled depth distribution, evaluated at a fixed
number of valid-depth pixels per image, drawn with replacement, whose
fine cost columns are rebuilt at those pixels only (the values the
reference's dense computation has there).
"""

import torch

from ...ops.resize import interp_matrix
from ...parallel import dist as D

__all__ = ['fine_depth_columns', 'sample_depth_pixels',
           'depth_distribution_loss', 'LOSS_TYPES']

LOSS_TYPES = ('ce', 'balanced_ce', 'focal', 'balanced_focal', 'hard_ce',
              'l1', 'purel1', 'gaussian', 'laplacian')


def fine_depth_columns(cost, pix_xy, up_factor):
    """x`up_factor` upsampled cost columns at integer fine pixels.

    Args:
        cost: (D, H, W) base depth cost.
        pix_xy: (P, 2) integer (x, y) fine-pixel coordinates.

    Returns:
        (P, D * up_factor) pre-softmax fine columns, float32.
    """
    d, h, w = cost.shape
    h_f, w_f = h * up_factor, w * up_factor
    f32 = dict(dtype=torch.float32, device=cost.device)
    # align-corners map; the divisors are tensors so that the division is
    # a true one on the card too (torch multiplies a CUDA tensor divided
    # by a Python number by the reciprocal)
    bx = pix_xy[:, 0].float() * (w - 1) / torch.tensor(w_f - 1., **f32)
    by = pix_xy[:, 1].float() * (h - 1) / torch.tensor(h_f - 1., **f32)
    x0 = torch.floor(bx)
    y0 = torch.floor(by)
    fx = (bx - x0)[:, None]
    fy = (by - y0)[:, None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    cflat = cost.float().permute(1, 2, 0).reshape(h * w, d)
    col = ((1 - fy) * ((1 - fx) * cflat[y0 * w + x0] + fx * cflat[y0 * w + x1])
           + fy * ((1 - fx) * cflat[y1 * w + x0] + fx * cflat[y1 * w + x1]))
    wd = interp_matrix(d, d * up_factor, device=cost.device)
    return col @ wd.t()


def _valid(depth_img, depth_min, depth_max):
    return ((depth_img > depth_min) & (depth_img < depth_max)).reshape(
        depth_img.shape[0], -1)


def sample_depth_pixels(depth_img, num_sample_pixels, generator,
                        depth_min=2.0, depth_max=59.6):
    """(B, P) flat pixel indices drawn with replacement, uniformly over
    each image's valid-depth pixels (all pixels where none is valid; the
    loss then weighs them zero), from `generator`."""
    valid = _valid(depth_img, depth_min, depth_max).float()
    probs = torch.where(valid.sum(1, keepdim=True) > 0, valid,
                        torch.ones_like(valid))
    return torch.multinomial(probs, num_sample_pixels, replacement=True,
                             generator=generator)


def depth_distribution_loss(cost, depth_img, depth_fgmask_img, depth_samples,
                            loss_cfg, up_factor=4, num_sample_pixels=8192,
                            depth_min=2.0, depth_max=59.6, generator=None,
                            pix_idx=None, dist_norm=False):
    """Depth loss over a fixed number of valid pixels of each image.

    Args:
        cost: (B, D, H, W) fused depth cost (pre-softmax, base resolution).
        depth_img: (B, H_pad, W_pad) sparse gt depth (0 where missing).
        depth_fgmask_img: (B, H_pad, W_pad) foreground ids (0 = bg) or
            None.
        depth_samples: (D * up,) fine depth-bin centres (tensor).
        loss_cfg: dict(type, loss_weight, fg_weight, bg_weight, alpha,
            gamma[, sigma]); every type of `LOSS_TYPES` (gaussian* and
            laplacian* by prefix).
        generator: the torch.Generator the pixels are drawn from
            (`sample_depth_pixels`), on cost's device.
        pix_idx: optional (B, P) flat pixel indices to use instead of a
            draw (the tests pass the JAX package's draws; a rank of a
            process group its rows of the global batch's draw).
        dist_norm: in a process group, the per-image mean over the global
            batch (the rank's loss is its share of the global batch's,
            `anchor3d_head_loss`'s rule); a no-op without a group.

    Returns:
        scalar loss: the per-image losses averaged, times loss_weight; an
        image with no valid depth pixel adds 0.
    """
    b = cost.shape[0]
    w_f = depth_img.shape[2]
    loss_type = loss_cfg.get('type', 'balanced_focal')
    interval = depth_samples[1] - depth_samples[0]
    valid = _valid(depth_img, depth_min, depth_max)
    if pix_idx is None:
        pix_idx = sample_depth_pixels(depth_img, num_sample_pixels,
                                      generator, depth_min, depth_max)
    n = pix_idx.shape[1]
    losses = []
    for i in range(b):
        idx = pix_idx[i].long()
        pix_xy = torch.stack([idx % w_f, idx // w_f], dim=-1)
        gt = depth_img[i].reshape(-1)[idx]
        col = fine_depth_columns(cost[i], pix_xy, up_factor)    # (P, Df)
        logp = torch.log_softmax(col, dim=-1)
        distance = (depth_samples[None] - gt[:, None]).abs() / interval
        probability = 1 - distance.clamp(max=1.0)
        if loss_type in ('ce', 'balanced_ce'):
            loss = -(probability * logp).sum(-1)
        elif loss_type in ('focal', 'balanced_focal'):
            p = torch.exp(logp)
            loss = -(probability * (loss_cfg.get('alpha', 1.0) *
                                    (1 - p) ** loss_cfg.get('gamma', 2.0) *
                                    logp)).sum(-1)
        elif loss_type == 'hard_ce':
            loss = -((probability >= 0.5).to(logp.dtype) * logp).sum(-1)
        elif loss_type in ('l1', 'purel1'):
            pred = (torch.softmax(col, -1) * depth_samples[None]).sum(-1)
            diff = (pred - gt).abs()
            loss = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5) \
                if loss_type == 'l1' else diff
        elif loss_type.startswith(('gaussian', 'laplacian')):
            sigma = float(loss_cfg.get('sigma', 1.0))
            dist = (depth_samples[None] - gt[:, None]).abs()
            pr = torch.exp(-0.5 * dist ** 2 / sigma ** 2) \
                if loss_type.startswith('gaussian') else \
                torch.exp(-dist / sigma)
            pr = pr / pr.sum(-1, keepdim=True).clamp(min=1.0)
            loss = -(pr * logp).sum(-1)
        else:
            raise NotImplementedError(loss_type)
        if loss_type.startswith('balanced') and depth_fgmask_img is not None:
            fg = depth_fgmask_img[i].reshape(-1)[idx] > 0
            loss = torch.where(fg, loss_cfg.get('fg_weight', 5.0) * loss,
                               loss_cfg.get('bg_weight', 1.0) * loss).sum() \
                / n
        else:
            loss = loss.mean()
        losses.append(torch.where(valid[i].any(), loss,
                                  torch.zeros_like(loss)))
    losses = torch.stack(losses)
    if dist_norm and D.is_active():
        mean = losses.sum() / D.global_sum(torch.full(
            (), b, dtype=torch.float32, device=losses.device))
    else:
        mean = losses.mean()
    return loss_cfg.get('loss_weight', 1.0) * mean
