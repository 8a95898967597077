"""Modulated deformable convolution (DCNv2), plain PyTorch.

Port of `dfm_tpu/ops/deform_conv.py:30-76` (`deform_conv2d`) over the
bilinear sampler of `dfm_tpu/ops/packed_sample.py:81-101`. Each of the
K = kh * kw taps of output pixel (oy, ox) samples the input at

    (oy * stride + (ky - (kh - 1) / 2) * dilation + dy_k,
     ox * stride + (kx - (kw - 1) / 2) * dilation + dx_k)

bilinearly from floor(): a corner outside the map reads zero (its weight
is 0), the fractional weights carry the gradient to the offsets. The
sample is scaled by the tap's mask (already sigmoided; None for DCNv1) and
the K taps are contracted with the weight in one matmul over (K, C_in).

All K taps are gathered at once: four row gathers (one per bilinear
corner) of a channels-last copy of the input, combined in float32 (in
float64 for a float64 reference), then one (B, H_out * W_out, K * C_in) @
(K * C_in, C_out) product in the input's dtype (float32 accumulation), as
JAX's einsum. Autograd of these ops gives the gradients of x (scatter-add
of the gathers), of the offsets, of the mask and of the weight.
"""

import torch

__all__ = ['deform_conv2d', 'tap_positions']


def _acc(x):
    """x in the sampler's precision: float32, float64 for float64."""
    return x if x.dtype == torch.float64 else x.float()


def tap_positions(offset, kh, kw, stride=1, dilation=1):
    """The sample points (py, px), each (B, H_out, W_out, K), of the taps
    under `offset` (B, 2K, H_out, W_out) laid out [dy_0, dx_0, dy_1, dx_1,
    ...]; float32 (float64 for float64 offsets)."""
    b, _, ho, wo = offset.shape
    k = kh * kw
    dev = offset.device
    off = _acc(offset).view(b, k, 2, ho, wo).permute(0, 3, 4, 1, 2)
    tap = torch.arange(k, device=dev)
    ky = torch.div(tap, kw, rounding_mode='floor').to(off.dtype)
    kx = (tap % kw).to(off.dtype)
    base_y = (torch.arange(ho, device=dev, dtype=off.dtype) *
              stride)[:, None, None] + (ky - (kh - 1) / 2) * dilation
    base_x = (torch.arange(wo, device=dev, dtype=off.dtype) *
              stride)[None, :, None] + (kx - (kw - 1) / 2) * dilation
    return base_y + off[..., 0], base_x + off[..., 1]


def _bilinear_taps(x, py, px):
    """Bilinear samples of NCHW `x` at (B, H', W', K) points -> (B, H', W',
    K, C) in the points' dtype, zero outside the map."""
    b, c, h, w = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = py - y0
    fx = px - x0
    base = (torch.arange(b, device=x.device) * (h * w)).view(b, 1, 1, 1)
    out = 0.
    for dy, wy in ((0, 1 - fy), (1, fy)):
        yy = y0 + dy
        vy = (yy >= 0) & (yy <= h - 1)
        yi = yy.clamp(0, h - 1).long()
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx = x0 + dx
            valid = vy & (xx >= 0) & (xx <= w - 1)
            idx = base + yi * w + xx.clamp(0, w - 1).long()
            wt = (wx * wy) * valid.to(wx.dtype)
            out = out + rows[idx].to(wx.dtype) * wt[..., None]
    return out


def deform_conv2d(x, offset, mask, weight, stride=1, dilation=1, bias=None):
    """DCNv2 forward (DCNv1 with `mask` None).

    Args:
        x: (B, C_in, H, W), float32 or bfloat16.
        offset: (B, 2K, H_out, W_out) per-tap (dy, dx) displacements.
        mask: (B, K, H_out, W_out) modulation (already sigmoided) or None.
        weight: (C_out, C_in, kh, kw) in x's dtype.
        stride, dilation: the conv's (padding dilation * (k // 2)).
        bias: (C_out,) or None.

    Returns:
        (B, C_out, H_out, W_out) in x's dtype.
    """
    b, cin = x.shape[:2]
    cout, _, kh, kw = weight.shape
    ho, wo = offset.shape[-2:]
    py, px = tap_positions(offset, kh, kw, stride, dilation)
    cols = _bilinear_taps(x, py, px)                  # (B, H', W', K, C)
    if mask is not None:
        cols = cols * _acc(mask).permute(0, 2, 3, 1)[..., None]
    cols = cols.to(x.dtype).reshape(b, ho * wo, kh * kw * cin)
    wmat = weight.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    out = torch.matmul(cols, wmat.t())                # (B, H'W', C_out)
    if bias is not None:
        out = out + bias
    return out.transpose(1, 2).reshape(b, cout, ho, wo)
