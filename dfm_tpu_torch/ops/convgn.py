"""The 3x3x3 Conv3D with GroupNorm partial moments, and the fused ConvNorm
(K9a).

Port of `dfm_tpu/ops/pallas/convgn.py`. What it computes:
`conv3d_zpack(x, w_big, th)` is the stride-1 'same' conv of a dense
(D, H, W, C) volume, weights rounded to x's type, products and sums in
float32, with the per-channel sum and sum of squares of the UNROUNDED
float32 result over each band of th rows and four depth slices:

    partials[k, hi, 0 | 1, j * C_out + co]
        = sum / sum of squares over rows hi*th .. hi*th + th - 1, all W,
          slice 4k + j, channel co                (D % 4 == 0, H % th == 0)

`conv3d_gn` finishes GroupNorm from those moments (`gn_partials_affine`:
the per-channel scale and bias, a few PyTorch ops over 2 x C_out
values, as the JAX package computes them) and applies it to the stored
(rounded) conv output, then adds the residual, then the relu, in that
order, rounded once (`gn_finish_plain`; K7a's order, affine -> relu ->
residual, is another). On the card that apply step is one pass of its
own kernel (`ops/cuda/conv3d.py:gn_finish`), as XLA fuses it into one
pass in the JAX package.

The JAX kernel takes its weights as a banded (9, 6 C, 4 C_out) matrix
(`pack_weights`) that computes four depth slices per 128-lane matmul at
twice the products; the port keeps `pack_weights` and its inverse
`band_taps` for callers that hold such weights, and its kernels take the
taps in the port's (C_out, C, 3, 3, 3) layout. The kernels
(`ops/cuda/conv3d.py:conv3d_stats`, `gn_finish`) run on CUDA tensors,
the plain versions below on CPU tensors.
"""

import torch

from .conv3d import conv3d_f32
from .conv_chain import gn_scale_bias

__all__ = ['pack_weights', 'band_taps', 'check_zpack_shape',
           'fold_row_partials', 'conv3d_zpack_plain', 'gn_partials_affine',
           'gn_finish_plain', 'conv3d_gn_plain', 'conv3d_zpack',
           'conv3d_gn']

ZB = 4           # depth slices per partial (the JAX kernel's z-block)


def pack_weights(weight):
    """(C_out, C, 3, 3, 3) -> the JAX kernel's banded (9, (ZB+2) C,
    ZB C_out) float32 matrix: block [dy*3 + dx, zi*C .. , j*C_out ..]
    holds tap (zi - j, dy, dx) as (C, C_out) where 0 <= zi - j < 3, zeros
    elsewhere."""
    c_out, c = weight.shape[:2]
    taps = weight.float().permute(2, 3, 4, 1, 0)      # (kz, ky, kx, C, C_out)
    w_big = taps.new_zeros((9, (ZB + 2) * c, ZB * c_out))
    for dy in range(3):
        for dx in range(3):
            for j in range(ZB):
                for kz in range(3):
                    w_big[dy * 3 + dx, (j + kz) * c:(j + kz + 1) * c,
                          j * c_out:(j + 1) * c_out] = taps[kz, dy, dx]
    return w_big


def band_taps(w_big, c, c_out):
    """The inverse of `pack_weights`: the taps of the j = 0 band,
    w_big[dy*3 + dx, zi*C:(zi+1)*C, :C_out] = K[zi, dy, dx], in the port's
    (C_out, C, 3, 3, 3) layout."""
    if tuple(w_big.shape) != (9, (ZB + 2) * c, ZB * c_out):
        raise ValueError(f'w_big: expected (9, {(ZB + 2) * c}, '
                         f'{ZB * c_out}), got {tuple(w_big.shape)}')
    k = w_big[:, :3 * c, :c_out].reshape(3, 3, 3, c, c_out)   # (dy, dx, zi)
    return k.permute(4, 3, 2, 0, 1).contiguous()


def check_zpack_shape(x, th):
    d, h = x.shape[:2]
    if d % ZB or th < 1 or h % th:
        raise ValueError(f'conv3d_zpack needs D % {ZB} == 0 and H % th == 0,'
                         f' got {tuple(x.shape)}, th={th}')


def fold_row_partials(rows, th):
    """Moments per (slice, row, column tile) (D, H, T, 2, C) -> the JAX
    layout (D//ZB, H//th, 2, ZB*C): one sum over th rows x T tiles."""
    d, h, t, _, c = rows.shape
    p = rows.reshape(d // ZB, ZB, h // th, th * t, 2, c).sum(3)
    return p.permute(0, 2, 3, 1, 4).reshape(d // ZB, h // th, 2, ZB * c)


def conv3d_zpack_plain(x, weight, th=8):
    """Plain version of K9a: (out (D, H, W, C_out) in x's type, partials
    (D//4, H//th, 2, 4 C_out) float32). weight (C_out, C, 3, 3, 3)."""
    check_zpack_shape(x, th)
    af = conv3d_f32(x, weight)
    rows = torch.stack([af.sum(2), (af * af).sum(2)], dim=2)[:, :, None]
    return af.to(x.dtype).contiguous(), fold_row_partials(rows, th)


def gn_partials_affine(ps, shape, scale, bias, num_groups, eps=1e-5):
    """GroupNorm from the partials (D//4, H//th, 2, 4 C_out) of a conv
    output of `shape` (D, H, W, C_out): f32, var = E[x^2] - E[x]^2 ->
    the per-channel (C_out,) float32 scale and bias of the folded
    affine."""
    c_out = shape[-1]
    per_c = ps.reshape(-1, 1, 2, ZB, c_out).sum(3)         # (N, 1, 2, C_out)
    return gn_scale_bias(per_c, shape, scale, bias, num_groups, eps=eps)


def gn_finish_plain(out, sc, bs, residual=None, relu=False):
    """Plain version of the finish kernel: [relu](out * sc + bs
    [+ residual]) in float32, each product and sum rounded alone, in
    out's type (one rounding)."""
    y = out.float() * sc + bs
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(out.dtype)


def conv3d_gn_plain(x, weight, scale, bias, num_groups, eps=1e-5,
                    residual=None, relu=False, th=8):
    """Plain version of `conv3d_gn`."""
    out, ps = conv3d_zpack_plain(x, weight, th)
    sc, bs = gn_partials_affine(ps, out.shape, scale, bias, num_groups, eps)
    return gn_finish_plain(out, sc, bs, residual, relu)


def conv3d_zpack(x, w_big, th=8):
    """K9a with the JAX signature: x (D, H, W, C), w_big the banded
    (9, 6 C, 4 C_out) weights of `pack_weights`. Returns (out, partials)
    as `conv3d_zpack_plain`. The taps are taken out of w_big on every
    call, so their kernel layout is not kept."""
    from .cuda.conv3d import conv3d_stats
    c = x.shape[-1]
    return conv3d_stats(x, band_taps(w_big, c, w_big.shape[-1] // ZB), th,
                        cache_weight=False)


def conv3d_gn(x, weight, scale, bias, num_groups, eps=1e-5, residual=None,
              relu=False, th=8):
    """Fused ConvNorm: [relu](GN(conv(x)) + residual). weight (C_out, C,
    3, 3, 3); scale, bias (C_out,); residual (D, H, W, C_out) or None.
    The conv and its moments are K9a; the scale and bias a few PyTorch
    ops on the moments; the finish one pass of its kernel (on the CPU
    the plain versions)."""
    from .cuda.conv3d import conv3d_stats, gn_finish
    out, ps = conv3d_stats(x, weight, th)
    sc, bs = gn_partials_affine(ps, out.shape, scale, bias, num_groups, eps)
    return gn_finish(out, sc, bs, residual, relu)
