"""Depth-banded volumes: exact shortcuts for slabs constant along depth.

Port of `dfm_tpu/ops/band_volume.py`. The cur half of the cost volume is
constant along depth (`ops/cost_volume.py`), so the mono trunk convolves
a volume whose slices are all equal, and the stereo dres0 convolves
[cur || prev] whose first half is constant along depth. A 3x3x3 conv of
such a volume equals ONE 2D conv with the kernel summed over z,
broadcast along depth, except within an edge band that grows by one
slice per conv, where the zero padding along z shows.

`BandVol` holds (interior slice, lo / hi edge bands of width E) with the
operations the dres stages need: conv (E grows by 1), GroupNorm
(statistics composed from the parts), relu, add. Tensors are
channels-last like the JAX package's; weights are in the port's layout
(Cout, Cin, kD, kH, kW). The convolutions are plain `F.conv2d` /
`F.conv3d` (the JAX `_wgroup_conv3d` lowering computes a plain conv).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ['BandVol', 'band_from_const', 'band_conv3', 'band_gn',
           'band_relu', 'band_add', 'band_to_dense', 'dual_conv3']


class BandVol(NamedTuple):
    interior: torch.Tensor   # (B, H, W, C): slices E..D-E-1 are all equal
    lo: torch.Tensor         # (B, E, H, W, C)
    hi: torch.Tensor         # (B, E, H, W, C)
    d: int                   # total depth

    @property
    def e(self):
        return self.lo.shape[1]


def band_from_const(x2d, d):
    """A volume constant along all of its depth (edge width 0)."""
    b, h, w, c = x2d.shape
    e = x2d.new_zeros((b, 0, h, w, c))
    return BandVol(x2d, e, e, d)


def _rep(bv, n):
    """n copies of the interior slice, (B, n, H, W, C)."""
    return bv.interior[:, None].expand(-1, n, -1, -1, -1)


def band_to_dense(bv):
    return torch.cat([bv.lo, _rep(bv, bv.d - 2 * bv.e), bv.hi], dim=1)


def _conv2d(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                    padding=1).permute(0, 2, 3, 1)


def _conv3d(x, w):
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype),
                    padding=1).permute(0, 2, 3, 4, 1)


def band_conv3(bv, weight):
    """3x3x3 'same' conv of a banded volume; the edge width grows by 1.
    weight: (Cout, Cin, 3, 3, 3), float32."""
    e = bv.e
    interior = _conv2d(bv.interior, weight.sum(dim=2))
    # edge outputs 0..E need input slices 0..E+1 = lo + 2 interior
    # slices; the conv of those E+2 slices is exact on its first E+1
    # (true zero pad below, real values above)
    lo = _conv3d(torch.cat([bv.lo, _rep(bv, 2)], dim=1), weight)[:, :e + 1]
    hi = _conv3d(torch.cat([_rep(bv, 2), bv.hi], dim=1),
                 weight)[:, -(e + 1):]
    return BandVol(interior, lo, hi, bv.d)


def band_gn(bv, weight, bias, groups, eps=1e-5):
    """GroupNorm over (D, H, W, C / groups), f32 statistics composed as
    interior x (D - 2E) + lo + hi, applied as one folded scale / bias."""
    b, h, w, c = bv.interior.shape
    e = bv.e

    def moments(x):
        xx = x.float().reshape(b, -1, h, w, groups, c // groups)
        return xx.sum(dim=(1, 2, 3, 5)), (xx * xx).sum(dim=(1, 2, 3, 5))

    s, s2 = moments(bv.interior)
    n_int = bv.d - 2 * e
    s, s2 = s * n_int, s2 * n_int
    if e:
        for part in (bv.lo, bv.hi):
            ps, ps2 = moments(part)
            s, s2 = s + ps, s2 + ps2
    cnt = bv.d * h * w * (c // groups)
    mean = s / cnt
    var = s2 / cnt - mean ** 2
    inv = torch.rsqrt(var + eps)                              # (B, g)
    wg = weight.float().view(groups, c // groups)
    sc = (wg * inv[..., None]).reshape(b, c)
    bs = (bias.float().view(groups, c // groups)
          - mean[..., None] * wg * inv[..., None]).reshape(b, c)

    def norm(x):
        shape = (b,) + (1,) * (x.dim() - 2) + (c,)
        return (x.float() * sc.view(shape) + bs.view(shape)).to(x.dtype)

    return BandVol(norm(bv.interior), norm(bv.lo), norm(bv.hi), bv.d)


def band_relu(bv):
    return BandVol(F.relu(bv.interior), F.relu(bv.lo), F.relu(bv.hi), bv.d)


def _widen(bv, to):
    extra = to - bv.e
    if extra == 0:
        return bv
    rep = _rep(bv, extra)
    return BandVol(bv.interior, torch.cat([bv.lo, rep], dim=1),
                   torch.cat([rep, bv.hi], dim=1), bv.d)


def band_add(a, b):
    """Sum of two banded volumes (the narrower band is widened with
    interior slices)."""
    e = max(a.e, b.e)
    a, b = _widen(a, e), _widen(b, e)
    return BandVol(a.interior + b.interior, a.lo + b.lo, a.hi + b.hi, a.d)


def dual_conv3(cur2d, prev_vol, weight):
    """3x3x3 conv of [cur broadcast along depth || prev] without the
    broadcast: weight (Cout, 2C, 3, 3, 3) splits into a cur part (banded
    conv) and a prev part (dense conv). cur2d (B, H, W, C), prev_vol
    (B, D, H, W, C) -> dense (B, D, H, W, Cout)."""
    c = cur2d.shape[-1]
    band = band_conv3(band_from_const(cur2d, prev_vol.shape[1]),
                      weight[:, :c])
    return band_to_dense(band) + _conv3d(prev_vol, weight[:, c:])
