"""The 3x3x3 conv chain of the DfM trunk: storage format, plain versions
of its three kernels, and the GroupNorm finishers.

Port of the functions of `dfm_tpu/ops/pallas/conv_chain.py` that the
stereo stem and the pred ConvNorm run (K4 `conv_p2p`, K7a
`unpack_affine_res`, K8a `pack_vol`, and the XLA-side finishers). It
keeps WHAT they compute: C32 -> C32 'same' convs whose results stay in
one inter-layer storage format, with the GroupNorm moments taken in the
conv's epilogue and the normalisation applied on the way out. The TPU's
z-in-128-lanes blocks, the two phases and the z-banded weight pairs do
not carry over.

**The chain format** (`ChainVol`): a (D, H, W, C) volume is stored as one
contiguous (D + 2, H + 2, W + 2, C) tensor, channels innermost, with a
border of stored zeros one voxel wide around D, H and W. A consumer reads
its 27 taps with no bounds test, and the valid-mode conv of the stored
tensor IS the 'same' conv of the volume. There is one format and no
phase. Every function that writes the format writes the border too.
The kernels take bfloat16 and C = 32; the plain versions take any
floating type (the CPU tests run them in float32).

**Partial moments** `ps` of a conv: (D, T, 2, C) float32, for each depth
slice and each of T spatial tiles the per-channel sum ([..., 0, :]) and
sum of squares ([..., 1, :]) of the conv result BEFORE it is rounded to
the storage type (with the residual, when one is added). The plain
version has T = 1. Summing over T gives per-slice moments, which the
multiplicity-weighted GroupNorm of reduced-depth volumes needs
(`fold_ps_weighted`).

The wrappers that launch the kernels are in `ops/cuda/conv_chain.py`;
on a CPU tensor they return the plain versions below.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ['ChainVol', 'pack_vol_plain', 'unpack_vol', 'conv_p2p_plain',
           'unpack_affine_plain', 'fold_ps_weighted', 'gn_scale_bias',
           'gn_from_partials', 'affine_mask', 'dres0_stats_affine',
           'unpack_affine_res']


class ChainVol(NamedTuple):
    """A volume in the chain format (see the module docstring)."""
    data: torch.Tensor       # (D + 2, H + 2, W + 2, C), zero border

    @property
    def shape(self):
        """(D, H, W, C) of the volume it holds."""
        dp, hp, wp, c = self.data.shape
        return dp - 2, hp - 2, wp - 2, c

    def interior(self):
        """The (D, H, W, C) volume, a view."""
        return self.data[1:-1, 1:-1, 1:-1]

    def border_is_zero(self):
        d = self.data
        return not any(bool(t.any()) for t in (
            d[0], d[-1], d[:, 0], d[:, -1], d[:, :, 0], d[:, :, -1]))


def _pad(x):
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))


def pack_vol_plain(x):
    """Plain version of K8a: dense (D, H, W, C) -> chain format."""
    return ChainVol(_pad(x))


def unpack_vol(cv):
    """Chain format -> dense (D, H, W, C); a view of the stored tensor."""
    return cv.interior()


def conv_p2p_plain(cv, weight, residual=False):
    """Plain version of K4: 3x3x3 stride-1 'same' conv on the chain
    format, weight (Cout, Cin, 3, 3, 3) rounded to the storage type,
    products and sums in float32; with `residual` the input is added to
    the result. Returns (ChainVol in the input's type, ps (D, 1, 2, C)
    float32 moments of the unrounded result)."""
    x = cv.data
    w = weight.to(x.dtype).float()
    af = F.conv3d(x.float().permute(3, 0, 1, 2)[None], w)[0]
    af = af.permute(1, 2, 3, 0)                           # (D, H, W, C)
    if residual:
        af = af + cv.interior().float()
    ps = torch.stack([af.sum(dim=(1, 2)), (af * af).sum(dim=(1, 2))], dim=1)
    return ChainVol(_pad(af.to(x.dtype))), ps[:, None]


def unpack_affine_plain(u, sc, bs, res=None, relu=False):
    """Plain version of K7a: chain -> dense, y = u * sc + bs per channel
    in float32, then relu if asked, then `+ res` (a ChainVol, added
    unnormalised), stored in u's type."""
    y = u.interior().float() * sc + bs
    if relu:
        y = F.relu(y)
    if res is not None:
        y = y + res.interior().float()
    return y.to(u.data.dtype)


def fold_ps_weighted(ps, zw):
    """Per-channel sums from partial moments with one weight per depth
    slice (the multiplicities of a reduced-depth volume,
    `ops/reduced_depth.py`). ps (D, T, 2, C), zw (D,). Returns
    (s (C,), s2 (C,), sum(zw))."""
    zw = torch.as_tensor(zw, dtype=torch.float32, device=ps.device)
    per_z = ps.sum(dim=1)                                  # (D, 2, C)
    s, s2 = (per_z * zw[:, None, None]).sum(dim=0)
    return s, s2, float(zw.sum())


def gn_scale_bias(ps, shape, weight, bias, groups, zw=None, eps=1e-5):
    """Finish GroupNorm from partial moments: the per-channel (C,) scale
    and bias of the folded affine. f32, var = E[x^2] - E[x]^2, the count
    is D (or sum(zw)) x H x W x C / groups."""
    d, h, w, c = shape
    if zw is None:
        s, s2 = ps.sum(dim=(0, 1))
        wsum = d
    else:
        s, s2, wsum = fold_ps_weighted(ps, zw)
    return _affine_from_sums(s, s2, wsum * h * w * (c // groups), weight,
                             bias, groups, eps)


def _affine_from_sums(s, s2, cnt, weight, bias, groups, eps):
    c = s.shape[0]
    mean = s.view(groups, c // groups).sum(dim=1) / cnt
    var = s2.view(groups, c // groups).sum(dim=1) / cnt - mean * mean
    rstd = torch.rsqrt(var + eps)
    wg = weight.float().view(groups, c // groups)
    sc = wg * rstd[:, None]
    bs = bias.float().view(groups, c // groups) - mean[:, None] * sc
    return sc.reshape(c), bs.reshape(c)


def affine_mask(cv, sc, bs, relu=False, extra=None):
    """Chain -> chain: y = f(sc * x + bs) (+ extra) on the volume, the
    border kept zero. `extra` is a ChainVol added after the affine."""
    return ChainVol(_pad(unpack_affine_plain(cv, sc, bs, extra, relu)))


def gn_from_partials(ps, cv, weight, bias, groups, relu=False, extra=None,
                     zw=None):
    """GroupNorm finished from a conv's partial moments and applied in
    one pass, the result staying in the chain format."""
    sc, bs = gn_scale_bias(ps, cv.shape, weight, bias, groups, zw)
    return affine_mask(cv, sc, bs, relu, extra)


def dres0_stats_affine(u, ps, ci, clo, chi, weight, bias, groups, eps=1e-5):
    """The dres0 exit: y = relu(GN(u + c)) in the chain format.

    `u` is conv_p2p(prev) with its moments `ps`; `c` is the cur half's
    contribution to the dual conv (`ops/band_volume.py:dual_conv3`),
    constant along depth: `ci` on every slice but the first (`clo`) and
    the last (`chi`), each (H, W, C) float32. The statistics of u + c are
    composed without another pass over a sum volume:
        sum(u + c)     = sum(u) + sum_hw(ci * (D - 2) + clo + chi)
        sum((u + c)^2) = sum(u^2) + 2 sum(u c) + sum(c^2)
        sum(u c)       = sum_hw(zsum(u) ci + u[0] (clo - ci)
                                + u[D-1] (chi - ci))
    sum(u) and sum(u^2) come from the f32 moments, sum(u c) from the
    stored u, as in the JAX function.
    """
    d, h, w, c = u.shape
    ud = u.interior().float()
    ci, clo, chi = ci.float(), clo.float(), chi.float()
    su, su2 = ps.sum(dim=(0, 1))
    sc_ = (ci * (d - 2) + clo + chi).sum(dim=(0, 1))
    sc2 = (ci * ci * (d - 2) + clo * clo + chi * chi).sum(dim=(0, 1))
    suc = (ud.sum(dim=0) * ci + ud[0] * (clo - ci)
           + ud[-1] * (chi - ci)).sum(dim=(0, 1))
    a, b = _affine_from_sums(su + sc_, su2 + 2 * suc + sc2,
                             d * h * w * (c // groups), weight, bias,
                             groups, eps)
    x = ud + ci                       # a new tensor: ud may alias u
    x[0] += clo - ci
    x[-1] += chi - ci
    y = F.relu_(x.mul_(a).add_(b))
    return ChainVol(_pad(y.to(u.data.dtype)))


def unpack_affine_res(u, ps, weight, bias, groups, res=None, relu=False,
                      zw=None):
    """The chain exit: dense = [relu](GN(u)) (+ res). GroupNorm is
    finished from the moments `ps` here; the pass over the volume is K7a.
    The order is affine, relu, residual. `zw` (D,) weighs the depth
    slices in the statistics (reduced-depth volumes)."""
    from .cuda.conv_chain import unpack_affine
    sc, bs = gn_scale_bias(ps, u.shape, weight, bias, groups, zw)
    return unpack_affine(u, sc, bs, res, relu)
