"""The 3x3x3 conv chain of the DfM trunk: storage format, plain versions
of its seven kernels, and the GroupNorm finishers.

Port of the functions of `dfm_tpu/ops/pallas/conv_chain.py` that the
stereo stem, the 3D hourglass ends and the pred ConvNorm run (K4
`conv_p2p`, K5 `conv_s2_p2d`, K6 `pack_parity8`, K7a `unpack_affine_res`,
K7b `gn_affine_res_packed`, K8a `pack_vol`, K8b `unpack_vol`, and the
XLA-side finishers and `convt1_parity`). It keeps WHAT they compute:
C32 'same' convs whose results stay in one inter-layer storage format,
with the GroupNorm moments taken in the producer's epilogue and the
normalisation applied on the way out. The TPU's z-in-128-lanes blocks,
the two phases, the z-banded weight pairs and the one-hot placement
matmuls do not carry over.

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
(`fold_ps_weighted`). K5's moments are those of its dense half-resolution
C = 64 result, (D / 2, T, 2, 64); K6 only moves values that are already
rounded, so its moments are of the values as stored.

The wrappers that launch the kernels are in `ops/cuda/conv_chain.py`;
on a CPU tensor they return the plain versions below.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ['ChainVol', 'pack_vol_plain', 'unpack_vol_plain', 'unpack_vol',
           'conv_p2p_plain', 'conv_s2_plain', 'convt1_parity',
           'pack_parity8_plain', 'unpack_affine_plain', 'fold_ps_weighted',
           'gn_scale_bias', 'gn_from_partials', 'gn_dense_from_partials',
           'gn_affine_res_packed', 'affine_mask', 'dres0_stats_affine',
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


def unpack_vol_plain(cv):
    """Plain version of K8b: chain format -> dense contiguous
    (D, H, W, C)."""
    return cv.interior().contiguous()


def unpack_vol(cv):
    """Chain format -> dense contiguous (D, H, W, C): K8b on the card
    (`ChainVol.interior()` is the view)."""
    from .cuda.conv_chain import unpack_vol as kernel
    return kernel(cv)


def _moments(af):
    """(D, H, W, C) float32 -> ps (D, 1, 2, C)."""
    return torch.stack([af.sum(dim=(1, 2)), (af * af).sum(dim=(1, 2))],
                       dim=1)[:, None]


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
    return ChainVol(_pad(af.to(x.dtype))), _moments(af)


def conv_s2_plain(cv, weight):
    """Plain version of K5: 3x3x3 stride-2 'same' conv (padding 1) on the
    chain format, D, H, W even, weight (Cout, Cin, 3, 3, 3) rounded to
    the storage type, products and sums in float32. Output voxel
    (m, n, t) reads the stored voxels [2m .. 2m + 2] of each axis: the
    stored border is the conv's padding. Returns (dense
    (D/2, H/2, W/2, Cout) in the input's type, ps (D/2, 1, 2, Cout)
    float32 moments of the unrounded result)."""
    x = cv.data
    if any(n % 2 for n in cv.shape[:3]):
        raise ValueError(f'conv_s2 needs even D, H, W, got {cv.shape}')
    w = weight.to(x.dtype).float()
    af = F.conv3d(x.float().permute(3, 0, 1, 2)[None], w, stride=2)[0]
    af = af.permute(1, 2, 3, 0)
    return af.to(x.dtype), _moments(af)


def _parity_axis(w, dim):
    """Replace the tap axis `dim` (size 3) of a transposed-conv weight
    (k3, s2, p1) by (offset 2, parity 2): the tap that takes x[m + offset]
    to out[2m + parity], or zeros where there is none. Parity 0 is w[1]
    of x[m]; parity 1 is w[2] of x[m] plus w[0] of x[m + 1]."""
    k0, k1, k2 = w.unbind(dim)
    return torch.stack([torch.stack([k1, k2], dim),
                        torch.stack([torch.zeros_like(k0), k0], dim)], dim)


def convt1_parity(x, weight):
    """The transposed conv of `layers.ConvTranspose` (k3, s2, p1, output
    padding 1) as tap products into 8 parity sub-volumes (JAX
    `convt1_parity`). x (D2, H2, W2, Cin); weight (Cin, Cout, 3, 3, 3) in
    torch's layout. Returns (8, D2, H2, W2, Cout) in x's type with
    out[2m + rz, 2n + ry, 2t + rx] = par[4 rz + 2 ry + rx, m, n, t]: a
    strided view (channels innermost) of a (D2 + 1, H2 + 1, W2 + 1, 8,
    Cout) buffer, which K6 reads as it is.

    Per axis, parity 0 takes tap w[1] of x[m]; parity 1 takes w[2] of
    x[m] and w[0] of x[m + 1] (zero past the end). torch's transposed
    conv correlates with the flipped kernel, so these are the JAX
    function's k[0] at offset 0 and k[2] at offset +1 of the flax kernel,
    which `utils/weights.py` flips on import. All 27 tap products are one
    matrix product: the eight shifted copies of x side by side, (rows,
    8 Cin), times a (8 Cin, 8 Cout) matrix that holds each tap in the
    block of its (shift, parity) and zeros elsewhere; a shift is a row
    offset in the zero-padded volume, so no gather is needed. Float32
    sums, rounded to x's type once per parity."""
    d2, h2, w2, cin = x.shape
    cout = weight.shape[1]
    hp, wp = h2 + 1, w2 + 1
    flat = F.pad(x, (0, 0, 0, 1, 0, 1, 0, 1)).reshape(-1, cin)
    offs = [(oz * hp + oy) * wp + ox
            for oz in (0, 1) for oy in (0, 1) for ox in (0, 1)]
    rows = flat.shape[0] - offs[-1]      # up to the last voxel of x
    x8 = torch.cat([flat[o:o + rows] for o in offs], dim=1)
    mat = weight.to(x.dtype)            # (Cin, Cout, kz, ky, kx)
    for dim in (4, 3, 2):               # -> (Cin, Cout, oz, rz, oy, ry, ox, rx)
        mat = _parity_axis(mat, dim)
    mat = mat.permute(2, 4, 6, 0, 3, 5, 7, 1).reshape(8 * cin, 8 * cout)
    buf = x.new_empty((d2 + 1, hp, wp, 8, cout))
    torch.matmul(x8, mat, out=buf.view(-1, 8 * cout)[:rows])
    return buf[:d2, :h2, :w2].permute(3, 0, 1, 2, 4)


def pack_parity8_plain(par):
    """Plain version of K6: (8, D2, H2, W2, C) parity sub-volumes (index
    4 rz + 2 ry + rx) -> (ChainVol of the interleaved (2 D2, 2 H2, 2 W2,
    C) volume, ps (2 D2, 1, 2, C) float32 moments of the values as
    stored)."""
    _, d2, h2, w2, c = par.shape
    p = par.reshape(2, 2, 2, d2, h2, w2, c).permute(3, 0, 4, 1, 5, 2, 6)
    full = p.reshape(2 * d2, 2 * h2, 2 * w2, c)
    return ChainVol(_pad(full)), _moments(full.float())


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
    """Plain version of K7b. Chain -> chain: y = f(sc * x + bs)
    (+ extra) on the volume, the border kept zero. `extra` is a ChainVol
    added after the affine."""
    return ChainVol(_pad(unpack_affine_plain(cv, sc, bs, extra, relu)))


def gn_from_partials(ps, cv, weight, bias, groups, relu=False, extra=None,
                     zw=None):
    """GroupNorm finished from a producer's partial moments and applied
    in one pass (K7b), the result staying in the chain format. `zw` (D,)
    weighs the depth slices in the statistics."""
    from .cuda.conv_chain import affine_chain
    sc, bs = gn_scale_bias(ps, cv.shape, weight, bias, groups, zw)
    return affine_chain(cv, sc, bs, extra, relu)


def gn_affine_res_packed(u, ps, weight, bias, groups, res=None, relu=False):
    """The stem exit that stays in the chain format: [relu](GN(u))
    (+ res), the JAX function of the same name. The same chain -> chain
    pass as `gn_from_partials`."""
    return gn_from_partials(ps, u, weight, bias, groups, relu, res)


def gn_dense_from_partials(x, ps, weight, bias, groups, zw=None, relu=True):
    """GroupNorm of a dense (D, H, W, C) volume finished from its
    producer's partial moments `ps` (D, T, 2, C) (K5's), then relu if
    asked; f32 math, stored in x's type. `zw` (D,) weighs the depth
    slices in the statistics."""
    sc, bs = gn_scale_bias(ps, x.shape, weight, bias, groups, zw)
    y = x.float() * sc + bs
    if relu:
        y = F.relu_(y)
    return y.to(x.dtype)


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
