"""DfM temporal-stereo backbone.

Port of `dfm_tpu/models/backbones/dfm_backbone.py:485-769`: plane-sweep
cost volume -> stereo trunk (dres0, dres1 + residual, 3D hourglass) and
mono trunk on the cur half, a depth-prediction ConvNorm + 1-channel conv
per trunk, and the learned sigmoid gate that fuses the two costs.

One set of parameters (the modules below, reference torch names) serves
four forms of the same function, selected by constructor arguments (the
JAX package selects by environment variables and backend):

* `use_band=False`: the dense form, the JAX `use_band=False` branch
  (:713-729). The broadcast cur half is materialised and both trunks are
  dense convs over every depth plane.
* `use_band=True, packed=False`: the banded form, the JAX default with
  `DFM_PACKED=0` (:636-642, :646-654, :702-711, :751-755). The cur half
  stays a 2D map: `dual_conv_norm` for the stereo dres0, the mono stem on
  a `BandVol` (`ops/band_volume.py`), the mono hourglass and pred on a
  reduced-depth volume with multiplicity-weighted GroupNorm
  (`ops/reduced_depth.py`; dense for depths too short to reduce).
* `use_band=True, packed='stem'`: the banded form with the stereo stem
  and the stereo pred ConvNorm on the conv chain (`ops/conv_chain.py`,
  kernels K4, K7a, K8a), both hourglasses dense: the JAX branch
  `DFM_PACKED=1 DFM_PACKED_HG=0 DFM_PACKED_MONO=0 DFM_PACKED_PRED=1`
  (:607-635 `packed_stereo_stem` :78-106, :737-742 `PackedPred`
  :251-269, here `chain_pred_convnorm`).
* `use_band=True, packed=True`: the full chain, the JAX default
  (`DFM_PACKED=1 DFM_PACKED_HG=1 DFM_PACKED_MONO=1`, :555-606 and
  :660-701). The stereo trunk stays in the chain format from the packed
  prev half to the pred exit: stem (K8a, K4, K4, K7b), `packed_hourglass`
  (K5, dense C64 convs at 1/2 and 1/4 resolution, `convt1_parity`, K6,
  K7b), pred ConvNorm (K4, K7a), and K8b for `stereo_feats`. The mono
  trunk runs its reduced-depth volume through the same functions with
  multiplicity-weighted GroupNorm (K8a, `packed_hourglass(mults)`, K4,
  K7a, K8b). Inference only. A trunk whose shapes do not allow it takes
  the `'stem'` form, as in the JAX package: the hourglass on the chain
  needs D, H', W' divisible by 4 (two stride-2 stages), the mono chain
  also a reduced-depth plan (`_packed_hg`, `_packed_mono`); a model
  built with an explicit `packed=True` warns when a trunk does so.
  `packed=None`, the default, is the full chain for bfloat16 inputs, as
  the JAX package does for bf16 inference, and the banded form
  otherwise. The chain needs 32 cost-volume channels; on the card its
  kernels take bfloat16 only.

Volumes cross this module's interface channels-last, as in the JAX
package: inputs (B, H, W, C) at full image resolution (feature sample
factor 1, as DfM uses it), outputs (B, D, H', W', C). Internally the
NDHWC volume is viewed as NCDHW (the channels_last_3d memory format), so
no transpose is materialised. The stages run in `record_function` spans
(`dfm.stereo_backbone.{cost_volume,stem,hourglass,mono,pred}`).
"""

import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..layers import Conv, ConvNorm, Hourglass, group_norm
from ...ops.band_volume import (band_add, band_conv3, band_from_const,
                                band_gn, band_relu, band_to_dense,
                                dual_conv3)
from ...ops.conv_chain import (convt1_parity, dres0_stats_affine,
                               gn_affine_res_packed, gn_dense_from_partials,
                               gn_from_partials, unpack_affine_res)
from ...ops.cost_volume import build_plane_sweep_cost
from ...ops.cuda.conv_chain import (conv_p2p, conv_s2_p2d, pack_parity8,
                                    pack_vol, unpack_vol)
from ...ops.reduced_depth import make_reduced_plan


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def band_conv_norm(cn, bv):
    """`cn` (a 3D GroupNorm ConvNorm) on a banded volume: the JAX
    `BandConvNorm` (:272-295) on the dense module's parameters."""
    bv = band_gn(band_conv3(bv, cn.conv.weight), cn.gn.weight, cn.gn.bias,
                 cn.gn.groups)
    return band_relu(bv) if cn.act else bv


def dual_conv_norm(cn, cur2d, prev_vol):
    """`cn` on [cur broadcast along depth || prev] without the broadcast
    (JAX `DualConvNorm`, :298-321). Returns NCDHW."""
    x = _ncdhw(dual_conv3(cur2d, prev_vol, cn.conv.weight))
    return F.relu(group_norm(x, cn.gn.weight, cn.gn.bias, cn.gn.groups))


def assemble_reduced(bv, plan):
    """BandVol -> reduced dense volume [lo | interior x k | hi], NCDHW
    (JAX `_assemble_reduced`, :360-366)."""
    mid = bv.interior[:, None].expand(-1, plan.dr - 2 * bv.e, -1, -1, -1)
    return _ncdhw(torch.cat([bv.lo, mid, bv.hi], dim=1))


def weighted_gn(x, mult, gn, eps=1e-5):
    """GroupNorm of a reduced-depth NCDHW volume whose statistics weigh
    each depth slice by its multiplicity in the full volume (JAX
    `_weighted_gn`, :369-382): equal to GroupNorm on the expanded
    volume."""
    b, c, d, h, w = x.shape
    g = gn.groups
    # per-slice sums with the channels innermost: a view (no copy) of a
    # volume that is NDHWC in memory, reduced over H * W
    xx = _ndhwc(x).float().reshape(b, d, h * w, g, c // g)
    m = torch.as_tensor(mult, dtype=torch.float32, device=x.device)
    cnt = float(m.sum()) * h * w * (c // g)
    mean = (xx.sum(dim=(2, 4)) * m[:, None]).sum(dim=1) / cnt     # (B, g)
    var = ((xx * xx).sum(dim=(2, 4)) * m[:, None]).sum(dim=1) / cnt \
        - mean ** 2
    rstd = torch.rsqrt(var + eps)
    sc = gn.weight.float().view(g, c // g) * rstd[..., None]
    bs = gn.bias.float().view(g, c // g) - mean[..., None] * sc
    shape = (b, c, 1, 1, 1)
    return (x.float() * sc.reshape(shape) + bs.reshape(shape)).to(x.dtype)


def _red_conv_norm(conv, gn, x, mult, act):
    """conv + GroupNorm (+ relu), the statistics weighted by `mult`
    unless it is None."""
    x = gn(conv(x)) if mult is None else weighted_gn(conv(x), mult, gn)
    return F.relu(x) if act else x


def red_hourglass(hg, x, plan):
    """`hg` (a 3D `Hourglass`) on a reduced-depth volume: every GroupNorm
    weighted with the multiplicities of its scale (JAX `RedHourglass`,
    :424-454)."""
    m0, m1, m2 = plan.mult(0), plan.mult(1), plan.mult(2)
    out = _red_conv_norm(*hg.conv1[0], x, m1, True)
    pre = _red_conv_norm(*hg.conv2, out, m1, True)
    out = _red_conv_norm(*hg.conv3[0], pre, m2, True)
    out = _red_conv_norm(*hg.conv4[0], out, m2, True)
    post = F.relu(_red_conv_norm(*hg.conv5, out, m1, False) + pre)
    return _red_conv_norm(*hg.conv6, post, m0, False)


def red_depth_pred(pred, x, plan):
    """`pred` (Sequential(ConvNorm, Conv)) on a reduced-depth volume
    (JAX `RedDepthPredModule`, :457-467)."""
    cn, scalar = pred
    return scalar(_red_conv_norm(cn.conv, cn.gn, x, plan.mult(0), True))


def _conv2d_f32(x2d, w):
    """(H, W, C) map, (Cout, C, 3, 3) weight rounded to the map's type,
    float32 result (H, W, Cout)."""
    return F.conv2d(x2d.float().permute(2, 0, 1)[None],
                    w.to(x2d.dtype).float(), padding=1)[0].permute(1, 2, 0)


def packed_stereo_stem(dres0, dres1, cur2d, prev_cv, keep_packed=False):
    """dres0 + dres1 of the stereo trunk on the conv chain, one sample:
    dual conv -> GN -> relu -> conv -> GN -> + residual, exactly
    `dual_conv_norm` + `dres1(c0) + c0` on the same parameters (JAX
    `packed_stereo_stem`, :78-106). cur2d (H, W, C), prev_cv the prev
    half as a ChainVol; returns dense (D, H, W, C), or with
    `keep_packed` a ChainVol for the hourglass on the chain."""
    c = cur2d.shape[-1]
    w0 = dres0.conv.weight
    k_cur, k_prev = w0[:, :c], w0[:, c:]
    # the cur half's contribution is constant along depth: all three z
    # taps inside, one missing on the first and on the last slice
    ci = _conv2d_f32(cur2d, k_cur.sum(dim=2))
    clo = ci - _conv2d_f32(cur2d, k_cur[:, :, 0])
    chi = ci - _conv2d_f32(cur2d, k_cur[:, :, 2])
    u0, ps0 = conv_p2p(prev_cv, k_prev)
    y0 = dres0_stats_affine(u0, ps0, ci, clo, chi, dres0.gn.weight,
                            dres0.gn.bias, dres0.gn.groups)
    u1, ps1 = conv_p2p(y0, dres1.conv.weight)
    exit_ = gn_affine_res_packed if keep_packed else unpack_affine_res
    return exit_(u1, ps1, dres1.gn.weight, dres1.gn.bias, dres1.gn.groups,
                 res=y0)


def packed_hourglass(hg, x_cv, mults=None):
    """x + `hg`(x) on the conv chain, one sample (JAX `packed_hourglass`,
    :167-224, on the parameters of the dense `Hourglass`). The two
    full-resolution ends are kernels: the stride-2 entry conv reads the
    chain format (K5) and the last transposed conv is taken as tap
    products into 8 parity sub-volumes (`convt1_parity`) that K6
    interleaves straight back into the chain format; both hand their
    GroupNorm moments on. The C64 convs at 1/2 and 1/4 resolution are
    dense. `mults` = (m0, m1, m2), the slice multiplicities of a
    reduced-depth volume at the three scales: every GroupNorm then weighs
    its statistics (`red_hourglass` on the chain). Inference only."""
    m0, m1, m2 = (None,) * 3 if mults is None else mults
    conv1, gn1 = hg.conv1[0]
    u0, ps0 = conv_s2_p2d(x_cv, conv1.weight)
    out = gn_dense_from_partials(u0, ps0, gn1.weight, gn1.bias, gn1.groups,
                                 zw=m1, relu=True)
    pre = _red_conv_norm(*hg.conv2, _ncdhw(out[None]), m1, True)
    mid = _red_conv_norm(*hg.conv3[0], pre, m2, True)
    mid = _red_conv_norm(*hg.conv4[0], mid, m2, True)
    post = F.relu(_red_conv_norm(*hg.conv5, mid, m1, False) + pre)
    convt, gn6 = hg.conv6
    par = convt1_parity(_ndhwc(post)[0].contiguous(), convt.weight)
    u1, ps1 = pack_parity8(par)
    # GroupNorm of the transposed conv + the hourglass residual in one
    # pass, staying in the chain format
    return gn_from_partials(ps1, u1, gn6.weight, gn6.bias, gn6.groups,
                            extra=x_cv, zw=m0)


def chain_pred_convnorm(cn, x_cv, zw=None):
    """The pred ConvNorm on the conv chain, one sample: conv -> GN (slices
    weighted by `zw`) + relu on the way out (JAX `PackedPred`, :251-269,
    before its scalar conv, and the pred exits of the full chain,
    :586-589, :684-688). `x_cv` is the trunk in the chain format, or its
    dense output packed (K8a)."""
    u, ps = conv_p2p(x_cv, cn.conv.weight)
    return unpack_affine_res(u, ps, cn.gn.weight, cn.gn.bias, cn.gn.groups,
                             relu=True, zw=zw)


def _stack(xs):
    """torch.stack without the copy for a batch of one."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


class DfMBackbone(nn.Module):
    def __init__(self, in_channels=32, cv_channels=32, cost_sample_factor=4,
                 num_depth_bins_out=72, use_band=True, packed=None):
        super().__init__()
        if packed not in (None, True, False, 'stem'):
            raise ValueError(f"packed is None, True, False or 'stem', got "
                             f'{packed!r}')
        if packed and not use_band:
            raise ValueError('the conv chain runs in the banded form: '
                             'packed=True needs use_band=True')
        if packed and not in_channels == cv_channels == 32:
            raise ValueError('the conv chain takes 32 channels')
        self.cost_sample_factor = cost_sample_factor
        self.use_band = use_band
        self.packed = packed
        cv = cv_channels

        def cn(cin, act=True):
            return ConvNorm(cin, cv, 3, ndim=3, act=act)

        self.dres0 = cn(2 * in_channels)
        self.dres1 = cn(cv, act=False)
        self.dres0_mono = cn(in_channels)
        self.dres1_mono = cn(cv, act=False)
        self.hg_stereo = nn.ModuleList([Hourglass(cv)])
        self.hg_mono = nn.ModuleList([Hourglass(cv)])
        self.pred_stereo = nn.ModuleList(
            [nn.Sequential(cn(cv), Conv(cv, 1, 3, ndim=3))])
        self.pred_mono = nn.ModuleList(
            [nn.Sequential(cn(cv), Conv(cv, 1, 3, ndim=3))])
        self.aggregate_cost = Conv(2 * num_depth_bins_out,
                                   num_depth_bins_out, 1)

    def _packed(self, x):
        """Whether the stereo stem and pred ConvNorm of this call (prev
        volume x (B, D, H', W', C)) run on the conv chain."""
        if self.packed is not None:
            return bool(self.packed)
        cv = self.dres1.conv.weight.shape[0]
        return (self.use_band and x.dtype == torch.bfloat16
                and x.shape[-1] == cv == 32)

    def _packed_hg(self, x):
        """Whether the stereo hourglass runs on the chain too (the full
        chain): a choice by shape, D, H', W' divisible by 4."""
        return (self._packed(x) and self.packed != 'stem'
                and all(n % 4 == 0 for n in x.shape[1:4]))

    def _packed_mono(self, x, plan):
        """Whether the mono hourglass and pred ConvNorm run on the chain:
        a reduced-depth `plan` whose depth, and H', W', divide by 4."""
        return (self._packed(x) and self.packed != 'stem'
                and plan is not None and plan.dr % 4 == 0
                and all(n % 4 == 0 for n in x.shape[2:4]))

    @staticmethod
    def _hg_stack(x, hgs):
        for hg in hgs:
            x = x + hg(x)
        return x

    def _warn_not_on_chain(self, trunk, why):
        """A trunk of a model built with an explicit `packed=True` takes the
        `'stem'` form for its shapes: say so (once per message)."""
        if self.packed is True:
            warnings.warn(f'DfMBackbone(packed=True): the {trunk} takes the '
                          f"packed='stem' form, {why}", RuntimeWarning,
                          stacklevel=2)

    def _stereo(self, cur2d, prev_vol, span):
        """The stereo trunk and its depth cost in the dense, banded and
        `'stem'` forms: (feats NCDHW, cost (B, D, H', W'))."""
        packed = self._packed(prev_vol)
        cn, scalar = self.pred_stereo[0]
        with record_function(span + 'stem'):
            if packed:
                x = _ncdhw(_stack([
                    packed_stereo_stem(self.dres0, self.dres1, cur2d[i],
                                       pack_vol(prev_vol[i]))
                    for i in range(prev_vol.shape[0])]))
            else:
                if self.use_band:
                    c0 = dual_conv_norm(self.dres0, cur2d, prev_vol)
                else:
                    b, d, hq, wq, c = prev_vol.shape
                    c0 = self.dres0(_ncdhw(torch.cat(
                        [cur2d[:, None].expand(b, d, hq, wq, c), prev_vol],
                        dim=-1)))
                x = self.dres1(c0) + c0
        with record_function(span + 'hourglass'):
            x = self._hg_stack(x, self.hg_stereo)
        with record_function(span + 'pred'):
            if packed:
                feat = _ncdhw(_stack([
                    chain_pred_convnorm(cn, pack_vol(dense))
                    for dense in _ndhwc(x).contiguous()]))
            else:
                feat = cn(x)
            return x, scalar(feat)[:, 0]

    def _stereo_chain(self, cur2d, prev_vol, span):
        """The same on the full chain: one ChainVol a sample from the
        packed prev half to the pred exit, K8b for the feats."""
        cn, scalar = self.pred_stereo[0]
        with record_function(span + 'stem'):
            xs = [packed_stereo_stem(self.dres0, self.dres1, cur2d[i],
                                     pack_vol(prev_vol[i]), keep_packed=True)
                  for i in range(prev_vol.shape[0])]
        with record_function(span + 'hourglass'):
            for hg in self.hg_stereo:
                xs = [packed_hourglass(hg, x_cv) for x_cv in xs]
        with record_function(span + 'pred'):
            feat = _ncdhw(_stack([chain_pred_convnorm(cn, x_cv)
                                  for x_cv in xs]))
            feats = _ncdhw(_stack([unpack_vol(x_cv) for x_cv in xs]))
            return feats, scalar(feat)[:, 0]

    def _mono(self, cur2d, prev_vol):
        """The mono trunk and its depth cost: (feats NCDHW, cost
        (B, D, H', W'))."""
        d = prev_vol.shape[1]
        pred = self.pred_mono[0]
        if not self.use_band:
            x = _ncdhw(cur2d[:, None].expand(-1, d, -1, -1, -1))
            c0 = self.dres0_mono(x)
            feats = self._hg_stack(self.dres1_mono(c0) + c0, self.hg_mono)
            return feats, pred(feats)[:, 0]
        m0 = band_conv_norm(self.dres0_mono, band_from_const(cur2d, d))
        band = band_add(band_conv_norm(self.dres1_mono, m0), m0)
        plan = make_reduced_plan(d, e=band.e) \
            if len(self.hg_mono) == 1 else None
        if plan is None:                 # too short to reduce: dense
            self._warn_not_on_chain(
                'mono trunk', f'{d} depth planes have no reduced-depth plan')
            feats = self._hg_stack(_ncdhw(band_to_dense(band)), self.hg_mono)
            return feats, pred(feats)[:, 0]
        red = assemble_reduced(band, plan)
        idx = torch.as_tensor(plan.expand_idx, dtype=torch.long,
                              device=red.device)
        if self._packed_mono(prev_vol, plan):
            mults = tuple(plan.mult(s) for s in range(3))
            feats, pred_feats = [], []
            for red_i in _ndhwc(red).contiguous():
                x_cv = packed_hourglass(self.hg_mono[0], pack_vol(red_i),
                                        mults)
                pred_feats.append(chain_pred_convnorm(pred[0], x_cv,
                                                      mults[0]))
                feats.append(unpack_vol(x_cv))
            red = _ncdhw(_stack(feats))
            cost = pred[1](_ncdhw(_stack(pred_feats)))[:, 0]
        else:
            self._warn_not_on_chain(
                'mono trunk', f"reduced D, H', W' = "
                f'{(plan.dr, *prev_vol.shape[2:4])} do not all divide by 4')
            red = red + red_hourglass(self.hg_mono[0], red, plan)
            cost = red_depth_pred(pred, red, plan)[:, 0]
        return red.index_select(2, idx), cost.index_select(1, idx)

    def forward(self, cur_stereo_feats, prev_stereo_feats, depths, cam2img,
                cur2prev, org_w=None, flip=None, crop_offset=None,
                scale_factor=None):
        """Returns (mono_stereo_cost (B, D, H', W', 1), stereo_feats and
        mono_feats (B, D, H', W', Cv))."""
        span = 'dfm.stereo_backbone.'
        with record_function(span + 'cost_volume'):
            cur2d, prev_vol = build_plane_sweep_cost(
                cur_stereo_feats, prev_stereo_feats, depths, cam2img,
                cur2prev, self.cost_sample_factor, 1, org_w, flip,
                crop_offset, scale_factor)
        if self._packed_hg(prev_vol):
            stereo, stereo_cost = self._stereo_chain(cur2d, prev_vol, span)
        else:
            self._warn_not_on_chain(
                'stereo trunk', f"D, H', W' = {tuple(prev_vol.shape[1:4])} "
                f'do not all divide by 4')
            stereo, stereo_cost = self._stereo(cur2d, prev_vol, span)
        with record_function(span + 'mono'):
            mono, mono_cost = self._mono(cur2d, prev_vol)
        with record_function(span + 'pred'):
            weight = torch.sigmoid(self.aggregate_cost(
                torch.cat([stereo_cost, mono_cost], dim=1)))
            fused = weight * stereo_cost + (1 - weight) * mono_cost
        return fused[..., None], _ndhwc(stereo), _ndhwc(mono)
