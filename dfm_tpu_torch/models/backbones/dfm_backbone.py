"""DfM temporal-stereo backbone.

Port of `dfm_tpu/models/backbones/dfm_backbone.py:485-769`: plane-sweep
cost volume -> stereo trunk (dres0, dres1 + residual, 3D hourglass) and
mono trunk on the cur half, a depth-prediction ConvNorm + 1-channel conv
per trunk, and the learned sigmoid gate that fuses the two costs.

One set of parameters (the modules below, reference torch names) serves
three forms of the same function, selected by constructor arguments (the
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
* `use_band=True, packed=True`: the banded form with the stereo stem and
  the stereo pred ConvNorm on the conv chain (`ops/conv_chain.py`,
  kernels K4, K7a, K8a), the JAX branch `DFM_PACKED=1 DFM_PACKED_HG=0
  DFM_PACKED_MONO=0 DFM_PACKED_PRED=1` (:607-635 `packed_stereo_stem`
  :78-106, :737-742 `PackedPred` :251-269). `packed=None`, the default,
  turns the chain on for bfloat16 inputs, as the JAX package does for
  bf16 inference. The chain needs 32 cost-volume channels; on the card
  its kernels take bfloat16 only.

The stereo and mono hourglass stay dense 3D convs in every form (the
JAX packed hourglass and packed mono chain are not ported yet).

Volumes cross this module's interface channels-last, as in the JAX
package: inputs (B, H, W, C) at full image resolution (feature sample
factor 1, as DfM uses it), outputs (B, D, H', W', C). Internally the
NDHWC volume is viewed as NCDHW (the channels_last_3d memory format), so
no transpose is materialised. The stages run in `record_function` spans
(`dfm.stereo_backbone.{cost_volume,stem,hourglass,mono,pred}`).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..layers import Conv, ConvNorm, Hourglass, group_norm
from ...ops.band_volume import (band_add, band_conv3, band_from_const,
                                band_gn, band_relu, band_to_dense,
                                dual_conv3)
from ...ops.conv_chain import dres0_stats_affine, unpack_affine_res
from ...ops.cost_volume import build_plane_sweep_cost
from ...ops.cuda.conv_chain import conv_p2p, pack_vol
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
    x = weighted_gn(conv(x), mult, gn)
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


def packed_stereo_stem(dres0, dres1, cur2d, prev_cv):
    """dres0 + dres1 of the stereo trunk on the conv chain, one sample:
    dual conv -> GN -> relu -> conv -> GN -> + residual, exactly
    `dual_conv_norm` + `dres1(c0) + c0` on the same parameters (JAX
    `packed_stereo_stem`, :78-106). cur2d (H, W, C), prev_cv the prev
    half as a ChainVol; returns dense (D, H, W, C)."""
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
    return unpack_affine_res(u1, ps1, dres1.gn.weight, dres1.gn.bias,
                             dres1.gn.groups, res=y0)


def packed_pred_convnorm(cn, feats):
    """The pred ConvNorm on the conv chain, one sample (D, H, W, C):
    pack -> conv -> GN + relu on the way out (JAX `PackedPred`,
    :251-269, before its scalar conv)."""
    u, ps = conv_p2p(pack_vol(feats), cn.conv.weight)
    return unpack_affine_res(u, ps, cn.gn.weight, cn.gn.bias, cn.gn.groups,
                             relu=True)


class DfMBackbone(nn.Module):
    def __init__(self, in_channels=32, cv_channels=32, cost_sample_factor=4,
                 num_depth_bins_out=72, use_band=True, packed=None):
        super().__init__()
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
        """Whether the stereo stem and pred ConvNorm of this call run on
        the conv chain."""
        if self.packed is not None:
            return self.packed
        cv = self.dres1.conv.weight.shape[0]
        return (self.use_band and x.dtype == torch.bfloat16
                and x.shape[-1] == cv == 32)

    @staticmethod
    def _hg_stack(x, hgs):
        for hg in hgs:
            x = x + hg(x)
        return x

    def _stereo_stem(self, cur2d, prev_vol, packed):
        if packed:
            return _ncdhw(torch.stack([
                packed_stereo_stem(self.dres0, self.dres1, cur2d[i],
                                   pack_vol(prev_vol[i]))
                for i in range(prev_vol.shape[0])]))
        if self.use_band:
            c0 = dual_conv_norm(self.dres0, cur2d, prev_vol)
        else:
            b, d, hq, wq, c = prev_vol.shape
            c0 = self.dres0(_ncdhw(torch.cat(
                [cur2d[:, None].expand(b, d, hq, wq, c), prev_vol], dim=-1)))
        return self.dres1(c0) + c0

    def _mono(self, cur2d, d):
        """The mono trunk and its depth cost: (feats NCDHW, cost
        (B, D, H', W'))."""
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
            feats = self._hg_stack(_ncdhw(band_to_dense(band)), self.hg_mono)
            return feats, pred(feats)[:, 0]
        red = assemble_reduced(band, plan)
        red = red + red_hourglass(self.hg_mono[0], red, plan)
        idx = torch.as_tensor(plan.expand_idx, dtype=torch.long,
                              device=red.device)
        cost = red_depth_pred(pred, red, plan)[:, 0]
        return red.index_select(2, idx), cost.index_select(1, idx)

    def _stereo_cost(self, stereo, packed):
        cn, scalar = self.pred_stereo[0]
        if not packed:
            return scalar(cn(stereo))[:, 0]
        dense = _ndhwc(stereo).contiguous()
        x = torch.stack([packed_pred_convnorm(cn, dense[i])
                         for i in range(dense.shape[0])])
        return scalar(_ncdhw(x))[:, 0]

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
        packed = self._packed(prev_vol)
        with record_function(span + 'stem'):
            stereo = self._stereo_stem(cur2d, prev_vol, packed)
        with record_function(span + 'hourglass'):
            stereo = self._hg_stack(stereo, self.hg_stereo)
        with record_function(span + 'mono'):
            mono, mono_cost = self._mono(cur2d, prev_vol.shape[1])
        with record_function(span + 'pred'):
            stereo_cost = self._stereo_cost(stereo, packed)
            weight = torch.sigmoid(self.aggregate_cost(
                torch.cat([stereo_cost, mono_cost], dim=1)))
            fused = weight * stereo_cost + (1 - weight) * mono_cost
        return fused[..., None], _ndhwc(stereo), _ndhwc(mono)
