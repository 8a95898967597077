"""DfM temporal-stereo backbone, dense form.

Port of `dfm_tpu/models/backbones/dfm_backbone.py:485-769`: plane-sweep
cost volume -> stereo trunk (dres0, dres1 + residual, 3D hourglass) and
mono trunk on the cur half, a depth-prediction ConvNorm + 1-channel conv
per trunk, and the learned sigmoid gate that fuses the two costs.

The port computes the dense form (the JAX `use_band=False` branch,
:713-729). The JAX default takes exact shortcuts with the same
parameters (D-constant banded stems, a reduced-depth mono hourglass, the
z-packed Pallas conv chain); those are not ported yet. The 3D convs are
plain `F.conv3d` / `F.conv_transpose3d`, as in the JAX configuration
`DFM_PACKED=0`.

Volumes cross this module's interface channels-last, as in the JAX
package: inputs (B, H, W, C) at full image resolution (feature sample
factor 1, as DfM uses it), outputs (B, D, H', W', C). Internally the
NDHWC volume is viewed as NCDHW (the channels_last_3d memory format), so
no transpose is materialised.
"""

import torch
import torch.nn as nn

from ..layers import Conv, ConvNorm, Hourglass
from ...ops.cost_volume import build_plane_sweep_cost


class DfMBackbone(nn.Module):
    def __init__(self, in_channels=32, cv_channels=32, cost_sample_factor=4,
                 num_depth_bins_out=72):
        super().__init__()
        self.cost_sample_factor = cost_sample_factor
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

    def _trunk(self, x, dres0, dres1, hgs):
        c0 = dres0(x)
        c0 = dres1(c0) + c0
        for hg in hgs:
            c0 = c0 + hg(c0)
        return c0

    def forward(self, cur_stereo_feats, prev_stereo_feats, depths, cam2img,
                cur2prev, org_w=None, flip=None, crop_offset=None,
                scale_factor=None):
        """Returns (mono_stereo_cost (B, D, H', W', 1), stereo_feats and
        mono_feats (B, D, H', W', Cv))."""
        cur2d, prev_vol = build_plane_sweep_cost(
            cur_stereo_feats, prev_stereo_feats, depths, cam2img, cur2prev,
            self.cost_sample_factor, 1, org_w, flip, crop_offset,
            scale_factor)
        b, d, hq, wq, c = prev_vol.shape
        cost = torch.cat([cur2d[:, None].expand(b, d, hq, wq, c), prev_vol],
                         dim=-1)                    # (B, D, H', W', 2C)
        ncdhw = cost.permute(0, 4, 1, 2, 3)
        stereo = self._trunk(ncdhw, self.dres0, self.dres1, self.hg_stereo)
        mono = self._trunk(ncdhw[:, :c], self.dres0_mono, self.dres1_mono,
                           self.hg_mono)
        stereo_cost = self.pred_stereo[0](stereo)[:, 0]      # (B, D, H', W')
        mono_cost = self.pred_mono[0](mono)[:, 0]
        weight = torch.sigmoid(self.aggregate_cost(
            torch.cat([stereo_cost, mono_cost], dim=1)))
        fused = weight * stereo_cost + (1 - weight) * mono_cost
        return (fused[..., None], stereo.permute(0, 2, 3, 4, 1),
                mono.permute(0, 2, 3, 4, 1))
