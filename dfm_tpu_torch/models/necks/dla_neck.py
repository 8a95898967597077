"""DLA neck (NCHW): DLAUp + IDAUp aggregation to one stride-4 map.

Port of `dfm_tpu/models/necks/dla_neck.py` (the reference's `DLANeck`,
with its two documented deviations: an exact bilinear x2 resize in place of
the frozen grouped transposed conv, and DCNv2 or a plain conv in the
projection and node blocks). Over DLA levels 2..5:

* `ProjNode` (JAX `_ProjNode`): `dcn` (DCNv2, `models/layers.py:
  DeformConv2d`) or `conv` (3x3 with a bias), then `bn` and ReLU;
* `IDAUp` (`ida_up`, `dla_up{k}`): for i >= 1, feats[i] <- node{i-1}(
  resize(proj{i-1}(feats[i]), feats[i-1]'s size, align_corners=False) +
  feats[i-1]), in order, each step reading the one before;
* `DLANeck`: `dla_up{k}` over the deepest k + 2 levels for k = 0, 1, 2,
  each replacing those levels (the list updates of `:80-91`), then
  `ida_up` over the first three; the output is its last map.

At 384x1280 this is 16 deformable layers, 64 channels out at 96x320.
"""

import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import resize_linear
from ..backbones.dla import DLA_CHANNELS
from ..layers import BatchNorm, Conv, DeformConv2d

__all__ = ['DLANeck', 'IDAUp', 'ProjNode']


class ProjNode(nn.Module):
    def __init__(self, cin, ch, use_dcn=True):
        super().__init__()
        if use_dcn:
            self.dcn = DeformConv2d(cin, ch)
        else:
            self.conv = Conv(cin, ch, 3, bias=True)
        self.bn = BatchNorm(ch)

    def forward(self, x):
        conv = self.dcn if hasattr(self, 'dcn') else self.conv
        return F.relu(self.bn(conv(x)))


class IDAUp(nn.Module):
    """Aggregate feats[0..n-1] (shallow -> deep, `in_channels` wide) into
    `ch` channels at each shallower scale; returns the updated list."""

    def __init__(self, ch, in_channels, use_dcn=True):
        super().__init__()
        self.n = len(in_channels)
        for i in range(1, self.n):
            setattr(self, f'proj{i - 1}', ProjNode(in_channels[i], ch,
                                                   use_dcn))
            setattr(self, f'node{i - 1}', ProjNode(ch, ch, use_dcn))

    def forward(self, feats):
        feats = list(feats)
        for i in range(1, self.n):
            p = getattr(self, f'proj{i - 1}')(feats[i])
            up = resize_linear(p, feats[i - 1].shape[2:], dims=(2, 3),
                               align_corners=False)
            feats[i] = getattr(self, f'node{i - 1}')(up + feats[i - 1])
        return feats


class DLANeck(nn.Module):
    """The six DLA level features -> one stride-4 map of
    in_channels[start_level] channels."""

    def __init__(self, in_channels=DLA_CHANNELS, start_level=2, end_level=5,
                 use_dcn=True):
        super().__init__()
        self.start_level, self.end_level = start_level, end_level
        chans = list(in_channels[start_level:end_level + 1])
        n = len(chans)
        for k in range(n - 1):
            sub = chans[n - 2 - k:]
            setattr(self, f'dla_up{k}', IDAUp(sub[0], sub, use_dcn))
            chans[n - 2 - k:] = [sub[0]] * len(sub)
        self.ida_up = IDAUp(chans[0], chans[:3], use_dcn)
        self.out_channels = chans[0]

    def forward(self, feats):
        lv = list(feats[self.start_level:self.end_level + 1])
        n = len(lv)
        for k in range(n - 1):
            lv[n - 2 - k:] = getattr(self, f'dla_up{k}')(lv[n - 2 - k:])
        return self.ida_up(lv[:3])[-1]
