"""BEV hourglass backbone.

Port of `dfm_tpu/models/backbones/bev_hourglass.py`: a 3x3 compress
ConvNorm and one 2D hourglass; returns (pre-hourglass, post-hourglass)
features, NCHW. Keys: compress_conv, bev_hourglass. `norm` is the
student's 'gn' or the LiDAR teacher's 'bn'.
"""

import torch.nn as nn

from ..layers import ConvNorm, Hourglass


class BEVHourglass(nn.Module):
    def __init__(self, in_channels, out_channels=64, norm='gn'):
        super().__init__()
        self.compress_conv = ConvNorm(in_channels, out_channels, 3,
                                      norm=norm)
        self.bev_hourglass = Hourglass(out_channels, ndim=2, norm=norm)

    def forward(self, x):
        pre = self.compress_conv(x)
        return pre, self.bev_hourglass(pre)
