"""Feature Pyramid Network (NCHW), in the one-input form DfMFull builds.

Port of `dfm_tpu/models/necks/fpn.py:16` (mmdet `FPN` with
add_extra_convs='on_output' and relu_before_extra_convs) as DfMFull's
`neck_2d` builds it: the stride-4 semantic features in, five levels out.
With one input JAX's top-down loop adds nothing, so there is none here.
Keys follow the JAX names: `lateral0` (1x1), `fpn_conv0` (3x3) and
`extra_conv1..4` (3x3, stride 2), each with a bias.
"""

import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv

__all__ = ['FPN']

NUM_OUTS = 5


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels=256):
        super().__init__()
        self.lateral0 = Conv(in_channels, out_channels, 1, bias=True)
        self.fpn_conv0 = Conv(out_channels, out_channels, 3, bias=True)
        for j in range(1, NUM_OUTS):
            setattr(self, f'extra_conv{j}',
                    Conv(out_channels, out_channels, 3, stride=2, bias=True))

    def forward(self, x):
        """(B, C_in, H, W) -> the five levels, strides 1, 2, 4, 8, 16
        relative to `x`."""
        outs = [self.fpn_conv0(self.lateral0(x))]
        # the ReLU goes before every extra conv but the first (JAX's
        # `len(outs) > len(laterals)`)
        for j in range(1, NUM_OUTS):
            src = F.relu(outs[-1]) if j > 1 else outs[-1]
            outs.append(getattr(self, f'extra_conv{j}')(src))
        return outs
