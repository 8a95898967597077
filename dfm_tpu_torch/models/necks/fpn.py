"""Feature Pyramid Network (NCHW).

Port of `dfm_tpu/models/necks/fpn.py:16-51` (mmdet `FPN` with
add_extra_convs='on_output' and relu_before_extra_convs): the inputs
from `start_level` on each get a 1x1 lateral conv; from the coarsest
level down, each lateral is upsampled x2 (nearest), cropped to the next
finer one and added to it; a 3x3 `fpn_conv` per lateral gives the
outputs, and stride-2 3x3 `extra_conv`s on the last output add levels
while fewer than `num_outs` exist (a ReLU before every extra conv but
the first). Keys follow the JAX names: `lateral{i}`, `fpn_conv{i}`,
`extra_conv{j}`, each with a bias.

DfMFull's `neck_2d` is the one-input form (the stride-4 semantic
features, five levels out); MultiViewDfM's `neck` takes the four ResNet
stages to four levels and reads only level 0, so its forward asks for
`levels=1`: the coarser `fpn_conv`s then do not run (their outputs are
unused, as XLA's jit drops them), while the top-down path still feeds
level 0.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv

__all__ = ['FPN']


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels=256, num_outs=5,
                 start_level=0):
        super().__init__()
        if isinstance(in_channels, int):
            in_channels = [in_channels]
        self.start_level = start_level
        self.num_ins = len(in_channels) - start_level
        self.num_outs = num_outs
        for i, cin in enumerate(in_channels[start_level:]):
            setattr(self, f'lateral{i}', Conv(cin, out_channels, 1,
                                              bias=True))
            setattr(self, f'fpn_conv{i}', Conv(out_channels, out_channels, 3,
                                               bias=True))
        for j in range(self.num_ins, num_outs):
            setattr(self, f'extra_conv{j}',
                    Conv(out_channels, out_channels, 3, stride=2, bias=True))

    def forward(self, feats, levels=None):
        """`feats`: one (B, C, H, W) tensor or a list of them, finest
        first. Returns the first `levels` outputs (all `num_outs` if
        None), finest first."""
        if torch.is_tensor(feats):
            feats = [feats]
        feats = feats[self.start_level:]
        laterals = [getattr(self, f'lateral{i}')(f)
                    for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            h, w = laterals[i - 1].shape[2:]
            up = laterals[i].repeat_interleave(2, 2).repeat_interleave(2, 3)
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        levels = self.num_outs if levels is None else levels
        outs = [getattr(self, f'fpn_conv{i}')(laterals[i])
                for i in range(min(levels, self.num_ins))]
        while len(outs) < levels:
            j = len(outs)
            src = F.relu(outs[-1]) if j > self.num_ins else outs[-1]
            outs.append(getattr(self, f'extra_conv{j}')(src))
        return outs
