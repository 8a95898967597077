"""SECOND's BEV backbone.

Port of `dfm_tpu/models/backbones/second.py:17-36` (reference
mmdet3d/models/backbones/second.py:10-91): per stage one 3x3 ConvNorm at
the stage's stride, then `layer_num` stride-1 3x3 ConvNorms (conv, norm,
ReLU), every stage's map returned. Keys `stage{s}_conv{i}` (`.conv`,
`.bn` / `.gn`), the flax module names. NCHW.
"""

import torch.nn as nn

from ..layers import ConvNorm

__all__ = ['SECOND']


class SECOND(nn.Module):
    def __init__(self, in_channels, out_channels=(128, 256),
                 layer_nums=(5, 5), layer_strides=(1, 2), norm='bn'):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        cin = in_channels
        for s, (ch, n, st) in enumerate(zip(out_channels, layer_nums,
                                            layer_strides)):
            setattr(self, f'stage{s}_conv0',
                    ConvNorm(cin, ch, 3, norm=norm, stride=st))
            for i in range(n):
                setattr(self, f'stage{s}_conv{i + 1}',
                        ConvNorm(ch, ch, 3, norm=norm))
            cin = ch

    def forward(self, x):
        """(B, C, H, W) -> the list of every stage's (B, C_s, H_s, W_s)."""
        outs = []
        for s, n in enumerate(self.layer_nums):
            for i in range(n + 1):
                x = getattr(self, f'stage{s}_conv{i}')(x)
            outs.append(x)
        return outs
