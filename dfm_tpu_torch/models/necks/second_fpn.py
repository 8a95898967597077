"""SECONDFPN: SECOND's BEV neck.

Port of `dfm_tpu/models/necks/second_fpn.py:17-41` (reference
mmdet3d/models/necks/second_fpn.py:12-91): each input level to the common
resolution, then a channel concat. A level of stride s > 1 takes a
transposed conv of kernel s and stride s without bias (`deblock{i}.conv`)
and a norm (`deblock{i}.bn` / `.gn`; flax names it `BatchNorm_{j}` /
`GroupNorm_{j}` in the neck's scope, j counting those levels) and ReLU;
a level of stride 1 a 1x1 ConvNorm `deblock{i}`. flax's `ConvTranspose`
(padding 'SAME', kernel not transposed) puts x[i] w[s - 1 - r] at output
s * i + r, which is `F.conv_transpose2d` with the kernel flipped
(`utils/weights.py` flips it): the output is s times the input, odd or
even. NCHW.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvNorm, ConvTranspose, _norm

__all__ = ['SECONDFPN', 'ConvTransposeNorm']


class ConvTransposeNorm(nn.Module):
    """`layers.ConvTranspose` of kernel = stride = s, no padding
    (`.conv`) + norm (`.bn` / `.gn`) + ReLU."""

    def __init__(self, cin, cout, s, norm='bn'):
        super().__init__()
        self.conv = ConvTranspose(cin, cout, k=s, stride=s, padding=0,
                                  output_padding=0)
        self.norm_name = norm
        setattr(self, norm, _norm(norm, cout))

    def forward(self, x):
        return F.relu(getattr(self, self.norm_name)(self.conv(x)))


class SECONDFPN(nn.Module):
    def __init__(self, in_channels, out_channels=(256, 256),
                 upsample_strides=(1, 2), norm='bn'):
        super().__init__()
        self.num_levels = len(out_channels)
        for i, (cin, ch, st) in enumerate(zip(in_channels, out_channels,
                                              upsample_strides)):
            setattr(self, f'deblock{i}',
                    ConvTransposeNorm(cin, ch, st, norm) if st > 1 else
                    ConvNorm(cin, ch, 1, norm=norm))

    def forward(self, feats):
        """The backbone's list of (B, C_i, H_i, W_i) -> (B, sum C, H, W)."""
        outs = [getattr(self, f'deblock{i}')(x)
                for i, x in enumerate(feats[:self.num_levels])]
        return torch.cat(outs, 1) if len(outs) > 1 else outs[0]
