"""LIGA-Stereo ResNet image backbone.

Port of `dfm_tpu/models/backbones/liga_resnet.py`: ResNet-18/34 whose
per-stage strides, dilations and channel factors, stem max-pool and
output stages are options, as JAX's `LIGAResNet` has them (its block
ReLU and norm options are not ported: nothing sets them). The defaults
are DfM's trunk: strides (1,2,1,1), dilations (1,1,2,4), channel factors
(1,2,2,2), no stem max-pool, every stage out; no block has a ReLU after
its add. ImVoteNet's image
branch takes the plain ResNet-18 form: strides (1,2,2,2), dilations 1,
factors (1,2,4,8), the max-pool, stages 1-3 out. Keys follow the mmdet
ResNet layout (conv1/bn1, layerL.B.{conv1,bn1,conv2,bn2,downsample.0,
downsample.1}). Input and outputs are NCHW.
"""

import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class LigaBasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = nn.Sequential(
            Conv(cin, planes, 1, stride), BatchNorm(planes)) \
            if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return out + identity


STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)
CHANNEL_FACTORS = (1, 2, 2, 2)


class LIGAResNet(nn.Module):
    """Returns the features of the stages in `out_indices` of an RGB image
    (DfM's defaults: all four, strides 2, 4, 4, 4); `out_channels` lists
    every stage's width."""

    def __init__(self, depth=34, base_channels=64, strides=STRIDES,
                 dilations=DILATIONS, num_channels_factor=CHANNEL_FACTORS,
                 out_indices=(0, 1, 2, 3), with_max_pool=False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.with_max_pool = with_max_pool
        self.conv1 = Conv(3, base_channels, 7, 2)
        self.bn1 = BatchNorm(base_channels)
        in_planes = base_channels
        self.out_channels = []
        for i, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            planes = base_channels * num_channels_factor[i]
            blocks = []
            for b in range(num_blocks):
                stride = strides[i] if b == 0 else 1
                need_ds = b == 0 and (stride != 1 or in_planes != planes)
                blocks.append(LigaBasicBlock(
                    in_planes if b == 0 else planes, planes, stride,
                    dilations[i], need_ds))
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            in_planes = planes
            self.out_channels.append(planes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        if self.with_max_pool:
            x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(len(self.out_channels)):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return outs
