"""LIGA-Stereo ResNet image backbone.

Port of `dfm_tpu/models/backbones/liga_resnet.py`: ResNet-18/34 with
per-stage strides (1,2,1,1), dilations (1,1,2,4), channel factors
(1,2,2,2), no stem max-pool and no post-add ReLU in the blocks. Keys
follow the mmdet ResNet layout (conv1/bn1, layerL.B.{conv1,bn1,conv2,
bn2,downsample.0,downsample.1}). Input and outputs are NCHW.
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
    """Returns the per-stage features (strides 2, 4, 4, 4) of an RGB
    image."""

    def __init__(self, depth=34, base_channels=64):
        super().__init__()
        self.conv1 = Conv(3, base_channels, 7, 2)
        self.bn1 = BatchNorm(base_channels)
        in_planes = base_channels
        self.out_channels = []
        for i, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            planes = base_channels * CHANNEL_FACTORS[i]
            blocks = []
            for b in range(num_blocks):
                stride = STRIDES[i] if b == 0 else 1
                need_ds = b == 0 and (stride != 1 or in_planes != planes)
                blocks.append(LigaBasicBlock(
                    in_planes if b == 0 else planes, planes, stride,
                    DILATIONS[i], need_ds))
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            in_planes = planes
            self.out_channels.append(planes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        outs = []
        for i in range(len(self.out_channels)):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        return outs
