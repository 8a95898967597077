"""Standard ResNet-18/34/50/101/152 image backbone (NCHW).

Port of `dfm_tpu/models/backbones/resnet.py:58-178` (mmdet `ResNet` as
MV-FCOS3D++ builds it): a 7x7 stride-2 stem with BatchNorm and ReLU, a
3x3 stride-2 max-pool padded by 1, then four stages of `BasicBlock`
(depths 18, 34; expansion 1) or `Bottleneck` (expansion 4, the stride
on its 3x3 conv), with a 1x1 projection on the first block of a stage
whose stride or width changes; the four stage outputs (strides 4, 8, 16,
32). Keys follow mmdet: conv1 / bn1, layerL.B.{conv1, bn1, conv2, bn2,
conv3, bn3, downsample.0, downsample.1}.

A stage of `stage_with_dcn` takes DCNv2 (`models/layers.py:DeformConv2d`,
the stride on it) for the 3x3 conv: a Bottleneck's conv2 (JAX
`conv2_dcn`), a BasicBlock's conv1 (JAX `conv1_dcn`, `:112-115`); its
keys are conv{i}.weight and conv{i}.conv_offset.{weight, bias}.
"""

import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv, DeformConv2d

__all__ = ['ResNet', 'Bottleneck', 'BasicBlock', 'STAGE_BLOCKS',
           'stage_channels']

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BASIC_DEPTHS = (18, 34)


def _conv3x3(cin, cout, stride, dilation, dcn):
    return DeformConv2d(cin, cout, 3, stride, dilation) if dcn else \
        Conv(cin, cout, 3, stride, dilation)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False,
                 dcn=False):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv3x3(planes, planes, stride, dilation, dcn)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            Conv(cin, planes * 4, 1, stride), BatchNorm(planes * 4)) \
            if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False,
                 dcn=False):
        super().__init__()
        self.conv1 = _conv3x3(cin, planes, stride, dilation, dcn)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm(planes)
        self.downsample = nn.Sequential(
            Conv(cin, planes, 1, stride), BatchNorm(planes)) \
            if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def stage_channels(depth, base_channels=64):
    """The widths of the four stage outputs."""
    exp = 1 if depth in BASIC_DEPTHS else 4
    return [base_channels * 2 ** i * exp for i in range(4)]


class ResNet(nn.Module):
    def __init__(self, depth=101, base_channels=64, strides=(1, 2, 2, 2),
                 dilations=(1, 1, 1, 1),
                 stage_with_dcn=(False, False, False, False)):
        super().__init__()
        block = BasicBlock if depth in BASIC_DEPTHS else Bottleneck
        self.conv1 = Conv(3, base_channels, 7, 2)
        self.bn1 = BatchNorm(base_channels)
        in_planes = base_channels
        self.num_stages = len(STAGE_BLOCKS[depth])
        for i, num_blocks in enumerate(STAGE_BLOCKS[depth]):
            planes = base_channels * 2 ** i
            blocks = []
            for b in range(num_blocks):
                stride = strides[i] if b == 0 else 1
                need_ds = b == 0 and (stride != 1 or
                                      in_planes != planes * block.expansion)
                blocks.append(block(in_planes, planes, stride, dilations[i],
                                    need_ds, stage_with_dcn[i]))
                in_planes = planes * block.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))

    def forward(self, x):
        """(N, 3, H, W) -> the four stage outputs."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            outs.append(x)
        return outs
