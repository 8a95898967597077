"""DLA-34 backbone (NCHW), the SMOKE / MonoFlex trunk.

Port of `dfm_tpu/models/backbones/dla.py` (the reference's `DLANet`, arch
34: BasicBlock, levels (1, 1, 1, 2, 2, 1), channels (16, 32, 64, 128, 256,
512), level_root (False, True, True, True)), BatchNorm throughout:

* `base_layer` (7x7), `level0` (3x3), `level1` (3x3, stride 2): conv,
  BatchNorm, ReLU (`ConvBNReLU`; JAX `_ConvNormRelu`);
* `level2`..`level5`: recursive `Tree`s. A Tree pools its input with a
  stride-sized max-pool (floor) into `bottom`, projects it (`project`, a
  1x1 conv and a BatchNorm) where the width changes, and with one level
  runs `tree1` (a stride-s basic block on the input, `bottom`'s
  projection as its identity) and `tree2`, then `root`: a 1x1 conv and a
  BatchNorm over the concatenation [tree2, tree1, children...], ReLU.
  With more levels `tree1` and `tree2` are Trees, `tree2` taking
  `bottom` (a level root's) and `tree1`'s output as children; JAX then
  computes the projection without reading it, so in train mode its
  BatchNorm statistics move, and the port computes it in train mode
  alone for the same statistics.

The trunk returns all six levels (strides 1, 2, 4, 8, 16, 32). Keys:
base_layer.{conv,bn}, levelL.{project.0, project.1, tree1, tree2,
root.{conv,bn}}, a basic block's conv1 / bn1 / conv2 / bn2 (JAX
`_ConvNormRelu_0` / `_1`).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, Conv

__all__ = ['DLANet', 'Tree', 'Root', 'DLABasicBlock', 'ConvBNReLU',
           'DLA_CHANNELS']

DLA_CHANNELS = (16, 32, 64, 128, 256, 512)
DLA_LEVELS = (1, 1, 1, 2, 2, 1)
DLA_LEVEL_ROOT = (False, True, True, True)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DLABasicBlock(nn.Module):
    def __init__(self, cin, ch, stride=1):
        super().__init__()
        self.conv1 = Conv(cin, ch, 3, stride)
        self.bn1 = BatchNorm(ch)
        self.conv2 = Conv(ch, ch, 3)
        self.bn2 = BatchNorm(ch)

    def forward(self, x, identity=None):
        identity = x if identity is None else identity
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + identity)


class Root(nn.Module):
    def __init__(self, cin, ch):
        super().__init__()
        self.conv = Conv(cin, ch, 1)
        self.bn = BatchNorm(ch)

    def forward(self, feats):
        return F.relu(self.bn(self.conv(torch.cat(feats, 1))))


class Tree(nn.Module):
    """`levels` levels of `ch` channels over a `cin`-channel input;
    `root_extra` is the width of the children a parent passes in."""

    def __init__(self, levels, cin, ch, stride=1, level_root=False,
                 root_extra=0):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        self.project = nn.Sequential(Conv(cin, ch, 1), BatchNorm(ch)) \
            if cin != ch else None
        if levels == 1:
            self.tree1 = DLABasicBlock(cin, ch, stride)
            self.tree2 = DLABasicBlock(ch, ch)
            self.root = Root(2 * ch + (cin if level_root else 0) +
                             root_extra, ch)
        else:
            self.tree1 = Tree(levels - 1, cin, ch, stride)
            self.tree2 = Tree(levels - 1, ch, ch, 1, root_extra=(
                cin if level_root else 0) + ch + root_extra)

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) \
            if self.stride > 1 else x
        identity = bottom
        if self.project is not None and (self.levels == 1 or self.training):
            identity = self.project(bottom)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, identity)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DLANet(nn.Module):
    """DLA-34: (B, 3, H, W) -> the six level features."""

    def __init__(self, channels=DLA_CHANNELS, levels=DLA_LEVELS,
                 level_root=DLA_LEVEL_ROOT):
        super().__init__()
        ch = channels
        self.base_layer = ConvBNReLU(3, ch[0], 7)
        self.level0 = ConvBNReLU(ch[0], ch[0])
        self.level1 = ConvBNReLU(ch[0], ch[1], stride=2)
        for i in range(4):
            setattr(self, f'level{i + 2}', Tree(
                levels[i + 2], ch[i + 1], ch[i + 2], 2, level_root[i]))

    def forward(self, x):
        x = self.base_layer(x)
        outs = []
        for i in range(6):
            x = getattr(self, f'level{i}')(x)
            outs.append(x)
        return outs
