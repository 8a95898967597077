"""SPP + U-Net neck, LIGA style.

Port of `dfm_tpu/models/necks/spp_unet.py`: four average-pool SPP
branches over the last backbone stage, resized back (align_corners=True)
and concatenated with the stride-4 stages, then an upconv decoder to
full resolution (`stereo_feature`) and a 2-conv `sem_feature` head at
stride 4. Keys: spp_branches.i.1, upconv_module.{conv,redir}.s,
lastconv.{0,1}, rpnconv.{0,1}. NCHW in and out.
"""

import torch
import torch.nn as nn

from ..layers import Conv, ConvNorm, UpconvModule
from ...ops.resize import avg_pool_2d, resize_linear

START_LEVEL = 2           # first backbone stage of the concat (stride 4)
SPP_CHANNELS = 32
UP_CHANNELS = (64, 32)    # upconv decoder widths (stride 2, stride 1)


class _SppPool(nn.Module):
    """Average pool of window `size`, clipped to the input (guards tiny
    test inputs, as the JAX neck does)."""

    def __init__(self, size):
        super().__init__()
        self.size = size

    def forward(self, x):
        return avg_pool_2d(x, (min(self.size, x.shape[2]),
                               min(self.size, x.shape[3])))


class SPPUNetNeck(nn.Module):
    """Input: [img, stage0, stage1, stage2, stage3] NCHW features with
    `in_channels` channels. Returns (stereo_feature, sem_feature)."""

    def __init__(self, in_channels=(3, 64, 128, 128, 128),
                 sem_channels=(128, 32), stereo_channels=(32, 32)):
        super().__init__()
        self.spp_branches = nn.ModuleList([
            nn.Sequential(_SppPool(s),
                          ConvNorm(in_channels[-1], SPP_CHANNELS, 1))
            for s in (64, 32, 16, 8)])
        cat_c = sum(in_channels[START_LEVEL:]) + 4 * SPP_CHANNELS
        self.upconv_module = UpconvModule(
            cat_c, (in_channels[1], in_channels[0]), UP_CHANNELS)
        self.lastconv = nn.Sequential(
            ConvNorm(UP_CHANNELS[-1], stereo_channels[0], 3),
            Conv(stereo_channels[0], stereo_channels[1], 1))
        self.rpnconv = nn.Sequential(
            ConvNorm(cat_c, sem_channels[0], 3),
            ConvNorm(sem_channels[0], sem_channels[1], 3))

    def forward(self, feats):
        target_hw = feats[START_LEVEL].shape[2:]
        spp = [resize_linear(branch(feats[-1]), target_hw, dims=(2, 3),
                             align_corners=True)
               for branch in self.spp_branches]
        concat = torch.cat(list(feats[START_LEVEL:]) + spp, dim=1)
        stereo = self.upconv_module([concat, feats[1], feats[0]])
        stereo = self.lastconv(stereo)
        sem = self.rpnconv(concat)
        return stereo, sem
