"""OutdoorImVoxelNeck: a voxel volume to a BEV map (NCDHW -> NCHW).

Port of `dfm_tpu/models/necks/imvoxel_neck.py:18-52` (reference
mmdet3d/models/necks/imvoxel_neck.py:9-117): three stages of a residual
3D block (`ResModule3D`: two 3^3 ConvNorm, BatchNorm, the second without
ReLU, added to the input, then ReLU) and a 3^3 ConvNorm that strides 2
along z while more than one z plane is left, widening 64 -> 128 -> 256
-> 256 channels at the camsync config; then the mean over the remaining
z planes (12 -> 6 -> 3 -> 2 -> mean). Every conv pads 1 on all sides,
as JAX's `Conv3DSum` pads k // 2 at every stride, so 3 planes stride to
2. Keys: res{i}.conv0, res{i}.conv1, down{i}, each `.conv` + `.bn`.

The convs take the model's dtype; the residual adds in the input's
dtype, as in the JAX package (its float32 sampled volume keeps the
first block's sum in float32 under a bfloat16 model).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ConvNorm

__all__ = ['ResModule3D', 'OutdoorImVoxelNeck']


class ResModule3D(nn.Module):
    def __init__(self, channels, norm='bn'):
        super().__init__()
        self.conv0 = ConvNorm(channels, channels, 3, ndim=3, norm=norm)
        self.conv1 = ConvNorm(channels, channels, 3, ndim=3, norm=norm,
                              act=False)

    def forward(self, x, dtype=None):
        out = self.conv1(self.conv0(x.to(dtype or x.dtype)))
        return F.relu(x + out)


class OutdoorImVoxelNeck(nn.Module):
    def __init__(self, in_channels=64, out_channels=256, norm='bn',
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        ch = in_channels
        for i in range(3):
            setattr(self, f'res{i}', ResModule3D(ch, norm))
            cout = ch * 2 if i < 2 else out_channels
            setattr(self, f'down{i}', ConvNorm(ch, cout, 3, ndim=3,
                                               norm=norm))
            ch = cout

    def forward(self, x):
        """(B, C, Nz, Ny, Nx) -> (B, C_out, Ny, Nx)."""
        for i in range(3):
            x = getattr(self, f'res{i}')(x, self.dtype)
            down = getattr(self, f'down{i}')
            # stride 2 along z only, while more than one plane is left
            sz = 2 if x.shape[2] > 1 else 1
            x = x.to(self.dtype)
            x = F.conv3d(x, down.conv.weight.to(x.dtype), None, (sz, 1, 1), 1)
            x = F.relu(down.bn(x))
        return x.mean(2) if x.shape[2] > 1 else x[:, :, 0]
