"""DfMNeck: the two-frame concat volume to a BEV map by gated mono and
stereo paths (NCDHW -> NCHW).

Port of `dfm_tpu/models/necks/dfm_neck.py:24-71` (reference
mmdet3d/models/necks/dfm_neck.py:11-122), the neck of the 10-sweeps
MV-FCOS3D++ config: the volume holds the frames' channels one after the
other, the current frame's first. The mono path reads channels [:C], the
stereo path all F * C. Each path is `ResModule3D` -> 3^3 ConvNorm with
z-stride 2 (C -> 2C) -> `ResModule3D` -> z-stride-2 ConvNorm (-> 4C) ->
`ResModule3D` -> a final conv to `out_channels` with kernel (min(3, nz),
3, 3), z VALID and y/x padded 1, no bias -> BatchNorm -> ReLU -> the mean
over the z planes left (when more than one is). A 1x1 conv without bias
(`aggregate_layer`) over both maps makes the gate w = sigmoid(.), and the
output is w * mono + (1 - w) * stereo.

The strided convs pad 1 at every stride, as JAX's `Conv3DSum` does (12
planes -> 6 -> 3, 4 -> 2 -> 1). Keys: `{mono,stereo}_res{i}.conv{j}`,
`{mono,stereo}_down{i}` (`.conv` + `.bn`), `{mono,stereo}_final_conv`,
`{mono,stereo}_final_bn` and `aggregate_layer`; the final BatchNorms are
JAX's `BatchNorm_0` (mono) and `BatchNorm_1` (stereo), auto-named in call
order. The convs take the model's dtype and the residuals add in the
input's, as in `imvoxel_neck.py`.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNorm, ConvNorm
from .imvoxel_neck import ResModule3D

__all__ = ['DfMNeck', 'z_after_downs']


def z_after_downs(nz, downs=2):
    """The z planes left after `downs` 3^3 convs of z-stride 2, padding 1."""
    for _ in range(downs):
        nz = (nz - 1) // 2 + 1
    return nz


class ZValidConv(nn.Module):
    """The paths' final conv: kernel (kz, 3, 3), z VALID, y / x padded 1,
    no bias; its f32 weight cast to the input's dtype."""

    def __init__(self, cin, cout, kz):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kz, 3, 3))

    def forward(self, x):
        return F.conv3d(x, self.weight.to(x.dtype), None, 1, (0, 1, 1))


class DfMNeck(nn.Module):
    def __init__(self, in_channels=64, out_channels=256, num_frames=2, nz=12,
                 norm='bn', dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.num_frames = num_frames
        self.dtype = dtype
        c = in_channels
        kz = min(3, z_after_downs(nz))
        for tag, cin in (('mono', c), ('stereo', c * num_frames)):
            setattr(self, f'{tag}_res0', ResModule3D(cin, norm))
            setattr(self, f'{tag}_down0', ConvNorm(cin, 2 * c, 3, ndim=3,
                                                   norm=norm))
            setattr(self, f'{tag}_res1', ResModule3D(2 * c, norm))
            setattr(self, f'{tag}_down1', ConvNorm(2 * c, 4 * c, 3, ndim=3,
                                                   norm=norm))
            setattr(self, f'{tag}_res2', ResModule3D(4 * c, norm))
            setattr(self, f'{tag}_final_conv', ZValidConv(4 * c, out_channels,
                                                          kz))
            setattr(self, f'{tag}_final_bn', BatchNorm(out_channels))
        self.aggregate_layer = nn.Conv2d(2 * out_channels, 1, 1, bias=False)

    def _path(self, x, tag):
        """(B, C', Nz, Ny, Nx) -> (B, C_out, Ny, Nx)."""
        def part(name):
            return getattr(self, f'{tag}_{name}')

        x = part('res0')(x, self.dtype)
        for i in range(2):
            down = part(f'down{i}')
            x = x.to(self.dtype)
            x = F.conv3d(x, down.conv.weight.to(x.dtype), None, (2, 1, 1), 1)
            x = F.relu(down.bn(x))
            x = part(f'res{i + 1}')(x, self.dtype)
        x = F.relu(part('final_bn')(part('final_conv')(x.to(self.dtype))))
        return x.mean(2) if x.shape[2] > 1 else x[:, :, 0]

    def forward(self, x):
        """x (B, C * num_frames, Nz, Ny, Nx), the current frame's C
        channels first -> (B, C_out, Ny, Nx)."""
        c = self.in_channels
        if x.shape[1] != c * self.num_frames:
            raise ValueError(f'DfMNeck expects {c} x {self.num_frames} '
                             f'channels, got {x.shape[1]}')
        mono = self._path(x[:, :c], 'mono')
        stereo = self._path(x, 'stereo')
        w = torch.sigmoid(F.conv2d(torch.cat([mono, stereo], 1),
                                   self.aggregate_layer.weight.to(mono.dtype)))
        return w * mono + (1 - w) * stereo
