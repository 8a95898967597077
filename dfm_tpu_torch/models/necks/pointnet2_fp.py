"""PointNet++'s feature-propagation neck.

Port of `dfm_tpu/models/necks/pointnet2_fp.py:25-46` (reference
mmdet3d pointnet2_fp_neck.py:10-80): coarse to fine down the SA
hierarchy, each step `FPModule` (3-NN interpolation of the coarser
level's features onto the finer level's points, its skip features, an
MLP); keys `fp{i}`, the coarsest step first. Input: the backbone's
dict(sa_xyz, sa_features) (level 0 the raw points); output
dict(fp_xyz, fp_features) at level 0.
"""

import torch
import torch.nn as nn

from ..backbones.pointnet2 import FPModule

__all__ = ['PointNetFPNeck']


class PointNetFPNeck(nn.Module):
    """`sa_channels`: each SA level's feature channels, level 0 first (0
    for points without features)."""

    def __init__(self, sa_channels,
                 fp_channels=((512, 512), (512, 512), (256, 256),
                              (128, 128)), dtype=torch.float32):
        super().__init__()
        assert len(fp_channels) == len(sa_channels) - 1
        src = sa_channels[-1]
        for i, mlp in enumerate(fp_channels):
            lvl = len(sa_channels) - 2 - i
            setattr(self, f'fp{i}', FPModule(tuple(mlp), sa_channels[lvl] + src,
                                             dtype))
            src = mlp[-1]
        self.num_steps = len(fp_channels)

    def forward(self, feat_dict):
        sa_xyz, sa_feats = feat_dict['sa_xyz'], feat_dict['sa_features']
        x, xyz = sa_feats[-1], sa_xyz[-1]
        for i in range(self.num_steps):
            lvl = len(sa_xyz) - 2 - i
            x = getattr(self, f'fp{i}')(sa_xyz[lvl], sa_feats[lvl], xyz, x)
            xyz = sa_xyz[lvl]
        return dict(fp_xyz=xyz, fp_features=x)
