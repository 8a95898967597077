"""DynamicVoxelNet: VoxelNet with dynamic voxelization.

Port of `dfm_tpu/models/detectors/dynamic_voxelnet.py` (reference
mmdet3d dynamic_voxelnet.py): every point of a voxel goes into its mean
(no cap a voxel; `VoxelNetConfig.max_points_per_voxel` keeps its default
None); the trunk is `VoxelNet`'s, under the module name `voxelnet` as in
the JAX tree. Loss and decode are VoxelNet's.
"""

import dataclasses

import torch
import torch.nn as nn

from .voxelnet import VoxelNet, VoxelNetConfig, voxelnet_loss, \
    voxelnet_predict

__all__ = ['DynamicVoxelNet', 'DynamicVoxelNetConfig',
           'dynamic_voxelnet_loss', 'dynamic_voxelnet_predict']


@dataclasses.dataclass(frozen=True)
class DynamicVoxelNetConfig(VoxelNetConfig):
    pass


class DynamicVoxelNet(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg or DynamicVoxelNetConfig()
        self.voxelnet = VoxelNet(self.cfg, dtype)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        return voxelnet_loss(self(points, point_mask), gt, self.cfg)

    def forward(self, points, point_mask):
        return self.voxelnet(points, point_mask)


dynamic_voxelnet_loss = voxelnet_loss
dynamic_voxelnet_predict = voxelnet_predict
