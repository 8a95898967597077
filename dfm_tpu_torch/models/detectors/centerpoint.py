"""CenterPoint: the LiDAR detector on SECOND's trunk with the CenterHead.

Port of `dfm_tpu/models/detectors/centerpoint.py:31-100` (reference
mmdet3d detectors/centerpoint.py: Voxelization -> VFE -> middle encoder
-> SECOND -> SECONDFPN -> CenterHead): the scatter-mean voxelization
(`voxelize_mean`, at most `max_points_per_voxel` points a voxel in
arrival order), two 3^3 ConvNorms with BatchNorm (`enc0`, `enc1`), the
z-collapse to BEV, `SECOND` (`backbone`), `SECONDFPN` (`neck`) and the
`CenterHead` (`bbox_head`, BatchNorm). The BEV channel of height z and
feature c is z * C + c, as JAX's `transpose(0, 2, 3, 1, 4).reshape(b, ny,
nx, nz * c)` orders it (z-major). `centerpoint_loss` and
`centerpoint_predict` are the head's loss and decode with the config's
`task_class_ids`.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..backbones.second import SECOND
from ..heads.center_head import (CenterHead, CenterHeadConfig,
                                 center_head_decode, center_head_loss)
from ..layers import ConvNorm
from ..necks.second_fpn import SECONDFPN
from .teacher import voxelize_mean

__all__ = ['CenterPoint', 'CenterPointConfig', 'centerpoint_loss',
           'centerpoint_predict']


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    """The fields and defaults of the JAX `CenterPointConfig`."""
    point_cloud_range: Tuple[float, ...] = (0.0, -40.0, -3.0, 70.4,
                                            40.0, 1.0)
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 0.4)
    max_points_per_voxel: int = 20
    encoder_channels: int = 64
    second_channels: Tuple[int, int] = (128, 256)
    second_layers: Tuple[int, int] = (5, 5)
    second_strides: Tuple[int, int] = (1, 2)
    fpn_channels: Tuple[int, int] = (256, 256)
    fpn_strides: Tuple[int, int] = (1, 2)
    head: CenterHeadConfig = dataclasses.field(
        default_factory=CenterHeadConfig)
    # global class ids per task (parallel to head.tasks)
    task_class_ids: Tuple[Tuple[int, ...], ...] = ((0,), (1, 2))

    @property
    def grid_size(self):
        pcr = self.point_cloud_range
        vx, vy, vz = self.voxel_size
        return (int(round((pcr[5] - pcr[2]) / vz)),
                int(round((pcr[4] - pcr[1]) / vy)),
                int(round((pcr[3] - pcr[0]) / vx)))


class CenterPoint(nn.Module):
    """The points carry (x, y, z), as every source of the repo gives them:
    their voxel means are the encoder's 3 input channels (JAX takes the
    channels of its input)."""

    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or CenterPointConfig()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.encoder_channels
        self.enc0 = ConvNorm(3, c, 3, ndim=3, norm='bn')
        self.enc1 = ConvNorm(c, c, 3, ndim=3, norm='bn')
        self.backbone = SECOND(cfg.grid_size[0] * c, cfg.second_channels,
                               cfg.second_layers, cfg.second_strides, 'bn')
        self.neck = SECONDFPN(cfg.second_channels, cfg.fpn_channels,
                              cfg.fpn_strides, 'bn')
        self.bbox_head = CenterHead(cfg.head, sum(cfg.fpn_channels), 'bn',
                                    dtype)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `centerpoint_loss` -> (total, terms);
        `generator` / `depth_pix_idx` (TrainStep's) are not read."""
        losses = centerpoint_loss(self(points, point_mask), gt, self.cfg)
        return sum(losses.values()), losses

    def voxelize(self, points, point_mask):
        """(B, P, C) points, (B, P) mask -> the encoder's input (B, C, Nz,
        Ny, Nx) in `dtype`: each voxel's mean."""
        cfg = self.cfg
        vox = torch.stack([voxelize_mean(
            p, m, cfg.point_cloud_range, cfg.voxel_size, cfg.grid_size,
            cfg.max_points_per_voxel)[0] for p, m in zip(points, point_mask)])
        return vox.to(self.dtype).permute(0, 4, 1, 2, 3)

    def bev(self, vox):
        """`voxelize`'s output -> the (B, Nz * C, Ny, Nx) BEV map,
        channel z * C + c."""
        x = self.enc1(self.enc0(vox))
        b, c, nz, ny, nx = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(b, nz * c, ny, nx)

    def forward(self, points, point_mask):
        """points (B, P, C), mask (B, P) -> the CenterHead's list (per
        task) of branch dicts, each (B, Ny, Nx, ch)."""
        with record_function('centerpoint.encoder'):
            bev = self.bev(self.voxelize(points, point_mask))
        with record_function('centerpoint.second'):
            x = self.neck(self.backbone(bev))
        with record_function('centerpoint.head'):
            return self.bbox_head(x)


def centerpoint_loss(task_outs, gt, cfg: CenterPointConfig):
    """The CenterHead's terms (`task{t}_loss_heatmap`, `task{t}_loss_bbox`),
    normalised over the global batch in a process group."""
    return center_head_loss(task_outs, gt, cfg.head, cfg.task_class_ids,
                            dist_norm=True)


def centerpoint_predict(task_outs, cfg: CenterPointConfig):
    """The detections of sample 0: 'boxes_3d', 'scores_3d', 'labels_3d'."""
    with record_function('centerpoint.predict'):
        return center_head_decode(task_outs, cfg.head, cfg.task_class_ids)
