"""SA-SSD: SECOND with the structure-aware point-wise auxiliary branch.

Port of `dfm_tpu/models/detectors/sassd.py:36-171` (reference
mmdet3d detectors/sassd.py:14-136 and SparseEncoderSASSD,
sparse_encoder.py:495-690): `LidarTeacher` (`encoder`) and the LIGA anchor
head with GroupNorm towers (`bbox_head`), as VoxelNet; then the auxiliary
branch, built and run in both modes as JAX does (its parameters are in
both state dicts; `sassd_predict` ignores it): one trilinear sample of
the (B, Nz', Ny, Nx, C) volume at every point (the voxel grid's x, y and
the pooled z spacing, cell centres at +0.5; the corner index clipped to
[0, n - 2], to [0, max(Nz' - 2, 0)] in z with the upper z corner clamped
to Nz' - 1, so a one-slice volume reads its one slice twice; the weights
clipped to [0, 1]), `point_fc` (64, ReLU), `point_cls` (1) and
`point_reg` (3), each a biased `Linear`.

`sassd_loss` is `voxelnet_loss` plus the two auxiliary terms
(SparseEncoderSASSD.aux_loss, sparse_encoder.py:636-681): a point is
foreground when it lies inside a valid gt box (BEV rotated test, z from
the bottom to the top face, edges included) and is itself valid; its
target is its offset from the nearest such box's gravity centre (ties to
the lower index). `loss_aux_cls` is the sigmoid focal loss (alpha 0.25,
gamma 2) over the valid points over the foreground count (at least 1),
`loss_aux_reg` the smooth L1 (beta 1/9) of the offsets of foreground
points over the same count; both counts over the global batch in a
process group where `cfg.dist_norm`.
"""

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import points_in_rotated_boxes_bev
from ...core.iou import _at_least
from ...parallel import dist as D
from ..heads.anchor3d_head import LIGAAnchor3DHead
from ..layers import Linear
from .teacher import LidarTeacher
from .voxelnet import VoxelNetConfig, voxelnet_loss, voxelnet_predict

__all__ = ['SASSDConfig', 'SASSD', 'sassd_loss', 'sassd_predict',
           'trilinear_points']


@dataclasses.dataclass(frozen=True)
class SASSDConfig(VoxelNetConfig):
    """SECOND's settings + the auxiliary branch's weights."""
    aux_cls_weight: float = 1.0
    aux_reg_weight: float = 1.0


def trilinear_points(vol, pos):
    """vol (B, Nz, Ny, Nx, C) float32, pos (B, P, 3) fractional (x, y, z)
    voxel coordinates -> (B, P, C): JAX's `tri`, its eight corners summed
    in its order (z, then y, then x)."""
    nz, ny, nx = vol.shape[1:4]
    fx, fy, fz = pos.unbind(-1)
    x0 = fx.floor().long().clamp(0, nx - 2)
    y0 = fy.floor().long().clamp(0, ny - 2)
    z0 = fz.floor().long().clamp(0, max(nz - 2, 0))
    wx = (fx - x0).clamp(0, 1)[..., None]
    wy = (fy - y0).clamp(0, 1)[..., None]
    wz = (fz - z0).clamp(0, 1)[..., None]
    bidx = torch.arange(vol.shape[0], device=vol.device)[:, None]
    out = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((wz if dz else 1 - wz) * (wy if dy else 1 - wy) *
                     (wx if dx else 1 - wx))
                f = vol[bidx, torch.clamp(z0 + dz, max=nz - 1), y0 + dy,
                        x0 + dx]
                out = out + w * f
    return out


class SASSD(nn.Module):
    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or SASSDConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = LidarTeacher(
            cfg.point_cloud_range, cfg.voxel_size,
            volume_channels=cfg.cv_channels, bev_channels=cfg.bev_channels,
            max_points=cfg.max_points_per_voxel, dtype=dtype)
        self.bbox_head = LIGAAnchor3DHead(
            cfg.num_classes, cfg.bev_channels, cfg.bev_channels,
            len(cfg.anchor_sizes) * len(cfg.anchor_rotations), norm='gn')
        self.point_fc = Linear(cfg.cv_channels, 64)
        self.point_cls = Linear(64, 1)
        self.point_reg = Linear(64, 3)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `sassd_loss` (the points from the inputs)
        -> (total, terms)."""
        return sassd_loss(self(points, point_mask),
                          dict(gt, points=points, point_mask=point_mask),
                          self.cfg)

    def point_positions(self, points, nz):
        """(B, P, 3+) points -> fractional voxel coordinates of a volume of
        `nz` slices (its z spacing the range over nz)."""
        cfg = self.cfg
        pcr = np.asarray(cfg.point_cloud_range, np.float32)
        vsz = np.asarray(cfg.voxel_size, np.float32)
        zs = (pcr[5] - pcr[2]) / nz
        dev = points.device
        return (points[..., :3].float() -
                torch.as_tensor(pcr[:3], device=dev)) / torch.as_tensor(
                    np.array([vsz[0], vsz[1], zs], np.float32),
                    device=dev) - 0.5

    def aux(self, points, vol):
        """The auxiliary branch: (B, P, 3+) points and the (B, Nz', Ny, Nx,
        C) volume -> 'point_cls' (B, P), 'point_reg' (B, P, 3), float32."""
        pw = trilinear_points(vol.float(), self.point_positions(
            points, vol.shape[1])).to(self.dtype)
        pw = F.relu(self.point_fc(pw))
        return dict(point_cls=self.point_cls(pw)[..., 0].float(),
                    point_reg=self.point_reg(pw).float())

    def forward(self, points, point_mask):
        """points (B, P, 3+), mask (B, P) -> VoxelNet's outputs and
        'point_cls' (B, P), 'point_reg' (B, P, 3) in float32."""
        with record_function('sassd.encoder'):
            vol, bev = self.encoder(points[..., :3].float(), point_mask)
        with record_function('sassd.bbox_head'):
            cls, reg, dirs = self.bbox_head(bev.permute(0, 3, 1, 2))
        with record_function('sassd.aux'):
            aux = self.aux(points, vol)
        return dict(cls_score=cls, bbox_pred=reg, dir_pred=dirs,
                    volume_feat=vol, bev_feat=bev, **aux)


def _smooth_l1(x, beta):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def aux_targets(points, point_mask, gt_boxes, gt_mask):
    """One sample's foreground labels (P,) and centre offsets (P, 3)."""
    p = points[:, :3].float()
    gt = gt_boxes.float()
    bev = points_in_rotated_boxes_bev(p[:, :2], gt)
    inz = (p[:, 2:3] >= gt[None, :, 2]) & \
        (p[:, 2:3] <= gt[None, :, 2] + gt[None, :, 5])
    inside = bev & inz & gt_mask[None, :].bool()           # (P, G)
    lbl = inside.any(-1) & point_mask.bool()
    ctr = torch.cat([gt[:, :2], gt[:, 2:3] + gt[:, 5:6] / 2], -1)
    d2 = ((p[:, None] - ctr[None]) ** 2).sum(-1)
    assign = torch.argmin(torch.where(inside, d2, torch.full_like(
        d2, torch.inf)), -1)
    off = torch.where(lbl[:, None], p - ctr[assign], torch.zeros_like(p))
    return lbl, off


def sassd_loss(outputs, gt, cfg: SASSDConfig):
    """`voxelnet_loss` and, where the outputs have 'point_cls', the two
    auxiliary terms on gt's 'points' / 'point_mask' -> (total, terms)."""
    total, losses = voxelnet_loss(outputs, gt, cfg)
    if 'point_cls' not in outputs:
        return total, losses
    pts = gt['points']
    pmask = gt.get('point_mask')
    if pmask is None:
        pmask = torch.ones(pts.shape[:2], dtype=torch.bool,
                           device=pts.device)
    lbl, off_t = (torch.stack(x) for x in zip(*[
        aux_targets(p, m, b, g) for p, m, b, g in zip(
            pts, pmask, gt['gt_boxes'], gt['gt_mask'])]))
    pos = lbl.float()
    valid = pmask.float()
    npos = pos.sum()
    npos = (D.global_sum(npos) if cfg.dist_norm else npos).clamp(min=1.0)
    logits = outputs['point_cls']
    p = torch.sigmoid(logits)
    ce = _at_least(logits, 0.0) - logits * pos + \
        torch.log1p(torch.exp(-logits.abs()))
    pt = p * pos + (1 - p) * (1 - pos)
    focal = (0.25 * pos + 0.75 * (1 - pos)) * (1 - pt) ** 2 * ce
    losses['loss_aux_cls'] = (focal * valid).sum() / npos * \
        cfg.aux_cls_weight
    reg = _smooth_l1(outputs['point_reg'] - off_t, beta=1 / 9.)
    losses['loss_aux_reg'] = (reg.sum(-1) * pos).sum() / npos * \
        cfg.aux_reg_weight
    return total + losses['loss_aux_cls'] + losses['loss_aux_reg'], losses


def sassd_predict(outputs, cfg: SASSDConfig):
    """The SECOND baseline's decode (reference sassd.py:105-116)."""
    return voxelnet_predict(outputs, cfg)
