"""Part-A2: the two-stage sparse-voxel LiDAR detector.

Port of `dfm_tpu/models/detectors/parta2.py:49-422` (reference mmdet3d
parta2.py with the SparseUNet middle encoder, PartA2RPNHead, the
part / segmentation supervision and the PartAggregationROIHead), the
JAX package's static shapes:

* hard voxelization into `voxel_capacity` voxels (`sparse_voxelize_mean`,
  5 points a voxel) on `sparse_shape`;
* `unet` (`SparseUNet`): two SubM convs at level 0 (`enc0`, `enc0b`),
  two strided levels (`down{l}`: a stride-2 SparseConv3d into V / 2 and
  V / 4 voxels, at least 8, then `enc{l + 1}`), and the decoder back up
  (`up{l}`: a SparseInverseConv3d's table into the finer set, concat with
  the level's features, `dec{l}`), every conv followed by `SparseBN`
  and ReLU (`bn*`), on `ops/sparse_conv.py`;
* `seg_cls` / `part_reg` (`Linear`) on the level-0 features;
* the bottom level made dense, collapsed over z (channel z * C + c),
  `bev_stem` (3x3 stride-2 conv) with flax's `nn.GroupNorm(16)`
  (`bev_gn`, eps 1e-6) and ReLU, the LIGA anchor head `rpn_head`, and its
  decode + NMS (score 0, IoU 0.8, 512 candidates) into `num_proposals`
  RoIs;
* RoI-aware pooling on a `roi_grid`^3 grid a RoI, flat (z, y, x):
  'voxel_center' samples each cell centre at the level-0 voxel holding
  it (`searchsorted` on the sorted keys: the features, the sigmoid
  segmentation score and part offsets), 'points' pools every level-0
  voxel centre falling in a cell (the segmentation features by max, the
  sigmoid part offsets and score by mean, empty cells 0; `index_add_`
  and `scatter_reduce('amax')` with a drop slot for the voxels in no
  cell);
* `roi_conv0` (32) and `roi_conv1` (64, stride 2), 3^3 convs with ReLU,
  flattened channels-last, `roi_fc0`, `roi_fc1` (256, ReLU), `roi_cls`,
  `roi_reg`.

`parta2_loss`: the anchor head's terms ('rpn_' + `anchor3d_head_loss`),
the voxels' binary cross entropy of foreground ('loss_seg', over the
active voxels) and of their part coordinates in their first box
('loss_part', over the foreground), and PointRCNN's RCNN terms;
`parta2_predict` refines the RoIs with NMS at 0.1.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.iou import _at_least
from ...ops.sparse_conv import (INVALID, flatten_key, inverse_table,
                                neighbor_table, sparse_conv_downsample,
                                sparse_to_dense, sparse_voxelize_mean,
                                subm_conv)
from ...parallel import dist as D
from ..heads.anchor3d_head import (LIGAAnchor3DHead,
                                   anchor3d_head_get_bboxes,
                                   anchor3d_head_loss)
from ..layers import Conv, GroupNorm, Linear
from .point_rcnn import points_in_boxes, rcnn_losses, refine_predict
from .teacher import SparseBN, SpKernel
from .voxelnet import VoxelNetConfig, anchors_of

__all__ = ['PartA2', 'PartA2Config', 'SparseUNet', 'parta2_loss',
           'parta2_predict', 'ROI_POOLS']

ROI_POOLS = ('voxel_center', 'points')


@dataclasses.dataclass(frozen=True)
class PartA2Config(VoxelNetConfig):
    """The fields and defaults of the JAX `PartA2Config`."""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.1)
    sparse_shape: Tuple[int, int, int] = (41, 1600, 1408)
    voxel_capacity: int = 16000
    unet_base: int = 16
    num_proposals: int = 64
    roi_grid: int = 7                 # reference RoIAwarePool3d: 14
    roi_pool: str = 'voxel_center'
    cls_pos_thr: float = 0.75
    cls_neg_thr: float = 0.25
    reg_pos_thr: float = 0.55
    max_num: int = 50


class SparseUNet(nn.Module):
    """The 3-level sparse U-Net: keys (B, V) sorted, feats (B, V, C_in),
    vmask (B, V) -> the level-0 features (B, V, base) and the bottom level
    (keys, mask, grid, features, neighbour tables)."""

    def __init__(self, cin, base=16, grid=(41, 1600, 1408),
                 dtype=torch.float32):
        super().__init__()
        self.grid = tuple(grid)
        self.dtype = dtype
        c = base
        for name, i, o in (('enc0', cin, c), ('enc0b', c, c),
                           ('down0', c, 2 * c), ('enc1', 2 * c, 2 * c),
                           ('down1', 2 * c, 4 * c), ('enc2', 4 * c, 4 * c),
                           ('up1', 4 * c, 2 * c), ('dec1', 4 * c, 2 * c),
                           ('up0', 2 * c, c), ('dec0', 2 * c, c)):
            setattr(self, name, SpKernel(27, i, o))
        for name, ch in (('bn0', c), ('bn0b', c), ('bn_down0', 2 * c),
                         ('bn_enc1', 2 * c), ('bn_down1', 4 * c),
                         ('bn_enc2', 4 * c), ('bn_up1', 2 * c),
                         ('bn_dec1', 2 * c), ('bn_up0', c), ('bn_dec0', c)):
            setattr(self, name, SparseBN(ch))

    def _conv(self, x, tables, name):
        w = getattr(self, name).kernel.to(self.dtype)
        return torch.stack([subm_conv(f.to(self.dtype), t, w)
                            for f, t in zip(x, tables)])

    def _bn_relu(self, x, vmask, name):
        return F.relu(getattr(self, name)(x, vmask))

    def forward(self, keys, feats, vmask):
        v = keys.shape[1]
        grid = self.grid
        nbr0 = [neighbor_table(k, m, grid) for k, m in zip(keys, vmask)]
        x0 = self._bn_relu(self._conv(feats, nbr0, 'enc0'), vmask, 'bn0')
        x0 = self._bn_relu(self._conv(x0, nbr0, 'enc0b'), vmask, 'bn0b')
        levels = [(keys, vmask, grid, x0, nbr0)]
        x, cur_keys, cur_mask, cur_grid = x0, keys, vmask, grid
        for li, cap in enumerate((max(v // 2, 8), max(v // 4, 8))):
            downs = [sparse_conv_downsample(k, m, cur_grid, (2, 2, 2),
                                            (1, 1, 1), cap)
                     for k, m in zip(cur_keys, cur_mask)]
            nk = torch.stack([d[0] for d in downs])
            nm = torch.stack([d[1] for d in downs])
            og = downs[0][2]
            x = self._bn_relu(self._conv(x, [d[3] for d in downs],
                                         f'down{li}'), nm, f'bn_down{li}')
            nbr = [neighbor_table(k, m, og) for k, m in zip(nk, nm)]
            x = self._bn_relu(self._conv(x, nbr, f'enc{li + 1}'), nm,
                              f'bn_enc{li + 1}')
            levels.append((nk, nm, og, x, nbr))
            cur_keys, cur_mask, cur_grid = nk, nm, og
        bottom = levels[-1]
        for li in (1, 0):
            fk, fm, fg, lat, fnbr = levels[li]
            inv = [inverse_table(a, b, c, d, fg, cur_grid, (2, 2, 2),
                                 (1, 1, 1))
                   for a, b, c, d in zip(fk, fm, cur_keys, cur_mask)]
            up = self._bn_relu(self._conv(x, inv, f'up{li}'), fm,
                               f'bn_up{li}')
            x = torch.cat([up, lat.to(up.dtype)], -1)
            x = self._bn_relu(self._conv(x, fnbr, f'dec{li}'), fm,
                              f'bn_dec{li}')
            cur_keys, cur_mask, cur_grid = fk, fm, fg
        return x, bottom


def _cell_centres(g, device):
    """The (g^3, 3) (x, y, z) unit offsets of a RoI's cells, flat (z, y,
    x)."""
    lin = (torch.arange(g, device=device, dtype=torch.float32) + 0.5) / \
        torch.tensor(float(g), device=device) - 0.5
    gz, gy, gx = torch.meshgrid(lin, lin, lin, indexing='ij')
    return torch.stack([gx, gy, gz], -1).reshape(-1, 3)


def roi_pool_voxel_center(rois, keys, vmask, feats, cfg):
    """Each RoI cell centre sampled at the level-0 voxel holding it: rois
    (B, R, 7), keys (B, V), vmask, feats (B, V, C) -> (B, R, g^3, C)."""
    g = cfg.roi_grid
    grid = cfg.sparse_shape
    dev = rois.device
    cell = _cell_centres(g, dev)
    pcr = torch.tensor(cfg.point_cloud_range, dtype=torch.float32,
                       device=dev)
    vs = torch.tensor(cfg.voxel_size, dtype=torch.float32, device=dev)
    out = []
    for rois_i, keys_i, vmask_i, feat_i in zip(rois, keys, vmask, feats):
        c = torch.cos(rois_i[:, 6])[:, None]
        s = torch.sin(rois_i[:, 6])[:, None]
        local = cell[None] * rois_i[:, None, 3:6]            # (R, G^3, 3)
        wx = local[..., 0] * c - local[..., 1] * s + rois_i[:, None, 0]
        wy = local[..., 0] * s + local[..., 1] * c + rois_i[:, None, 1]
        wz = local[..., 2] + rois_i[:, None, 2] + rois_i[:, None, 5] / 2
        iz = torch.floor((wz - pcr[2]) / vs[2]).long()
        iy = torch.floor((wy - pcr[1]) / vs[1]).long()
        ix = torch.floor((wx - pcr[0]) / vs[0]).long()
        ok = ((iz >= 0) & (iz < grid[0]) & (iy >= 0) & (iy < grid[1]) &
              (ix >= 0) & (ix < grid[2]))
        q = torch.where(ok, flatten_key(iz, iy, ix, grid),
                        torch.full_like(iz, INVALID))
        slot = torch.searchsorted(keys_i, q.reshape(-1)).clamp(
            0, keys_i.shape[0] - 1).reshape(q.shape)
        hit = ok & (keys_i[slot] == q) & vmask_i[slot]
        f = torch.index_select(feat_i, 0, slot.reshape(-1)).reshape(
            slot.shape + feat_i.shape[-1:])
        out.append(f * hit[..., None])
    return torch.stack(out)


def roi_pool_points(rois, vxyz, vmask, seg_f, part_f, g):
    """Every level-0 voxel centre pooled into its RoI cell: the (B, V, C)
    `seg_f` by max, the (B, V, 4) `part_f` by mean, empty cells 0 -> (B,
    R, g^3, C + 4)."""
    n_cells = g ** 3 + 1                        # + the drop slot
    out = []
    for rois_i, xyz_i, m_i, sf, pf in zip(rois, vxyz, vmask, seg_f, part_f):
        r = rois_i.shape[0]
        d = xyz_i[None] - rois_i[:, None, :3]                 # (R, V, 3)
        c = torch.cos(-rois_i[:, 6])[:, None]
        s = torch.sin(-rois_i[:, 6])[:, None]
        lx = d[..., 0] * c - d[..., 1] * s
        ly = d[..., 0] * s + d[..., 1] * c
        lz = xyz_i[None, :, 2] - (rois_i[:, None, 2] + rois_i[:, None, 5] / 2)
        dims = _at_least(rois_i[:, 3:6], 1e-4)
        ix = torch.floor((lx / dims[:, None, 0] + 0.5) * g).long()
        iy = torch.floor((ly / dims[:, None, 1] + 0.5) * g).long()
        iz = torch.floor((lz / dims[:, None, 2] + 0.5) * g).long()
        ok = (m_i[None] & (ix >= 0) & (ix < g) & (iy >= 0) & (iy < g) &
              (iz >= 0) & (iz < g))
        cell = torch.where(ok, (iz * g + iy) * g + ix,
                           torch.full_like(ix, g ** 3))
        flat = (cell + torch.arange(r, device=cell.device)[:, None] *
                n_cells).reshape(-1)                           # (R * V,)
        okf = ok.to(pf.dtype)
        cnt = torch.zeros(r * n_cells, dtype=pf.dtype,
                          device=pf.device).index_add_(0, flat,
                                                       okf.reshape(-1))
        avg = torch.zeros((r * n_cells, pf.shape[-1]), dtype=pf.dtype,
                          device=pf.device).index_add_(
                              0, flat, (pf[None] * okf[..., None]).reshape(
                                  -1, pf.shape[-1]))
        avg = avg / torch.clamp(cnt[:, None], min=1.0)
        vals = torch.where(ok[..., None], sf[None],
                           torch.full((), -1e30, dtype=sf.dtype,
                                      device=sf.device))
        mx = torch.full((r * n_cells, sf.shape[-1]), -torch.inf,
                        dtype=sf.dtype, device=sf.device).scatter_reduce(
            0, flat[:, None].expand(-1, sf.shape[-1]),
            vals.reshape(-1, sf.shape[-1]), 'amax', include_self=False)
        mx = torch.where(cnt[:, None] > 0, mx, torch.zeros_like(mx))
        keep = torch.arange(r * n_cells, device=mx.device) % n_cells != \
            g ** 3
        out.append(torch.cat([mx[keep], avg[keep]], -1).reshape(
            r, g ** 3, -1))
    return torch.stack(out)


class PartA2(nn.Module):
    """The points carry (x, y, z), as every source of the repo gives them:
    their voxel means are the U-Net's 3 input channels."""

    def __init__(self, cfg=None, dtype=torch.float32):
        super().__init__()
        cfg = cfg or PartA2Config()
        if cfg.roi_pool not in ROI_POOLS:
            raise ValueError(f'PartA2 roi_pool {cfg.roi_pool!r}: one of '
                             f'{ROI_POOLS}')
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.unet_base
        self.unet = SparseUNet(3, c, cfg.sparse_shape, dtype)
        self.seg_cls = Linear(c, 1)
        self.part_reg = Linear(c, 3)
        bz = self.bottom_grid()[0]
        self.bev_stem = Conv(bz * 4 * c, cfg.bev_channels, 3, stride=2)
        self.bev_gn = GroupNorm(cfg.bev_channels, groups=16, eps=1e-6)
        self.rpn_head = LIGAAnchor3DHead(
            cfg.num_classes, cfg.bev_channels, cfg.bev_channels,
            len(cfg.anchor_sizes) * len(cfg.anchor_rotations), norm='gn')
        g = cfg.roi_grid
        pooled = c + 4
        self.roi_conv0 = Conv(pooled, 32, 3, ndim=3)
        self.roi_conv1 = Conv(32, 64, 3, stride=2, ndim=3)
        self.roi_fc0 = Linear(((g - 1) // 2 + 1) ** 3 * 64, 256)
        self.roi_fc1 = Linear(256, 256)
        self.roi_cls = Linear(256, 1)
        self.roi_reg = Linear(256, 7)

    def bottom_grid(self):
        g = self.cfg.sparse_shape
        for _ in range(2):
            g = tuple((n + 2 - 3) // 2 + 1 for n in g)
        return g

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `parta2_loss` -> (total, terms)."""
        return parta2_loss(self(points, point_mask), gt, self.cfg)

    def voxelize(self, points, point_mask):
        """(B, P, C) points -> keys (B, V), mean features (B, V, C), vmask."""
        cfg = self.cfg
        out = [sparse_voxelize_mean(p, m, cfg.point_cloud_range,
                                    cfg.voxel_size, cfg.sparse_shape,
                                    cfg.voxel_capacity)
               for p, m in zip(points, point_mask)]
        return tuple(torch.stack(x) for x in zip(*out))

    def rpn(self, bottom):
        """The bottom level -> the anchor head's (cls, reg, dir) maps
        (B, Ny, Nx, ...)."""
        bk, bm, bg, bx, _ = bottom
        dense = torch.stack([sparse_to_dense(k, m, f.float(), bg)
                             for k, m, f in zip(bk, bm, bx)])
        b, dz, dy, dx, c = dense.shape
        bev = dense.permute(0, 1, 4, 2, 3).reshape(b, dz * c, dy, dx)
        bev = F.relu(self.bev_gn(self.bev_stem(bev.to(self.dtype))))
        return self.rpn_head(bev)

    def proposals(self, cls_score, bbox_pred, dir_pred):
        """The anchor head's decode + NMS (score 0, IoU 0.8, 512
        candidates) -> `num_proposals` padded RoIs ('boxes3d', 'scores',
        'labels', 'mask')."""
        cfg = self.cfg
        _, flat = anchors_of(cfg, cls_score.shape[1:3], cls_score.device)
        return anchor3d_head_get_bboxes(
            (cls_score.detach(), bbox_pred.detach(), dir_pred.detach()),
            flat, num_classes=cfg.num_classes, dir_offset=cfg.dir_offset,
            score_thr=0.0, nms_thr=0.8, nms_pre=512,
            max_num=cfg.num_proposals)

    def roi_pool(self, rois, keys, vfeat, vmask, seg_feat, seg_logit,
                 part_reg):
        """The config's RoI-aware pooling -> (B, R, g^3, base + 4)."""
        cfg = self.cfg
        if cfg.roi_pool == 'points':
            return roi_pool_points(
                rois, vfeat[..., :3], vmask, seg_feat.float(),
                torch.cat([torch.sigmoid(part_reg.float()),
                           torch.sigmoid(seg_logit.float())[..., None]], -1),
                cfg.roi_grid)
        return roi_pool_voxel_center(
            rois, keys, vmask, torch.cat(
                [seg_feat.float(), torch.sigmoid(seg_logit.float())[..., None],
                 torch.sigmoid(part_reg.float())], -1), cfg)

    def roi_head(self, pooled):
        """(B, R, g^3, C) pooled RoIs -> rcnn_cls (B, R), rcnn_reg (B, R,
        7)."""
        b, r = pooled.shape[:2]
        g = self.cfg.roi_grid
        x = pooled.reshape(b * r, g, g, g, -1).permute(0, 4, 1, 2, 3)
        x = F.relu(self.roi_conv0(x.to(self.dtype)))
        x = F.relu(self.roi_conv1(x))
        x = x.permute(0, 2, 3, 4, 1).reshape(b * r, -1)
        x = F.relu(self.roi_fc1(F.relu(self.roi_fc0(x))))
        return self.roi_cls(x).reshape(b, r), self.roi_reg(x).reshape(b, r, 7)

    def forward(self, points, point_mask):
        """points (B, P, 3+), mask (B, P) -> dict: the voxels' 'keys',
        'vmask', 'voxel_xyz', 'seg_logit', 'part_reg'; the RPN's
        'cls_score', 'bbox_pred', 'dir_pred'; 'proposals' (B, R, 7),
        'prop_scores', 'prop_labels', 'prop_mask'; 'rcnn_cls' (B, R),
        'rcnn_reg' (B, R, 7)."""
        with record_function('parta2.unet'):
            keys, vfeat, vmask = self.voxelize(points, point_mask)
            seg_feat, bottom = self.unet(keys, vfeat, vmask)
            seg_logit = self.seg_cls(seg_feat)[..., 0]
            part_reg = self.part_reg(seg_feat)
        with record_function('parta2.rpn'):
            cls_score, bbox_pred, dir_pred = self.rpn(bottom)
            props = self.proposals(cls_score, bbox_pred, dir_pred)
        with record_function('parta2.roi_pool'):
            pooled = self.roi_pool(props['boxes3d'], keys, vfeat, vmask,
                                   seg_feat, seg_logit, part_reg)
        with record_function('parta2.roi_head'):
            rcnn_cls, rcnn_reg = self.roi_head(pooled)
        return dict(keys=keys, vmask=vmask, voxel_xyz=vfeat[..., :3],
                    seg_logit=seg_logit, part_reg=part_reg,
                    cls_score=cls_score, bbox_pred=bbox_pred,
                    dir_pred=dir_pred, proposals=props['boxes3d'],
                    prop_scores=props['scores'], prop_labels=props['labels'],
                    prop_mask=props['mask'], rcnn_cls=rcnn_cls,
                    rcnn_reg=rcnn_reg)


def part_targets(xyz, gt_boxes, gt_mask):
    """One sample's level-0 voxel targets: foreground (V,) and the part
    coordinates (V, 3) in [0, 1] of each voxel in its first box."""
    inside = points_in_boxes(xyz, gt_boxes) & gt_mask[None].bool()
    fg = inside.any(-1)
    sel = gt_boxes[torch.argmax(inside.to(torch.int32), -1)]
    lx = xyz[:, 0] - sel[:, 0]
    ly = xyz[:, 1] - sel[:, 1]
    c, s = torch.cos(-sel[:, 6]), torch.sin(-sel[:, 6])
    px = (lx * c - ly * s) / _at_least(sel[:, 3], 1e-3) + 0.5
    py = (lx * s + ly * c) / _at_least(sel[:, 4], 1e-3) + 0.5
    pz = (xyz[:, 2] - sel[:, 2]) / _at_least(sel[:, 5], 1e-3)
    return fg, torch.stack([px, py, pz], -1).clamp(0.0, 1.0)


def _bce(x, t):
    return _at_least(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def parta2_loss(outputs, gt, cfg: PartA2Config):
    """The RPN's anchor terms (prefix 'rpn_'), 'loss_seg', 'loss_part' and
    the RCNN terms -> (total, terms); every count over the global batch
    in a process group where `cfg.dist_norm`."""
    per_class, _ = anchors_of(cfg, outputs['cls_score'].shape[1:3],
                              outputs['cls_score'].device)
    losses = anchor3d_head_loss(
        (outputs['cls_score'], outputs['bbox_pred'], outputs['dir_pred']),
        per_class, gt['gt_boxes'], gt['gt_labels'], gt['gt_mask'],
        list(cfg.assigner_cfgs), num_classes=cfg.num_classes,
        dir_offset=cfg.dir_offset,
        normalizer_clamp_value=cfg.normalizer_clamp_value,
        dist_norm=cfg.dist_norm)
    losses = {f'rpn_{k}': v for k, v in losses.items()}
    gtb = gt['gt_boxes'].float()
    fg, part_t = (torch.stack(x) for x in zip(*[
        part_targets(x, b, m) for x, b, m in zip(
            outputs['voxel_xyz'].float(), gtb, gt['gt_mask'])]))
    vmask = outputs['vmask']
    fg_f = (fg & vmask).float()
    w = vmask.float()
    gsum = D.global_sum if cfg.dist_norm else (lambda x: x)
    losses['loss_seg'] = (_bce(outputs['seg_logit'].float(), fg_f) *
                          w).sum() / gsum(w.sum()).clamp(min=1.0)
    losses['loss_part'] = (_bce(outputs['part_reg'].float(), part_t).sum(-1)
                           * fg_f).sum() / gsum(fg_f.sum()).clamp(min=1.0)
    losses.update(rcnn_losses(outputs, gt, cfg, cfg.dist_norm))
    return sum(losses.values()), losses


def parta2_predict(outputs, cfg: PartA2Config):
    """Refined boxes + class-agnostic rotated NMS at 0.1 -> padded
    'boxes3d', 'scores', 'labels', 'mask'."""
    with record_function('parta2.predict'):
        return refine_predict(outputs, cfg, 0.1)
