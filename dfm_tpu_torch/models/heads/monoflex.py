"""MonoFlex monocular 3D head, its targets, loss and decode.

Port of `dfm_tpu/models/heads/monoflex.py` (the reference's inherited
`MonoFlexHead` and MonoFlex coder): ten branches over the neck's map, each
a 3x3 conv of `feat_channels` with a bias, GroupNorm 32, ReLU and a biased
1x1 conv: cls (the clamped sigmoid heatmap), offset, bbox2d, kpts (10
keypoints), dims, ori_cls / ori_off (4-bin multibin), depth, depth_unc,
kpt_unc. Outputs are channels last, (B, h, w, ch) float32 views of the
NCHW maps, as in the JAX package. Keys: bbox_head.{name}_{conv,gn,out}
(JAX `{name}_conv`, `GroupNorm_<i>` in branch order, `{name}_out`).

Edge fusion (`use_edge_fusion`, `EdgeFusion` as `edge_cls` / `edge_offset`):
the branch features along the map's boundary (`edge_path`: left column
down, bottom row right, right column up, top row left; each corner pixel
listed twice), a 1D conv of 3 with a bias, BatchNorm, ReLU and a 1D conv
of 1, added back at the path's pixels onto the cls logits and the offset
prediction. The add accumulates both contributions of a corner
(`index_add`), as JAX's `.at[].add` does. Keys: edge_{cls,offset}.
{edge_conv, edge_bn, edge_out}.

The loss: the Gaussian focal heatmap loss, L1 of offset, keypoints,
log-dimension residuals, the multibin orientation loss and the direct
depth with its log-variance at the gt cells, divided by the valid gts (the
global batch's in a process group). The decode: 3x3 local maxima, the top
`topk` (ties to the lower index), the direct depth and three keypoint
depths fused by an inverse-uncertainty softmax, multibin yaw.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.transforms import points_img2cam
from ...parallel import dist as D
from ..detectors.smoke import gather_cells, gaussian_heatmap, heatmap_peaks
from ..layers import BatchNorm, Conv, GroupNorm
from .center_head import gaussian_focal_loss, gaussian_radius
from .fcos_mono3d import pad44

__all__ = ['MonoFlexConfig', 'MonoFlexHead', 'EdgeFusion', 'edge_path',
           'multibin_loss', 'monoflex_targets', 'monoflex_loss',
           'monoflex_decode', 'BRANCHES']

BIN_CENTERS = (0.0, math.pi / 2, math.pi, -math.pi / 2)
BIN_MARGIN = math.pi / 6
# the branches in JAX's order of creation (their GroupNorm_<i> index)
BRANCHES = ('cls', 'offset', 'bbox2d', 'kpts', 'dims', 'ori_cls', 'ori_off',
            'depth', 'depth_unc', 'kpt_unc')


@dataclasses.dataclass(frozen=True)
class MonoFlexConfig:
    num_classes: int = 3
    feat_channels: int = 256
    downsample: int = 4
    base_dims: Tuple[Tuple[float, float, float], ...] = (
        (3.88, 1.53, 1.63), (0.84, 1.76, 0.66), (1.76, 1.73, 0.60))
    max_objs: int = 32
    topk: int = 100
    score_thr: float = 0.25
    use_edge_fusion: bool = False

    def branch_channels(self):
        return dict(cls=self.num_classes, offset=2, bbox2d=4, kpts=20,
                    dims=3, ori_cls=4, ori_off=8, depth=1, depth_unc=1,
                    kpt_unc=3)


def edge_path(ny, nx):
    """The boundary path (P, 2) int64 (x, y), P = 2 (ny + nx): left column
    top -> bottom, bottom row left -> right, right column bottom -> top, top
    row right -> left (the reference's get_edge_indices order)."""
    ys = np.arange(ny, dtype=np.int64)
    xs = np.arange(nx, dtype=np.int64)
    left = np.stack([np.zeros(ny, np.int64), ys], 1)
    bottom = np.stack([xs, np.full(nx, ny - 1, np.int64)], 1)
    right = np.stack([np.full(ny, nx - 1, np.int64), ys[::-1]], 1)
    top = np.stack([xs[::-1], np.zeros(nx, np.int64)], 1)
    return np.concatenate([left, bottom, right, top])


class EdgeFusion(nn.Module):
    def __init__(self, out_channels, feat_channels):
        super().__init__()
        self.edge_conv = Conv(feat_channels, feat_channels, 3, ndim=1,
                              bias=True)
        self.edge_bn = BatchNorm(feat_channels)
        self.edge_out = Conv(feat_channels, out_channels, 1, ndim=1,
                             bias=True)

    def forward(self, branch_feat, out):
        """`branch_feat` (B, C, h, w), `out` (B, ch, h, w) float32 -> `out`
        with the boundary sequence's prediction added at its pixels."""
        ny, nx = branch_feat.shape[2:]
        path = torch.from_numpy(edge_path(ny, nx)).to(out.device)
        idx = path[:, 1] * nx + path[:, 0]
        e = branch_feat.flatten(2)[:, :, idx]                  # (B, C, P)
        e = F.relu(self.edge_bn(self.edge_conv(e)))
        e = self.edge_out(e).to(out.dtype)
        return out.flatten(2).index_add(2, idx, e).view_as(out)


class MonoFlexHead(nn.Module):
    def __init__(self, cfg, cin=64):
        super().__init__()
        self.cfg = cfg
        f = cfg.feat_channels
        for name, cout in cfg.branch_channels().items():
            setattr(self, f'{name}_conv', Conv(cin, f, 3, bias=True))
            setattr(self, f'{name}_gn', GroupNorm(f))
            setattr(self, f'{name}_out', Conv(f, cout, 1, bias=True))
        if cfg.use_edge_fusion:
            self.edge_cls = EdgeFusion(cfg.num_classes, f)
            self.edge_offset = EdgeFusion(2, f)

    def _feat(self, name, feat):
        return F.relu(getattr(self, f'{name}_gn')(
            getattr(self, f'{name}_conv')(feat)))

    def forward(self, feat):
        """(B, C, h, w) -> dict of the ten (B, h, w, ch) float32 outputs,
        'heatmap' for cls."""
        outs = {}
        for name in BRANCHES:
            x = self._feat(name, feat)
            out = getattr(self, f'{name}_out')(x).float()
            if self.cfg.use_edge_fusion and name in ('cls', 'offset'):
                out = getattr(self, f'edge_{name}')(x, out)
            if name == 'cls':
                name, out = 'heatmap', torch.sigmoid(out).clamp(1e-4,
                                                                1 - 1e-4)
            outs[name] = out.permute(0, 2, 3, 1)
        return outs


def _decode_direct_depth(x):
    """1 / sigmoid(x) - 1 (the coder's decode_depth)."""
    return 1.0 / torch.sigmoid(x) - 1.0


def _wrap(a):
    """a into [-pi, pi) (JAX's (a + pi) % (2 pi) - pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def multibin_loss(ori_cls, ori_off, gt_alpha, weights, avg_factor):
    """The 4-bin multibin orientation loss: BCE over bin membership (within
    pi / 2 + pi / 6 of a bin centre) + L1 of the member bins' (sin, cos);
    (B, K, 4), (B, K, 8), (B, K), (B, K) weights."""
    centers = torch.tensor(BIN_CENTERS, device=ori_cls.device)
    diff = _wrap(gt_alpha[..., None] - centers)
    cls_tgt = (torch.abs(diff) < (math.pi / 2 + BIN_MARGIN)).float()
    cls_loss = -(cls_tgt * F.logsigmoid(ori_cls) +
                 (1 - cls_tgt) * F.logsigmoid(-ori_cls))
    cls_loss = (cls_loss.mean(-1) * weights).sum() / avg_factor
    off = ori_off.reshape(ori_off.shape[:-1] + (4, 2))
    reg = torch.abs(off[..., 0] - torch.sin(diff)) + \
        torch.abs(off[..., 1] - torch.cos(diff))
    reg = (reg * cls_tgt).sum(-1) / cls_tgt.sum(-1).clamp(min=1.0)
    return cls_loss + (reg * weights).sum() / avg_factor


def monoflex_targets(gt_boxes_cam, centers2d, kpts2d, gt_labels, gt_mask,
                     featmap_size, cfg):
    """A batch's (B, G, ...) targets: dict(heatmap (B, h, w, classes), inds
    (B, G) flat cells, mask, offset (B, G, 2), kpts (B, G, 20))."""
    ny, nx = featmap_size
    c = centers2d / cfg.downsample
    xi = torch.floor(c[..., 0]).clamp(0, nx - 1).long()
    yi = torch.floor(c[..., 1]).clamp(0, ny - 1).long()
    inside = (c[..., 0] >= 0) & (c[..., 0] < nx) & (c[..., 1] >= 0) & \
        (c[..., 1] < ny)
    valid = gt_mask.bool() & inside
    wl = torch.stack([gt_boxes_cam[..., 4], gt_boxes_cam[..., 3]], -1) * 8
    radius = gaussian_radius(wl, 0.7).clamp(min=2.0)
    heatmap = gaussian_heatmap(xi.float(), yi.float(), radius, valid,
                               gt_labels, cfg.num_classes, ny, nx)
    cell = torch.stack([xi, yi], -1).float()
    kpt = kpts2d / cfg.downsample - cell[..., None, :]
    return dict(heatmap=heatmap, inds=yi * nx + xi, mask=valid,
                offset=c - cell, kpts=kpt.reshape(kpt.shape[:-2] + (20,)))


def monoflex_loss(outs, gt, cfg, cam2img=None):
    """The loss terms of the head's outputs and a gt dict ('gt_boxes_cam',
    'centers2d', 'kpts2d', 'gt_labels', 'gt_mask', 'gt_alphas'); `cam2img`
    is not read (JAX's takes the batch's first)."""
    ny, nx = outs['heatmap'].shape[1:3]
    boxes = gt['gt_boxes_cam'].float()
    tg = monoflex_targets(boxes, gt['centers2d'].float(),
                          gt['kpts2d'].float(), gt['gt_labels'],
                          gt['gt_mask'], (ny, nx), cfg)
    losses = dict(loss_heatmap=gaussian_focal_loss(
        outs['heatmap'], tg['heatmap'], dist_norm=True))
    w = tg['mask'].float()
    num = D.global_sum(w.sum()).clamp(min=1.0)

    def at(key):
        return gather_cells(outs[key], tg['inds'])

    losses['loss_offset'] = (torch.abs(at('offset') - tg['offset']).sum(-1)
                             * w).sum() / num
    losses['loss_kpts'] = (torch.abs(at('kpts') - tg['kpts']).mean(-1)
                           * w).sum() / num
    labels = gt['gt_labels'].long().clamp(0, cfg.num_classes - 1)
    base = torch.tensor(cfg.base_dims, dtype=torch.float32,
                        device=w.device)[labels]
    dims_tgt = torch.log(boxes[..., 3:6].clamp(min=1e-3) / base)
    losses['loss_dims'] = (torch.abs(at('dims') - dims_tgt).sum(-1)
                           * w).sum() / num
    losses['loss_ori'] = multibin_loss(at('ori_cls'), at('ori_off'),
                                       gt['gt_alphas'].float(), w, num)
    depth_pred = _decode_direct_depth(at('depth')[..., 0])
    logvar = at('depth_unc')[..., 0]
    dl = torch.abs(depth_pred - boxes[..., 2]) * torch.exp(-logvar) + logvar
    losses['loss_depth'] = (dl * w).sum() / num
    return losses


def monoflex_decode(outs, cam2img, cfg):
    """Every sample's top-`topk` decode: dict(boxes_3d (B, topk, 7)
    camera frame (bottom centre, l, h, w, yaw), scores_3d (0 at or below
    `score_thr`), labels_3d); `cam2img` (B, 3|4, 4)."""
    hm = outs['heatmap']
    nx = hm.shape[2]
    scores, labels, pix = heatmap_peaks(hm, cfg.topk)
    xi = (pix % nx).float()
    yi = torch.div(pix, nx, rounding_mode='floor').float()

    def at(key):
        return gather_cells(outs[key], pix)

    cam2img = pad44(cam2img)
    c2d = (torch.stack([xi, yi], -1) + at('offset')) * cfg.downsample
    d_direct = _decode_direct_depth(at('depth')[..., 0])
    kpts = at('kpts').reshape(pix.shape + (10, 2)) * cfg.downsample
    base = torch.tensor(cfg.base_dims, dtype=torch.float32,
                        device=hm.device)[labels]
    dims_res = at('dims')
    h3d = torch.exp(dims_res[..., 1]) * base[..., 1]
    f = cam2img[:, 1, 1, None]
    ky = kpts[..., 1]
    ph_center = (ky[..., 9] - ky[..., 8]).clamp(min=0.1)
    ph_d1 = (((ky[..., 4] + ky[..., 6]) - (ky[..., 0] + ky[..., 2])) /
             2).clamp(min=0.1)
    ph_d2 = (((ky[..., 5] + ky[..., 7]) - (ky[..., 1] + ky[..., 3])) /
             2).clamp(min=0.1)
    d_kpts = torch.stack([f * h3d / ph_center, f * h3d / ph_d1,
                          f * h3d / ph_d2], -1)
    wgt = torch.softmax(-torch.cat([at('depth_unc'), at('kpt_unc')], -1), -1)
    depth = (torch.cat([d_direct[..., None], d_kpts], -1) * wgt).sum(-1)
    depth = depth.clamp(0.1, 200.0)
    loc = points_img2cam(torch.cat([c2d, depth[..., None]], -1), cam2img)
    dims = torch.exp(dims_res) * base
    bin_id = torch.argmax(at('ori_cls'), -1)
    so = torch.gather(at('ori_off').reshape(pix.shape + (4, 2)), -2,
                      bin_id[..., None, None].expand(-1, -1, 1, 2))[..., 0, :]
    alpha = torch.tensor(BIN_CENTERS, device=hm.device)[bin_id] + \
        torch.atan2(so[..., 0], so[..., 1])
    yaw = _wrap(alpha + torch.atan2(loc[..., 0], loc[..., 2]))
    bottom = torch.stack([loc[..., 0], loc[..., 1] + dims[..., 1] / 2,
                          loc[..., 2]], -1)
    return dict(boxes_3d=torch.cat([bottom, dims, yaw[..., None]], -1),
                scores_3d=torch.where(scores > cfg.score_thr, scores,
                                      torch.zeros((), device=hm.device)),
                labels_3d=labels)
