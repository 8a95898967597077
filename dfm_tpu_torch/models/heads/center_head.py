"""CenterPoint head: heatmaps and box regression on a BEV map, its targets,
loss and decode.

Port of `dfm_tpu/models/heads/center_head.py:30-325` (reference
mmdet3d/models/dense_heads/centerpoint_head.py:19-122, 244-360 and
`box3d_nms.circle_nms`), as MultiViewDfM's `bbox_head='center'` builds
it:

* a shared 3x3 ConvNorm (bias, BatchNorm, ReLU), then per task a
  `SeparateHead` with the branches reg (2), height (1), dim (3), rot (2)
  [, vel (2)] and heatmap (the task's classes), each (num_conv - 1) 3x3
  ConvNorms with bias and a biased final 3x3 conv (the heatmap's bias
  initialised to -2.19);
* targets: a Gaussian per box drawn at its floored centre cell with the
  CornerNet radius (at least `min_radius`), max-composited per class, and
  the regression targets of the first `max_objs` valid boxes in their
  order;
* the loss: the Gaussian focal loss over the sigmoid heatmap divided by
  the positives (cells with target 1), and `loss_bbox_weight` x the L1 at
  the boxes' cells divided by their count (+ 1e-4); in a process group
  both counts are the global batch's;
* decode (sample 0 only, as the JAX package decodes): 3x3 local-max
  suppression, the top `max_per_task` cells (ties to the lower index, as
  `lax.top_k`), the boxes, and the greedy circle NMS over those
  candidates (a loop on the host).

Outputs are channels last, (B, Ny, Nx, ch), views of the NCHW maps, as
in the JAX package.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import dist as D
from ..layers import Conv, ConvNorm

__all__ = ['CenterHeadConfig', 'SeparateHead', 'CenterHead',
           'gaussian_radius', 'center_head_targets', 'gaussian_focal_loss',
           'center_head_loss', 'circle_nms_mask', 'center_head_decode']

HEATMAP_BIAS = -2.19


@dataclasses.dataclass(frozen=True)
class CenterHeadConfig:
    """Fields and defaults of the JAX `CenterHeadConfig`."""
    tasks: Tuple[Tuple[str, ...], ...] = (('Car',), ('Pedestrian',
                                                     'Cyclist'))
    share_conv_channel: int = 64
    head_conv: int = 64
    final_kernel: int = 3
    num_heatmap_convs: int = 2
    with_vel: bool = False
    norm_bbox: bool = True          # dims predicted in log space
    max_objs: int = 100
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    out_size_factor: int = 1
    voxel_size: Tuple[float, float] = (0.2, 0.2)
    pc_range: Tuple[float, float] = (0.0, -40.0)   # (x0, y0)
    max_per_task: int = 50
    score_thr: float = 0.1
    circle_nms_thr: float = 4.0     # squared centre distance

    @property
    def num_tasks(self):
        return len(self.tasks)

    def heads(self, task):
        """(name, out channels, convs) of one task's branches."""
        heads = [('reg', 2, 2), ('height', 1, 2), ('dim', 3, 2),
                 ('rot', 2, 2)]
        if self.with_vel:
            heads.append(('vel', 2, 2))
        return heads + [('heatmap', len(self.tasks[task]),
                         self.num_heatmap_convs)]


class SeparateHead(nn.Module):
    """Keys `{name}_conv{i}` (ConvNorm with bias) and `{name}_final`."""

    def __init__(self, cin, heads, head_conv=64, final_kernel=3, norm='bn'):
        super().__init__()
        self.heads = tuple(heads)
        k = final_kernel
        for name, ch, num_conv in self.heads:
            c = cin
            for i in range(num_conv - 1):
                setattr(self, f'{name}_conv{i}', ConvNorm(
                    c, head_conv, k, norm=norm, bias=True))
                c = head_conv
            setattr(self, f'{name}_final', Conv(c, ch, k, bias=True))

    def forward(self, x):
        out = {}
        for name, _, num_conv in self.heads:
            f = x
            for i in range(num_conv - 1):
                f = getattr(self, f'{name}_conv{i}')(f)
            out[name] = getattr(self, f'{name}_final')(f).permute(0, 2, 3, 1)
        return out


class CenterHead(nn.Module):
    """Keys `shared_conv` and `task{t}`."""

    def __init__(self, cfg=None, in_channels=256, norm='bn',
                 dtype=torch.float32):
        super().__init__()
        cfg = cfg or CenterHeadConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.shared_conv = ConvNorm(in_channels, cfg.share_conv_channel, 3,
                                    norm=norm, bias=True)
        for t in range(cfg.num_tasks):
            setattr(self, f'task{t}', SeparateHead(
                cfg.share_conv_channel, cfg.heads(t), cfg.head_conv,
                cfg.final_kernel, norm))

    def forward(self, bev):
        """bev (B, C, Ny, Nx) -> a list (per task) of branch dicts, each
        (B, Ny, Nx, ch)."""
        x = self.shared_conv(bev.to(self.dtype))
        return [getattr(self, f'task{t}')(x)
                for t in range(self.cfg.num_tasks)]


def gaussian_radius(det_size, min_overlap=0.1):
    """The CornerNet radius of (..., 2) (h, w) sizes (the minimum of its
    three quadratic roots)."""
    h, w = det_size[..., 0], det_size[..., 1]
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def center_head_targets(gt_boxes, gt_labels, gt_mask, task_classes,
                        featmap_size, cfg: CenterHeadConfig):
    """Targets of one task of one sample.

    Args:
        gt_boxes: (G, 7[+2]) bottom-centre boxes (vehicle frame).
        gt_labels: (G,) global class ids; `task_classes` the task's.
        gt_mask: (G,) bool.
        featmap_size: (Ny, Nx).

    Returns:
        heatmap (Ny, Nx, C_task), anno_boxes (max_objs, 8[+2]), inds
        (max_objs,) flat cell indices, mask (max_objs,) bool.
    """
    ny, nx = featmap_size
    dev = gt_boxes.device
    gt_boxes = gt_boxes.float()
    vx, vy = cfg.voxel_size
    fac = cfg.out_size_factor
    in_task = torch.zeros_like(gt_mask, dtype=torch.bool)
    local_cls = torch.zeros(gt_labels.shape, dtype=torch.long, device=dev)
    for li, c in enumerate(task_classes):
        sel = gt_labels == c
        in_task |= sel
        local_cls = torch.where(sel, li, local_cls)
    cx = (gt_boxes[:, 0] - cfg.pc_range[0]) / (vx * fac)
    cy = (gt_boxes[:, 1] - cfg.pc_range[1]) / (vy * fac)
    wl = torch.stack([gt_boxes[:, 4] / (vy * fac),
                      gt_boxes[:, 3] / (vx * fac)], -1)
    radius = gaussian_radius(wl, cfg.gaussian_overlap).clamp(
        min=float(cfg.min_radius))
    xi = torch.floor(cx).clamp(0, nx - 1).long()
    yi = torch.floor(cy).clamp(0, ny - 1).long()
    inside = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    valid = in_task & gt_mask.bool() & inside

    gy = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    gx = torch.arange(nx, dtype=torch.float32, device=dev)[None, None, :]
    d2 = (gx - xi[:, None, None].float()) ** 2 + \
        (gy - yi[:, None, None].float()) ** 2
    sigma = ((2 * radius + 1) / 6.0)[:, None, None]
    gauss = torch.exp(-d2 / (2 * sigma ** 2))
    gauss = torch.where((d2 <= radius[:, None, None] ** 2)
                        & valid[:, None, None], gauss, 0.0)
    heatmap = torch.stack([
        torch.where((local_cls == li)[:, None, None], gauss, 0.0).amax(0)
        if len(gauss) else gauss.new_zeros(ny, nx)
        for li in range(len(task_classes))], -1)          # (Ny, Nx, C)

    take = torch.argsort((~valid).int(), stable=True)[:cfg.max_objs]
    mask = valid[take]
    box = gt_boxes[take]

    def size(i):
        return torch.log(box[:, i].clamp(min=1e-3)) if cfg.norm_bbox \
            else box[:, i]

    anno = [cx[take] - xi[take], cy[take] - yi[take], box[:, 2], size(3),
            size(4), size(5), torch.sin(box[:, 6]), torch.cos(box[:, 6])]
    if cfg.with_vel and gt_boxes.shape[1] >= 9:
        anno += [box[:, 7], box[:, 8]]
    return heatmap, torch.stack(anno, -1), yi[take] * nx + xi[take], mask


def gaussian_focal_loss(pred_sigmoid, gt_heatmap, alpha=2.0, gamma=4.0,
                        dist_norm=False):
    """The focal loss of a sigmoid heatmap against Gaussian targets,
    divided by the positives (target 1; at least 1), in a process group
    (`dist_norm`) the global batch's."""
    eps = 1e-6
    pos = (gt_heatmap >= 1.0 - 1e-6).float()
    neg_w = torch.pow(1 - gt_heatmap, gamma)
    pos_loss = -torch.log(pred_sigmoid + eps) * \
        torch.pow(1 - pred_sigmoid, alpha) * pos
    neg_loss = -torch.log(1 - pred_sigmoid + eps) * \
        torch.pow(pred_sigmoid, alpha) * neg_w * (1 - pos)
    num_pos = D.global_sum(pos.sum()) if dist_norm else pos.sum()
    return (pos_loss.sum() + neg_loss.sum()) / num_pos.clamp(min=1.0)


def center_head_loss(task_outs, gt, cfg: CenterHeadConfig, task_class_ids,
                     loss_bbox_weight=0.25, code_weights=None,
                     dist_norm=False):
    """`task{t}_loss_heatmap` and `task{t}_loss_bbox` of every task.

    Args:
        task_outs: `CenterHead`'s list of branch dicts.
        gt: 'gt_boxes' (B, G, 7[+2]), 'gt_labels' (B, G), 'gt_mask' (B, G).
        task_class_ids: per task, its global class ids.
        dist_norm: in a process group, the positives and the box count
            over the global batch (a rank's loss its share of the global
            batch's); a no-op without a group.
    """
    losses = {}
    for t, out in enumerate(task_outs):
        ny, nx = out['heatmap'].shape[1:3]
        tgt = [center_head_targets(b, lb, m, task_class_ids[t], (ny, nx),
                                   cfg)
               for b, lb, m in zip(gt['gt_boxes'], gt['gt_labels'],
                                   gt['gt_mask'])]
        hm, anno, inds, mask = (torch.stack(x) for x in zip(*tgt))
        pred_hm = torch.sigmoid(out['heatmap'].float())
        losses[f'task{t}_loss_heatmap'] = gaussian_focal_loss(
            pred_hm, hm, dist_norm=dist_norm)
        parts = [out['reg'], out['height'], out['dim'], out['rot']]
        if cfg.with_vel:
            parts.append(out['vel'])
        pred = torch.cat([p.float() for p in parts], -1)
        pred_at = torch.gather(pred.reshape(pred.shape[0], ny * nx, -1), 1,
                               inds[..., None].expand(-1, -1,
                                                      pred.shape[-1]))
        w = mask.float()[..., None]
        if code_weights is not None:
            w = w * torch.as_tensor(code_weights, dtype=torch.float32,
                                    device=w.device)
        num = mask.sum().float()
        num = (D.global_sum(num) if dist_norm else num).clamp(min=1.0)
        losses[f'task{t}_loss_bbox'] = loss_bbox_weight * (
            (pred_at - anno).abs() * w).sum() / (num + 1e-4)
    return losses


def circle_nms_mask(centers_xy, scores, thresh):
    """Greedy circle NMS: in score order (ties to the lower index), a
    candidate is dropped when an earlier kept one lies within squared
    distance `thresh`. Returns the keep mask in the input order. The
    greedy loop runs on the host."""
    order = torch.argsort(-scores, stable=True)
    c = centers_xy[order].float().cpu().numpy()
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    near = d2 <= thresh
    supp = np.zeros(len(c), bool)
    for i in range(len(c)):
        supp[i] = bool((near[i, :i] & ~supp[:i]).any())
    keep = torch.zeros(len(c), dtype=torch.bool, device=scores.device)
    keep[order] = torch.from_numpy(~supp).to(scores.device)
    return keep


def center_head_decode(task_outs, cfg: CenterHeadConfig, task_class_ids):
    """The detections of sample 0 over all tasks: 'boxes_3d' (T * K, 7),
    'scores_3d' (0 where dropped or below `score_thr`), 'labels_3d'
    (global ids), K = `max_per_task`."""
    boxes_all, scores_all, labels_all = [], [], []
    vx, vy = cfg.voxel_size
    fac = cfg.out_size_factor
    for t, out in enumerate(task_outs):
        hm = torch.sigmoid(out['heatmap'][0].float())        # (Ny, Nx, C)
        ny, nx, c = hm.shape
        hmax = F.max_pool2d(hm.permute(2, 0, 1)[None], 3, 1, 1)[0].permute(
            1, 2, 0)
        hm = torch.where(hm >= hmax, hm, 0.0)
        k = cfg.max_per_task
        scores, idx = torch.sort(hm.reshape(-1), descending=True,
                                 stable=True)
        scores, idx = scores[:k], idx[:k]
        cls = idx % c
        pix = idx // c
        yi = (pix // nx).float()
        xi = (pix % nx).float()

        def at(name, ch):
            return out[name][0].float().reshape(ny * nx, ch)[pix]

        reg, height, dim, rot = (at('reg', 2), at('height', 1)[:, 0],
                                 at('dim', 3), at('rot', 2))
        x = (xi + reg[:, 0]) * fac * vx + cfg.pc_range[0]
        y = (yi + reg[:, 1]) * fac * vy + cfg.pc_range[1]
        dims = torch.exp(dim) if cfg.norm_bbox else dim
        yaw = torch.atan2(rot[:, 0], rot[:, 1])
        boxes = torch.stack([x, y, height, dims[:, 0], dims[:, 1],
                             dims[:, 2], yaw], -1)
        keep = circle_nms_mask(torch.stack([x, y], -1), scores,
                               cfg.circle_nms_thr)
        scores_all.append(torch.where(keep & (scores > cfg.score_thr),
                                      scores, 0.0))
        boxes_all.append(boxes)
        labels_all.append(torch.as_tensor(task_class_ids[t],
                                          device=cls.device)[cls])
    return dict(boxes_3d=torch.cat(boxes_all),
                scores_3d=torch.cat(scores_all),
                labels_3d=torch.cat(labels_all))
