"""H3DNet: indoor detection refined by geometric primitives (ScanNet).

Port of `dfm_tpu/models/detectors/h3dnet.py:42-309` (reference mmdet3d
h3dnet.py + primitive_head.py + h3d_bbox_head.py), the JAX package's
static shapes:

* `backbone{t}`: `num_backbones` VoteNet `PointNet2SASSG` towers on the
  same points (the shipped config's 4); the first tower's seeds, the
  towers' features concatenated through `fuse` + ReLU;
* `rpn`: ImVoteNet's `VoteTower` -> the initial proposals;
* `prim_z`, `prim_xy`, `prim_line` (`_PrimitiveHead`: `m0` + ReLU, the
  existence logits `flag` and `vote`: a centre offset and a 64-feature)
  per seed;
* the initial proposals decoded (`votenet_predict`, no gradient) to
  their 6 face centres and 12 edge centres (`box_surface_line_centers`);
* with `with_cues` (the shipped config) the faces ball-group the z and xy
  primitives within `surface_radius`, the edges the line primitives
  within `line_radius` (`match_surf` / `match_line` + ReLU, the max over
  the group), `cue_obj` / `cue_sem` per keypoint, the features gated by
  sigmoid(cue_obj[1]); else one ball group of every primitive within
  `primitive_radius` (`match0` + ReLU, the max);
* `ref0`, `ref1` (+ ReLU) and `ref_out`: a residual on the initial raw
  head -> the refined proposals.

`h3dnet_loss`: the initial and refined `votenet_loss` (the latter x
`refine_weight`), each primitive mode's existence (seeds within 0.3 m of
a gt face / edge centre of that mode) and centre distance, and with the
cues the keypoints' objectness (near within `near_threshold`, far beyond
`far_threshold`, sqrt distances) and class at the near ones. The gt boxes
are read as gravity-centre boxes for the primitives and as
`votenet_loss` reads them, as JAX does (ROADMAP.md §3).
`h3dnet_predict`: the refined proposals' `votenet_predict`.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..backbones.pointnet2 import PointNet2SASSG, ball_group
from ..layers import Linear
from .imvotenet import VoteTower
from .votenet import VoteNetConfig, votenet_loss, votenet_predict

__all__ = ['H3DNetConfig', 'H3DNet', 'box_surface_line_centers',
           'h3dnet_loss', 'h3dnet_predict']

MODES = ('z', 'xy', 'line')


@dataclasses.dataclass(frozen=True)
class H3DNetConfig(VoteNetConfig):
    """The fields and defaults of the JAX `H3DNetConfig`."""
    num_backbones: int = 2
    primitive_radius: float = 0.5
    primitive_k: int = 8
    refine_weight: float = 1.0
    flag_weight: float = 0.5
    center_weight: float = 0.5
    with_cues: bool = False
    surface_radius: float = 0.5
    line_radius: float = 0.5
    cues_weight: float = 0.5
    near_threshold: float = 0.3
    far_threshold: float = 0.6


def box_surface_line_centers(boxes):
    """(..., 7) gravity-centre boxes -> (..., 6, 3) face centres (+z, -z,
    +x, -x, +y, -y) and (..., 12, 3) edge centres, turned by the yaw."""
    c, d, yaw = boxes[..., :3], boxes[..., 3:6], boxes[..., 6]
    cy, sy = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    zero = torch.zeros_like(d[..., 0])
    hx, hy, hz = d[..., 0] / 2, d[..., 1] / 2, d[..., 2] / 2

    def rot(vec):
        x = vec[..., 0] * cy - vec[..., 1] * sy
        y = vec[..., 0] * sy + vec[..., 1] * cy
        return torch.stack([x, y, vec[..., 2]], -1)

    def pt(x, y, z):
        return torch.stack([x, y, z], -1)

    faces = torch.stack([pt(zero, zero, hz), pt(zero, zero, -hz),
                         pt(hx, zero, zero), pt(-hx, zero, zero),
                         pt(zero, hy, zero), pt(zero, -hy, zero)], -2)
    lines = [pt(sx * hx, zero, sz * hz) for sx in (1, -1) for sz in (1, -1)]
    lines += [pt(zero, s * hy, sz * hz) for s in (1, -1) for sz in (1, -1)]
    lines += [pt(sx * hx, s * hy, zero) for sx in (1, -1) for s in (1, -1)]
    return (c[..., None, :] + rot(faces),
            c[..., None, :] + rot(torch.stack(lines, -2)))


class _PrimitiveHead(nn.Module):
    """Per seed: existence logits (2), a centre vote, a 64-feature."""

    def __init__(self, cin, feat_dim=64):
        super().__init__()
        self.m0 = Linear(cin, 128)
        self.flag = Linear(128, 2)
        self.vote = Linear(128, 3 + feat_dim)

    def forward(self, seed_xyz, seed_f):
        """-> (flag (B, S, 2) float32, centre (B, S, 3) float32, feature
        (B, S, 64))."""
        x = F.relu(self.m0(seed_f))
        off = self.vote(x)
        return (self.flag(x).float(), (seed_xyz + off[..., :3]).float(),
                off[..., 3:])


class H3DNet(nn.Module):
    """`point_channels`: 3 + the points' features (4: x, y, z and
    ScanNet's height)."""

    def __init__(self, cfg=None, dtype=torch.float32, point_channels=4):
        super().__init__()
        cfg = cfg or H3DNetConfig()
        self.cfg = cfg
        self.dtype = dtype
        for t in range(cfg.num_backbones):
            setattr(self, f'backbone{t}',
                    PointNet2SASSG(point_channels, dtype=dtype))
        c = self.backbone0.out_channels
        self.fuse = Linear(c * cfg.num_backbones, 256)
        self.rpn = VoteTower(cfg, 256)
        for mode in MODES:
            setattr(self, f'prim_{mode}', _PrimitiveHead(256))
        if cfg.with_cues:
            self.match_surf = Linear(3 + 64, 64)
            self.match_line = Linear(3 + 64, 64)
            self.cue_obj = Linear(64, 2)
            self.cue_sem = Linear(64, cfg.num_classes)
        else:
            self.match0 = Linear(3 + 64, 64)
        self.ref0 = Linear(18 * 64, 128)
        self.ref1 = Linear(128, 128)
        self.ref_out = Linear(128, 2 + 3 + cfg.num_classes * 3 +
                              cfg.num_heading_bins * 2 + cfg.num_classes)

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `h3dnet_loss` on gt's 'gt_boxes' (B, G,
        7), 'gt_labels', 'gt_mask' -> (total, dict of terms); the mask,
        `generator` and `depth_pix_idx` (TrainStep's) are not read."""
        return h3dnet_loss(self(points), gt, self.cfg)

    def backbones(self, points):
        """-> (the first tower's seeds (B, M, 3), the fused features (B, M,
        256))."""
        pts = points.to(self.dtype)
        outs = [getattr(self, f'backbone{t}')(pts)
                for t in range(self.cfg.num_backbones)]
        return outs[0][0], F.relu(self.fuse(torch.cat([f for _, f in outs],
                                                      -1)))

    def primitives(self, seed_xyz, seed_f):
        return {m: getattr(self, f'prim_{m}')(seed_xyz, seed_f)
                for m in MODES}

    def match(self, initial, prims):
        """The primitives matched to the initial proposals' keypoints ->
        (the (B, P, 18 * 64) matched features, the cue outputs: with
        `with_cues` 'cues_obj', 'cues_sem' and 'kp_xyz', else none)."""
        cfg = self.cfg
        with torch.no_grad():
            init_boxes = votenet_predict(initial, cfg)['boxes_3d']
        surf, line = box_surface_line_centers(init_boxes)
        b, p = surf.shape[:2]
        k = cfg.primitive_k
        if cfg.with_cues:
            surf_xyz = torch.cat([prims['z'][1], prims['xy'][1]], 1)
            surf_f = torch.cat([prims['z'][2], prims['xy'][2]], 1)
            gs = ball_group(surf_xyz, surf_f, surf.reshape(b, p * 6, 3),
                            cfg.surface_radius, k)
            gl = ball_group(prims['line'][1], prims['line'][2],
                            line.reshape(b, p * 12, 3), cfg.line_radius, k)
            gs = F.relu(self.match_surf(gs.to(self.dtype)))
            gl = F.relu(self.match_line(gl.to(self.dtype)))
            g = torch.cat([gs.reshape(b, p, 6, k, 64),
                           gl.reshape(b, p, 12, k, 64)], 2)
            cue_feat = g.amax(3)                            # (B, P, 18, 64)
            cues_obj = self.cue_obj(cue_feat)
            cues_sem = self.cue_sem(cue_feat)
            gate = torch.sigmoid(cues_obj[..., 1:2].float())
            matched = (cue_feat.float() * gate).reshape(b, p, 18 * 64).to(
                self.dtype)
            return matched, dict(cues_obj=cues_obj.float(),
                                 cues_sem=cues_sem.float(),
                                 kp_xyz=torch.cat([surf, line], 2))
        prim_xyz = torch.cat([prims[m][1] for m in MODES], 1)
        prim_f = torch.cat([prims[m][2] for m in MODES], 1)
        kp = torch.cat([surf, line], 2)                     # (B, P, 18, 3)
        g = ball_group(prim_xyz, prim_f, kp.reshape(b, p * 18, 3),
                       cfg.primitive_radius, k)
        g = F.relu(self.match0(g.to(self.dtype)))
        return g.amax(2).reshape(b, p, 18 * 64), {}

    def refine(self, initial, matched):
        x = F.relu(self.ref1(F.relu(self.ref0(matched))))
        refined = dict(initial)
        refined['raw'] = initial['raw'] + self.ref_out(x).float()
        return refined

    def forward(self, points, point_mask=None):
        """points (B, N, 3+C) (`point_mask` is not read) -> dict 'initial'
        and 'refined' (VoteNet outputs), 'prims' (mode -> (flag, centre,
        feature)), 'seed_xyz' and, with the cues, 'cues_obj' (B, P, 18,
        2), 'cues_sem' (B, P, 18, C), 'kp_xyz' (B, P, 18, 3)."""
        with record_function('h3dnet.backbones'):
            seed_xyz, seed_f = self.backbones(points)
        with record_function('h3dnet.rpn'):
            initial = self.rpn(seed_xyz, seed_f)
        with record_function('h3dnet.primitives'):
            prims = self.primitives(seed_xyz, seed_f)
        with record_function('h3dnet.refine'):
            matched, extra = self.match(initial, prims)
            refined = self.refine(initial, matched)
        return dict(initial=initial, refined=refined, prims=prims,
                    seed_xyz=seed_xyz, **extra)


def _nearest(xyz, targets, mask):
    d2 = ((xyz[:, :, None] - targets[:, None]) ** 2).sum(-1)
    d2 = torch.where(mask[:, None], d2, torch.full_like(d2, torch.inf))
    return d2.min(-1).values, torch.argmin(d2, -1)


def h3dnet_loss(outputs, gt, cfg: H3DNetConfig):
    """JAX's `h3dnet_loss` on gt 'gt_boxes' (B, G, 7), 'gt_labels',
    'gt_mask' -> (total, dict of terms)."""
    total, losses = votenet_loss(outputs['initial'], gt, cfg)
    losses = {f'init_{k}': v for k, v in losses.items()}
    rt, rl = votenet_loss(outputs['refined'], gt, cfg)
    total = total + cfg.refine_weight * rt
    losses.update({f'ref_{k}': v * cfg.refine_weight for k, v in rl.items()})

    boxes, gmask = gt['gt_boxes'], gt['gt_mask']
    bsz = boxes.shape[0]
    surf, line = box_surface_line_centers(boxes)
    targets = dict(z=surf[..., 0:2, :].reshape(bsz, -1, 3),
                   xy=surf[..., 2:6, :].reshape(bsz, -1, 3),
                   line=line.reshape(bsz, -1, 3))
    reps = dict(z=2, xy=4, line=12)
    has_gt = gmask.any(-1, keepdim=True)
    seed = outputs['seed_xyz']
    for mode in MODES:
        flag, center, _ = outputs['prims'][mode]
        tgt = targets[mode]
        near, gi = _nearest(seed, tgt, gmask.repeat_interleave(reps[mode],
                                                               -1))
        pos = (near < 0.3 ** 2) & has_gt
        w = pos.to(flag.dtype)
        npos = torch.clamp(w.sum(), min=1.0)
        logp = F.log_softmax(flag, -1)
        loss_flag = -(w * logp[..., 1] + (1 - w) * logp[..., 0]).mean()
        sel = torch.gather(tgt, 1, gi[..., None].expand(gi.shape + (3,)))
        loss_center = (torch.linalg.norm(center - sel, dim=-1) *
                       w).sum() / npos
        losses[f'prim_{mode}_flag'] = cfg.flag_weight * loss_flag
        losses[f'prim_{mode}_center'] = cfg.center_weight * loss_center
        total = total + losses[f'prim_{mode}_flag'] + \
            losses[f'prim_{mode}_center']

    if 'cues_obj' in outputs:
        kp = outputs['kp_xyz']
        p, nk = kp.shape[1:3]
        gt_kp = torch.cat([surf, line], 2).reshape(bsz, -1, 3)
        near, gi = _nearest(kp.reshape(bsz, p * nk, 3), gt_kp,
                            gmask.repeat_interleave(18, -1))
        near = torch.sqrt(near)
        pos = near < cfg.near_threshold
        neg = near > cfg.far_threshold
        w = ((pos | neg) & has_gt).float()
        nval = torch.clamp(w.sum(), min=1.0)
        logp = F.log_softmax(outputs['cues_obj'].reshape(bsz, p * nk, 2), -1)
        tgt_obj = pos.float()
        loss_obj = -(w * (tgt_obj * logp[..., 1] + (1 - tgt_obj) *
                          logp[..., 0])).sum() / nval
        cls_t = torch.gather(gt['gt_labels'].long().repeat_interleave(18, -1),
                             1, gi)
        logs = F.log_softmax(outputs['cues_sem'].reshape(bsz, p * nk, -1),
                             -1)
        wpos = (pos & has_gt).float()
        nposk = torch.clamp(wpos.sum(), min=1.0)
        loss_sem = -(wpos * torch.gather(logs, -1, cls_t[..., None])[..., 0]
                     ).sum() / nposk
        losses['cues_objectness'] = cfg.cues_weight * loss_obj
        losses['cues_semantic'] = cfg.cues_weight * loss_sem
        total = total + losses['cues_objectness'] + losses['cues_semantic']
    return total, losses


def h3dnet_predict(outputs, cfg: H3DNetConfig):
    """The refined proposals' `votenet_predict`."""
    return votenet_predict(outputs['refined'], cfg)
