"""Group-Free 3D: the indoor transformer detector (ScanNet).

Port of `dfm_tpu/models/detectors/groupfree3d.py:43-324` (reference
mmdet3d groupfree3dnet.py + groupfree3d_head.py), the JAX package's
static shapes:

* `backbone`: `PointNet2SASSG` with its FP decoder (four SA levels, two
  FP steps: 1024 seeds of 288 features at the config's widths);
* KPS sampling: `points_obj_mlp` + `points_obj_bn` + ReLU,
  `points_obj_cls` -> one objectness logit a seed; the `num_proposal`
  highest (`highest_k`: `lax.top_k`'s order, ties to the lower index)
  are the candidates;
* `head_proposal` (`_PredHead`: two `Linear` + BatchNorm + ReLU, then
  `cls_out` (objectness + classes) and `reg_out` (centre residual, size
  class, size residual a class)) on the candidates' features;
* `decoder_query_proj` / `decoder_key_proj`, then `num_decoder_layers`
  `_DecoderLayer`s (self attention over the queries, cross attention to
  every seed, each + residual + `LayerNorm`, a ReLU FFN + residual +
  `LayerNorm`; flax's attention and eps 1e-6: `layers.MultiHeadAttention`
  / `LayerNorm`), each with a query position from the previous stage's
  box (centre and decoded size, no gradient: `self_posembed{i}`) and a
  key position from the seeds' xyz (`cross_posembed{i}`), and its own
  `head_s{i}`.

`groupfree3d_loss` (gt boxes bottom-centre, as the indoor datasets give
them; the loss lifts their centres by half the height): the seeds in a
gt box (BEV and z) take its nearest, each gt's 4 closest assigned seeds
by size-normalised distance (`lowest_k`, ties to the lower index, as
`lax.top_k(-comp.T)` ranks the 100.0 of every other seed) are the
sampling targets (`scatter_reduce` 'amax'); the focal sampling loss, and
a stage's focal objectness, smooth-L1 centre, size-class CE, smooth-L1
size residual and class CE on the candidates, each stage weighted
1 / the stages. `groupfree3d_predict`: the last stage, axis-aligned
bottom-centre boxes, objectness x class probability of the argmax class
(0 at or below `score_thr`).
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ...core.boxes import points_in_rotated_boxes_bev
from ..backbones.pointnet2 import (PointNet2SASSG, gather_points, highest_k,
                                   lowest_k)
from ..layers import BatchNormLast, LayerNorm, Linear, MultiHeadAttention

__all__ = ['GroupFree3DConfig', 'GroupFree3DNet', 'groupfree3d_loss',
           'groupfree3d_predict']


@dataclasses.dataclass(frozen=True)
class GroupFree3DConfig:
    """The fields and defaults of the JAX `GroupFree3DConfig` (ScanNet's
    18 classes, L6 x O256)."""
    num_classes: int = 18
    num_proposal: int = 256
    num_decoder_layers: int = 6
    embed_dims: int = 288
    num_heads: int = 8
    ffn_channels: int = 2048
    mean_sizes: Tuple[Tuple[float, float, float], ...] = tuple(
        (0.8, 0.8, 0.9) for _ in range(18))
    seed_points_obj_topk: int = 4
    sa_points: Tuple[int, ...] = (2048, 1024, 512, 256)
    sa_radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    sa_ks: Tuple[int, ...] = (64, 32, 16, 16)
    sa_mlps: Tuple[Tuple[int, ...], ...] = (
        (64, 64, 128), (128, 128, 256), (128, 128, 256),
        (128, 128, 256))
    fp_channels: Tuple[Tuple[int, ...], ...] = ((256, 256), (256, 288))
    sampling_obj_weight: float = 8.0
    center_weight: float = 10.0
    size_res_weight: float = 10.0
    max_gt: int = 32
    score_thr: float = 0.0
    max_num: int = 128


class _PredHead(nn.Module):
    """Shared `shared{i}` + `shared_bn{i}` + ReLU, then `cls_out` and
    `reg_out` -> a stage's prediction dict (the heads' outputs float32,
    as JAX casts them; the centre in the candidates' dtype if wider)."""

    def __init__(self, cfg, cin):
        super().__init__()
        c, e = cfg.num_classes, cfg.embed_dims
        self.num_classes = c
        self.shared0 = Linear(cin, e)
        self.shared_bn0 = BatchNormLast(e)
        self.shared1 = Linear(e, e)
        self.shared_bn1 = BatchNormLast(e)
        self.cls_out = Linear(e, 1 + c)
        self.reg_out = Linear(e, 3 + c + 3 * c)

    def forward(self, x, base_xyz):
        x = F.relu(self.shared_bn0(self.shared0(x)))
        x = F.relu(self.shared_bn1(self.shared1(x)))
        cls = self.cls_out(x).float()
        reg = self.reg_out(x).float()
        c = self.num_classes
        ctr_res = reg[..., :3]
        return dict(obj_scores=cls[..., :1], sem_scores=cls[..., 1:],
                    center_residual=ctr_res,
                    center=base_xyz.detach() + ctr_res,
                    size_class=reg[..., 3:3 + c],
                    size_res_norm=reg[..., 3 + c:].reshape(
                        reg.shape[:-1] + (c, 3)))


class _DecoderLayer(nn.Module):
    """self_attn -> norm0 -> cross_attn -> norm1 -> ffn -> norm2, the
    positions added to the attention inputs."""

    def __init__(self, cfg):
        super().__init__()
        e = cfg.embed_dims
        self.self_attn = MultiHeadAttention(e, e, cfg.num_heads)
        self.norm0 = LayerNorm(e)
        self.cross_attn = MultiHeadAttention(e, e, cfg.num_heads)
        self.norm1 = LayerNorm(e)
        self.ffn0 = Linear(e, cfg.ffn_channels)
        self.ffn1 = Linear(cfg.ffn_channels, e)
        self.norm2 = LayerNorm(e)

    def forward(self, query, key, query_pos, key_pos):
        q = query + query_pos
        x = self.norm0(query + self.self_attn(q, q))
        x = self.norm1(x + self.cross_attn(x + query_pos, key + key_pos))
        return self.norm2(x + self.ffn1(F.relu(self.ffn0(x))))


def _decoded_dims(pred, mean, floor):
    """The (B, P, 3) size of each box of a stage: its argmax size class's
    mean size x (1 + that class's residual), at least `floor`."""
    scls = torch.argmax(pred['size_class'], -1)
    idx = scls[..., None, None].expand(scls.shape + (1, 3))
    sres = torch.gather(pred['size_res_norm'], 2, idx)[:, :, 0]
    return torch.clamp(mean[scls] * (1 + sres), min=floor)


class GroupFree3DNet(nn.Module):
    """`point_channels`: 3 + the points' features (4: x, y, z and the
    height that the indoor datasets append)."""

    def __init__(self, cfg=None, dtype=torch.float32, point_channels=4):
        super().__init__()
        cfg = cfg or GroupFree3DConfig()
        self.cfg = cfg
        self.dtype = dtype
        e = cfg.embed_dims
        self.backbone = PointNet2SASSG(
            point_channels, cfg.sa_points, cfg.sa_radii, cfg.sa_ks,
            cfg.sa_mlps, cfg.fp_channels, dtype=dtype)
        c = self.backbone.out_channels
        self.points_obj_mlp = Linear(c, e)
        self.points_obj_bn = BatchNormLast(e)
        self.points_obj_cls = Linear(e, 1)
        self.head_proposal = _PredHead(cfg, c)
        self.decoder_query_proj = Linear(c, e)
        self.decoder_key_proj = Linear(c, e)
        for i in range(cfg.num_decoder_layers):
            setattr(self, f'self_posembed{i}', Linear(6, e))
            setattr(self, f'cross_posembed{i}', Linear(3, e))
            setattr(self, f'decoder{i}', _DecoderLayer(cfg))
            setattr(self, f'head_s{i}', _PredHead(cfg, e))

    def forward_train(self, points, point_mask, gt, generator=None,
                      depth_pix_idx=None):
        """The forward pass and `groupfree3d_loss` on gt's 'gt_boxes' (B,
        G, 7) bottom-centre, 'gt_labels', 'gt_mask' -> (total, dict of
        terms); the mask, `generator` and `depth_pix_idx` (TrainStep's)
        are not read."""
        return groupfree3d_loss(self(points), gt, self.cfg)

    def sampling(self, seed_xyz, seed_f):
        """KPS: the seeds' objectness logits (B, S) float32 and the
        `num_proposal` highest seeds' indices, xyz and features."""
        s = F.relu(self.points_obj_bn(self.points_obj_mlp(seed_f)))
        logits = self.points_obj_cls(s)[..., 0].float()
        _, idx = highest_k(logits, self.cfg.num_proposal)
        return logits, idx, gather_points(seed_xyz, idx), \
            gather_points(seed_f, idx)

    def decoder(self, seed_xyz, seed_f, cand_xyz, cand_f):
        """The proposal head and the decoder layers -> the stages'
        predictions, proposal first."""
        cfg = self.cfg
        pred = self.head_proposal(cand_f, cand_xyz)
        stages = [pred]
        query = self.decoder_query_proj(cand_f)
        key = self.decoder_key_proj(seed_f)
        mean = torch.as_tensor(cfg.mean_sizes, dtype=torch.float32,
                               device=seed_xyz.device)
        for i in range(cfg.num_decoder_layers):
            with torch.no_grad():
                base = torch.cat([pred['center'], _decoded_dims(
                    pred, mean, 0.1)], -1).to(self.dtype)
            qp = getattr(self, f'self_posembed{i}')(base)
            kp = getattr(self, f'cross_posembed{i}')(seed_xyz)
            query = getattr(self, f'decoder{i}')(query, key, qp, kp)
            pred = getattr(self, f'head_s{i}')(query, cand_xyz)
            stages.append(pred)
        return stages

    def forward(self, points, point_mask=None):
        """points (B, N, 3+C) (`point_mask` is not read) -> dict
        'seeds_obj_cls_logits' (B, S), 'seed_points' (B, S, 3),
        'query_points_xyz' (B, P, 3), 'candidate_idx' (B, P) and 'stages'
        (the per-stage prediction dicts, proposal first)."""
        with record_function('groupfree3d.backbone'):
            seed_xyz, seed_f = self.backbone(points.to(self.dtype))
        with record_function('groupfree3d.sampling'):
            logits, idx, cand_xyz, cand_f = self.sampling(seed_xyz, seed_f)
        with record_function('groupfree3d.decoder'):
            stages = self.decoder(seed_xyz, seed_f, cand_xyz, cand_f)
        return dict(seeds_obj_cls_logits=logits, seed_points=seed_xyz,
                    query_points_xyz=cand_xyz, candidate_idx=idx,
                    stages=stages)


def _sigmoid_focal(logits, targets, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    ce = torch.clamp(logits, min=0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    pt = p * targets + (1 - p) * (1 - targets)
    a = alpha * targets + (1 - alpha) * (1 - targets)
    return a * (1 - pt) ** gamma * ce


def _smooth_l1(x, beta=1.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _targets(seeds, cand_idx, gt, gt_labels, gt_mask, mean, topk):
    """The batched targets of `groupfree3d_loss`'s `single`: sampling
    targets (B, S), candidate objectness (B, P), their gt's gravity
    centre, class and normalised size residual."""
    b, s = seeds.shape[:2]
    g = gt.shape[1]
    gt_center = torch.cat([gt[..., :2], gt[..., 2:3] + gt[..., 5:6] / 2], -1)
    bev = torch.stack([points_in_rotated_boxes_bev(seeds[i, :, :2], gt[i])
                       for i in range(b)])                       # (B, S, G)
    z = seeds[..., 2:3]
    inz = (z >= gt[:, None, :, 2]) & (z <= gt[:, None, :, 2] +
                                      gt[:, None, :, 5])
    pm = bev & inz & gt_mask[:, None, :]
    obj = pm.any(-1)
    diff = seeds[:, :, None] - gt_center[:, None]
    d2 = (diff ** 2).sum(-1)
    assign = torch.argmin(torch.where(pm, d2, torch.full_like(d2, torch.inf)),
                          -1)
    assign = torch.where(obj, assign, torch.zeros_like(assign))
    norm_d = torch.sqrt(((diff / (gt[:, None, :, 3:6] + 1e-6)) ** 2).sum(-1)
                        + 1e-6)
    onehot = F.one_hot(assign, g).bool() & obj[..., None]
    comp = torch.where(onehot, norm_d, torch.full_like(norm_d, 100.0))
    k = min(topk, s)
    top = lowest_k(comp.transpose(1, 2), k).reshape(b, g * k)   # (B, G*k)
    val = gt_mask.float().repeat_interleave(k, -1)
    samp = torch.zeros((b, s), dtype=torch.float32, device=seeds.device)
    samp = samp.scatter_reduce(1, top, val, 'amax') * obj.float()
    cobj = torch.gather(obj, 1, cand_idx)
    cassign = torch.gather(assign, 1, cand_idx)
    ct = gather_points(gt_center, cassign)
    lbl = torch.gather(gt_labels.long(), 1, cassign)
    dims = gather_points(gt[..., 3:6], cassign)
    sres = (dims - mean[lbl]) / (mean[lbl] + 1e-6)
    return samp, cobj, ct, lbl, sres


def groupfree3d_loss(outputs, gt, cfg: GroupFree3DConfig):
    """JAX's `groupfree3d_loss` on gt 'gt_boxes' (B, G, 7) bottom-centre,
    'gt_labels', 'gt_mask' -> (total, dict of terms)."""
    seeds = outputs['seed_points'].detach()
    boxes = gt['gt_boxes'].float()
    mean = torch.as_tensor(cfg.mean_sizes, dtype=torch.float32,
                           device=seeds.device)
    samp, cobj, ct, lbl, sres_t = _targets(
        seeds, outputs['candidate_idx'], boxes, gt['gt_labels'],
        gt['gt_mask'], mean, cfg.seed_points_obj_topk)
    b = boxes.shape[0]
    losses = {'loss_sampling_obj': _sigmoid_focal(
        outputs['seeds_obj_cls_logits'], samp).sum() / b *
        cfg.sampling_obj_weight}
    w_box = cobj.float()
    w_box = w_box / torch.clamp(w_box.sum(), min=1e-6)
    stages = outputs['stages']
    ns = len(stages)
    sidx = lbl[..., None, None].expand(lbl.shape + (1, 3))
    for si, st in enumerate(stages):
        tag = 'proposal' if si == 0 else f's{si - 1}'
        lobj = _sigmoid_focal(st['obj_scores'][..., 0],
                              cobj.float()).sum() / b / ns
        lctr = (_smooth_l1(st['center'] - ct).sum(-1) * w_box).sum() * \
            cfg.center_weight / ns
        slp = F.log_softmax(st['size_class'], -1)
        lscls = (-torch.gather(slp, -1, lbl[..., None])[..., 0] *
                 w_box).sum() / ns
        sres_p = torch.gather(st['size_res_norm'], 2, sidx)[:, :, 0]
        lsres = (_smooth_l1(sres_p - sres_t).sum(-1) * w_box).sum() * \
            cfg.size_res_weight / ns
        clp = F.log_softmax(st['sem_scores'], -1)
        lsem = (-torch.gather(clp, -1, lbl[..., None])[..., 0] *
                w_box).sum() / ns
        losses[f'loss_{tag}_obj'] = lobj
        losses[f'loss_{tag}_center'] = lctr
        losses[f'loss_{tag}_size_cls'] = lscls
        losses[f'loss_{tag}_size_res'] = lsres
        losses[f'loss_{tag}_sem'] = lsem
    return sum(losses.values()), losses


def groupfree3d_predict(outputs, cfg: GroupFree3DConfig):
    """The last stage -> 'boxes_3d' (B, P, 7) axis-aligned bottom-centre
    boxes, 'scores_3d' (objectness x the argmax class's probability, 0 at
    or below `score_thr`), 'labels_3d'."""
    st = outputs['stages'][-1]
    obj = torch.sigmoid(st['obj_scores'][..., 0])
    sem = F.softmax(st['sem_scores'], -1)
    scores = obj[..., None] * sem
    mean = torch.as_tensor(cfg.mean_sizes, dtype=torch.float32,
                           device=obj.device)
    dims = _decoded_dims(st, mean, 0.01)
    ctr = st['center']
    bottom = torch.cat([ctr[..., :2], ctr[..., 2:3] - dims[..., 2:3] / 2], -1)
    boxes = torch.cat([bottom, dims, torch.zeros_like(dims[..., :1])], -1)
    labels = torch.argmax(sem, -1)
    best = torch.gather(scores, -1, labels[..., None])[..., 0]
    best = torch.where(best > cfg.score_thr, best, torch.zeros_like(best))
    return dict(boxes_3d=boxes, scores_3d=best, labels_3d=labels)
