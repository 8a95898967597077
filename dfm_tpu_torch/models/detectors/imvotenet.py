"""ImVoteNet: image-vote fusion for indoor point detection (SUN RGB-D).

Port of `dfm_tpu/models/detectors/imvotenet.py:44-259` (reference
mmdet3d imvotenet.py + fusion_layers/vote_fusion.py), the JAX package's
static shapes:

* `backbone`: VoteNet's `PointNet2SASSG` (256 seeds of 256 features);
* with `with_img_branch` the 2D detector in the graph on the raw 0-255
  image: `img_backbone` (`LIGAResNet` as a plain ResNet-18: strides
  (1,2,2,2), no dilation, factors (1,2,4,8), the stem max-pool, stages
  1-3 out, BatchNorm), `img_neck` (`FPN`, 64 channels, 5 levels, strides
  8-128), `img_bbox_head` (`ATSS2DHead`, one conv a tower) and
  `atss2d_decode`'s `img_max_boxes` slots, which replace the
  `bboxes_2d` input; `freeze_img_branch` detaches them (the branch's
  BatchNorms still run in train mode, and the optimizer still decays its
  weights, as JAX's train CLI freezes no prefix of ImVoteNet) and drops
  the 2D outputs, else they stay as 'outs_2d' for the 2D loss;
* `vote_fusion_cues`: per seed its projection into the image, the
  geometric cue of each 2D box around it (the box centre's offset lifted
  at the seed's depth through the inverse projection: the xz
  displacement and the ray), the semantic cue (the box's confidence at
  its class), the `max_imvote_per_pixel` boxes of the highest in-box +
  confidence score (`highest_k`, ties to the lower index, as
  `lax.top_k`), and the texture cue (the pixel's RGB / 255, the
  projection rounded half to even); the cues' max over the kept boxes
  (0 where none), with the texture, through `img_mlp` + ReLU;
* three `_VoteTower`s (vote MLP `vote0`, `vote1`, `vote_out`, a `skip`
  projection of the seed features, the votes' FPS centres and ball
  groups, `prop0`, `prop1`, `head_out`): `joint` on the seed and image
  features, `pts` on the seed features, `img` on the image features.

`imvotenet_loss`: the towers' `votenet_loss` weighted by `loss_weights`
(joint, pts, img), plus with a trainable branch and 'gt_bboxes2d' in the
batch the ATSS 2D loss x `img_loss_weight`. `imvotenet_predict`: the
joint tower's `votenet_predict`.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..backbones.liga_resnet import LIGAResNet
from ..backbones.pointnet2 import (PointNet2SASSG, ball_group,
                                   farthest_point_sample, gather_points,
                                   highest_k)
from ..heads.atss2d import (ATSS2DConfig, ATSS2DHead, atss2d_decode,
                            atss2d_loss)
from ..layers import Linear
from ..necks.fpn import FPN
from .votenet import VoteNetConfig, votenet_loss, votenet_predict

__all__ = ['ImVoteNetConfig', 'ImVoteNet', 'VoteTower', 'vote_fusion_cues',
           'imvotenet_loss', 'imvotenet_predict', 'img_atss_config']

IMG_STRIDES = (8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class ImVoteNetConfig(VoteNetConfig):
    """The fields and defaults of the JAX `ImVoteNetConfig`."""
    max_imvote_per_pixel: int = 3
    img_feat_dim: int = 128
    loss_weights: Tuple[float, float, float] = (0.4, 0.3, 0.3)
    with_img_branch: bool = False
    freeze_img_branch: bool = True
    img_backbone_depth: int = 18
    img_max_boxes: int = 16
    img_loss_weight: float = 1.0


def img_atss_config(cfg):
    """The image branch's `ATSS2DConfig`: 64 channels, one conv a tower,
    strides 8-128."""
    return ATSS2DConfig(num_classes=cfg.num_classes, in_channels=64,
                        feat_channels=64, stacked_convs=1,
                        strides=IMG_STRIDES)


def vote_fusion_cues(seeds, bboxes_2d, img, depth2img, num_classes,
                     max_per=3):
    """Per-seed image cues of a batch (JAX's `vote_fusion_cues` on each
    sample).

    Args:
        seeds: (B, S, 3) depth-frame seeds (taken as float32).
        bboxes_2d: (B, M, 6) (l, t, r, b, conf, cls); conf <= 0 is a pad.
        img: (B, H, W, 3) image, 0-255.
        depth2img: (B, 3 or 4, 4) projection (taken as float32).
        max_per: image votes kept a seed.

    Returns:
        cues (B, S, max_per', 5 + num_classes), txt (B, S, 3) float32 and
        mask (B, S, max_per') (max_per' = min(max_per, M)).
    """
    seeds = seeds.float()
    b, s, _ = seeds.shape
    h, w = img.shape[1:3]
    d2i = depth2img.float()
    if d2i.shape[1] == 3:
        row = torch.tensor([0.0, 0.0, 0.0, 1.0], device=d2i.device)
        d2i = torch.cat([d2i, row.expand(b, 1, 4)], 1)
    homo = torch.cat([seeds, torch.ones_like(seeds[..., :1])], -1)
    proj = homo @ d2i.transpose(1, 2)                           # (B, S, 4)
    z = torch.clamp(proj[..., 2], min=1e-5)
    uv = proj[..., :2] / z[..., None]
    u, v = uv[..., 0:1], uv[..., 1:2]                           # (B, S, 1)
    l, t, r, bt = (bboxes_2d[..., i][:, None] for i in range(4))
    conf = bboxes_2d[..., 4]
    cls = bboxes_2d[..., 5].to(torch.int32)
    valid = conf > 0
    in_box = (u > l) & (u < r) & (v > t) & (v < bt) & valid[:, None]

    du = (l + r) / 2 - u                                        # (B, S, M)
    dv = (t + bt) / 2 - v
    zc = z[..., None]
    zero = torch.zeros_like(du * zc)
    dvec = torch.stack([du * zc, dv * zc, zero, zero], -1)
    inv = torch.linalg.inv(d2i)
    imvote = (dvec @ inv.transpose(1, 2)[:, None].to(dvec.dtype))[..., :3]
    ray = seeds[:, :, None] + imvote
    ray = ray / torch.sqrt((ray ** 2).sum(-1, keepdim=True) + 1e-8)
    sxz = seeds[..., [0, 2]][:, :, None]
    xz = ray[..., [0, 2]] / (ray[..., 1:2] + 1e-8) * \
        seeds[:, :, None, 1:2] - sxz
    geo = torch.cat([xz, ray], -1)                              # (B,S,M,5)
    onehot = cls[..., None] == torch.arange(num_classes, device=cls.device)
    sem = (onehot.to(conf.dtype) * conf[..., None])[:, None].expand(
        geo.shape[:3] + (num_classes,))
    cues = torch.cat([geo, sem.to(geo.dtype)], -1) * in_box[..., None]

    score = in_box.float() + (conf * valid)[:, None]
    _, top = highest_k(score, min(max_per, score.shape[-1]))
    cues = torch.gather(cues, 2, top[..., None].expand(
        top.shape + cues.shape[-1:]))
    mask = torch.gather(in_box, 2, top)
    cues = cues * mask[..., None]

    ui = torch.clamp(torch.round(uv[..., 0]), 0, w - 1).to(torch.int32)
    vi = torch.clamp(torch.round(uv[..., 1]), 0, h - 1).to(torch.int32)
    bi = torch.arange(b, device=img.device)[:, None]
    # x / 255 as XLA computes it: times the float32 reciprocal
    txt = img[bi, vi.long(), ui.long()].float() * (1.0 / 255.0)
    return cues, txt, mask


class VoteTower(nn.Module):
    """Vote -> FPS cluster -> proposal head, VoteNet's trunk on a given
    per-seed feature set (JAX's `_VoteTower`; keys `vote0`, `vote1`,
    `vote_out`, `skip`, `prop0`, `prop1`, `head_out`)."""

    def __init__(self, cfg, cin):
        super().__init__()
        self.cfg = cfg
        self.vote0 = Linear(cin, 256)
        self.vote1 = Linear(256, 256)
        self.vote_out = Linear(256, 3 + 256)
        self.skip = Linear(cin, 256)
        self.prop0 = Linear(3 + 256, 128)
        self.prop1 = Linear(128, 128)
        self.head_out = Linear(128, 2 + 3 + cfg.num_classes * 3 +
                               cfg.num_heading_bins * 2 + cfg.num_classes)

    def votes(self, seed_xyz, seed_f):
        x = F.relu(self.vote1(F.relu(self.vote0(seed_f))))
        v = self.vote_out(x)
        return seed_xyz + v[..., :3], self.skip(seed_f) + v[..., 3:]

    def proposals(self, vote_xyz, vote_f):
        """-> (centres (B, P, 3), raw (B, P, R) float32)."""
        cfg = self.cfg
        cidx = farthest_point_sample(vote_xyz, cfg.num_proposals)
        centers = gather_points(vote_xyz, cidx)
        g = ball_group(vote_xyz, vote_f, centers, cfg.vote_radius, cfg.vote_k)
        agg = F.relu(self.prop1(F.relu(self.prop0(g)))).amax(2)
        return centers, self.head_out(agg).float()

    def forward(self, seed_xyz, seed_f):
        vote_xyz, vote_f = self.votes(seed_xyz, seed_f)
        centers, raw = self.proposals(vote_xyz, vote_f)
        return dict(seed_xyz=seed_xyz, vote_xyz=vote_xyz, centers=centers,
                    raw=raw)


class ImVoteNet(nn.Module):
    """`point_channels`: 3 + the points' features (4: x, y, z and SUN
    RGB-D's height)."""

    def __init__(self, cfg=None, dtype=torch.float32, point_channels=4):
        super().__init__()
        cfg = cfg or ImVoteNetConfig()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = PointNet2SASSG(point_channels, dtype=dtype)
        c = self.backbone.out_channels
        if cfg.with_img_branch:
            self.img_backbone = LIGAResNet(
                depth=cfg.img_backbone_depth, strides=(1, 2, 2, 2),
                dilations=(1, 1, 1, 1), num_channels_factor=(1, 2, 4, 8),
                out_indices=(1, 2, 3), with_max_pool=True)
            self.img_neck = FPN(self.img_backbone.out_channels[1:], 64, 5)
            self.img_bbox_head = ATSS2DHead(img_atss_config(cfg))
        self.img_mlp = Linear(5 + cfg.num_classes + 3, cfg.img_feat_dim)
        self.joint = VoteTower(cfg, c + cfg.img_feat_dim)
        self.pts = VoteTower(cfg, c)
        self.img = VoteTower(cfg, cfg.img_feat_dim)

    def forward_train(self, points, cond, gt, generator=None,
                      depth_pix_idx=None):
        """`cond` = (img, bboxes_2d, depth2img); the forward pass and
        `imvotenet_loss` on gt's 'gt_boxes' (B, G, 7), 'gt_labels',
        'gt_mask' (and, for the 2D loss, 'gt_bboxes2d', 'centers2d',
        'img_hw') -> (total, dict of terms); `generator` / `depth_pix_idx`
        (TrainStep's) are not read."""
        return imvotenet_loss(self(points, None, *cond), gt, self.cfg)

    def image_branch(self, img):
        """(B, H, W, 3) 0-255 -> (the ATSS level outputs, the decoded
        (B, img_max_boxes, 6) float32 boxes)."""
        cfg = self.cfg
        x = img.permute(0, 3, 1, 2).to(self.dtype)
        outs = self.img_bbox_head(self.img_neck(self.img_backbone(x)))
        return outs, atss2d_decode(outs, tuple(img.shape[1:3]),
                                   img_atss_config(cfg), cfg.img_max_boxes)

    def image_features(self, seed_xyz, bboxes_2d, img, depth2img):
        """The seeds' fused image features (B, S, img_feat_dim)."""
        cfg = self.cfg
        cues, txt, mask = vote_fusion_cues(seed_xyz, bboxes_2d, img,
                                           depth2img, cfg.num_classes,
                                           cfg.max_imvote_per_pixel)
        cue = torch.where(mask[..., None], cues,
                          torch.full_like(cues, -torch.inf)).amax(2)
        cue = torch.where(torch.isfinite(cue), cue, torch.zeros_like(cue))
        feat = torch.cat([cue, txt.to(cue.dtype)], -1).to(self.dtype)
        return F.relu(self.img_mlp(feat))

    def forward(self, points, point_mask, img, bboxes_2d, depth2img):
        """points (B, N, 3+C) (`point_mask` is not read), img (B, H, W, 3)
        0-255, bboxes_2d (B, M, 6) (not read with the image branch),
        depth2img (B, 3|4, 4) -> dict of the towers' outputs 'joint',
        'pts', 'img' (and 'outs_2d', the 2D head's, when the branch
        trains)."""
        cfg = self.cfg
        with record_function('imvotenet.backbone'):
            seed_xyz, seed_f = self.backbone(points.to(self.dtype))
        outs_2d = None
        if cfg.with_img_branch:
            with record_function('imvotenet.img_branch'):
                outs_2d, bboxes_2d = self.image_branch(img)
                if cfg.freeze_img_branch:
                    bboxes_2d, outs_2d = bboxes_2d.detach(), None
        with record_function('imvotenet.fusion'):
            img_feat = self.image_features(seed_xyz, bboxes_2d, img,
                                           depth2img)
        with record_function('imvotenet.towers'):
            towers = dict(
                joint=self.joint(seed_xyz, torch.cat([seed_f, img_feat], -1)),
                pts=self.pts(seed_xyz, seed_f),
                img=self.img(seed_xyz, img_feat))
        if outs_2d is not None:
            towers['outs_2d'] = outs_2d
        return towers


def imvotenet_loss(outputs, gt, cfg: ImVoteNetConfig):
    """The towers' `votenet_loss` weighted by `loss_weights` (each term
    '{tower}_{term}' x its weight), plus the ATSS 2D loss x
    `img_loss_weight` when the outputs hold 'outs_2d' and gt
    'gt_bboxes2d' -> (total, dict of terms)."""
    total = 0.0
    losses = {}
    for w, name in zip(cfg.loss_weights, ('joint', 'pts', 'img')):
        t, parts = votenet_loss(outputs[name], gt, cfg)
        total = total + w * t
        for k, v in parts.items():
            losses[f'{name}_{k}'] = v * w
    if 'outs_2d' in outputs and 'gt_bboxes2d' in gt:
        hw = tuple(int(x) for x in gt['img_hw'])
        for k, v in atss2d_loss(outputs['outs_2d'], hw, gt,
                                img_atss_config(cfg)).items():
            losses[k] = v * cfg.img_loss_weight
            total = total + losses[k]
    return total, losses


def imvotenet_predict(outputs, cfg: ImVoteNetConfig):
    """The joint tower's `votenet_predict`."""
    return votenet_predict(outputs['joint'], cfg)
