"""PointNet++ set abstraction and feature propagation.

Port of `dfm_tpu/models/backbones/pointnet2.py:23-150` (reference mmcv's
CUDA furthest_point_sample / ball_query / grouping / three_nn /
three_interpolate and mmdet3d's point_sa_module / point_fp_module), the
JAX package's static-shape forms, batched over (B, ...) tensors:

* `farthest_point_sample`: from index 0, running minima of the squared
  distance to the chosen points (from +inf), the next point the first
  maximum; a loop of `npoint` - 1 steps on the whole batch;
* `ball_group`: per centre the `k` nearest points within `radius`
  (and at or past `min_radius`: the dilated query of the MSG stages),
  ranked by squared distance with ties to the lower index, as
  `lax.top_k` ranks them; an empty slot takes the nearest point; the
  group's coordinates relative to the centre, then its features;
* `SAModule`: FPS -> ball group -> a shared MLP (`Linear` + flax-style
  BatchNorm over every axis but the channel + ReLU) -> max over the
  group;
* `three_interpolate`: inverse squared-distance weights of the 3
  nearest source points (ties to the lower index), normalised;
* `FPModule`: that interpolation, the skip features before it, a shared
  MLP;
* `PointNet2SASSG`: VoteNet's stack of four `SAModule`s (`sa{i}`) and
  JAX's FP decoder (`fp_channels`, `fp{j}`: GroupFree3D's two steps back
  up the pyramid); `return_hierarchy` comes with the segmentors.

`lowest_k` gives `lax.top_k(-x, k)`'s indices (ascending, ties to the
lower index) for any size: `torch.topk` promises no order among ties.
Point sets are channels-last, (B, N, C).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNormLast, Linear

__all__ = ['lowest_k', 'highest_k', 'farthest_point_sample', 'ball_group',
           'three_interpolate', 'gather_points', 'SAModule', 'FPModule',
           'PointNet2SASSG']


def lowest_k(x, k):
    """Indices (..., k) of the k smallest entries of `x` along its last
    axis, ascending, equal values in index order: `lax.top_k(-x, k)`'s.
    The k-th smallest value by `torch.topk`, then every entry below it
    and the first ones equal to it, in index order, sorted stably."""
    n = x.shape[-1]
    kth = torch.topk(x, k, dim=-1, largest=False).values[..., -1:]
    less = x < kth
    eq = x == kth
    need = k - less.sum(-1, keepdim=True, dtype=torch.int32)
    take = less | (eq & (torch.cumsum(eq, -1, dtype=torch.int32) <= need))
    slot = torch.cumsum(take, -1, dtype=torch.int32) - 1
    cols = torch.zeros(x.shape[:-1] + (k + 1,), dtype=torch.long,
                       device=x.device)
    cols.scatter_(-1, torch.where(take, slot, k).long(),
                  torch.arange(n, device=x.device).expand(x.shape))
    cols = cols[..., :k]
    order = torch.sort(torch.gather(x, -1, cols), dim=-1, stable=True)[1]
    return torch.gather(cols, -1, order)


def highest_k(x, k):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index: `lax.top_k(x, k)`."""
    idx = lowest_k(-x, k)
    return torch.gather(x, -1, idx), idx


def _sq_dist(a, b):
    """Squared distances (..., N) of points `a` (..., 1|N, D) from `b`
    (..., N|1, D), the D terms summed in order (D = 3 on the hot paths)."""
    d = a - b
    if d.shape[-1] > 3:
        return (d * d).sum(-1)
    out = d[..., 0] * d[..., 0]
    for j in range(1, d.shape[-1]):
        out = out + d[..., j] * d[..., j]
    return out


def gather_points(x, idx):
    """x (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def farthest_point_sample(xyz, npoint):
    """(B, N, D) points -> (B, npoint) indices (int64), from index 0."""
    b, n, _ = xyz.shape
    dists = torch.full((b, n), torch.inf, dtype=xyz.dtype,
                       device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.long, device=xyz.device)
    last = torch.zeros((b, 1), dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = _sq_dist(xyz, gather_points(xyz, last))
        dists = torch.minimum(dists, d)
        last = torch.argmax(dists, -1, keepdim=True)
        idx[:, i:i + 1] = last
    return idx


def ball_group(xyz, feats, centers, radius, k, min_radius=0.0):
    """xyz (B, N, 3), feats (B, N, C) or None, centers (B, M, 3) -> (B, M,
    k, 3 + C): up to `k` points within `radius` of each centre (at least
    `min_radius` from it where > 0), nearest first; a slot without one
    repeats the centre's nearest point; coordinates relative to the
    centre."""
    d2 = _sq_dist(centers[:, :, None, :], xyz[:, None, :, :])   # (B, M, N)
    r2 = torch.tensor(radius ** 2, dtype=d2.dtype, device=d2.device)
    in_ball = d2 <= r2
    if min_radius > 0:
        in_ball &= d2 >= torch.tensor(min_radius ** 2, dtype=d2.dtype,
                                      device=d2.device)
    masked = torch.where(in_ball, d2, torch.full_like(d2, torch.inf))
    kk = min(k, xyz.shape[1])
    nbr = lowest_k(masked, kk)
    if kk < k:                     # tiny clouds: repeat the last slot
        nbr = torch.cat([nbr, nbr[..., -1:].expand(
            nbr.shape[:-1] + (k - kk,))], -1)
    valid = torch.gather(masked, -1, nbr) < torch.inf
    nearest = torch.argmin(d2, -1, keepdim=True)
    nbr = torch.where(valid, nbr, nearest)
    parts = [gather_points(xyz, nbr) - centers[:, :, None, :]]
    if feats is not None:
        parts.append(gather_points(feats, nbr))
    return torch.cat(parts, -1)


def three_interpolate(src_xyz, src_feats, dst_xyz, eps=1e-8):
    """src_xyz (B, S, 3), src_feats (B, S, C), dst_xyz (B, N, 3) -> (B, N,
    C): the 3 nearest sources' features by inverse squared distance."""
    d2 = _sq_dist(dst_xyz[:, :, None, :], src_xyz[:, None, :, :])  # (B,N,S)
    idx = lowest_k(d2, min(3, src_xyz.shape[1]))
    w = 1.0 / (torch.gather(d2, -1, idx) + eps)
    w = w / w.sum(-1, keepdim=True)
    return (gather_points(src_feats, idx) * w[..., None]).sum(2)


def _mlp_layers(owner, cin, widths, prefix, bn_prefix):
    """Register `Linear` `{prefix}{i}` and `BatchNormLast` `{bn_prefix}{i}`
    on `owner`; -> their names."""
    names = []
    for i, ch in enumerate(widths):
        setattr(owner, f'{prefix}{i}', Linear(cin, ch))
        setattr(owner, f'{bn_prefix}{i}', BatchNormLast(ch))
        names.append((f'{prefix}{i}', f'{bn_prefix}{i}'))
        cin = ch
    return names


def _run_mlp(owner, names, x):
    for m, b in names:
        x = F.relu(getattr(owner, b)(getattr(owner, m)(x)))
    return x


class SAModule(nn.Module):
    """Single-scale set abstraction; `cin` = 3 + the features' channels.
    Keys `mlp{i}`, `bn{i}`."""

    def __init__(self, npoint, radius, k, mlp, cin, dtype=torch.float32):
        super().__init__()
        self.npoint, self.radius, self.k = npoint, radius, k
        self.dtype = dtype
        self.layers = _mlp_layers(self, cin, mlp, 'mlp', 'bn')

    def forward(self, xyz, feats):
        """xyz (B, N, 3), feats (B, N, C) or None -> (new_xyz (B, M, 3),
        pooled (B, M, C'))."""
        idx = farthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, idx)
        g = ball_group(xyz, feats, new_xyz, self.radius, self.k)
        x = _run_mlp(self, self.layers, g.to(self.dtype))
        return new_xyz, x.amax(2)


class FPModule(nn.Module):
    """Feature propagation; `cin` = the skip features' channels + the
    interpolated ones. Keys `mlp{i}`, `bn{i}`."""

    def __init__(self, mlp, cin, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = _mlp_layers(self, cin, mlp, 'mlp', 'bn')

    def forward(self, dst_xyz, dst_feats, src_xyz, src_feats):
        interp = three_interpolate(src_xyz, src_feats, dst_xyz)
        x = interp if dst_feats is None else \
            torch.cat([dst_feats, interp.to(dst_feats.dtype)], -1)
        return _run_mlp(self, self.layers, x.to(self.dtype))


class PointNet2SASSG(nn.Module):
    """The SSG stack (VoteNet's defaults: four levels); `point_channels` =
    3 + the points' features. forward(points (B, N, 3+C)) -> (seed_xyz
    (B, M, 3), seed_feats (B, M, C')) of the last level, or with
    `fp_channels` of the FP level len(fp_channels) steps up from it: step
    j (`fp{j}`) interpolates onto level len(levels) - 2 - j (level 0 the
    input points) and takes that level's features as its skip."""

    def __init__(self, point_channels=3, sa_points=(2048, 1024, 512, 256),
                 sa_radii=(0.2, 0.4, 0.8, 1.2), sa_ks=(64, 32, 16, 16),
                 sa_mlps=((64, 64, 128), (128, 128, 256), (128, 128, 256),
                          (128, 128, 256)), fp_channels=(),
                 dtype=torch.float32):
        super().__init__()
        self.num_levels = len(sa_points)
        self.num_fp = len(fp_channels)
        cin = point_channels
        level_channels = [point_channels - 3]
        for i in range(self.num_levels):
            setattr(self, f'sa{i}', SAModule(sa_points[i], sa_radii[i],
                                             sa_ks[i], sa_mlps[i], cin,
                                             dtype))
            cin = 3 + sa_mlps[i][-1]
            level_channels.append(sa_mlps[i][-1])
        src = level_channels[-1]
        for j, mlp in enumerate(fp_channels):
            dst = self.num_levels - 1 - j
            setattr(self, f'fp{j}', FPModule(tuple(mlp),
                                             level_channels[dst] + src, dtype))
            src = mlp[-1]
        self.out_channels = src

    def forward(self, points):
        xyz = points[..., :3]
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        sa_xyz, sa_feats = [xyz], [feats]
        for i in range(self.num_levels):
            xyz, feats = getattr(self, f'sa{i}')(xyz, feats)
            sa_xyz.append(xyz)
            sa_feats.append(feats)
        for j in range(self.num_fp):
            dst = len(sa_xyz) - 2 - j
            feats = getattr(self, f'fp{j}')(sa_xyz[dst], sa_feats[dst], xyz,
                                            feats)
            xyz = sa_xyz[dst]
        return xyz, feats
