"""PointNet++ with multi-scale grouping (MSG) and fusion sampling.

Port of `dfm_tpu/models/backbones/pointnet2_msg.py:30-182` (reference
mmdet3d pointnet2_sa_msg.py:13-175 and mmcv's Points_Sampler /
PointSAModuleMSG): per stage the centres by a fusion of D-FPS (FPS on
xyz), F-FPS (FPS on [xyz, features]) and 'FS' (both, F-FPS first), each
mode on its slice of the points (`fps_ranges`: each mode's end,
exclusive, -1 to the end), or given centres (`target_xyz`: 3DSSD's vote
aggregation), then per radius a ball group (with `dilated`, from the
previous radius on), a shared MLP and a max, the radii's features
concatenated and, with `aggregation`, a `Linear` + BatchNorm + ReLU. Keys
`mlp{i}_{j}`, `bn{i}_{j}`, `aggregation`, `aggregation_bn`; the stack's
stages `sa{s}`. Channels-last.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import BatchNormLast, Linear
from .pointnet2 import (_mlp_layers, _run_mlp, ball_group,
                        farthest_point_sample, gather_points)

__all__ = ['sample_centers', 'SAModuleMSG', 'PointNet2SAMSG']


def _fps_feature(xyz, feats, npoint):
    """F-FPS: FPS in the concatenated [xyz, feats] space."""
    space = xyz if feats is None else torch.cat([xyz, feats.to(xyz.dtype)],
                                                -1)
    return farthest_point_sample(space, npoint)


def sample_centers(xyz, feats, fps_mods, fps_ranges, npoints):
    """Fusion sampling: xyz (B, N, 3), feats (B, N, C) or None -> (B, M)
    indices into the points (M the modes' total; 'FS' gives 2 x its
    count)."""
    n = xyz.shape[1]
    out, start = [], 0
    for mod, rng_end, npoint in zip(fps_mods, fps_ranges, npoints):
        end = n if rng_end == -1 else min(rng_end, n)
        sub_xyz = xyz[:, start:end]
        sub_feats = None if feats is None else feats[:, start:end]
        if mod == 'D-FPS':
            out.append(farthest_point_sample(sub_xyz, npoint) + start)
        elif mod == 'F-FPS':
            out.append(_fps_feature(sub_xyz, sub_feats, npoint) + start)
        elif mod == 'FS':
            out.append(_fps_feature(sub_xyz, sub_feats, npoint) + start)
            out.append(farthest_point_sample(sub_xyz, npoint) + start)
        else:
            raise ValueError(f'unknown fps mod {mod!r}')
        start = end
    return torch.cat(out, 1)


class SAModuleMSG(nn.Module):
    """`cin` = 3 + the features' channels."""

    def __init__(self, npoints, radii, ks, mlps, cin, fps_mods=('D-FPS',),
                 fps_ranges=(-1,), aggregation=None, dilated=True,
                 dtype=torch.float32):
        super().__init__()
        self.npoints, self.radii, self.ks = tuple(npoints), radii, ks
        self.fps_mods, self.fps_ranges = tuple(fps_mods), tuple(fps_ranges)
        self.dilated = dilated
        self.dtype = dtype
        self.layers = [_mlp_layers(self, cin, mlp, f'mlp{i}_', f'bn{i}_')
                       for i, mlp in enumerate(mlps)]
        width = sum(m[-1] for m in mlps)
        self.aggregation = None
        if aggregation is not None:
            self.aggregation = Linear(width, aggregation)
            self.aggregation_bn = BatchNormLast(aggregation)
            width = aggregation
        self.out_channels = width

    def forward(self, xyz, feats, target_xyz=None):
        """xyz (B, N, 3), feats (B, N, C) or None -> (new_xyz (B, M, 3),
        features (B, M, C'), idx (B, M)). With `target_xyz` (B, M, 3) the
        groups form around those centres, nothing is sampled and idx is
        zeros (JAX's `target_xyz` path)."""
        if target_xyz is None:
            idx = sample_centers(xyz, feats, self.fps_mods, self.fps_ranges,
                                 self.npoints)
            new_xyz = gather_points(xyz, idx)
        else:
            idx = torch.zeros(target_xyz.shape[:2], dtype=torch.long,
                              device=xyz.device)
            new_xyz = target_xyz
        scale_feats = []
        for i, (radius, k) in enumerate(zip(self.radii, self.ks)):
            min_r = self.radii[i - 1] if self.dilated and i > 0 else 0.0
            g = ball_group(xyz, feats, new_xyz, radius, k, min_radius=min_r)
            x = _run_mlp(self, self.layers[i], g.to(self.dtype))
            scale_feats.append(x.amax(2))
        out = torch.cat(scale_feats, -1)
        if self.aggregation is not None:
            out = F.relu(self.aggregation_bn(self.aggregation(out)))
        return new_xyz, out, idx


class PointNet2SAMSG(nn.Module):
    """The MSG stack (3DSSD's fusion-sampling defaults); `point_channels`
    = 3 + the points' features. forward(points (B, N, 3+C)) ->
    dict(sa_xyz, sa_features, sa_indices), lists per stage, entry 0 the
    input points (features None without any)."""

    def __init__(self, point_channels=3,
                 num_points=((4096,), (512,), (256, 256)),
                 radii=((0.2, 0.4, 0.8), (0.4, 0.8, 1.6), (1.6, 3.2, 4.8)),
                 num_samples=((32, 32, 64), (32, 32, 64), (32, 32, 32)),
                 sa_channels=(((16, 16, 32), (16, 16, 32), (32, 32, 64)),
                              ((64, 64, 128), (64, 64, 128), (64, 96, 128)),
                              ((128, 128, 256), (128, 192, 256),
                               (128, 256, 256))),
                 aggregation_channels=(64, 128, 256),
                 fps_mods=(('D-FPS',), ('FS',), ('F-FPS', 'D-FPS')),
                 fps_ranges=((-1,), (-1,), (512, -1)),
                 dtype=torch.float32):
        super().__init__()
        self.num_stages = len(num_points)
        cin = point_channels
        self.out_channels = [point_channels - 3]
        for s in range(self.num_stages):
            sa = SAModuleMSG(num_points[s], radii[s], num_samples[s],
                             sa_channels[s], cin, fps_mods[s], fps_ranges[s],
                             aggregation=aggregation_channels[s],
                             dtype=dtype)
            setattr(self, f'sa{s}', sa)
            self.out_channels.append(sa.out_channels)
            cin = 3 + sa.out_channels

    def forward(self, points):
        xyz = points[..., :3]
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        b, n = xyz.shape[:2]
        indices = torch.arange(n, device=points.device).expand(b, n)
        sa_xyz, sa_feats, sa_idx = [xyz], [feats], [indices]
        for s in range(self.num_stages):
            xyz, feats, idx = getattr(self, f'sa{s}')(xyz, feats)
            sa_xyz.append(xyz)
            sa_feats.append(feats)
            sa_idx.append(torch.gather(sa_idx[-1], 1, idx))
        return dict(sa_xyz=sa_xyz, sa_features=sa_feats, sa_indices=sa_idx)
