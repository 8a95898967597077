"""FrustumToVoxel neck, KITTI (separable-camera) path.

Port of `dfm_tpu/models/necks/frustum_to_voxel.py:72-146, 248-277`:
lift the stereo volume into the pseudo-lidar voxel grid, weight the
sampled 2D semantic features by the depth-softmax attention (K3) and
concat them along channels, all three in one kernel (K2 fused, as the
JAX package's `_fused` cond computes them), then the voxel ConvNorm and
an average pool over z. The stages run in `record_function` spans
`dfm.frustum_to_voxel.{uv, softmax_volume, attention, voxel_features,
voxel_convnorm, pool}`.

Only the configuration DfM-KITTI uses is ported (sem_atten_feat,
cat_img_feature, no stereo attention, one voxel conv). The generic
gather path for arbitrary projections (multi-view Waymo,
`ops/frustum.py`) is not ported yet.
"""

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..layers import ConvNorm
from ...ops import frustum_separable as FS
from ...ops.cuda.sampling import attention_sample, \
    frustum_voxel_features


class FrustumToVoxel(nn.Module):
    pool_z = 4                # AvgPool3d((4, 1, 1)) over z

    def __init__(self, in_channels=64, out_channels=32, depth_min=2.0,
                 depth_max=59.6, up_factor=4):
        super().__init__()
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.up_factor = up_factor
        self.voxel_convs = nn.ModuleList([nn.Sequential(
            ConvNorm(in_channels, out_channels, 3, ndim=3))])

    def forward(self, stereo_vol, depth_cost, sem_feat, coors_3d, cam2img,
                pad_shape):
        """
        Args:
            stereo_vol: (B, D, H', W', Cv) stereo features.
            depth_cost: (B, D, H', W') fused depth cost.
            sem_feat: (B, Hs, Ws, Cs) semantic features.
            coors_3d: (Nz, Ny, Nx, 3) numpy pseudo-lidar voxel centres.
            cam2img: (B, 4, 4) augmented intrinsics.
            pad_shape: (pad_h, pad_w) of the input image.

        Returns:
            (B, Nz / pool_z, Ny, Nx, C_out) voxel features.
        """
        span = 'dfm.frustum_to_voxel.'
        with record_function(span + 'uv'):
            coors_3d = np.asarray(coors_3d)
            xs = coors_3d[0, 0, :, 0]
            ys = coors_3d[0, :, 0, 1]
            zs = coors_3d[:, 0, 0, 2]
            u, v = FS.slab_uv(cam2img, xs, ys, zs)
            d = stereo_vol.shape[1]
            ds = FS.slab_depth_static(xs, self.depth_min, self.depth_max, d)
            dsf = FS.slab_depth_static(xs, self.depth_min, self.depth_max,
                                       d * self.up_factor)
        with record_function(span + 'softmax_volume'), torch.no_grad():
            # the attention takes no gradient to the cost: JAX's
            # stop_gradient (`dfm_tpu/models/necks/frustum_to_voxel.py:95,
            # 189`); built outside the graph, the volume is freed below
            sm = FS.build_fine_softmax_volume(depth_cost.detach(),
                                              self.up_factor, pad_shape,
                                              stereo_vol.dtype)
        with record_function(span + 'attention'):
            att = attention_sample(sm, u, v, dsf, pad_shape)
            del sm                                   # 236 MB at DfM-KITTI
        with record_function(span + 'voxel_features'):
            # K2 fused: stereo sample, sem sample x attention, concat
            vol = frustum_voxel_features(
                stereo_vol.contiguous(), sem_feat.contiguous(), att, u, v,
                ds, pad_shape)                       # (B, Nz, Ny, Nx, C)
        with record_function(span + 'voxel_convnorm'):
            x = vol.permute(0, 4, 1, 2, 3)
            for conv in self.voxel_convs:
                x = conv(x)
        with record_function(span + 'pool'):
            b, c, nz, ny, nx = x.shape
            x = x.reshape(b, c, nz // self.pool_z, self.pool_z, ny,
                          nx).mean(3)
            return x.permute(0, 2, 3, 4, 1)
