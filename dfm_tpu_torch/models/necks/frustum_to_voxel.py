"""FrustumToVoxel neck: the KITTI separable-camera path and the generic
path for any projection.

Port of `dfm_tpu/models/necks/frustum_to_voxel.py:72-146, 207-277`: lift
the stereo volume into the pseudo-lidar voxel grid, weight the sampled 2D
semantic features by the depth-softmax attention and concat them along
channels, then the voxel ConvNorm and an average pool over z.

* Separable (`separable=True`, the default, as JAX's, with a static numpy
  `coors_3d`): the projection of a KITTI P-form camera splits by axis, and
  the attention (K3) and the fused voxel features (K2) run in CUDA
  kernels on the card, as JAX's `_fused` cond computes them. The stages
  run in `record_function` spans `dfm.frustum_to_voxel.{uv,
  softmax_volume, attention, voxel_features, voxel_convnorm, pool}`.
* Generic (`separable=False`, or a `coors_3d` tensor, as JAX takes its
  gather path for a traced one): each voxel centre is projected by the
  full cam2img and sampled by direct gathers (`ops/frustum.py`; the
  attention from the log-sum-exp map, without the x4 volume), in the
  span `dfm.frustum_to_voxel.generic`. No Pallas kernel lies on JAX's
  branch, so the plain PyTorch version is the port.

Only the configuration DfM-KITTI uses is ported (sem_atten_feat,
cat_img_feature, no stereo attention, one voxel conv).
"""

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..layers import ConvNorm
from ...ops import frustum_separable as FS
from ...ops.frustum import frustum_voxel_features_generic
from ...ops.cuda.sampling import attention_sample, \
    frustum_voxel_features


class FrustumToVoxel(nn.Module):
    pool_z = 4                # AvgPool3d((4, 1, 1)) over z

    def __init__(self, in_channels=64, out_channels=32, depth_min=2.0,
                 depth_max=59.6, up_factor=4, separable=True):
        super().__init__()
        self.separable = separable
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
            coors_3d: (Nz, Ny, Nx, 3) pseudo-lidar voxel centres, numpy
                (a tensor takes the generic path).
            cam2img: (B, 4, 4) augmented intrinsics.
            pad_shape: (pad_h, pad_w) of the input image.

        Returns:
            (B, Nz / pool_z, Ny, Nx, C_out) voxel features.
        """
        span = 'dfm.frustum_to_voxel.'
        if not self.separable or torch.is_tensor(coors_3d):
            with record_function(span + 'generic'):
                vol = frustum_voxel_features_generic(
                    stereo_vol, depth_cost, sem_feat, coors_3d, cam2img,
                    pad_shape, self.depth_min, self.depth_max,
                    self.up_factor)
            return self._convs_and_pool(vol, span)
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
        return self._convs_and_pool(vol, span)

    def _convs_and_pool(self, vol, span):
        with record_function(span + 'voxel_convnorm'):
            x = vol.permute(0, 4, 1, 2, 3)
            for conv in self.voxel_convs:
                x = conv(x)
        with record_function(span + 'pool'):
            b, c, nz, ny, nx = x.shape
            x = x.reshape(b, c, nz // self.pool_z, self.pool_z, ny,
                          nx).mean(3)
            return x.permute(0, 2, 3, 4, 1)
