"""The 3x3x3 stride-1 'same' Conv3D of a dense volume (K9b).

Port of `dfm_tpu/ops/pallas/conv3d.py:conv3d_pallas`: x (D, H, W, C),
weight in the port's layout (C_out, C, 3, 3, 3) (`utils/weights.py:
torch_conv_weight` turns the JAX (3, 3, 3, C, C_out) kernel into it),
torch's symmetric zero padding of one voxel, the weights rounded to x's
type, products and sums in float32, the result rounded to x's type. The
TPU kernel's dx-in-lanes packing, its D % 8, H % th and 3 C <= 128 tiling
conditions do not carry over: any D, H, W, C, C_out >= 1 in float32 or
bfloat16. The entry point is the kernel's wrapper
`ops/cuda/conv3d.py:conv3d`: the kernel on CUDA tensors, the plain
version below on CPU tensors.
"""

import torch.nn.functional as F

__all__ = ['conv3d_f32', 'conv3d_plain']


def conv3d_f32(x, weight):
    """The float32 result before its rounding: (D, H, W, C_out)."""
    w = weight.to(x.dtype).float()
    y = F.conv3d(x.float().permute(3, 0, 1, 2)[None], w, padding=1)[0]
    return y.permute(1, 2, 3, 0)


def conv3d_plain(x, weight):
    """Plain version of K9b: (D, H, W, C_out) contiguous in x's type."""
    return conv3d_f32(x, weight).to(x.dtype).contiguous()

