"""Shared building blocks (NCHW / NCDHW, 2D and 3D).

Port of `dfm_tpu/models/layers.py:278-465`. Parameters are kept in
float32 and cast to the activation dtype at use, as the flax modules
do (`dtype` is the compute precision, parameters stay f32); norm
statistics are f32 (f64 in a float64 model, `stat_float`).

Module and attribute names follow the reference torch layout
(mmcv `ConvModule` `.conv`/`.gn`, `convbn` `Sequential(conv, norm)`,
hourglass `conv1..conv6`), so a `state_dict` of the port carries the
reference keys that `dfm_tpu/utils/checkpoint_import.py` maps.

The JAX package's TPU lowerings of the same convolutions
(`Conv3DSum`, `_wgroup_conv3d`, `grouped_convgn3d`, `Conv2D`,
`Conv2DStride2`, `ops/wfold.py`) compute plain conv (+ GN); the port
has only the plain form.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d
from ..ops.resize import resize_linear
from ..parallel import dist as D

__all__ = ['Conv', 'ConvTranspose', 'DeformConv2d', 'GroupNorm', 'BatchNorm',
           'ConvNorm', 'convbn', 'Hourglass', 'UpconvModule', 'group_norm',
           'gn_groups', 'stat_float', 'conv_bias']

_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def stat_float(x):
    """`x` in the statistics' precision: float32, or float64 for a
    float64 tensor (a model in `.double()`, the reference of the card's
    float32 rounding)."""
    return x if x.dtype == torch.float64 else x.float()


def gn_groups(c):
    """32 groups, or one per channel when C is not a multiple of 32 (the
    JAX `apply_norm` group rule)."""
    return 32 if c % 32 == 0 else c


def group_norm(x, weight, bias, groups):
    """GroupNorm with f32 (`stat_float`) statistics (var = E[x^2] -
    E[x]^2) applied as ONE folded per-(batch, channel) scale/bias, cast
    back to x.dtype (`dfm_tpu/models/layers.py:336-362`)."""
    b, c = x.shape[:2]
    xf = stat_float(x)
    flat = xf.reshape(b, groups, -1)
    mean = flat.mean(-1)
    var = (flat * flat).mean(-1) - mean * mean
    rstd = torch.rsqrt(var + 1e-5)                             # (B, g)
    sc = stat_float(weight).view(groups, c // groups) * rstd[..., None]
    bs = stat_float(bias).view(groups, c // groups) - mean[..., None] * sc
    shape = (b, c) + (1,) * (x.dim() - 2)
    return (xf * sc.reshape(shape) + bs.reshape(shape)).to(x.dtype)


def conv_bias(conv, x):
    """`conv`'s bias in x's dtype, or None. Every caller that reads a
    conv's `weight` directly passes this as its bias: a BatchNorm fold
    (`utils/fuse_conv_bn.py`) gives a conv without one a bias."""
    return None if conv.bias is None else conv.bias.to(x.dtype)


class Conv(nn.Module):
    """Conv1d / Conv2d / Conv3d (by `ndim`) whose f32 weight is cast to
    the input dtype at use. 'same' padding k//2 * dilation."""

    def __init__(self, cin, cout, k=3, stride=1, dilation=1, ndim=2,
                 bias=False):
        super().__init__()
        self.ndim = ndim
        self.stride = stride
        self.dilation = dilation
        self.padding = (k // 2) * dilation
        self.weight = nn.Parameter(torch.empty((cout, cin) + (k,) * ndim))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return _CONV_FNS[self.ndim](x, self.weight.to(x.dtype),
                                    conv_bias(self, x), self.stride,
                                    self.padding, self.dilation)


class ConvTranspose(nn.Module):
    """torch ConvTranspose{2,3}d(k3, s2, p1, output_padding 1): exact 2x
    upsample; the flax equivalent is padding (1, 2) per spatial dim
    (`layers.py:393-398`). Weight layout (I, O, k...); no bias until a
    BatchNorm fold gives it one."""

    transposed = True

    def __init__(self, cin, cout, ndim=2):
        super().__init__()
        self.ndim = ndim
        self.weight = nn.Parameter(torch.empty((cin, cout) + (3,) * ndim))
        self.bias = None

    def forward(self, x):
        fn = F.conv_transpose2d if self.ndim == 2 else F.conv_transpose3d
        return fn(x, self.weight.to(x.dtype), conv_bias(self, x), 2, 1, 1)


class DeformConv2d(nn.Module):
    """DCNv2 layer (`dfm_tpu/models/backbones/resnet.py:23-55`): a biased
    `conv_offset` (3K channels laid out [2K interleaved (dy, dx); K mask
    logits], initialised to zero by `utils/weights.py:init_weights`, as
    JAX does) at the layer's stride and dilation, then
    `ops/deform_conv.py:deform_conv2d` with the float32 (`stat_float`)
    offsets and the sigmoid of the mask logits. The main `weight` (C_out,
    C_in, k, k) has no bias until a BatchNorm fold gives it one
    (`conv_bias`)."""

    def __init__(self, cin, cout, k=3, stride=1, dilation=1):
        super().__init__()
        self.k, self.stride, self.dilation = k, stride, dilation
        self.conv_offset = Conv(cin, 3 * k * k, k, stride, dilation,
                                bias=True)
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = None

    def forward(self, x):
        kk = self.k * self.k
        off = stat_float(self.conv_offset(x))
        return deform_conv2d(x, off[:, :2 * kk],
                             torch.sigmoid(off[:, 2 * kk:]),
                             self.weight.to(x.dtype), self.stride,
                             self.dilation, conv_bias(self, x))


class GroupNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.groups = gn_groups(c)
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups)


class BatchNorm(nn.Module):
    """BatchNorm as flax's `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`,
    f32 math (`stat_float`: f64 for a f64 input), cast back to the input
    dtype.

    Eval mode (`self.training` False) applies the running statistics.
    Train mode normalises with the batch statistics over every axis but
    the channel one: the mean and flax's "fast" biased variance
    E[x^2] - E[x]^2 clipped at 0; then, outside the graph, it updates the
    running buffers the flax way, ra = 0.9 * ra + 0.1 * batch, with that
    biased variance (`F.batch_norm` would store the unbiased one).

    In a process group of several ranks (`parallel/dist.py`) the batch is
    the global one, as JAX's BatchNorm sees it on the sharded batch: each
    rank's float32 sums of x and x^2 and its count are all-reduced (in
    float64, the count exact) with a gradient, so every rank normalises
    with, and stores, the same moments. A group of one has nothing to
    combine and takes the moments as one process does.
    """

    momentum = 0.9

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer('running_mean', torch.empty(c))
        self.register_buffer('running_var', torch.empty(c))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            sc = stat_float(self.weight) * torch.rsqrt(
                stat_float(self.running_var) + 1e-5)
            bs = stat_float(self.bias) - stat_float(self.running_mean) * sc
            return (stat_float(x) * sc.view(shape) +
                    bs.view(shape)).to(x.dtype)
        xf = stat_float(x)
        dims = [0] + list(range(2, x.dim()))
        if D.world_size() > 1:
            c = xf.shape[1]
            count = torch.full((1,), xf.numel() // c, dtype=torch.float64,
                               device=xf.device)
            stats = D.sum_over_group(torch.cat([torch.cat([
                xf.sum(dims), (xf * xf).sum(dims)]).double(), count]))
            mean = (stats[:c] / stats[-1]).to(xf.dtype)
            var = ((stats[c:2 * c] / stats[-1]).to(xf.dtype) -
                   mean * mean).clamp(min=0.0)
        else:
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean +
                                    (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + 1e-5) * stat_float(self.weight)
        return ((xf - mean.view(shape)) * mul.view(shape) +
                stat_float(self.bias).view(shape)).to(x.dtype)


def _norm(norm, c):
    if norm == 'gn':
        return GroupNorm(c)
    if norm == 'bn':
        return BatchNorm(c)
    raise ValueError(norm)


class ConvNorm(nn.Module):
    """mmcv ConvModule: conv (+ bias) + norm (+ ReLU); keys `.conv`,
    `.gn`/`.bn`."""

    def __init__(self, cin, cout, k=3, ndim=2, norm='gn', act=True,
                 bias=False):
        super().__init__()
        self.conv = Conv(cin, cout, k, ndim=ndim, bias=bias)
        self.norm_name = norm
        setattr(self, norm, _norm(norm, cout))
        self.act = act

    def forward(self, x):
        x = getattr(self, self.norm_name)(self.conv(x))
        return F.relu(x) if self.act else x


def convbn(cin, cout, stride=1, ndim=2, norm='gn'):
    """Reference `convbn`/`convbn_3d`: Sequential(3x3 conv, norm)."""
    return nn.Sequential(Conv(cin, cout, 3, stride, ndim=ndim),
                         _norm(norm, cout))


class Hourglass(nn.Module):
    """Two stride-2 encoders, two transposed-conv decoders, skip add at
    1/2 scale (`layers.py:404-443` with presqu = postsqu = None).
    `norm` ('gn' or 'bn') throughout. Returns the full-resolution output
    (the caller adds its residual)."""

    def __init__(self, c, ndim=3, norm='gn'):
        super().__init__()
        c2 = 2 * c
        self.conv1 = nn.Sequential(convbn(c, c2, 2, ndim, norm), nn.ReLU())
        self.conv2 = convbn(c2, c2, ndim=ndim, norm=norm)
        self.conv3 = nn.Sequential(convbn(c2, c2, 2, ndim, norm), nn.ReLU())
        self.conv4 = nn.Sequential(convbn(c2, c2, ndim=ndim, norm=norm),
                                   nn.ReLU())
        self.conv5 = nn.Sequential(ConvTranspose(c2, c2, ndim),
                                   _norm(norm, c2))
        self.conv6 = nn.Sequential(ConvTranspose(c2, c, ndim),
                                   _norm(norm, c))

    def forward(self, x):
        pre = F.relu(self.conv2(self.conv1(x)))             # 1/2
        out = self.conv4(self.conv3(pre))                   # 1/4
        post = F.relu(self.conv5(out) + pre)                # 1/2
        return self.conv6(post)                             # 1/1


class UpconvModule(nn.Module):
    """LIGA upconv decoder: repeated [conv -> bilinear up
    (align_corners=False) -> add lateral -> ReLU]
    (`layers.py:446-465`). BatchNorm, as the reference hard-codes."""

    def __init__(self, in_channels, lateral_channels, up_channels):
        super().__init__()
        ins = [in_channels] + list(up_channels[:-1])
        self.conv = nn.ModuleList(
            [convbn(ci, co, norm='bn') for ci, co in zip(ins, up_channels)])
        self.redir = nn.ModuleList(
            [convbn(cl, co, norm='bn')
             for cl, co in zip(lateral_channels, up_channels)])

    def forward(self, feats):
        x = feats[0]
        for stage, (conv, redir) in enumerate(zip(self.conv, self.redir)):
            x = conv(x)
            lateral = redir(feats[stage + 1])
            up = resize_linear(x, lateral.shape[2:], dims=(2, 3),
                               align_corners=False)
            x = F.relu(up + lateral)
        return x
