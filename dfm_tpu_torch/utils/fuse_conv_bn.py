"""Fold eval-mode BatchNorm into the convolution before it.

The port's counterpart of `dfm_tpu/utils/fuse_conv_bn.py` (the
reference's tools/misc/fuse_conv_bn.py, mmcv `fuse_conv_bn`), for
`tools.test --fuse-conv-bn`: y = BN(conv(x) + b) with the running
statistics is the convolution of weight w * f and bias (b - mean) * f +
beta, f = gamma / sqrt(var + eps), computed in float64 and stored in
float32; the BatchNorm becomes `nn.Identity`, so inference runs one
convolution (with its bias) where it ran two passes.

The pairs are found by name, whatever the module's type (the JAX
function pairs `Conv_<i>` with `BatchNorm_<i>` the same way): a
BatchNorm child named `...bn<suffix>` of a module folds into its sibling
`...conv<suffix>` (`bn1` / `conv1`, ConvNorm's `bn` / `conv`, DfMNeck's
`mono_final_bn` / `mono_final_conv`, EdgeFusion's `edge_bn` /
`edge_conv`), else into `...dcn<suffix>` (the DLA neck's DCNv2 `dcn` /
`bn`), and a BatchNorm at index k of an `nn.Sequential` into its child
k - 1 (`convbn`, a downsample branch, a DLA Tree's `project`). The
convolution is any module with a `weight` of 3 or more dimensions and a
`bias` attribute (None or a tensor: a 1D conv, a `DeformConv2d`, whose
offset conv keeps its own bias); a transposed convolution's weight
(I, O, k...) scales along dim 1 (`ConvTranspose`, detected by
`transposed`). A BatchNorm with no such sibling is left as it is. The
fold is for inference only: after it the model has no BatchNorm state to
train or to load a checkpoint into.

The fold is right only where every use of a folded conv adds its new
bias. The port's conv modules do (`models/layers.py:conv_bias`), and so
must any code that reads a conv's `weight` directly (DfMNeck's and
OutdoorImVoxelNeck's stride-(2, 1, 1) downsamples pass
`conv_bias(conv, x)`); tests/test_torch_fuse_conv_bn.py holds the fused
forward of every ported BatchNorm model to the unfused one.
"""

import torch
import torch.nn as nn

from ..models.layers import BatchNorm

__all__ = ['fuse_conv_bn', 'fold_pair', 'EPS']

EPS = 1e-5


def _partner(parent, name):
    """The conv-like sibling of BatchNorm child `name` of `parent`, or
    None."""
    if isinstance(parent, nn.Sequential) and name.isdigit():
        cand = parent[int(name) - 1] if int(name) > 0 else None
    else:
        i = name.rfind('bn')
        cand = None
        for conv in ('conv', 'dcn'):
            if cand is None and i >= 0:
                cand = getattr(parent, name[:i] + conv + name[i + 2:], None)
    w = getattr(cand, 'weight', None)
    if cand is None or not torch.is_tensor(w) or w.dim() < 3 or \
            not hasattr(cand, 'bias'):
        return None
    return cand


@torch.no_grad()
def fold_pair(conv, bn):
    """Fold `bn`'s running statistics and affine into `conv` in place:
    the new weight and bias (float64 math, the parameters' dtype)."""
    f = bn.weight.double() / torch.sqrt(bn.running_var.double() + EPS)
    w = conv.weight
    axis = 1 if getattr(conv, 'transposed', False) else 0
    shape = [1] * w.dim()
    shape[axis] = -1
    w.copy_((w.double() * f.view(shape)).to(w.dtype))
    b = conv.bias.double() if conv.bias is not None else torch.zeros_like(f)
    bias = (b - bn.running_mean.double()) * f + bn.bias.double()
    conv.bias = nn.Parameter(bias.to(w.dtype), requires_grad=False)


def fuse_conv_bn(model):
    """Fold every (conv, BatchNorm) pair of `model` (module, in eval mode)
    in place; returns the number folded. A model without BatchNorm (DfM's
    GroupNorm trunks) is left as it is."""
    if model.training:
        raise ValueError('fuse_conv_bn folds the running statistics: put '
                         'the model in eval mode first')
    pairs = []
    for parent in model.modules():
        for name, child in parent.named_children():
            if isinstance(child, BatchNorm):
                conv = _partner(parent, name)
                if conv is not None:
                    pairs.append((parent, name, conv, child))
    for parent, name, conv, bn in pairs:
        fold_pair(conv, bn)
        setattr(parent, name, nn.Identity())
    return len(pairs)
