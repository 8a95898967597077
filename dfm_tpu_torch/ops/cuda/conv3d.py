"""Wrappers of K9a and K9b, CUDA C++ for sm_90a (csrc/conv3d.cu).

| wrapper        | kernel source  | replaces (TPU)                           |
| `conv3d_stats` | csrc/conv3d.cu | ops/pallas/convgn.py:conv3d_zpack (:162) |
| `conv3d`       | csrc/conv3d.cu | ops/pallas/conv3d.py:conv3d_pallas (:119) |

`conv3d_stats` launches `dfm_conv3d_tc` (the wmma tensor-core code of
csrc/conv_wmma.cuh, K4's first design, on dense tensors) for bfloat16
with C = C_out = 32,
the DfM trunk width, and `dfm_conv3d_direct` with moments for every other
width and type. `conv3d` takes the route `tensor_core_chunks` gives:
`dfm_conv3d_wgmma` (csrc/conv_dense.cuh, `wgmma` + TMA) for bfloat16
with C % 8 == 0 and C_out % 8 == 0, else `dfm_conv3d_direct`.

On a CPU tensor a wrapper returns its plain PyTorch version
(`ops/convgn.py`, `ops/conv3d.py`). On a CUDA tensor it checks device,
dtype, shape and contiguity, allocates the outputs, launches on the
current stream, raises if the launch reports an error, and adds one to
its count in `LAUNCHES` (the table shared with `sampling.py`). There is
no fallback. Both take float32 or bfloat16 volumes (D, H, W, C), any
D, H, W, C, C_out >= 1 (K9a: D % 4 == 0 and H % th == 0, as in JAX),
weight (C_out, C, 3, 3, 3) of any floating type, rounded to x's type.
"""

import math

import torch
import torch.nn.functional as F

from ..conv3d import conv3d_plain
from ..convgn import check_zpack_shape, conv3d_zpack_plain, fold_row_partials
from .build import load
from .conv_chain import _sm_count, _z_chunk, blocked_weight, \
    cached_wgmma_weight
from .sampling import _DTYPES, LAUNCHES, _check, _on_cpu, _raise_on, _stream

__all__ = ['conv3d_stats', 'conv3d', 'tensor_core_chunks']

WMMA_TILE = (16, 32)   # (rows, columns) a block of dfm_conv3d_tc owns
ROW_TILE = 32     # columns per moment tile of both kernels (csrc TX, kDTX)
CHUNK_IN = 8      # input channels per shared-memory chunk (csrc kCK)

# csrc/conv_dense.cuh: the widths of its wgmma (output channels a launch
# writes; a width of 64 would need 128 accumulators a thread, past the 168
# registers each of 288 threads can have) and the shared memory of a
# block: a ring of `RING` slots of one (10 x 66)-voxel input slice (an
# octet plane of 10,624 bytes each), the weights (27 x koct x n x 16
# bytes), the barriers
WGMMA_WIDTHS = (32, 16, 8)
OCT_PLANE = 10624
MAX_SMEM = 232448
RING = (3, 4)     # fewest slots the kernel runs with, most it takes


def _koct(c):
    """Octet planes of K9b's slots for C input channels: whole k16 steps,
    the padding octet zero (TMA's fill, zero weights)."""
    return -(-c // 16) * 2


def _wgmma_ring(koct, n):
    """Slots of K9b's ring for `koct` input octets and n output channels
    (csrc k9::ring_slots): the most, up to RING[1], that fit."""
    for r in range(RING[1], 0, -1):
        if r * koct * OCT_PLANE + 27 * koct * n * 16 + (2 * r + 1) * 8 \
                <= MAX_SMEM:
            return r
    return 0


def tensor_core_chunks(dtype, c, c_out):
    """K9b's route: the output-channel chunks (each a launch of the
    `wgmma` code, widest first) for bfloat16 with C % 8 == 0 and
    C_out % 8 == 0, every chunk's weights fitting shared memory beside a
    ring of at least three input slices; None for the direct kernel
    (float32, whose products the tensor cores would round to TF32, and
    every other width)."""
    if dtype != torch.bfloat16 or c % 8 or c_out % 8:
        return None
    koct = _koct(c)
    chunks, left = [], c_out
    while left:
        n = next((n for n in WGMMA_WIDTHS
                  if n <= left and _wgmma_ring(koct, n) >= RING[0]), None)
        if n is None:
            return None
        chunks.append(n)
        left -= n
    return chunks


def _check_conv(x, weight):
    _check(x, 'x', 4, _DTYPES)
    if weight.dim() != 5 or tuple(weight.shape[1:]) != (x.shape[-1], 3, 3, 3) \
            or not weight.is_floating_point():
        raise ValueError(f'weight: expected (C_out, {x.shape[-1]}, 3, 3, 3) '
                         f'floating, got {tuple(weight.shape)} {weight.dtype}')
    if x.numel() == 0 or weight.shape[0] == 0:
        raise ValueError(f'empty conv: x {tuple(x.shape)}, weight '
                         f'{tuple(weight.shape)}')


def _out_chunk(c_out):
    """Output channels per block of the direct kernel (its COC)."""
    return 8 if c_out <= 8 else 16 if c_out <= 16 else 32


def direct_weight(weight, dtype, coc):
    """(C_out, C, 3, 3, 3) -> (C_out chunks, 27, Cp, coc) float32 with the
    values of `dtype`, zero-padded to Cp = C rounded up to 8 and to whole
    chunks of `coc` output channels; tap = (dz * 3 + dy) * 3 + dx."""
    c_out, c = weight.shape[:2]
    cp = -(-c // CHUNK_IN) * CHUNK_IN
    chunks = -(-c_out // coc)
    w = weight.to(dtype).float().permute(2, 3, 4, 1, 0).reshape(27, c, c_out)
    w = F.pad(w, (0, chunks * coc - c_out, 0, cp - c))
    return w.reshape(27, cp, chunks, coc).permute(2, 0, 1, 3).contiguous()


def _direct(x, weight, ps):
    d, h, w, c = x.shape
    c_out = weight.shape[0]
    coc = _out_chunk(c_out)
    out = torch.empty((d, h, w, c_out), dtype=x.dtype, device=x.device)
    wt = direct_weight(weight, x.dtype, coc)
    rc = load('conv3d').dfm_conv3d_direct(
        x.data_ptr(), wt.data_ptr(), out.data_ptr(),
        None if ps is None else ps.data_ptr(), d, h, w, c, c_out, coc,
        _DTYPES[x.dtype], _stream())
    return out, rc


def conv3d_stats(x, weight, th=8):
    """K9a. 3x3x3 stride-1 'same' conv of x (D, H, W, C) float32/bf16,
    D % 4 == 0, H % th == 0, f32 accumulation. Returns (out (D, H, W,
    C_out) in x's type, partials (D//4, H//th, 2, 4 C_out) float32: per 4
    slices and th rows the per-channel sum and sum of squares of the
    unrounded result, lane j * C_out + co for slice 4k + j)."""
    if _on_cpu(x, weight):
        return conv3d_zpack_plain(x, weight, th)
    _check_conv(x, weight)
    check_zpack_shape(x, th)
    d, h, w, c = x.shape
    c_out = weight.shape[0]
    dev = x.device
    tiles_x = math.ceil(w / ROW_TILE)
    rows = torch.empty((d, h, tiles_x, 2, c_out), dtype=torch.float32,
                       device=dev)
    if x.dtype == torch.bfloat16 and c == c_out == 32:
        if x.data_ptr() % 16:
            raise ValueError('x must start on 16 bytes')
        tiles = math.ceil(h / WMMA_TILE[0]) * tiles_x
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out = torch.empty_like(x)
        wt = blocked_weight(weight)
        rc = load('conv3d').dfm_conv3d_tc(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), rows.data_ptr(), d,
            h, w, tiles, _z_chunk(d, tiles, sms), _stream())
    else:
        out, rc = _direct(x, weight, rows)
    _raise_on(rc, 'conv3d_zpack')
    LAUNCHES['conv3d_zpack'] += 1
    return out, fold_row_partials(rows, th)


def conv3d(x, weight):
    """K9b. 3x3x3 stride-1 'same' conv of x (D, H, W, C) float32/bf16,
    f32 accumulation -> (D, H, W, C_out) in x's type. The route is
    chosen by type and shape (`tensor_core_chunks`): bfloat16 with
    C % 8 == 0 and C_out % 8 == 0 (weights that fit shared memory beside
    a ring of three slices) runs the `wgmma` + TMA code, one launch per
    chunk of at most 32 output channels; float32 and every other width
    the direct kernel (exact f32 products)."""
    if _on_cpu(x, weight):
        return conv3d_plain(x, weight)
    _check_conv(x, weight)
    d, h, w, c = x.shape
    c_out = weight.shape[0]
    chunks = tensor_core_chunks(x.dtype, c, c_out)
    if chunks is None:
        out, rc = _direct(x, weight, None)
        _raise_on(rc, 'conv3d_pallas')
    else:
        if x.data_ptr() % 16:
            raise ValueError('x must start on 16 bytes (a TMA tensor map)')
        out = torch.empty((d, h, w, c_out), dtype=x.dtype, device=x.device)
        koct = _koct(c)
        co0 = 0
        for n in chunks:
            wt = cached_wgmma_weight(weight[co0:co0 + n], koct)
            rc = load('conv3d').dfm_conv3d_wgmma(
                x.data_ptr(), wt.data_ptr(), out.data_ptr(), d, h, w, c,
                c_out, co0, n, _sm_count(x.device), _stream())
            _raise_on(rc, 'conv3d_pallas')
            co0 += n
    LAUNCHES['conv3d_pallas'] += 1
    return out
