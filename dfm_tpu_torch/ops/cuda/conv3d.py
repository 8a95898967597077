"""Wrappers of K9a and K9b, CUDA C++ for sm_90a (csrc/conv3d.cu).

| wrapper        | kernel source  | replaces (TPU)                           |
| `conv3d_stats` | csrc/conv3d.cu | ops/pallas/convgn.py:conv3d_zpack (:162) |
| `gn_finish`    | csrc/conv3d.cu | the finish of ops/pallas/convgn.py:conv3d_gn |
| `conv3d`       | csrc/conv3d.cu | ops/pallas/conv3d.py:conv3d_pallas (:119) |

`conv3d_stats` and `conv3d` take the route `tensor_core_chunks` gives:
`dfm_conv3d_wgmma` (csrc/conv_dense.cuh, `wgmma` + TMA; for
`conv3d_stats` its instance with the moments in the epilogue, per 64
columns) for bfloat16 with C % 8 == 0 and C_out % 8 == 0, one launch per
chunk of output channels, else `dfm_conv3d_direct` (moments per 32
columns). `gn_finish` is `conv3d_gn`'s finish in one pass
(`dfm_conv3d_gn_finish`).

On a CPU tensor a wrapper returns its plain PyTorch version
(`ops/convgn.py`, `ops/conv3d.py`). On a CUDA tensor it checks device,
dtype, shape and contiguity, allocates the outputs, launches on the
current stream, raises if the launch reports an error, and adds one to
its count in `LAUNCHES` (the table shared with `sampling.py`). There is
no fallback. The convs take float32 or bfloat16 volumes (D, H, W, C),
any D, H, W, C, C_out >= 1 (K9a: D % 4 == 0 and H % th == 0, as in JAX),
weight (C_out, C, 3, 3, 3) of any floating type, rounded to x's type.
"""

import math

import torch
import torch.nn.functional as F

from ..conv3d import conv3d_plain
from ..convgn import check_zpack_shape, conv3d_zpack_plain, \
    fold_row_partials, gn_finish_plain
from .build import load
from .conv_chain import _sm_count, cached_wgmma_weight, wgmma_weight
from .sampling import _DTYPES, LAUNCHES, _check, _on_cpu, _raise_on, _stream

__all__ = ['conv3d_stats', 'gn_finish', 'conv3d', 'tensor_core_chunks',
           'stats_route', 'chunk_weights']

ROW_TILE = 32     # columns per moment tile of the direct kernel (csrc kDTX)
CHUNK_IN = 8      # input channels per shared-memory chunk (csrc kCK)

# csrc/conv_dense.cuh: its output tile (rows, columns; K9a's moments are
# per 64 columns), the widths of its wgmma (output channels a launch
# writes; a width of 64 would need 128 accumulators a thread, past the 168
# registers each of 288 threads can have) and the shared memory of a
# block: a ring of `RING` slots of one (10 x 66)-voxel input slice (an
# octet plane of 10,624 bytes each), the weights (27 x koct x n x 16
# bytes), K9a's moment buffer (RED_BYTES per output channel), the
# barriers
DENSE_TILE = (8, 64)
WGMMA_WIDTHS = (32, 16, 8)
OCT_PLANE = 10624
MAX_SMEM = 232448
RING = (3, 4)     # fewest slots the kernel runs with, most it takes
RED_BYTES = 128


def _koct(c):
    """Octet planes of K9b's slots for C input channels: whole k16 steps,
    the padding octet zero (TMA's fill, zero weights)."""
    return -(-c // 16) * 2


def _wgmma_ring(koct, n, moments=False):
    """Slots of the ring of conv_dense.cuh for `koct` input octets, n
    output channels and, for K9a, the moment buffer (csrc
    k9::ring_slots): the most, up to RING[1], that fit."""
    for r in range(RING[1], 0, -1):
        if r * koct * OCT_PLANE + 27 * koct * n * 16 \
                + moments * RED_BYTES * n + (2 * r + 1) * 8 <= MAX_SMEM:
            return r
    return 0


def tensor_core_chunks(dtype, c, c_out, moments=False):
    """The route of K9b (and, with `moments`, of K9a): the output-channel
    chunks (each a launch of the `wgmma` code, widest first) for bfloat16
    with C % 8 == 0 and C_out % 8 == 0, every chunk's weights (and
    moment buffer) fitting shared memory beside a ring of at least three
    input slices; None for the direct kernel (float32, whose products the
    tensor cores would round to TF32, and every other width)."""
    if dtype != torch.bfloat16 or c % 8 or c_out % 8:
        return None
    koct = _koct(c)
    chunks, left = [], c_out
    while left:
        n = next((n for n in WGMMA_WIDTHS
                  if n <= left and _wgmma_ring(koct, n, moments) >= RING[0]),
                 None)
        if n is None:
            return None
        chunks.append(n)
        left -= n
    return chunks


def stats_route(dtype, c, c_out):
    """K9a's route: (the `wgmma` chunks or None for the direct kernel,
    columns per moment tile of that code)."""
    chunks = tensor_core_chunks(dtype, c, c_out, moments=True)
    return chunks, ROW_TILE if chunks is None else DENSE_TILE[1]


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


def chunk_weights(weight, chunks, koct, cache=True):
    """The `wgmma` layouts of `weight`'s output-channel chunks, from
    `cached_wgmma_weight`'s table, or with `cache=False` laid out for
    this call only (a weight made for one call, which the table could
    never find again)."""
    lay = cached_wgmma_weight if cache else \
        (lambda w, k: wgmma_weight(w, koct=k))
    starts = [sum(chunks[:i]) for i in range(len(chunks))]
    return [lay(weight[co0:co0 + n], koct) for co0, n in zip(starts, chunks)]


def _wgmma(x, weight, chunks, ps, cache=True):
    """One launch of conv_dense.cuh per output-channel chunk; ps (the
    moments, K9a) or None (K9b). Returns (out, the first failing rc or
    0)."""
    if x.data_ptr() % 16:
        raise ValueError('x must start on 16 bytes (a TMA tensor map)')
    d, h, w, c = x.shape
    c_out = weight.shape[0]
    out = torch.empty((d, h, w, c_out), dtype=x.dtype, device=x.device)
    co0 = 0
    for n, wt in zip(chunks, chunk_weights(weight, chunks, _koct(c), cache)):
        rc = load('conv3d').dfm_conv3d_wgmma(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(),
            None if ps is None else ps.data_ptr(), d, h, w, c, c_out, co0, n,
            _sm_count(x.device), _stream())
        if rc:
            return out, rc
        co0 += n
    return out, 0


def conv3d_stats(x, weight, th=8, cache_weight=True):
    """K9a. 3x3x3 stride-1 'same' conv of x (D, H, W, C) float32/bf16,
    D % 4 == 0, H % th == 0, f32 accumulation. Returns (out (D, H, W,
    C_out) in x's type, partials (D//4, H//th, 2, 4 C_out) float32: per 4
    slices and th rows the per-channel sum and sum of squares of the
    unrounded result, lane j * C_out + co for slice 4k + j). The route
    is `stats_route`'s: the moment instance of the `wgmma` code for
    bfloat16 with C, C_out % 8 == 0, else the direct kernel.
    `cache_weight=False` lays a weight made for this call out without
    keeping its layout (`chunk_weights`)."""
    if _on_cpu(x, weight):
        return conv3d_zpack_plain(x, weight, th)
    _check_conv(x, weight)
    check_zpack_shape(x, th)
    d, h, w, c = x.shape
    c_out = weight.shape[0]
    chunks, cols = stats_route(x.dtype, c, c_out)
    rows = torch.empty((d, h, math.ceil(w / cols), 2, c_out),
                       dtype=torch.float32, device=x.device)
    if chunks is None:
        out, rc = _direct(x, weight, rows)
    else:
        out, rc = _wgmma(x, weight, chunks, rows, cache_weight)
    _raise_on(rc, 'conv3d_zpack')
    LAUNCHES['conv3d_zpack'] += 1
    return out, fold_row_partials(rows, th)


def gn_finish(out, sc, bs, residual=None, relu=False):
    """`conv3d_gn`'s finish in one pass: [relu](out * sc + bs
    [+ residual]) of out (..., C) float32/bf16, sc, bs (C,) float32,
    residual like out or None -> out's shape and type, the plain
    version's bits (`gn_finish_plain`)."""
    ts = (out, sc, bs) + (() if residual is None else (residual,))
    if _on_cpu(*ts):
        return gn_finish_plain(out, sc, bs, residual, relu)
    if out.dtype not in _DTYPES or not out.is_contiguous() or out.dim() < 1:
        raise TypeError(f'out: float32 / bfloat16 contiguous, got '
                        f'{out.dtype} {tuple(out.shape)}')
    c = out.shape[-1]
    for name, t in (('sc', sc), ('bs', bs)):
        _check(t, name, 1, (torch.float32,))
        if t.shape[0] != c:
            raise ValueError(f'{name}: expected ({c},), got {tuple(t.shape)}')
    if residual is not None and (residual.shape != out.shape
                                 or residual.dtype != out.dtype
                                 or not residual.is_contiguous()):
        raise ValueError(f'residual: expected {tuple(out.shape)} '
                         f'{out.dtype} contiguous, got '
                         f'{tuple(residual.shape)} {residual.dtype}')
    y = torch.empty_like(out)
    vec = 16 // out.element_size()
    if c % vec or any(t.data_ptr() % 16 for t in (out, residual, y)
                      if t is not None):
        vec = 1
    rc = load('conv3d').dfm_conv3d_gn_finish(
        out.data_ptr(), sc.data_ptr(), bs.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        out.numel(), c, vec, int(relu), _DTYPES[out.dtype], _stream())
    _raise_on(rc, 'conv3d_gn_finish')
    LAUNCHES['conv3d_gn_finish'] += 1
    return y


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
    chunks = tensor_core_chunks(x.dtype, x.shape[-1], weight.shape[0])
    if chunks is None:
        out, rc = _direct(x, weight, None)
    else:
        out, rc = _wgmma(x, weight, chunks, None)
    _raise_on(rc, 'conv3d_pallas')
    LAUNCHES['conv3d_pallas'] += 1
    return out
