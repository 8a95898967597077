"""The host-side helpers and the index arithmetic of the Hopper designs
of K3 `attention_sample`, K4 `conv_p2p`, K5 `conv_s2_p2d` and K9b
`conv3d`, on the CPU.

The CUDA kernels run only on the card (`tests/test_torch_kernels.py`,
`cuda` marker). Here numpy models replay what each kernel does with its
shared-memory images, descriptors, tables and registers, step for step
as the sources describe it, and are held against the plain versions:

* K4 (`csrc/conv_p2p.cuh`): the ring slot a TMA box fills
  ([octet][row][column][8 ch], zeros outside the stored tensor, 128-byte
  plane stride), the no-swizzle K-major descriptor walk over 27 taps x 2
  k-steps for A (slices) and B (`wgmma_weight`), the accumulator
  fragment of m64n32, the residual from the centre slot, the quad
  transpose before the 16-byte stores, the persistent grid's shares and
  the ring's load / release protocol. float64 sums of bf16-valued
  operands against the plain version in float32: atol 1e-4.
* K5 (`csrc/hourglass_chain.cu`, namespace k5): the parity-split boxes
  (element stride 2 on W, 65 columns from 2 x0 + parity, 32 channels,
  TMA's 64-byte swizzle read back through the swizzled descriptor), the
  descriptor start of every (dy, dx) tap, the odd / even
  order of the stored slices with its two accumulator sets, the m64n64
  fragment, the epilogue's chunks and stores, the per-(slice, tile)
  moments, and the ring protocol: against `conv_s2_plain`.
* K9b (`csrc/conv_dense.cuh`): dense boxes that start at -1 with TMA's
  zero fill (a padding octet for an odd number of octets), the N-generic
  B layout and m64nN fragment, the epilogue's chunk enumeration over
  the quad transpose, ragged last tiles and output-channel chunks:
  against `conv3d_plain`; and the route (`tensor_core_chunks`).
* K3 (`csrc/frustum_sample.cu`): `depth_xtab`, the per-block row
  tables it stages (against `_voxel_taps` and the depth tables) and the
  separable gather in float32, rounded as the kernel rounds: the plain
  version's bits.
* K2 fused (`csrc/frustum_sample.cu`, `voxel_features_kernel`): the
  per-x stereo and sem row tables it stages and the per-(x, y) column
  taps (against `_voxel_taps` and the depth tables), the gather rounded
  as the kernel rounds (float32 and bf16, Cs = 32 and 16: the plain
  version's bits), the warp roles and the lane-to-chunk map of a voxel's
  output row, and the coverage of ragged tiles.
* K1 sweep (`csrc/warp_prev.cu`): the blocks' pixels, the points each
  lane computes from the block's parameter row and passes by shuffle,
  rounded as the kernel rounds (against `sweep_coords_plain`, bit for
  bit), and the bilinear sum (against `warp_prev_plain`, bit for bit).
* K2-bwd and K1-bwd, the gathers of the training step: at chip_smoke.py
  phase 7 (b)'s geometry, K2-bwd's plane lists (from the depth table), the
  z each warp walks and the y masks of each tile (with the multiply's
  superset of them) add every (voxel, tap) of nonzero weight exactly once,
  and K1-bwd's candidate boxes (the homography inverted in float64) hold
  every (pixel, tap) of nonzero weight of its tile; both walks emulated in
  float32 (K2 on a camera-like grid, K1 at the `aug_b2` sweep with its
  flip) against the plain gradients.
"""

import numpy as np
import pytest
import torch

from dfm_tpu_torch.ops import conv3d as C3
from dfm_tpu_torch.ops import conv_chain as CC
from dfm_tpu_torch.ops import cost_volume as PCV
from dfm_tpu_torch.ops import frustum_separable as PFS
from dfm_tpu_torch.ops.cuda import conv3d as KC3
from dfm_tpu_torch.ops.cuda import conv_chain as KC
from dfm_tpu_torch.ops.cuda import sampling as K

torch.set_num_threads(1)    # from import on; the workers share the cores

# K4's constants (csrc/conv_p2p.cuh)
TY, TX = KC.TILE
SY, SX = TY + 2, TX + 2
OCT = -(-SY * SX * 16 // 128) * 128      # bytes of an octet plane, padded
RING = 4


# ---------------------------------------------------------------- K4

def test_wgmma_weight_layout():
    """[tap][k octet][n][k 8] of weight[n, k, dz, dy, dx], rounded to
    bf16 by default."""
    w = torch.arange(32 * 32 * 27, dtype=torch.float32).reshape(
        32, 32, 3, 3, 3)
    g = KC.wgmma_weight(w, torch.float32)
    assert g.shape == (27, 4, 32, 8) and g.is_contiguous()
    taps = torch.arange(27)
    for k in range(32):
        for n in (0, 5, 31):
            assert torch.equal(g[:, k // 8, n, k % 8],
                               w[n, k].reshape(27)[taps])
    wb = torch.randn(32, 32, 3, 3, 3)
    assert KC.wgmma_weight(wb).dtype == torch.bfloat16
    assert torch.equal(KC.wgmma_weight(wb).float(),
                       KC.wgmma_weight(wb.to(torch.bfloat16).float(),
                                       torch.float32))


def _slot(chain, s, y0, x0):
    """The ring slot the producer's four TMA boxes fill for stored slice
    s of the tile at (y0, x0): octet plane c8 at c8 * OCT bytes, each
    [row SY][column SX][8 channels]; zeros outside the stored tensor."""
    _, hp, wp, _ = chain.shape
    box = np.zeros((SY, SX, 32))
    ny, nx = min(SY, hp - y0), min(SX, wp - x0)
    box[:ny, :nx] = chain[s, y0:y0 + ny, x0:x0 + nx]
    img = np.zeros(4 * OCT // 2)
    for c8 in range(4):
        plane = box[..., 8 * c8:8 * c8 + 8].reshape(-1)
        img[c8 * OCT // 2:c8 * OCT // 2 + plane.size] = plane
    return img


def _kmajor(img, start, lbo, sbo, rows):
    """rows x 16 operand that a no-swizzle K-major descriptor (byte start,
    LBO, SBO) gives wgmma: core matrices of 8 rows x 16 bytes."""
    i = np.arange(rows)[:, None]
    j = np.arange(16)[None, :]
    addr = start + (i // 8) * sbo + (i % 8) * 16 + (j // 8) * lbo \
        + (j % 8) * 2
    return img[addr // 2]


def _quad_transpose(p):
    """csrc quad_transpose on the 32 lanes of a warp: p (32, 4)."""
    p = p.copy()
    lane = np.arange(32)
    q = lane & 3
    hi, odd = (q & 2) > 0, (q & 1) > 0

    def shfl(v, k):
        return v[lane ^ k]

    r0 = shfl(np.where(hi, p[:, 0], p[:, 2]), 2)
    r1 = shfl(np.where(hi, p[:, 1], p[:, 3]), 2)
    p[:, 0] = np.where(hi, r0, p[:, 0])
    p[:, 1] = np.where(hi, r1, p[:, 1])
    p[:, 2] = np.where(hi, p[:, 2], r0)
    p[:, 3] = np.where(hi, p[:, 3], r1)
    r0 = shfl(np.where(odd, p[:, 0], p[:, 1]), 1)
    r1 = shfl(np.where(odd, p[:, 2], p[:, 3]), 1)
    p[:, 0] = np.where(odd, r0, p[:, 0])
    p[:, 2] = np.where(odd, r1, p[:, 2])
    p[:, 1] = np.where(odd, p[:, 1], r0)
    p[:, 3] = np.where(odd, p[:, 3], r1)
    return p


def test_quad_transpose_gives_each_lane_its_octet():
    """Before: lane (g8, q) holds pair j = channels (8j + 2q, +1) of its
    voxel; after: pair j = channels (8q + 2j, +1), i.e. octet q."""
    lane = np.arange(32)
    g8, q = lane >> 2, lane & 3
    j = np.arange(4)
    before = (g8[:, None] * 100 + 8 * j[None] + 2 * q[:, None])
    after = _quad_transpose(before)
    assert np.array_equal(after,
                          g8[:, None] * 100 + 8 * q[:, None] + 2 * j[None])


def _emulate_k4(chain, wimg, residual):
    """K4 on a chain tensor (float64 numpy), one (tile, slice) work item
    after the other: returns the stored chain tensor and ps (D, T, 2,
    32)."""
    dp, hp, wp, _ = chain.shape
    d, h, w = dp - 2, hp - 2, wp - 2
    tiles_x, tiles_y = -(-w // TX), -(-h // TY)
    out = np.zeros_like(chain)
    ps = np.zeros((d, tiles_x * tiles_y, 2, 32))
    lane = np.arange(32)
    q, g8 = lane & 3, lane >> 2
    for tile in range(tiles_x * tiles_y):
        y0, x0 = tile // tiles_x * TY, tile % tiles_x * TX
        for o in range(d):
            slots = [_slot(chain, o + dz, y0, x0) for dz in range(3)]
            for wg in range(2):
                for m in range(4):
                    r = 4 * wg + m
                    acc = np.zeros((64, 32))
                    for tap in range(27):
                        dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
                        for ks in range(2):
                            a = _kmajor(slots[dz], ks * 2 * OCT
                                        + ((r + dy) * SX + dx) * 16,
                                        OCT, 128, 64)
                            b = _kmajor(wimg, tap * 2048 + ks * 1024, 512,
                                        128, 32)
                            acc += a @ b.T
                    for wq in range(4):
                        # the m64n32 accumulator fragment of warp wq
                        i = np.arange(16)[None]
                        row = 16 * wq + g8[:, None] + 8 * ((i >> 1) & 1)
                        ch = 8 * (i >> 2) + 2 * q[:, None] + (i & 1)
                        reg = acc[row, ch]                       # (32, 16)
                        for hh in range(2):
                            col = 16 * wq + g8 + 8 * hh
                            # v[:, 2j + e]: channel 8j + 2q + e
                            v = np.stack([reg[:, 4 * (jj // 2) + 2 * hh
                                              + jj % 2]
                                          for jj in range(8)], 1)
                            if residual:
                                cen = slots[1].reshape(4, -1)[
                                    :, :SY * SX * 8].reshape(4, SY, SX, 8)
                                v = v + np.stack([
                                    cen[jj // 2, r + 1, col + 1,
                                        2 * q + jj % 2]
                                    for jj in range(8)], 1)
                            y, x = y0 + r, x0 + col
                            ok = (y < h) & (x < w)
                            for jj in range(8):
                                c = 8 * (jj // 2) + 2 * q + jj % 2
                                np.add.at(ps[o, tile, 0], c, v[:, jj] * ok)
                                np.add.at(ps[o, tile, 1], c,
                                          v[:, jj] ** 2 * ok)
                            # bf16 pairs by id (lane, j), transposed, and
                            # each lane's 16 bytes stored at octet q
                            pairs = v.reshape(32 * 4, 2)
                            ids = _quad_transpose(
                                np.arange(32)[:, None] * 4 + np.arange(4))
                            for ln in np.nonzero(ok)[0]:
                                out[o + 1, y + 1, x[ln] + 1,
                                    8 * q[ln]:8 * q[ln] + 8] = \
                                    pairs[ids[ln]].reshape(8)
    return out, ps


@pytest.mark.parametrize('residual', [False, True])
def test_k4_descriptor_walk_is_the_conv(residual):
    """The emulated kernel (slots, descriptors, fragment, epilogue) on a
    volume with ragged tiles in H and W against `conv_p2p_plain`."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 9, 66, 32).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    k = torch.from_numpy((rng.randn(32, 32, 3, 3, 3) * 0.1).astype(
        np.float32)).to(torch.bfloat16).float()
    cv = CC.pack_vol_plain(x)
    wimg = KC.wgmma_weight(k, torch.float32).reshape(-1).double().numpy()
    out, ps = _emulate_k4(cv.data.double().numpy(), wimg, residual)
    want, wps = CC.conv_p2p_plain(cv, k, residual)
    np.testing.assert_allclose(out, want.data.numpy(), atol=1e-4, rtol=0)
    assert ps.shape == (2, 4, 2, 32)
    np.testing.assert_allclose(ps.sum(1), wps.sum(1).numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize('d,tiles,grid', [(72, 50, 132), (44, 50, 132),
                                          (7, 4, 132), (13, 12, 132),
                                          (5, 3, 2)])
def test_k4_shares_and_ring_protocol(d, tiles, grid):
    """The persistent grid's shares cover every (tile, slice) once; in
    each block the producer's loads and the consumers' waits and
    releases follow the ring: every load released once, after its last
    use, and no slot refilled while a consumer may still read it."""
    units = tiles * d
    grid = min(grid, units)
    seen = np.zeros(units, int)
    for blk in range(grid):
        begin, end = blk * units // grid, (blk + 1) * units // grid
        loads = []                       # (tile, stored slice) per load
        uses, releases = [], []          # per output slice / load index
        u, load = begin, 0
        while u < end:
            tile, z0 = divmod(u, d)
            n = min(d - z0, end - u)
            loads += [(tile, s) for s in range(z0, z0 + n + 2)]
            for i in range(n):
                o, l0 = z0 + i, load + i
                seen[tile * d + o] += 1
                assert [loads[l0 + dz] for dz in range(3)] == [
                    (tile, o + dz) for dz in range(3)]
                uses.append((l0, l0 + 2))
                releases.append(l0)
                if i == n - 1:
                    releases += [l0 + 1, l0 + 2]
            load += n + 2
            u += n
        assert sorted(releases) == list(range(len(loads)))
        # load L may only be issued once load L - RING was released, and
        # that release must come after every use of L - RING
        order = {l: i for i, l in enumerate(releases)}
        for first, last in uses:
            for l in range(first, last + 1):
                if l >= RING:
                    assert order[l - RING] <= order.get(l, len(releases))
    assert (seen == 1).all()


@pytest.mark.parametrize('d,h,w,grid', [(3, 5, 7, 4), (7, 13, 70, 28),
                                        (2, 1, 1, 2), (4, 6, 9, 132)])
def test_k4_border_shares_cover_the_border(d, h, w, grid):
    """zero_border_share: the idle producer lanes of all blocks (31 a
    block) write every 16-byte chunk of the output's zero border once,
    and nothing of its interior."""
    hp, wp = h + 2, w + 2
    rows, lanes = (d + 2) * hp, 31
    hits = np.zeros((d + 2, hp, wp * 4), int)
    for blk in range(grid):
        for row in range(blk * rows // grid, (blk + 1) * rows // grid):
            pz, py = divmod(row, hp)
            for lane in range(lanes):
                if pz in (0, d + 1) or py in (0, h + 1):
                    hits[pz, py, lane:wp * 4:lanes] += 1
                elif lane < 8:
                    hits[pz, py, (0 if lane < 4 else (w + 1) * 4)
                         + (lane & 3)] += 1
    hits = hits.reshape(d + 2, hp, wp, 4)
    border = np.ones((d + 2, hp, wp), bool)
    border[1:-1, 1:-1, 1:-1] = False
    assert (hits[border] == 1).all() and (hits[~border] == 0).all()


def _fragment(acc, wq):
    """The m64nN accumulator fragment of warp wq (rows 16 wq ..): (32
    lanes, N / 2) with accumulator i at row 16 wq + g8 + 8 ((i >> 1) &
    1), column 8 (i >> 2) + 2 q + (i & 1)."""
    n = acc.shape[1]
    lane = np.arange(32)
    q, g8 = lane & 3, lane >> 2
    i = np.arange(n // 2)[None]
    row = 16 * wq + g8[:, None] + 8 * ((i >> 1) & 1)
    ch = 8 * (i >> 2) + 2 * q[:, None] + (i & 1)
    return acc[row, ch]


def _chunk_stores(groups):
    """The quad transpose of the epilogues: `groups` (G, 32, 4, 2) holds
    per group of four chunks, per lane, the bf16 pair of chunk k at
    [g, lane, k]. Returns (G, 32, 8): the 16-byte chunk lane (g8, q)
    stores, chunk 4 g + q of its thread group."""
    ids = _quad_transpose(np.arange(32)[:, None] * 4 + np.arange(4))
    out = []
    for grp in groups:
        pairs = grp.reshape(32 * 4, 2)
        out.append(pairs[ids].reshape(32, 8))
    return np.stack(out)


# ---------------------------------------------------------------- K5

S2_TY, S2_TX = KC.TILE_S2
S2_SY, S2_SXP = 2 * S2_TY + 1, S2_TX + 1
S2_BOX = S2_SY * S2_SXP * 64                       # bytes of a parity's box
S2_SLOT = -(-S2_BOX // 1024) * 1024
S2_RING = 5


def _sw64(addr):
    """TMA's and wgmma's 64-byte swizzle of a shared-memory byte address:
    bits 4-5 XOR bits 7-8."""
    return addr ^ (((addr >> 7) & 3) << 4)


def _s2_slot(chain, s, p, y0, x0):
    """The ring slot of column parity p of stored slice s: one TMA box of
    all 32 channels, stored rows 2 y0 .. 2 y0 + 4, columns 2 x0 + p + 2 t
    (element stride 2 on W), [row][column][64 bytes] with the 64-byte
    swizzle (the slot starts on 1024 bytes); zeros outside the tensor."""
    _, hp, wp, _ = chain.shape
    rows = 2 * y0 + np.arange(S2_SY)
    cols = 2 * x0 + p + 2 * np.arange(S2_SXP)
    box = np.zeros((S2_SY, S2_SXP, 32))
    ry, rx = rows < hp, cols < wp
    box[np.ix_(ry, rx)] = chain[s][np.ix_(rows[ry], cols[rx])]
    logical = np.arange(S2_BOX // 2) * 2                   # byte addresses
    img = np.zeros(S2_SLOT // 2)
    img[_sw64(logical) // 2] = box.reshape(-1)
    return img


def _kmajor_sw64(img, start, rows):
    """rows x 16 operand of a 64-byte-swizzle K-major descriptor at byte
    `start`: row i at start + 64 i, k at 2 k, each address swizzled."""
    i = np.arange(rows)[:, None]
    j = np.arange(16)[None, :]
    return img[_sw64(start + i * 64 + j * 2) // 2]


def _emulate_k5(chain, wimg):
    """K5 on a chain tensor (float64): per (tile, segment of all output
    slices) the stored slices in order, each from its two parity slots,
    dz = 1 (odd) or dz = 2 then dz = 0 into the second accumulator set
    (even), then the epilogue of the completed slice. Returns the dense
    output and ps (D2, T, 2, 64)."""
    dp, hp, wp, _ = chain.shape
    d2, h2, w2 = (dp - 2) // 2, (hp - 2) // 2, (wp - 2) // 2
    tiles_x, tiles_y = -(-w2 // S2_TX), -(-h2 // S2_TY)
    out = np.zeros((d2, h2, w2, 64))
    ps = np.zeros((d2, tiles_x * tiles_y, 2, 64))
    lane = np.arange(32)
    q, g8 = lane & 3, lane >> 2

    def taps(acc, parities, dz, wg, fresh):
        for dy in range(3):
            for dx in range(3):
                for ks in range(2):
                    tap = (dz * 3 + dy) * 3 + dx
                    a = _kmajor_sw64(parities[dx & 1], (
                        (2 * wg + dy) * S2_SXP + (dx >> 1)) * 64 + ks * 32,
                        64)
                    b = _kmajor(wimg, tap * 4096 + ks * 2048, 1024, 128, 64)
                    if fresh and dy == dx == ks == 0:
                        acc[:] = 0
                    acc += a @ b.T

    for tile in range(tiles_x * tiles_y):
        y0, x0 = tile // tiles_x * S2_TY, tile % tiles_x * S2_TX
        acc = np.zeros((2, 64, 64))          # [warpgroup] m64 x n64
        nxt = np.zeros((2, 64, 64))
        for j in range(2 * d2 + 1):          # stored slice j, m0 = 0
            halves = [_s2_slot(chain, j, p, y0, x0) for p in range(2)]
            for wg in range(2):
                if j & 1:
                    taps(acc[wg], halves, 1, wg, False)
                else:
                    if j > 0:
                        taps(acc[wg], halves, 2, wg, False)
                    if j < 2 * d2:
                        taps(nxt[wg], halves, 0, wg, True)
            if j & 1:
                continue
            if j > 0:
                m = j // 2 - 1
                for wg in range(2):
                    y = y0 + wg
                    for wq in range(4):
                        reg = _fragment(acc[wg], wq)          # (32, 32)
                        groups = np.zeros((4, 32, 4, 2))
                        for g in range(4):
                            for k in range(4):     # chunk k: h, octet jj
                                h, jj = k >> 1, 2 * g + (k & 1)
                                v = reg[:, [4 * jj + 2 * h,
                                            4 * jj + 2 * h + 1]]
                                ok = (y < h2) & (x0 + 16 * wq + g8 + 8 * h
                                                 < w2)
                                for e in range(2):
                                    ch = 8 * jj + 2 * q + e
                                    np.add.at(ps[m, tile, 0], ch,
                                              v[:, e] * ok)
                                    np.add.at(ps[m, tile, 1], ch,
                                              v[:, e] ** 2 * ok)
                                groups[g, :, k] = v
                        st = _chunk_stores(groups)            # (4, 32, 8)
                        for g in range(4):
                            h, jj = q >> 1, 2 * g + (q & 1)
                            x = x0 + 16 * wq + g8 + 8 * h
                            for ln in np.nonzero((y < h2) & (x < w2))[0]:
                                out[m, y, x[ln], 8 * jj[ln]:8 * jj[ln] + 8] \
                                    = st[g, ln]
            acc = nxt.copy()
    return out, ps


def test_k5_parity_boxes_and_descriptor_walk_are_the_conv():
    """The emulated K5 (element-stride-2 swizzled boxes, parity slots,
    descriptor starts, slice order, fragment, epilogue) on a chain volume
    whose
    H / 2 and W / 2 are multiples of neither tile side, against
    `conv_s2_plain`; the per-tile moments fold into the plain version's
    per-slice moments."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 6, 132, 32).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    k = torch.from_numpy((rng.randn(64, 32, 3, 3, 3) * 0.1).astype(
        np.float32)).to(torch.bfloat16).float()
    cv = CC.pack_vol_plain(x)
    wimg = KC.wgmma_weight(k, torch.float32).reshape(-1).double().numpy()
    out, ps = _emulate_k5(cv.data.double().numpy(), wimg)
    want, wps = CC.conv_s2_plain(cv, k)
    np.testing.assert_allclose(out, want.numpy(), atol=1e-4, rtol=0)
    assert ps.shape == (2, 2 * 2, 2, 64)
    np.testing.assert_allclose(ps.sum(1), wps.sum(1).numpy(), rtol=1e-4,
                               atol=1e-3)


def test_k5_box_and_slot_sizes():
    """A slot is one parity's box of 5 rows x 65 columns x 64 bytes (what
    TMA counts for a box of 130 columns at element stride 2), on 1024
    bytes; five slots, the weights and the moment buffers fit a block's
    shared memory; the swizzle is a permutation of the 16-byte chunks of
    each 512-byte atom."""
    assert (S2_SY, S2_SXP) == (5, 65) and -(-2 * S2_SXP // 2) == 65
    assert S2_BOX == 20800 and S2_SLOT == 21504
    smem = S2_RING * S2_SLOT + 27 * 32 * 64 * 2 + 2 * 8 * 2 * 64 * 4 \
        + (2 * S2_RING + 1) * 8
    assert smem == 226392 and smem <= 232448
    addr = np.arange(0, 2048, 16)
    assert sorted(_sw64(addr)) == list(addr)
    assert (_sw64(addr) // 512 == addr // 512).all()


@pytest.mark.parametrize('d2,tiles,grid', [(36, 60, 132), (22, 60, 132),
                                           (3, 4, 132), (7, 5, 3),
                                           (2, 1, 1)])
def test_k5_shares_and_ring_protocol(d2, tiles, grid):
    """The persistent grid's shares cover every (tile, output slice)
    once; per block the producer's loads (one column parity of a stored
    slice each) and the consumers' waits and releases follow the ring: a
    segment's stored slices 2 m0 .. 2 (m0 + n) are loaded as two
    parities each; the consumers wait for slice 0, then per output i for
    slice 2 i + 1, release 2 i (its last products have finished), wait
    for 2 i + 2, release 2 i + 1, and after the segment's last output
    2 n. Every load is released once, after its wait, and load L, which
    needs the release of L - RING, never waits on a release that comes
    after the consumers' wait for L."""
    units = tiles * d2
    grid = min(grid, units)
    seen = np.zeros(units, int)
    for blk in range(grid):
        begin, end = blk * units // grid, (blk + 1) * units // grid
        loads, events = [], []        # consumer events: ('wait' | 'rel', L)
        u, load = begin, 0
        while u < end:
            tile, m0 = divmod(u, d2)
            n = min(d2 - m0, end - u)
            loads += [(tile, s, p) for s in range(2 * m0, 2 * (m0 + n) + 1)
                      for p in range(2)]

            def ev(kind, j):
                events.extend([(kind, load + 2 * j), (kind, load + 2 * j + 1)])
                assert loads[load + 2 * j][:2] == (tile, 2 * m0 + j)

            ev('wait', 0)
            for i in range(n):
                ev('wait', 2 * i + 1)
                ev('rel', 2 * i)
                ev('wait', 2 * i + 2)
                ev('rel', 2 * i + 1)
                if i == n - 1:
                    ev('rel', 2 * i + 2)
                seen[tile * d2 + m0 + i] += 1
            load += 2 * (2 * n + 1)
            u += n
        pos = {e: k for k, e in enumerate(events)}
        assert sorted(l for kind, l in events if kind == 'rel') == \
            list(range(len(loads)))
        for l in range(len(loads)):
            assert pos[('wait', l)] < pos[('rel', l)]
            if l >= S2_RING:
                assert pos[('rel', l - S2_RING)] < pos[('wait', l)]
    assert (seen == 1).all()


# ---------------------------------------------------------------- K9b

def _dense_slot(x, s, y0, x0, koct):
    """The ring slot of input slice s for the tile at (y0, x0): koct TMA
    boxes of 8 channels from coordinates (8 c8, x0 - 1, y0 - 1, s), each
    [row SY][column SX][8 ch] at c8 * OCT bytes; zeros outside the tensor
    (slices -1 and D, rows and columns outside, channels >= C)."""
    d, h, w, c = x.shape
    img = np.zeros(koct * OCT // 2)
    rows, cols = y0 - 1 + np.arange(SY), x0 - 1 + np.arange(SX)
    ry, rx = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
    for c8 in range(koct):
        box = np.zeros((SY, SX, 8))
        if 0 <= s < d and 8 * c8 < c:
            box[np.ix_(ry, rx)] = x[s][np.ix_(rows[ry], cols[rx])][
                ..., 8 * c8:8 * c8 + 8]
        img[c8 * OCT // 2:c8 * OCT // 2 + box.size] = box.reshape(-1)
    return img


def _k9a_holders(n):
    """(lane, register i, value index) of the values that `moments`
    (csrc/conv_dense.cuh) files after its reduce-scatter over g8, V =
    n / 2 values a thread ([k] the sum of its channel slot k, [V / 2 + k]
    the sum of squares): the halving steps at lane offsets 16, 8, 4
    (for n = 8 the last one a butterfly, of whose lane pair the even g8
    writes), replayed on value indices."""
    v = n // 2
    out = []
    for ln in range(32):
        held = list(range(v))
        for off in (16, 8, 4):
            if len(held) > 1:
                half = len(held) // 2
                held = held[half:] if ln & off else held[:half]
        g8 = ln >> 2
        if v >= 8 or g8 % 2 == 0:
            out += [(ln, i, idx) for i, idx in enumerate(held)]
    return out


def _k9a_moments(acc, x0, w):
    """The moment epilogue of conv_dense.cuh (kMoments) on the float32
    accumulators acc (8 rows, 64 columns, n) of one (tile, slice): per
    row r = 4 wg + m, per warp wq its m64nN fragment, each thread's two
    columns summed (columns past W add nothing), the reduce-scatter over
    g8 (lane offsets 16, 8, 4: a butterfly's tree in that order) and the
    lanes that hold each channel's sums after it (`_k9a_holders`), then
    the four warps summed in order; every product and sum rounded alone
    in float32. Returns (8, 2, n) float32: the sum and sum of squares per
    row and channel."""
    f = np.float32
    n = acc.shape[-1]
    lane = np.arange(32)
    q, g8 = lane & 3, lane >> 2
    k = np.arange(n // 4)
    res = np.zeros((8, 2, n), f)
    for r in range(8):
        red = np.full((4, 2, n), np.nan, f)
        for wq in range(4):
            regs = _fragment(acc[r], wq)                   # (32, n / 2)
            s = np.zeros((32, n // 4), f)
            s2 = np.zeros((32, n // 4), f)
            for hh in range(2):
                ok = (x0 + 16 * wq + g8 + 8 * hh < w)[:, None]
                v = np.where(ok, regs[:, 2 * k + 2 * hh - (k & 1)], f(0))
                s = f(s + v)
                s2 = _madd(v, v, s2)
            for off in (16, 8, 4):
                s = f(s + s[lane ^ off])
                s2 = f(s2 + s2[lane ^ off])
            v = np.concatenate([s, s2], 1)                 # (32, n / 2)
            for ln, i, idx in _k9a_holders(n):
                kk, sel = idx % (n // 4), idx // (n // 4)
                ch = 8 * (kk >> 1) + 2 * (ln & 3) + (kk & 1)
                assert np.isnan(red[wq, sel, ch])
                red[wq, sel, ch] = v[ln, idx]
        tot = np.zeros((2, n), f)
        for wq in range(4):
            tot = f(tot + red[wq])
        res[r] = tot
    return res


def _emulate_k9(x, wimgs, chunks, moments=False):
    """K9b on a dense volume (float64), one launch per output-channel
    chunk n of `chunks` with its laid-out weights: per (tile, slice) the
    three input slots, the descriptor walk over 27 taps x koct / 2
    k-steps, the m64nN fragment, the epilogue's chunks through the quad
    transpose into channels co0 + 8 j. Returns (D, H, W, sum(chunks));
    with `moments` (K9a) also the moments of the accumulators rounded to
    float32 (`_k9a_moments`), (D, H, ceil(W / 64), 2, sum(chunks))."""
    d, h, w, c = x.shape
    koct = -(-c // 16) * 2
    cout = sum(chunks)
    tiles_x, tiles_y = -(-w // TX), -(-h // TY)
    out = np.full((d, h, w, cout), np.nan)
    rows = np.full((d, h, tiles_x, 2, cout), np.nan, np.float32)
    lane = np.arange(32)
    q, g8 = lane & 3, lane >> 2
    co0 = 0
    for n, wimg in zip(chunks, wimgs):
        nj = n // 8
        for tile in range(tiles_x * tiles_y):
            y0, x0 = tile // tiles_x * TY, tile % tiles_x * TX
            for o in range(d):
                slots = [_dense_slot(x, o - 1 + dz, y0, x0, koct)
                         for dz in range(3)]
                acc = np.zeros((4 * 2, 64, n))       # [wg * 4 + m]
                for r in range(8):
                    for tap in range(27):
                        dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
                        for ks in range(koct // 2):
                            a = _kmajor(slots[dz], ks * 2 * OCT
                                        + ((r + dy) * SX + dx) * 16,
                                        OCT, 128, 64)
                            b = _kmajor(wimg, tap * koct * n * 16
                                        + ks * 2 * n * 16, n * 16, 128, n)
                            acc[r] += a @ b.T
                if moments:
                    mom = _k9a_moments(acc.astype(np.float32), x0, w)
                    for r in range(min(8, h - y0)):
                        rows[o, y0 + r, tile % tiles_x, :, co0:co0 + n] = \
                            mom[r]
                for wg in range(2):
                    for wq in range(4):
                        regs = [_fragment(acc[4 * wg + m], wq)
                                for m in range(4)]          # (32, n / 2)
                        groups = np.zeros((2 * nj, 32, 4, 2))
                        for cc in range(8 * nj):
                            m, hh, j = cc // (2 * nj), cc // nj % 2, cc % nj
                            groups[cc // 4, :, cc % 4] = regs[m][
                                :, [4 * j + 2 * hh, 4 * j + 2 * hh + 1]]
                        st = _chunk_stores(groups)
                        for g in range(2 * nj):
                            cc = 4 * g + q
                            m, hh, j = cc // (2 * nj), cc // nj % 2, cc % nj
                            yy = y0 + wg * 4 + m
                            xx = x0 + 16 * wq + g8 + 8 * hh
                            for ln in np.nonzero((yy < h) & (xx < w))[0]:
                                ch = co0 + 8 * j[ln]
                                out[o, yy[ln], xx[ln], ch:ch + 8] = st[g, ln]
        co0 += n
    return (out, rows) if moments else out


@pytest.mark.parametrize('c,chunks', [(8, [8]), (16, [16]), (32, [32]),
                                      (8, [32]), (32, [8]), (16, [16, 8])])
def test_k9b_dense_boxes_and_descriptor_walk_are_the_conv(c, chunks):
    """The emulated K9b (boxes at -1 with zero fill, a padding octet for
    C = 8, the N-generic B layout, the m64nN fragment, the epilogue's
    chunks, output-channel chunks) on a volume with ragged last tiles in
    H and W (9 x 66 against 8 x 64) against `conv3d_plain`."""
    rng = np.random.RandomState(c + len(chunks))
    x = torch.from_numpy(rng.randn(3, 9, 66, c).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    k = torch.from_numpy((rng.randn(sum(chunks), c, 3, 3, 3) * 0.1).astype(
        np.float32)).to(torch.bfloat16).float()
    koct = -(-c // 16) * 2
    wimgs, co0 = [], 0
    for n in chunks:
        wt = KC.wgmma_weight(k[co0:co0 + n], torch.float32, koct)
        assert wt.shape == (27, koct, n, 8)
        assert not wt[:, c // 8:].any()                # the padding octet
        wimgs.append(wt.reshape(-1).double().numpy())
        co0 += n
    out = _emulate_k9(x.double().numpy(), wimgs, chunks)
    np.testing.assert_allclose(out, C3.conv3d_plain(x, k).numpy(),
                               atol=1e-4, rtol=0)


def test_k9b_route():
    """bf16 with C % 8 == 0 and C_out % 8 == 0 takes the tensor-core code
    in chunks that fit shared memory beside a ring of at least 3 slices;
    float32, C = 42 and other widths the direct kernel."""
    chunks = KC3.tensor_core_chunks
    bf = torch.bfloat16
    assert chunks(bf, 32, 32) == [32]                  # the DfM width
    assert chunks(bf, 16, 8) == [8]                    # chip_smoke's case
    assert chunks(bf, 8, 64) == [32, 32] == chunks(bf, 32, 64)
    assert chunks(bf, 48, 16) == [8, 8]       # three k16 steps: n 8 fits
    assert chunks(bf, 16, 24) == [16, 8]
    assert chunks(bf, 8, 8) == [8]
    for dt, c, co in ((torch.float32, 32, 32), (torch.float32, 16, 8),
                      (torch.float32, 42, 42), (bf, 42, 42), (bf, 32, 20),
                      (bf, 12, 32), (bf, 64, 64), (bf, 128, 8)):
        assert chunks(dt, c, co) is None, (dt, c, co)
    assert KC3._wgmma_ring(4, 32) == 4 and KC3._wgmma_ring(6, 32) == 2
    # csrc k9::smem_bytes of the DfM width: four slots, the weights, bars
    assert 4 * 4 * OCT + 27 * 4 * 32 * 16 + 9 * 8 == 225352


# ---------------------------------------------------------------- K9a

@pytest.mark.parametrize('c,chunks,h,w', [
    (32, [32], 8, 64), (16, [16, 8], 12, 70), (8, [32, 32], 16, 130),
    (32, [32], 12, 130), (16, [16, 8], 8, 64), (8, [32], 4, 70)])
def test_k9a_moment_epilogue_folds_to_the_partials(c, chunks, h, w):
    """K9a on the K9b code: the emulated kMoments epilogue (the m64nN
    fragment, each thread's two columns, the xor tree over g8, the four
    warps in order; per (slice, row, 64-column tile)) on volumes with
    whole and ragged tiles in H and W and one or two output-channel
    chunks, folded by `fold_row_partials` for every row band th <= 8
    that divides H, against `conv3d_zpack_plain`'s partials within
    chip_smoke's bound (rtol 1e-4; sums + 1e-6 * sqrt(N * sum of
    squares), N = th * W values a sum); the output against
    `conv3d_plain` (atol 1e-4)."""
    from dfm_tpu_torch.ops import convgn as G
    rng = np.random.RandomState(c + h + w)
    d = 4
    x = torch.from_numpy(rng.randn(d, h, w, c).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    k = torch.from_numpy((rng.randn(sum(chunks), c, 3, 3, 3) * 0.1).astype(
        np.float32)).to(torch.bfloat16).float()
    koct = -(-c // 16) * 2
    wimgs, co0 = [], 0
    for n in chunks:
        wimgs.append(KC.wgmma_weight(k[co0:co0 + n], torch.float32, koct)
                     .reshape(-1).double().numpy())
        co0 += n
    out, rows = _emulate_k9(x.double().numpy(), wimgs, chunks, moments=True)
    assert rows.shape == (d, h, -(-w // 64), 2, sum(chunks))
    assert not np.isnan(rows).any()
    np.testing.assert_allclose(out, C3.conv3d_plain(x, k).numpy(),
                               atol=1e-4, rtol=0)
    for th in (t for t in range(1, 9) if h % t == 0):
        got = G.fold_row_partials(torch.from_numpy(rows), th).double()
        want = G.conv3d_zpack_plain(x, k, th)[1].double()
        lim = 1e-4 * want.abs()
        lim[..., 0, :] += 1e-6 * (th * w * want[..., 1, :]).sqrt()
        assert bool(((got - want).abs() <= lim).all()), th


def _dense_smem_source():
    """csrc/conv_dense.cuh's constants and the expression of smem_bytes,
    as the source states them (int arithmetic: `/` is floor division
    on these non-negative values)."""
    import re
    from dfm_tpu_torch.ops.cuda.build import CSRC
    src = (CSRC / 'conv_dense.cuh').read_text()
    names = {}
    for line in re.findall(r'^constexpr int ([^;]+);', src, re.M):
        for decl in line.split(', '):                # "TY = 8, TX = 64"
            name, expr = decl.split(' = ')
            names[name] = eval(expr.replace('/', '//'), {}, dict(names))
    body = re.search(r'smem_bytes\(int koct, int n, int ring,\s*bool '
                     r'moments\) \{\s*return ([^;]+);', src).group(1)
    return names, ' '.join(body.replace('/', '//').split())


def test_k9a_ring_mirrors_ring_slots():
    """`_wgmma_ring` computes the slots of `k9::ring_slots`, moment buffer
    included, from the source's own `smem_bytes` and constants, for every
    k16 step count and width; the DfM width keeps four slots with the
    moment buffer (229,448 bytes), and every chunk K9a's route picks has
    a ring of at least three slots."""
    names, body = _dense_smem_source()
    assert names['kMaxSmem'] == KC3.MAX_SMEM
    assert names['kOct'] == KC3.OCT_PLANE and names['kRedBytes'] == 128
    assert (names['TY'], names['TX']) == KC3.DENSE_TILE

    def smem(koct, n, ring, moments):
        return eval(body, {}, dict(names, koct=koct, n=n, ring=ring,
                                   moments=int(moments)))

    for koct in (2, 4, 6):
        for n in (8, 16, 32):
            for moments in (False, True):
                r = names['kMaxRing']
                while r > 0 and smem(koct, n, r, moments) > names['kMaxSmem']:
                    r -= 1
                assert KC3._wgmma_ring(koct, n, moments) == r, (koct, n)
    assert KC3._wgmma_ring(4, 32, True) == 4
    assert smem(4, 32, 4, True) == 229448 == 225352 + 128 * 32
    for c in range(8, 49, 8):
        for co in range(8, 65, 8):
            for n in KC3.tensor_core_chunks(torch.bfloat16, c, co, True):
                assert KC3._wgmma_ring(KC3._koct(c), n, True) >= 3


def test_k9a_route():
    """`conv3d_stats` takes `stats_route`: the moment instance of the
    `wgmma` code (moments per 64 columns) for bf16 with C, C_out % 8 == 0
    in the chunks K9b takes (the moment buffer changes no route), the
    direct kernel (moments per 32 columns) for float32 and other
    widths."""
    bf = torch.bfloat16
    route = KC3.stats_route
    assert route(bf, 32, 32) == ([32], 64)            # the DfM width
    assert route(bf, 8, 32) == ([32], 64)             # chip_smoke's 8 -> 32
    assert route(bf, 16, 24) == ([16, 8], 64)
    assert route(bf, 8, 64) == ([32, 32], 64) == route(bf, 32, 64)
    assert route(bf, 48, 16) == ([8, 8], 64)
    assert route(bf, 8, 8) == ([8], 64)
    for dt, c, co in ((torch.float32, 32, 32), (torch.float32, 8, 32),
                      (bf, 42, 42), (bf, 32, 20), (bf, 12, 32),
                      (bf, 64, 64)):
        assert route(dt, c, co) == (None, 32), (dt, c, co)
    for c in range(8, 49, 8):
        for co in range(8, 65, 8):
            assert route(bf, c, co)[0] == KC3.tensor_core_chunks(bf, c, co)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize('relu', [False, True])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gn_finish_plain_is_the_old_composition(dtype, residual, relu):
    """The finish kernel's plain apply step (`gn_finish_plain`, which the
    wrapper takes on the CPU) and `conv3d_gn_plain` give, bit for bit,
    the composition `conv3d_gn` applied before the split: scale and bias
    from the partials, out * sc + bs, + residual, relu, one rounding."""
    from dfm_tpu_torch.ops import conv_chain as CC
    from dfm_tpu_torch.ops import convgn as G
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.randn(4, 8, 20, 16).astype(np.float32)).to(dt)
    wt = torch.from_numpy((rng.randn(24, 16, 3, 3, 3) * 0.1).astype(
        np.float32))
    gamma = torch.from_numpy((rng.rand(24) + 0.5).astype(np.float32))
    beta = torch.from_numpy(rng.randn(24).astype(np.float32))
    res = torch.from_numpy(rng.randn(4, 8, 20, 24).astype(np.float32)).to(
        dt) if residual else None
    out, ps = G.conv3d_zpack_plain(x, wt, 4)
    per_c = ps.reshape(-1, 1, 2, 4, 24).sum(3)
    sc, bs = CC.gn_scale_bias(per_c, out.shape, gamma, beta, 8, eps=1e-5)
    y = out.float() * sc + bs
    if res is not None:
        y = y + res.float()
    if relu:
        y = torch.relu(y)
    want = y.to(dt)
    got_sc, got_bs = G.gn_partials_affine(ps, out.shape, gamma, beta, 8)
    assert torch.equal(got_sc, sc) and torch.equal(got_bs, bs)
    for got in (G.gn_finish_plain(out, sc, bs, res, relu),
                KC3.gn_finish(out, sc, bs, res, relu),
                G.conv3d_gn_plain(x, wt, gamma, beta, 8, residual=res,
                                  relu=relu, th=4)):
        assert got.dtype == dt and torch.equal(_bits(got), _bits(want))
    assert relu is False or bool((want >= 0).all())


# ---------------------------------------------------------------- K3

def _ds(nx, d):
    return PFS.slab_depth_static(np.linspace(1.0, 32.0, nx), 2.0, 30.0, d)


def test_attention_xtab_rows_and_cache():
    """(z0, z1, w0, w1) per slab, the weights zero out of the depth range;
    one device table per content; taps beyond the table raise."""
    ds = _ds(11, 12)
    tab = K.depth_xtab(ds, 12, torch.device('cpu'))
    assert tab.shape == (11, 4) and tab.dtype == torch.float32
    keep = ds['in_range'].astype(np.float32)
    np.testing.assert_array_equal(tab.numpy(), np.stack(
        [ds['z0'], ds['z1'], ds['w0'] * keep, ds['w1'] * keep], 1))
    assert not ds['in_range'].all() and (tab[~torch.from_numpy(
        ds['in_range'])][:, 2:] == 0).all()
    again = {k: v.copy() for k, v in _ds(11, 12).items()}
    assert K.depth_xtab(again, 12, torch.device('cpu')) is tab
    assert K.depth_xtab(_ds(11, 24), 24, torch.device('cpu')) is not tab
    with pytest.raises(ValueError):
        K.depth_xtab(ds, 8, torch.device('cpu'))


def _emulate_k3(sm, u, v, xtab, pad):
    """attention_sample_kernel in float32 numpy: per (b, z) and x the
    staged rows and weights, per (x, y) the column taps, products and
    sums rounded one by one. Returns (out, rows, wzy) with the staged
    tables (B, nz, nx, 4)."""
    f = np.float32
    b_, d, h, w = sm.shape
    _, nx, ny = u.shape
    nz = v.shape[2]
    pad_h, pad_w = f(pad[0]), f(pad[1])
    flat = sm.reshape(b_, -1)

    def taps(idx, n):
        i0 = np.floor(idx)
        fr = f(idx - i0)
        out = []
        for dd, wt in ((0, f(1) - fr), (1, fr)):
            ii = i0 + dd
            ok = (ii >= 0) & (ii <= n - 1)
            out.append((np.clip(ii, 0, n - 1).astype(np.int64),
                        np.where(ok, wt, f(0))))
        return out

    rows = np.zeros((b_, nz, nx, 4), np.int64)
    wzy = np.zeros((b_, nz, nx, 4), f)
    vv = v.transpose(0, 2, 1)                                # (B, nz, nx)
    yt = taps(vv / (pad_h - f(1)) * f(h - 1), h)
    valid_v = (vv >= 0) & (vv <= pad_h)
    for dz in range(2):
        zi = xtab[:, dz].astype(np.int64)
        wz = xtab[:, 2 + dz]
        for dy in range(2):
            yi, wy = yt[dy]
            rows[..., 2 * dz + dy] = (zi * h + yi) * w
            wzy[..., 2 * dz + dy] = np.where(valid_v, f(wz * wy), f(0))
    uu = u.transpose(0, 2, 1)[:, None]                       # (B,1,ny,nx)
    xt = taps(uu / (pad_w - f(1)) * f(w - 1), w)
    valid_u = (uu >= 0) & (uu <= pad_w)
    acc = np.zeros((b_, nz, ny, nx), f)
    bi = np.arange(b_)[:, None, None, None]
    for k in range(4):
        wk = wzy[:, :, None, :, k]
        base = rows[:, :, None, :, k]
        for dx in range(2):
            xi, wx = xt[dx]
            term = f(flat[bi, base + xi] * f(wk * wx))
            acc = np.where(valid_u & (wk != 0), f(acc + term), acc)
    return acc, rows, wzy


@pytest.mark.parametrize('w', [33, 64])
def test_k3_block_tables_and_gather(w):
    """The staged per-(x, z) rows and weights against `_voxel_taps` and
    the depth tables, and the separable gather against
    `attention_sample_plain` bit for bit, at B = 2 with voxels outside
    validity and out of the depth range, and taps on the last row and
    column."""
    rng = np.random.RandomState(3)
    b, d, h = 2, 12, 16
    nz, ny, nx = 5, 40, 37
    pad = (2 * h, 2 * w)
    sm = np.abs(rng.randn(b, d, h, w)).astype(np.float32)
    u = (rng.rand(b, nx, ny) * (pad[1] + 8) - 4).astype(np.float32)
    v = (rng.rand(b, nx, nz) * (pad[0] + 8) - 4).astype(np.float32)
    u[0, :, :3] = [pad[1] - 1, pad[1], 0.0]
    v[1, :, :2] = [pad[0] - 1, pad[0]]
    ds = _ds(nx, d)
    xtab = K.depth_xtab(ds, d, torch.device('cpu')).numpy()
    got, rows, wzy = _emulate_k3(sm, u, v, xtab, pad)

    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    z0, z1, w0, w1, inr = PFS.depth_tables(ds, 'cpu')
    ys, _ = PFS._voxel_taps(tu, tv, pad, h, w)               # (B,nz,1,nx)
    vmask = ((tv >= 0) & (tv <= pad[0])).transpose(1, 2).numpy()
    for dz, (zi, wz) in enumerate(((z0, w0), (z1, w1))):
        for dy, (yi, wy) in enumerate(ys):
            k = 2 * dz + dy
            np.testing.assert_array_equal(
                rows[..., k], ((zi.long() * h + yi[:, :, 0]) * w).numpy())
            want = (wz * wy[:, :, 0]).numpy() * vmask * inr.numpy()
            np.testing.assert_array_equal(wzy[..., k], want)
    want = PFS.attention_sample_plain(torch.from_numpy(sm), tu, tv, z0, z1,
                                      w0, w1, inr, pad).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).mean() > 0.3


# ---------------------------------------------------------------- K2

VOX_X, VOX_Y, QUAD = 8, 32, 4          # csrc/frustum_sample.cu


def _bf16(x):
    """float32 -> nearest-even bf16, kept in float32 (finite values)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _madd(f, w, acc):
    """csrc/common.cuh:madd: the product and the sum rounded alone."""
    return np.float32(acc + np.float32(f * w))


def _taps(idx, n):
    """axis_taps (csrc/common.cuh) in float32 numpy."""
    f = np.float32
    i0 = np.floor(idx)
    fr = f(idx - i0)
    out = []
    for dd, wt in ((0, f(1) - fr), (1, fr)):
        ii = i0 + dd
        ok = (ii >= 0) & (ii <= n - 1)
        out.append((np.clip(ii, 0, n - 1).astype(np.int64),
                    np.where(ok, wt, f(0)).astype(f)))
    return out


def _emulate_k2(vol, sem, att, u, v, xtab, pad, rnd):
    """voxel_features_kernel in float32 numpy, `rnd` the element type's
    rounding: per (b, z) and x the staged stereo and sem rows and weights,
    per (x, y) the column taps and validity, the 8 + 4 taps summed in the
    kernel's order by `_madd`. Returns the output and the staged tables
    (B, nz, nx, .)."""
    f = np.float32
    b_, d, h, w, c = vol.shape
    _, hs, ws, cs = sem.shape
    _, nx, ny = u.shape
    nz = v.shape[2]
    pad_h, pad_w = f(pad[0]), f(pad[1])
    vv = v.transpose(0, 2, 1)                                # (B, nz, nx)
    vok = (vv >= 0) & (vv <= pad_h)
    yt = _taps(vv / (pad_h - f(1)) * f(h - 1), h)
    mt = _taps(vv / (pad_h - f(1)) * f(hs - 1), hs)
    srow = np.zeros((b_, nz, nx, 4), np.int64)
    swt = np.zeros((b_, nz, nx, 4), f)
    for dz in range(2):
        zi = xtab[:, dz].astype(np.int64)
        wz = xtab[:, 2 + dz]
        for dy in range(2):
            yi, wy = yt[dy]
            srow[..., 2 * dz + dy] = (zi * h + yi) * w
            swt[..., 2 * dz + dy] = np.where(vok, f(wz * wy), f(0))
    mrow = np.stack([mt[dy][0] * ws for dy in range(2)], -1)
    mwt = np.stack([np.where(vok, mt[dy][1], f(0)) for dy in range(2)], -1)
    uu = u.transpose(0, 2, 1)[:, None]                       # (B,1,ny,nx)
    xt = _taps(uu / (pad_w - f(1)) * f(w - 1), w)
    mx = _taps(uu / (pad_w - f(1)) * f(ws - 1), ws)
    valid = vok[:, :, None, :] & (uu >= 0) & (uu <= pad_w)   # (B,nz,ny,nx)
    bi = np.arange(b_)[:, None, None, None]
    flat = vol.reshape(b_, -1, c)
    acc = np.zeros(valid.shape + (c,), f)
    for k in range(8):
        wt = f(swt[:, :, None, :, k >> 1] * xt[k & 1][1])
        tap = flat[bi, srow[:, :, None, :, k >> 1] + xt[k & 1][0]]
        use = (valid & (wt != 0))[..., None]
        acc = np.where(use, _madd(tap, wt[..., None], acc), acc)
    a = rnd(att)
    flat = sem.reshape(b_, -1, cs)
    sacc = np.zeros(valid.shape + (cs,), f)
    for k in range(4):
        wt = f(mwt[:, :, None, :, k >> 1] * mx[k & 1][1])
        tap = flat[bi, mrow[:, :, None, :, k >> 1] + mx[k & 1][0]]
        use = (valid & (a != 0) & (wt != 0))[..., None]
        sacc = np.where(use, _madd(tap, wt[..., None], sacc), sacc)
    sout = rnd(f(rnd(sacc) * a[..., None]))
    return np.concatenate([rnd(acc), sout], -1), srow, swt, mrow, mwt


@pytest.mark.parametrize('cs', [32, 16])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k2_staging_and_gather(dtype, cs):
    """The fused K2's staged per-(x, z) stereo and sem rows and weights
    against `_voxel_taps` and the depth tables, and its gather, rounded as
    the kernel rounds, against `frustum_voxel_features_plain`, at B = 2
    with voxels outside validity, slabs out of the depth range, taps on
    the last row and column and zeros in the attention, with sem maps of
    Cs = 32 (the DfM width) and 16: the plain version's bits (each
    product and sum rounded alone)."""
    rng = np.random.RandomState(4)
    dt = getattr(torch, dtype)
    rnd = _bf16 if dt == torch.bfloat16 else np.float32
    b, d, h, w, c = 2, 6, 8, 16, 32
    hs, ws = 10, 20
    nz, ny, nx = 5, 40, 37
    pad = (32, 64)
    vol = torch.from_numpy(rng.randn(b, d, h, w, c).astype(np.float32)).to(dt)
    sem = torch.from_numpy(rng.randn(b, hs, ws, cs).astype(np.float32)).to(dt)
    att = (rng.rand(b, nz, ny, nx) * (rng.rand(b, nz, ny, nx) > 0.2)
           ).astype(np.float32)
    u = (rng.rand(b, nx, ny) * (pad[1] + 8) - 4).astype(np.float32)
    v = (rng.rand(b, nx, nz) * (pad[0] + 8) - 4).astype(np.float32)
    u[0, :, :3] = [pad[1] - 1, pad[1], 0.0]
    v[1, :, :2] = [pad[0] - 1, pad[0]]
    ds = _ds(nx, d)
    xtab = K.depth_xtab(ds, d, torch.device('cpu')).numpy()
    got, srow, swt, mrow, mwt = _emulate_k2(
        vol.float().numpy(), sem.float().numpy(), att, u, v, xtab, pad, rnd)

    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    z0, z1, w0, w1, inr = PFS.depth_tables(ds, 'cpu')
    ys, _ = PFS._voxel_taps(tu, tv, pad, h, w)               # (B,nz,1,nx)
    vmask = ((tv >= 0) & (tv <= pad[0])).transpose(1, 2).numpy()
    for dz, (zi, wz) in enumerate(((z0, w0), (z1, w1))):
        for dy, (yi, wy) in enumerate(ys):
            k = 2 * dz + dy
            np.testing.assert_array_equal(
                srow[..., k], ((zi.long() * h + yi[:, :, 0]) * w).numpy())
            want = (wz * wy[:, :, 0]).numpy() * vmask * inr.numpy()
            np.testing.assert_array_equal(swt[..., k], want)
    ms, _ = PFS._voxel_taps(tu, tv, pad, hs, ws)
    for dy, (yi, wy) in enumerate(ms):
        np.testing.assert_array_equal(mrow[..., dy],
                                      (yi[:, :, 0] * ws).numpy())
        np.testing.assert_array_equal(mwt[..., dy],
                                      wy[:, :, 0].numpy() * vmask)
    want = PFS.frustum_voxel_features_plain(
        vol, sem, torch.from_numpy(att), tu, tv, z0, z1, w0, w1, inr,
        pad).float().numpy()
    assert got.shape == want.shape == (b, nz, ny, nx, c + cs)
    np.testing.assert_array_equal(got, want)
    assert (want[..., :c] != 0).mean() > 0.2
    assert (want[..., c:] != 0).mean() > 0.2


def _k2_threads():
    """(thread, pass) -> (role, voxel slot of the pass, quad lane) of
    `voxel_features_kernel`: threads 0-127 (warps 0-3) the stereo role,
    128-255 (warps 4-7) the sem role."""
    for t in range(256):
        role, rest = divmod(t, 128)
        slot, q = divmod(rest, QUAD)
        for p in range(VOX_X):
            yield t, p, ('sem' if role else 'stereo'), slot, q


@pytest.mark.parametrize('c,cs,vec', [(32, 32, 8), (32, 32, 4), (32, 16, 8),
                                      (5, 3, 1)])
def test_k2_lanes_write_each_row_once(c, cs, vec):
    """The lane-to-chunk map of `voxel_features_kernel`: a warp holds one
    role, so no warp runs both instruction streams; quad lane q of a
    voxel's stereo (sem) role takes chunks q, q + 4, ... of VEC elements
    of the row's first C (last Cs) elements; together they write the
    row's C + Cs elements once. At the DfM width (bf16, C = Cs = 32) each
    lane makes one 16-byte store: the stereo quad bytes 0-63, the sem
    quad bytes 64-127 of the 128-byte row."""
    owner = {}
    roles = {}
    for t, p, role, slot, q in _k2_threads():
        roles.setdefault(t // 32, set()).add(role)
        if (p, slot) != (0, 0):
            continue       # one voxel's row is enough for the map
        first, count = (0, c) if role == 'stereo' else (c, cs)
        for j in range(q, count // vec, QUAD):
            for e in range(first + j * vec, first + (j + 1) * vec):
                assert e not in owner
                owner[e] = (role, q)
    assert all(len(r) == 1 for r in roles.values())
    assert roles[0] == {'stereo'} and roles[7] == {'sem'}
    assert sorted(owner) == list(range(c + cs))
    assert all((e < c) == (r == 'stereo') for e, (r, _) in owner.items())
    if (c, cs, vec) == (32, 32, 8):
        for e, (role, q) in owner.items():
            assert e // 8 == q + (4 if role == 'sem' else 0)   # 16 bytes


@pytest.mark.parametrize('b,nz,ny,nx', [(2, 3, 33, 19), (1, 2, 32, 8),
                                        (1, 1, 5, 70), (1, 2, 64, 16),
                                        (2, 1, 1, 1), (1, 2, 31, 9)])
def test_k2_ragged_tiles_cover_every_voxel_once(b, nz, ny, nx):
    """The grid (ceil(ny / 32), ceil(nx / 8), B * nz) of 256 threads, each
    on voxel (x0 + pass, y0 + slot) of its passes, skipping what lies
    outside the grid: every voxel is taken by each quad lane of each role
    exactly once, in one block."""
    roles = ('stereo', 'sem')
    seen = np.zeros((b, nz, ny, nx, len(roles), QUAD), np.int64)
    threads = list(_k2_threads())
    for bz in range(b * nz):
        bb, z = divmod(bz, nz)
        for by in range(-(-nx // VOX_X)):
            for bx in range(-(-ny // VOX_Y)):
                x0, y0 = by * VOX_X, bx * VOX_Y
                for _, p, role, slot, q in threads:
                    x, y = x0 + p, y0 + slot
                    if x < nx and y < ny:
                        seen[bb, z, y, x, roles.index(role), q] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------- K1

K1_ROWS = 4                           # csrc/warp_prev.cu


def _sweep_point(p, dd, h, w, step):
    """sweep_point (csrc/warp_prev.cu) in float32 numpy, for pixel
    arrays h, w."""
    f = np.float32
    org_w, flip, cox, coy, sf, inv = p[12], p[13] > 0, p[14], p[15], \
        p[16], p[17]
    u = f(f(f(w.astype(f) * f(step)) + cox) / sf)
    v = f(f(f(h.astype(f) * f(step)) + coy) / sf)
    if flip:
        u = f(org_w - u)
    r = []
    for i in range(3):
        m = p[4 * i:4 * i + 4]
        s_ = f(f(f(m[0] * u) + f(m[1] * v)) + m[2])
        r.append(f(f(dd * s_) + m[3]))
    pu, pv = f(r[0] / r[2]), f(r[1] / r[2])
    if flip:
        pu = f(org_w - pu)
    return f(f(f(pu * sf) - cox) * inv), f(f(f(pv * sf) - coy) * inv)


@pytest.mark.parametrize('hq', [10, 8])
@pytest.mark.parametrize('lanes', [4, 8])
def test_k1_sweep_blocks_points_and_sum(lanes, hq):
    """K1's sweep replayed per block (b, d) of 4 output rows: lane j of a
    warp's 32-pixel group computes pixel j's point from the block's
    parameter row and depth, step by step as the kernel rounds, and
    lane l of shuffle step s takes pixel s * (32 / LANES) + l / LANES.
    Every (pixel, sub-lane) is taken once; the points are
    `sweep_coords_plain`'s bits, and the bilinear sum with the kernel's
    rounding is `warp_prev_plain`'s bits, at B = 2 with flip + crop +
    scale on one sample, with a ragged last row block (hq = 10) and
    without (hq = 8)."""
    f = np.float32
    cam = np.array([[700., 0, 310, 12], [0, 700., 95, 0.3],
                    [0, 0, 1, 0.004], [0, 0, 0, 1]], np.float32)
    c2p = np.repeat(np.eye(4, dtype=np.float32)[None], 2, 0)
    c2p[:, :3, 3] = [(0.3, -0.05, -0.9), (-0.1, 0.02, 1.2)]
    c2p[0, 0, 2], c2p[0, 2, 0] = 0.02, -0.02
    params = PCV.sweep_params(
        torch.from_numpy(np.repeat(cam[None], 2, 0)), torch.from_numpy(c2p),
        torch.tensor([1242.0, 640.0]), torch.tensor([1.0, 0.0]),
        torch.tensor([[6.0, 2.0], [0.0, 0.0]]), torch.tensor([0.5, 1.0]), 4)
    depths = torch.linspace(2.5, 40.0, 3)
    wq, step = 40, 16
    want_u, want_v = PCV.sweep_coords_plain(params, depths, hq, wq, step)
    pn, dn = params.numpy(), depths.numpy()
    b, d = pn.shape[0], len(dn)
    got_u = np.full((b, d, hq, wq), np.nan, f)
    got_v = np.full((b, d, hq, wq), np.nan, f)
    taken = np.zeros((b, d, hq, wq, lanes), np.int64)
    kpix = 32 // lanes
    lane = np.arange(32)
    for bd in range(b * d):
        bb, dd = divmod(bd, d)
        for blk in range(-(-hq // K1_ROWS)):
            h0 = blk * K1_ROWS
            npix = min(K1_ROWS, hq - h0) * wq
            for warp in range(8):
                for g in range(warp * 32, npix, 256):
                    p = g + lane
                    hl = p // wq
                    pu, pv = _sweep_point(pn[bb], dn[dd], h0 + hl,
                                          p - hl * wq, step)
                    for s_ in range(lanes):
                        q = s_ * kpix + lane // lanes
                        ok = g + q < npix
                        pix = g + q[ok]
                        hh, ww = h0 + pix // wq, pix % wq
                        np.add.at(taken, (bb, dd, hh, ww, lane[ok] % lanes), 1)
                        got_u[bb, dd, hh, ww] = pu[q[ok]]
                        got_v[bb, dd, hh, ww] = pv[q[ok]]
    assert (taken == 1).all()
    np.testing.assert_array_equal(got_u, want_u.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())

    rng = np.random.RandomState(6)
    prev = rng.randn(b, 48, 160, 8).astype(np.float32)
    h, w = prev.shape[1:3]
    yt, xt = _taps(got_v, h), _taps(got_u, w)
    acc = np.zeros(got_u.shape + (8,), f)
    bi = np.arange(b)[:, None, None, None]
    for k in range(4):
        (yi, wy), (xi, wx) = yt[k >> 1], xt[k & 1]
        wt = f(wx * wy)
        acc = np.where((wt != 0)[..., None],
                       _madd(prev[bi, yi, xi], wt[..., None], acc), acc)
    want = PCV.warp_prev_plain(torch.from_numpy(prev), want_u, want_v)
    np.testing.assert_array_equal(acc, want.numpy())
    assert (want.numpy() != 0).mean() > 0.5


# ------------------------------------------------- K2-bwd and K1-bwd gathers

BWD_COLS = 32                           # both backward kernels' tiles
BWD_WARPS = 8                           # K1-bwd: a warp a row
K2_WARPS = 16                           # K2-bwd (csrc/frustum_sample.cu)
SEM_GROUPS = 16
SEM_ROWS = K2_WARPS // SEM_GROUPS
ST_GROUPS = 4
ST_ROWS = K2_WARPS // ST_GROUPS
K1_CAND = 256                           # csrc/warp_prev.cu: kCand
K1_MARGIN = 0.5                         # kBoxMargin


def _floor_tap(idx, n):
    """floor_tap (csrc/common.cuh)."""
    return np.clip(np.floor(np.nan_to_num(idx, nan=-2.0)), -2,
                   n + 1).astype(np.int64)


def _stage_taps(vals, pad, n):
    """stage_slab's taps of v (per z) or u (per y), float32 numpy: the
    floor and the two weights, zero unless 0 <= val <= pad."""
    f = np.float32
    vals = np.asarray(vals, f)
    ok = (vals >= 0) & (vals <= f(pad))
    idx = f(f(vals / f(f(pad) - f(1))) * f(n - 1))
    (_, w0), (_, w1) = _taps(idx, n)
    return (np.where(ok, _floor_tap(idx, n), -2), np.where(ok, w0, f(0)),
            np.where(ok, w1, f(0)))


def _plane_lists(xtab, d):
    """A stereo block's warp-0 compaction, 32 slabs a ballot: plane p's
    (x, depth tap, wz) entries in x order, tap 0 first."""
    nx = len(xtab)
    lists = []
    for p in range(d):
        ent, n = {}, 0
        for xb in range(0, nx, 32):
            x = np.arange(xb, min(xb + 32, nx))
            t = xtab[x]
            f0 = (t[:, 0].astype(np.int64) == p) & (t[:, 2] != 0)
            f1 = (t[:, 1].astype(np.int64) == p) & (t[:, 3] != 0)
            pos = n + np.cumsum(f0) - f0 + np.cumsum(f1) - f1
            for i in np.flatnonzero(f0):
                ent[int(pos[i])] = (int(x[i]), 0, t[i, 2])
            for i in np.flatnonzero(f1):
                ent[int(pos[i] + f0[i])] = (int(x[i]), 1, t[i, 3])
            n += int(f0.sum() + f1.sum())
        assert sorted(ent) == list(range(n))
        lists.append([ent[i] for i in range(n)])
    return lists


def _col_hits(ycol, yw0, yw1, w):
    """Per column tile of a map of width w, for every staged y: whether the
    block's y mask holds it (a column tap of nonzero weight in the tile)
    and which of its two taps a warp adds to a tile column (its j range).
    Arrays (..., tiles)."""
    c0 = np.arange(0, w, BWD_COLS)
    ncols = np.minimum(BWD_COLS, w - c0)
    j = ycol[..., None] - c0
    in0 = (j >= 0) & (j < ncols)
    in1 = (j >= -1) & (j + 1 < ncols)
    mask = (in0 & (yw0[..., None] != 0)) | (in1 & (yw1[..., None] != 0))
    return mask, in0, in1


def _row_hits(zrow, zw0, zw1, h):
    """Per map row r, for every staged z: the warp of row r walks z when a
    row tap of nonzero weight lands in r, and takes zw0 if the floor is r,
    else zw1. Returns (walked (..., h), the weight taken (..., h))."""
    r = np.arange(h)
    at0 = zrow[..., None] == r
    hz = (at0 & (zw0[..., None] != 0)) | ((zrow[..., None] + 1 == r)
                                          & (zw1[..., None] != 0))
    return hz, np.where(at0, zw0[..., None], zw1[..., None])


def _k2_bwd_counts(u, v, xtab, att, pad, d, h, w, hs, ws):
    """How often the tile walk of `voxel_features_bwd_kernel` adds each
    (voxel, tap) (B = 1): stereo (nz, ny, nx, dz, dy, dx) and sem
    (nz, ny, nx, dy, dx), beside the taps of nonzero weight of the
    forward. A stereo tap is added by the block of its plane, row tile and
    column tile, by the warp of its row, when the plane's list holds
    (x, dz), the warp walks z with that tap's weight, the block's y mask
    holds y and the y's tap lands in the tile; a sem tap likewise, with
    every x in one group (x = 16 i + g) and att rounded nonzero."""
    f = np.float32
    u, v = u[0], v[0]                                   # (nx, ny), (nx, nz)
    nx, nz = v.shape
    listed = np.zeros((nx, 2), np.int64)
    for p, ent in enumerate(_plane_lists(xtab, d)):
        for x, tap, wz in ent:
            assert int(xtab[x, tap]) == p and wz == xtab[x, 2 + tap]
            listed[x, tap] += 1
    wz = xtab[:, 2:4]
    assert (listed == (wz != 0)).all()

    def halves(hm, wm, zweight):
        zrow, zw0, zw1 = _stage_taps(v, pad[0], hm)              # (nx, nz)
        ycol, yw0, yw1 = _stage_taps(u, pad[1], wm)              # (nx, ny)
        mask, in0, in1 = _col_hits(ycol, yw0, yw1, wm)           # (nx,ny,T)
        # each y tap: in how many tiles the warp adds it to the tile column
        # it lands on (the y masked, the j range, the column in the map)
        yadd = np.stack([(mask & in0).sum(-1), (mask & in1).sum(-1)], -1)
        out = {}
        for key, wzk in zweight:
            zw = [f(wzk[:, None] * zw0), f(wzk[:, None] * zw1)]
            hz, wzy = _row_hits(zrow, zw[0], zw[1], hm)          # (nx,nz,h)
            zadd = np.stack([(hz & (np.arange(hm) == zrow[..., None] + dy)
                              & (wzy == zw[dy][..., None])).sum(-1)
                             for dy in (0, 1)], -1)              # (nx,nz,2)
            wt = np.stack([np.stack([f(zw[dy][:, :, None] * yw[:, None, :])
                                     for yw in (yw0, yw1)], -1)
                           for dy in (0, 1)], -2)         # (nx,nz,ny,dy,dx)
            walk = zadd[:, :, None, :, None] * yadd[:, None, :, None, :]
            out[key] = (np.where(wt != 0, walk, 0), wt)
        return out

    ones = np.ones(nx, f)
    st = halves(h, w, [(dz, wz[:, dz]) for dz in (0, 1)])
    sem = halves(hs, ws, [('sem', ones)])['sem']
    a = (att[0] != 0).transpose(2, 0, 1)                         # (nx,nz,ny)
    return ({dz: st[dz] for dz in (0, 1)},
            (np.where(a[..., None, None], sem[0], 0), sem[1] * a[..., None,
                                                                  None]))


def _phase7b_k2():
    """chip_smoke.py phase 7 (b)'s K2 geometry (full DfMConfig grid,
    KITTI-like intrinsics) with a seeded attention, 20 % zeros."""
    import chip_smoke
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    cfg = DfMConfig()
    meta = chip_smoke.kitti_meta(1, 'cpu')
    coors = cfg.coordinates_3d()
    xs, ys, zs = coors[0, 0, :, 0], coors[0, :, 0, 1], coors[:, 0, 0, 2]
    u, v = PFS.slab_uv(meta.cam2img, xs, ys, zs)
    d = len(cfg.downsampled_depths())
    ds = PFS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, d)
    xtab = K.depth_xtab(ds, d, torch.device('cpu')).numpy()
    nz, ny, nx = cfg.voxel_grid_size()
    rng = np.random.RandomState(2)
    att = (rng.rand(1, nz, ny, nx) * (rng.rand(1, nz, ny, nx) > 0.2)
           ).astype(np.float32)
    h, w = chip_smoke.IMG_HW
    s = cfg.cost_sample_factor
    return u.numpy(), v.numpy(), xtab, att, chip_smoke.IMG_HW, d, h // s, \
        w // s


def test_k2_bwd_tiles_add_every_tap_once():
    """K2-bwd's tile walk at phase 7 (b)'s geometry (72 planes of 80 x 320,
    the sem map 80 x 320, the 20 x 304 x 288 grid): every plane's slab list
    holds each (x, depth tap) of nonzero weight once, and every (voxel,
    tap) of nonzero weight of the forward, stereo and sem, is added by
    exactly one (block, warp, item, column) and nothing else is; each
    stereo plane is read by a handful of slabs."""
    u, v, xtab, att, pad, d, h, w = _phase7b_k2()
    f = np.float32
    for n, pd in ((w, pad[1]),):     # the multiply's mask holds the exact one
        ycol, yw0, yw1 = _stage_taps(u[0], pd, n)
        exact, _, _ = _col_hits(ycol, yw0, yw1, n)
        scale = f(f(f(1) / f(f(pd) - f(1))) * f(n - 1))
        ok = (u[0] >= 0) & (u[0] <= f(pd))
        jc = np.floor(f(u[0] * scale)).astype(np.int64)[..., None] - \
            np.arange(0, n, BWD_COLS)
        ncols = np.minimum(BWD_COLS, n - np.arange(0, n, BWD_COLS))
        may = ok[..., None] & (jc >= -2) & (jc <= ncols)
        assert (may | ~exact).all() and exact.sum() > 5e4
    lists = _plane_lists(xtab, d)
    sizes = [len(x) for x in lists]
    assert max(sizes) <= 12 and np.mean(sizes) > 6, sizes
    st, (sem_walk, sem_wt) = _k2_bwd_counts(u, v, xtab, att, pad, d, h, w,
                                            h, w)
    for dz, (walk, wt) in st.items():
        np.testing.assert_array_equal(walk, (wt != 0).astype(walk.dtype))
    np.testing.assert_array_equal(sem_walk,
                                  (sem_wt != 0).astype(sem_walk.dtype))
    assert (st[0][1] != 0).sum() > 1e6 and (sem_wt != 0).sum() > 1e6


def _emulate_k2_bwd(gout, att, u, v, xtab, pad, vol_shape, sem_shape):
    """voxel_features_bwd_kernel in float32 numpy (float32 grad_out): per
    block its tile (stereo 4 rows, sem 1 row, of 32 columns), per warp its
    group's slabs (4 stereo groups, 16 sem groups) and for each, 32 y at a
    time, the z it walks and the masked y in order, the weights and sums
    rounded as the kernel rounds, and the groups added in group order;
    every element written once."""
    f = np.float32
    b_, d, h, w, c = vol_shape
    hs, ws, cs = sem_shape[1:]
    nz, ny, nx = att.shape[1:]
    gvol = np.full(vol_shape, np.nan, f)
    gsem = np.full(sem_shape, np.nan, f)
    lists = _plane_lists(xtab, d)
    blocks = [('sem', b, 0, r0, c0) for b in range(b_)
              for r0 in range(0, hs, SEM_ROWS)
              for c0 in range(0, ws, BWD_COLS)]
    blocks += [('st', b, p, r0, c0) for b in range(b_) for p in range(d)
               for r0 in range(0, h, ST_ROWS)
               for c0 in range(0, w, BWD_COLS)]
    for kind, b, p, r0, c0 in blocks:
        stereo = kind == 'st'
        hm, wm, ct, rows, groups = (h, w, c, ST_ROWS, ST_GROUPS) if stereo \
            else (hs, ws, cs, SEM_ROWS, SEM_GROUPS)
        slabs = lists[p] if stereo else [(x, 0, f(1)) for x in range(nx)]
        nrows, ncols = min(rows, hm - r0), min(BWD_COLS, wm - c0)
        acc = np.zeros((K2_WARPS, BWD_COLS, ct), f)
        for warp in range(K2_WARPS):
            g, rr = divmod(warp, rows)
            for k in range(g, len(slabs) if rr < nrows else 0, groups):
                x, _, wz = slabs[k]
                r = r0 + rr
                zrow, zw0, zw1 = _stage_taps(v[b, x], pad[0], hm)
                if stereo:
                    zw0, zw1 = f(wz * zw0), f(wz * zw1)
                ycol, yw0, yw1 = _stage_taps(u[b, x], pad[1], wm)
                j = ycol - c0
                ymask = ((j >= 0) & (j < ncols) & (yw0 != 0)) | \
                    ((j >= -1) & (j + 1 < ncols) & (yw1 != 0))
                walked = [z for z in range(nz)
                          if (zrow[z] == r and zw0[z] != 0) or
                          (zrow[z] + 1 == r and zw1[z] != 0)]
                for z, y in [(z, y) for y0 in range(0, ny, 32)
                             for z in walked for y in
                             np.flatnonzero(ymask[y0:y0 + 32]) + y0]:
                    wzy = zw0[z] if zrow[z] == r else zw1[z]
                    gv = gout[b, z, y, x, :c] if stereo else \
                        gout[b, z, y, x, c:]
                    if not stereo:
                        a = att[b, z, y, x]
                        if a == 0:
                            continue
                        gv = f(a * gv)
                    for jj, ok, yw in ((j[y], 0 <= j[y] < ncols, yw0[y]),
                                       (j[y] + 1, -1 <= j[y] < ncols - 1,
                                        yw1[y])):
                        wt = f(wzy * yw)
                        if ok and wt != 0:
                            acc[warp, jj] = f(acc[warp, jj] + f(wt * gv))
        tile = acc[:rows].copy()
        for g in range(1, groups):
            tile = f(tile + acc[g * rows:(g + 1) * rows])
        out = gvol[b, p] if stereo else gsem[b]
        out[r0:r0 + nrows, c0:c0 + ncols] = tile[:nrows, :ncols]
    return gvol, gsem


def test_k2_bwd_emulation_is_the_plain_gradient():
    """The tile walk emulated in float32 numpy, rounded as the kernel
    rounds, against `frustum_voxel_features_bwd_plain` (atol 1e-5 + rtol
    1e-5: autograd sums in another order) on a camera-like grid at B = 2
    (near slabs spanning columns, far slabs sharing rows, voxels outside
    the image, slabs out of range, zeros in att, ragged tiles): every
    element written once."""
    rng = np.random.RandomState(4)
    nz, ny, nx = 6, 44, 40
    pad = (32, 64)
    xs = np.linspace(1.0, 32.0, nx)
    y = np.arange(ny) - (ny - 1) / 2
    z = np.arange(nz) - (nz - 1) / 2
    u = np.repeat((pad[1] / 2 + 24.0 * y / xs[:, None])[None], 2, 0)
    v = np.repeat((pad[0] / 2 + 1.5 + 12.0 * z / xs[:, None])[None], 2, 0)
    u, v = u.astype(np.float32), v.astype(np.float32)
    att = (rng.rand(2, nz, ny, nx) * (rng.rand(2, nz, ny, nx) > 0.2)
           ).astype(np.float32)
    ds = PFS.slab_depth_static(xs, 2.0, 30.0, 6)
    xtab = K.depth_xtab(ds, 6, torch.device('cpu')).numpy()
    vol_shape, sem_shape = (2, 6, 11, 40, 3), (2, 10, 35, 2)
    gout = rng.randn(2, nz, ny, nx, 5).astype(np.float32)
    gv, gs = _emulate_k2_bwd(gout, att, u, v, xtab, pad, vol_shape,
                             sem_shape)
    wv, ws = K.frustum_voxel_features_bwd_plain(
        torch.from_numpy(gout), torch.from_numpy(att), torch.from_numpy(u),
        torch.from_numpy(v), ds, pad, vol_shape, sem_shape)
    np.testing.assert_allclose(gv, wv.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gs, ws.numpy(), atol=1e-5, rtol=1e-5)
    assert (wv.numpy() != 0).mean() > 0.05 and (ws.numpy() != 0).mean() > 0.3


def _k1_boxes(p, depth, hq, wq, h, w, step):
    """candidate_box (csrc/warp_prev.cu) in float64 numpy for every tile of
    an h x w prev map at one parameter row and depth: (h0, w0, width,
    count) per (row tile, column tile)."""
    p = p.astype(np.float64)
    dd = np.float64(np.float32(depth))
    org_w, flip, cox, coy, sf = p[12], p[13] > 0, p[14], p[15], p[16]
    fsf = 1.0 / p[17]
    m = np.array([[dd * p[4 * i], dd * p[4 * i + 1],
                   dd * p[4 * i + 2] + p[4 * i + 3]] for i in range(3)])
    adj = np.array([[m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1],
                     m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2],
                     m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]],
                    [m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2],
                     m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0],
                     m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]],
                    [m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0],
                     m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1],
                     m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]]])
    det = m[0] @ adj[:, 0]
    r0 = np.arange(0, h, BWD_WARPS)[:, None]
    c0 = np.arange(0, w, BWD_COLS)[None, :]
    nrows, ncols = np.minimum(BWD_WARPS, h - r0), np.minimum(BWD_COLS, w - c0)
    ws_, hs_, q2s = [], [], []
    for k in range(4):
        px = c0 + ncols + K1_MARGIN if k & 1 else c0 - 1 - K1_MARGIN
        py = r0 + nrows + K1_MARGIN if k & 2 else r0 - 1 - K1_MARGIN
        pu = (px * fsf + cox) / sf + 0 * py
        pv = (py * fsf + coy) / sf + 0 * px
        if flip:
            pu = org_w - pu
        q = [adj[i, 0] * pu + adj[i, 1] * pv + adj[i, 2] for i in range(3)]
        uu, vv = q[0] / q[2], q[1] / q[2]
        if flip:
            uu = org_w - uu
        ws_.append((uu * sf - cox) / step)
        hs_.append((vv * sf - coy) / step)
        q2s.append(q[2])
    ws_, hs_, q2s = np.stack(ws_), np.stack(hs_), np.stack(q2s)
    ok = (det != 0) & np.isfinite(ws_).all(0) & np.isfinite(hs_).all(0) & (
        (q2s > 0).all(0) | (q2s < 0).all(0))
    h0 = np.where(ok, np.maximum(np.ceil(hs_.min(0)), 0), 0)
    h1 = np.where(ok, np.minimum(np.floor(hs_.max(0)), hq - 1), hq - 1)
    w0 = np.where(ok, np.maximum(np.ceil(ws_.min(0)), 0), 0)
    w1 = np.where(ok, np.minimum(np.floor(ws_.max(0)), wq - 1), wq - 1)
    empty = (h0 > h1) | (w0 > w1)
    width = np.where(empty, 1, w1 - w0 + 1)
    return np.stack([np.where(empty, 0, h0), np.where(empty, 0, w0), width,
                     np.where(empty, 0, (h1 - h0 + 1) * width)],
                    -1).astype(np.int64)


def _k1_tap_owners_in_boxes(params, depths, hq, wq, h, w, step):
    """For every (pixel, tap) of nonzero weight of K1's forward (points
    from `sweep_coords_plain`, the kernel's bits), whether the box of the
    tile that owns the tap's cell holds the pixel, per depth; and the
    mean box size."""
    pu, pv = PCV.sweep_coords_plain(torch.from_numpy(params),
                                    torch.from_numpy(depths), hq, wq, step)
    pu, pv = pu.numpy(), pv.numpy()
    hh, ww = np.meshgrid(np.arange(hq), np.arange(wq), indexing='ij')
    held, sizes = [], []
    for b in range(len(params)):
        for di, dep in enumerate(depths):
            box = _k1_boxes(params[b], dep, hq, wq, h, w, step)
            sizes.append(box[..., 3].mean())
            (yi0, wy0), (yi1, wy1) = _taps(pv[b, di], h)
            (xi0, wx0), (xi1, wx1) = _taps(pu[b, di], w)
            for yi, wy in ((yi0, wy0), (yi1, wy1)):
                for xi, wx in ((xi0, wx0), (xi1, wx1)):
                    tap = np.float32(wx * wy) != 0
                    bx = box[yi[tap] // BWD_WARPS, xi[tap] // BWD_COLS]
                    hq_, wq_ = hh[tap], ww[tap]
                    held.append((hq_ >= bx[:, 0]) & (wq_ >= bx[:, 1]) &
                                (hq_ < bx[:, 0] + bx[:, 3] // bx[:, 2]) &
                                (wq_ < bx[:, 1] + bx[:, 2]))
    return np.concatenate(held), float(np.mean(sizes))


def test_k1_bwd_boxes_hold_every_tap_at_phase7b():
    """K1-bwd's candidate boxes at phase 7 (b)'s geometry (prev 320 x 1280,
    72 depths of 80 x 320 samples, KITTI-like intrinsics, 0.8 m forward
    ego-motion): the box of the tile that owns each (pixel, tap) of
    nonzero weight holds the pixel, so the walk finds it; a box holds
    about 21 pixels on average (the edge tiles' boxes clipped)."""
    import chip_smoke
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    cfg = DfMConfig()
    meta = chip_smoke.kitti_meta(1, 'cpu')
    params = PCV.sweep_params(meta.ori_cam2img, meta.cur2prev, meta.org_w,
                              meta.flip, meta.crop_offset,
                              meta.scale_factor, 1).numpy()
    depths = np.asarray(cfg.downsampled_depths(), np.float32)
    h, w = chip_smoke.IMG_HW
    s = cfg.cost_sample_factor
    held, size = _k1_tap_owners_in_boxes(params, depths, h // s, w // s, h,
                                         w, s)
    assert held.size > 5e6 and held.all()
    assert 10 < size < 40, size


def _emulate_k1_bwd(gout, params, depths, h, w, step):
    """warp_prev_bwd_kernel in float32 numpy: per block (b, row tile,
    column tile) the depths' boxes and their prefix sums, rounds of 256
    candidates (the depth by binary search, the pixel row-major in its
    box), the points from `sweep_coords_plain` (the kernel's bits), per
    warp the candidates with a tap in its row in order, the weights and
    sums rounded as the kernel rounds; every element written once, and
    each box pixel staged once."""
    f = np.float32
    b_, d, hq, wq, c = gout.shape
    pu, pv = PCV.sweep_coords_plain(torch.from_numpy(params),
                                    torch.from_numpy(depths), hq, wq, step)
    pu, pv = pu.numpy(), pv.numpy()
    out = np.full((b_, h, w, c), np.nan, f)
    for b in range(b_):
        boxes = [_k1_boxes(params[b], dep, hq, wq, h, w, step)
                 for dep in depths]
        for rt, r0 in enumerate(range(0, h, BWD_WARPS)):
            for ctile, c0 in enumerate(range(0, w, BWD_COLS)):
                nrows, ncols = min(BWD_WARPS, h - r0), min(BWD_COLS, w - c0)
                box = np.stack([bx[rt, ctile] for bx in boxes])
                cum = np.concatenate([[0], np.cumsum(box[:, 3])])
                acc = np.zeros((BWD_WARPS, BWD_COLS, c), f)
                staged = set()
                for k0 in range(0, cum[-1], K1_CAND):
                    ks = np.arange(k0, min(k0 + K1_CAND, cum[-1]))
                    dep = np.searchsorted(cum[:d], ks, side='right') - 1
                    i = ks - cum[dep]
                    hh = box[dep, 0] + i // box[dep, 2]
                    ww = box[dep, 1] + i % box[dep, 2]
                    staged |= set(zip(dep, hh, ww))
                    cu, cv = pu[b, dep, hh, ww], pv[b, dep, hh, ww]
                    (_, wy0), (_, wy1) = _taps(cv, h)
                    (_, wx0), (_, wx1) = _taps(cu, w)
                    crow, ccol = _floor_tap(cv, h), _floor_tap(cu, w)
                    for warp in range(nrows):
                        r = r0 + warp
                        j = ccol - c0
                        hit = ((crow == r) & (wy0 != 0) |
                               (crow + 1 == r) & (wy1 != 0)) & (
                            (j >= 0) & (j < ncols) & (wx0 != 0) |
                            (j >= -1) & (j + 1 < ncols) & (wx1 != 0))
                        for t in np.flatnonzero(hit):
                            g = gout[b, dep[t], hh[t], ww[t]]
                            wyr = wy0[t] if crow[t] == r else wy1[t]
                            for jj, wx in ((j[t], wx0[t]),
                                           (j[t] + 1, wx1[t])):
                                wt = f(wx * wyr)
                                if 0 <= jj < ncols and wt != 0:
                                    acc[warp, jj] = f(acc[warp, jj] +
                                                      f(wt * g))
                assert len(staged) == cum[-1]
                out[b, r0:r0 + nrows, c0:c0 + ncols] = acc[:nrows, :ncols]
    return out


@pytest.mark.parametrize('fsf', [4, 1])
def test_k1_bwd_emulation_is_the_plain_gradient(fsf):
    """The K1-bwd walk emulated in float32 numpy at the `aug_b2` sweep (B =
    2, one sample flipped, cropped and scaled; prev 48 x 160 (fsf 4, step
    16) or 36 x 100 (fsf 1, step 4, ragged tiles)), against
    `warp_prev_sweep_bwd_plain` (atol 1e-5 + rtol 1e-5: autograd sums in
    another order); every element written, and the boxes hold every
    (pixel, tap) of nonzero weight."""
    cam = np.array([[700., 0, 310, 12], [0, 700., 95, 0.3],
                    [0, 0, 1, 0.004], [0, 0, 0, 1]], np.float32)
    c2p = np.repeat(np.eye(4, dtype=np.float32)[None], 2, 0)
    c2p[:, :3, 3] = [(0.3, -0.05, -0.9), (-0.1, 0.02, 1.2)]
    c2p[0, 0, 2], c2p[0, 2, 0] = 0.02, -0.02
    params = PCV.sweep_params(
        torch.from_numpy(np.repeat(cam[None], 2, 0)), torch.from_numpy(c2p),
        torch.tensor([1242.0, 640.0]), torch.tensor([1.0, 0.0]),
        torch.tensor([[6.0, 2.0], [0.0, 0.0]]), torch.tensor([0.5, 1.0]),
        fsf).numpy()
    depths = np.linspace(2.5, 40.0, 5).astype(np.float32)
    (h, w), step, hq, wq = ((48, 160), 16, 12, 40) if fsf == 4 else \
        ((36, 100), 4, 9, 25)
    held, _ = _k1_tap_owners_in_boxes(params, depths, hq, wq, h, w, step)
    assert held.all()
    rng = np.random.RandomState(8)
    gout = rng.randn(2, len(depths), hq, wq, 3).astype(np.float32)
    got = _emulate_k1_bwd(gout, params, depths, h, w, step)
    want = K.warp_prev_sweep_bwd_plain(
        torch.from_numpy(gout), torch.from_numpy(params),
        torch.from_numpy(depths), (2, h, w, 3), step).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (want != 0).mean() > 0.1
