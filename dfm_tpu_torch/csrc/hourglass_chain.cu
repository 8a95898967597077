// K5 conv_s2_p2d and K6 pack_parity8: the two full-resolution ends of the
// 3D hourglass on the conv chain's storage format.
//
// Replace the TPU kernels of dfm_tpu/ops/pallas/conv_chain.py:
//   conv_s2_p2d  -> _conv_s2_call    (_conv_s2_kernel)
//   pack_parity8 -> _pack_zpair_call (_pack_zpair_kernel, and the H / W
//                                     interleaves its wrapper left to XLA)
// Plain versions and the format: dfm_tpu_torch/ops/conv_chain.py. The
// chain format is a (D, H, W, 32) bf16 volume stored as
// (D+2, H+2, W+2, 32), channels innermost, with a border of stored zeros.
// The TPU kernels' z-in-lanes blocks, phases, the compute-every-column-
// then-subsample trick and the one-hot placement matmuls exist for a
// 128-lane matrix unit without strided selects and are not carried over.
//
// K5 (namespace k5) is bound by bytes at the card's peaks (25.5 GFLOP
// at 72x80x320 against ~155 MB, 0.026 ms against 0.046 ms): an implicit
// GEMM, M = output voxels, N = 64 output channels, K = 27 taps x 32 input
// channels, on the Hopper machinery of K4 (wgmma.cuh):
//   - wgmma m64n64k16, bf16 operands, f32 accumulators, A and B read from
//     shared memory through K-major descriptors (A 64-byte swizzled, B
//     not). The stored zero border is the conv's padding: output
//     (m, n, t) reads stored [2m .. 2m+2] of each axis.
//   - The stride-2 column walk: a slice arrives split by column parity,
//     as two TMA boxes with element stride 2 along W (65 stored columns
//     of all 32 channels each, starting at column 2 x0 for parity 0 and
//     2 x0 + 1 for parity 1), so tap dx reads parity dx & 1 at column
//     t + (dx >> 1): a stride-1 walk of 64-byte rows, and a tap only
//     moves A's start address. The boxes are 64 bytes wide with TMA's
//     64-byte swizzle, which the A descriptor reads back (desc_hi_sw64):
//     boxes of 8 channels (16 bytes) take the card about twice as long
//     to load (`python -m dfm_tpu_torch.probe_k5`, PERF.md).
//   - A 2 x 64 output tile (one m64 tile for each of two consumer
//     warpgroups) needs 5 stored rows. The weights (110.6 KB) stay in
//     shared memory, so a ring slot holds one parity of a stored slice
//     ([row 5][column 65][32 ch], 21 KB), and the ring has five: the
//     producer warp keeps 1.5 slices in flight while the tensor cores
//     work on one.
//   - Stored slices are consumed in order, each once: an odd slice 2m+1
//     feeds output m through dz = 1; an even slice 2m feeds m-1 through
//     dz = 2, which completes it, and m through dz = 0, into the other of
//     two accumulator sets. The epilogue of m-1 then runs in registers
//     while the tensor cores work on m's first taps (a slice's products
//     are waited for one group later, so its slots are released then):
//     f32 moments of the unrounded result, the quad transpose, 16-byte
//     stores of the dense (D/2, H/2, W/2, 64) output.
//   - Moments per (output slice, tile): lanes, then warps, then the eight
//     warps summed in a fixed order, no atomics: identical bits on every
//     run.
//   - A persistent grid of one block per SM walks an equal share of the
//     (tile, output slice) work items, tile-major; each new tile in a
//     block's share costs one extra stored slice.
//
// K6 is bound by bytes (one read of the eight sub-volumes, one write of
// the chain tensor): one block per stored row, one thread per 16 bytes,
// the whole interleave (z, y and x) and the zero border in the one pass.
// The sub-volumes come with their strides, so the kernel reads the tap
// products where the matrix product left them (channels innermost, the
// eight parities of a half-resolution voxel side by side).
// A thread's chunk index within a voxel never changes along the row, so
// it keeps the sums of its eight channels in registers; they are reduced
// lane -> warp -> block in a fixed order and written per (slice, row).
#include <stdint.h>

#include "wgmma.cuh"

namespace k5 {

using namespace hop;
using bf16 = __nv_bfloat16;

constexpr int kC = 32, kN = 64;              // channels in, out
constexpr int TY = 2, TX = 64;               // output tile (rows, columns)
constexpr int SY = 2 * TY + 1;               // stored rows of a tile
constexpr int SXP = TX + 1;                  // stored columns of a parity
constexpr int kBox = SY * SXP * kC * 2;      // bytes of one parity's box
constexpr int kSlot = (kBox + 1023) / 1024 * 1024;   // a ring slot, aligned
constexpr int kRing = 5;
constexpr int kTapBytes = kC * kN * 2;       // weights of one tap
constexpr int kWBytes = 27 * kTapBytes;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kRedFloats = 2 * 8 * 2 * kN;   // [buffer 2][warp 8][s, s2][64]
constexpr int kSmem = kRing * kSlot + kWBytes + kRedFloats * 4 +
                      (2 * kRing + 1) * 8;   // 226,392 bytes
static_assert(kSmem <= 232448, "more shared memory than a block may have");

// The taps dz of one stored slice (its two ring slots, p0: even stored
// columns, p1: odd ones) into acc, for output row wg of the tile;
// `fresh`: the first product overwrites acc.
__device__ __forceinline__ void taps(float (&acc)[32], uint32_t p0,
                                     uint32_t p1, uint64_t bdesc, int dz,
                                     int wg, bool fresh) {
  constexpr uint64_t kAHi = desc_hi_sw64();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int tap = (dz * 3 + dy) * 3 + dx;
        const uint64_t b = bdesc + ((tap * kTapBytes + ks * 2 * kN * 16) >> 4);
        // output column t reads stored column 2 (x0 + t) + dx: parity
        // dx & 1, column t + (dx >> 1) of that parity's box; channels
        // 16 ks .. 16 ks + 15 are bytes 32 ks .. of its 64-byte row
        const uint32_t a = ((dx & 1) ? p1 : p0) +
                           ((2 * wg + dy) * SXP + (dx >> 1)) * 64 + ks * 32;
        const uint32_t scale = (fresh && (dy | dx | ks) == 0) ? 0u : 1u;
        wgmma<64>(acc, kAHi | (a >> 4), b, scale);
      }
}

// Epilogue of output slice m, row y of the tile at x0, from its complete
// accumulators (the warpgroup's m64 tile): accumulator i is voxel column
// 16 wq + g8 + 8 ((i >> 1) & 1), channel 8 (i >> 2) + 2 q + (i & 1).
// Stores the rounded result (16 bytes a lane, after the quad transpose)
// and the f32 moments of the unrounded one for (m, tile); `rb` is this
// slice's half of the moment buffers.
__device__ __forceinline__ void epilogue(const float (&acc)[32],
                                         bf16* __restrict__ out,
                                         float* __restrict__ ps, float* rb,
                                         int m, int tile, int ntiles, int y,
                                         int x0, int H2, int W2, int tid) {
  const int warp = tid >> 5, wq = warp & 3, lane = tid & 31;
  const int q = lane & 3, g8 = lane >> 2;
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) ok[h] = y < H2 && x0 + 16 * wq + g8 + 8 * h < W2;
  // group g: chunks k = 2 h + e, octet jj = 2 g + e of column 16 wq + g8
  // + 8 h, through the quad transpose; then the moments of its two
  // octets are complete
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s[4], s2[4];    // channel 8 (2 g + (c >> 1)) + 2 q + (c & 1) at c
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = s2[c] = 0.f;
    uint32_t p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = k >> 1, e = k & 1, jj = 2 * g + e;
      const float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
      const float f0 = ok[h] ? v0 : 0.f, f1 = ok[h] ? v1 : 0.f;
      s[2 * e] += f0;
      s2[2 * e] += f0 * f0;
      s[2 * e + 1] += f1;
      s2[2 * e + 1] += f1 * f1;
      p[k] = pack_bf16x2(v0, v1);
    }
    quad_transpose(p, q);
    const int h = q >> 1, jj = 2 * g + (q & 1);
    const int x = x0 + 16 * wq + g8 + 8 * h;
    if (y < H2 && x < W2)
      *reinterpret_cast<uint4*>(
          out + (((long long)m * H2 + y) * W2 + x) * kN + 8 * jj) =
          make_uint4(p[0], p[1], p[2], p[3]);
    // lanes with the same q hold the same channels; fixed-order trees,
    // no atomics
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
        s2[c] += __shfl_xor_sync(0xffffffffu, s2[c], off);
      }
    }
    if (g8 == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ch = 8 * (2 * g + (c >> 1)) + 2 * q + (c & 1);
        rb[warp * 2 * kN + ch] = s[c];
        rb[warp * 2 * kN + kN + ch] = s2[c];
      }
    }
  }
  // the two buffers alternate: a buffer is written again only after the
  // next epilogue's barrier, which its readers pass after reading
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  if (tid < 2 * kN) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t += rb[w * 2 * kN + tid];
    ps[((long long)m * ntiles + tile) * (2 * kN) + tid] = t;
  }
}

// The ring slots (its two column parities) of stored slice j of a segment
// whose first load is `load`.
struct Slots {
  uint32_t p0, p1, full0, full1, empty0, empty1, par0, par1;
  __device__ __forceinline__ Slots(uint32_t ring_a, uint32_t bar_a,
                                   int load, int j) {
    const int l = load + 2 * j, s0 = l % kRing, s1 = (l + 1) % kRing;
    p0 = ring_a + s0 * kSlot;
    p1 = ring_a + s1 * kSlot;
    full0 = bar_a + 8 * s0;
    full1 = bar_a + 8 * s1;
    empty0 = bar_a + 8 * (kRing + s0);
    empty1 = bar_a + 8 * (kRing + s1);
    par0 = (l / kRing) & 1;
    par1 = ((l + 1) / kRing) & 1;
  }
  __device__ __forceinline__ void wait() const {
    mbar_wait(full0, par0);
    mbar_wait(full1, par1);
  }
  __device__ __forceinline__ void release() const {
    mbar_arrive(empty0);
    mbar_arrive(empty1);
  }
};

// Output slice m0 + i of a segment: its odd stored slice 2 i + 1 (dz =
// 1) and its even stored slice 2 i + 2 (dz = 2, which completes it, and
// dz = 0 of the next output, into `b`), then its epilogue from `a` while
// the tensor cores work on `b`. On entry at most one group is running
// (on `a`, reading slice 2 i, which is released here); on return at most
// one (on `b`, reading slice 2 i + 2), none after the segment's last.
__device__ __forceinline__ void output_slice(
    float (&a)[32], float (&b)[32], uint32_t ring_a, uint32_t bar_a,
    uint64_t bdesc, int load, int i, int n, int wg, bf16* __restrict__ out,
    float* __restrict__ ps, float* rb, int m, int tile, int ntiles, int y,
    int x0, int H2, int W2, int tid) {
  const Slots prev(ring_a, bar_a, load, 2 * i);
  const Slots odd(ring_a, bar_a, load, 2 * i + 1);
  const Slots even(ring_a, bar_a, load, 2 * i + 2);
  odd.wait();
  __syncwarp();
  fence_regs(a);
  wgmma_fence();
  taps(a, odd.p0, odd.p1, bdesc, 1, wg, false);
  wgmma_commit();
  wgmma_wait<1>();
  prev.release();

  even.wait();
  __syncwarp();
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
  taps(a, even.p0, even.p1, bdesc, 2, wg, false);
  wgmma_commit();
  const bool last = i == n - 1;
  if (!last) {
    taps(b, even.p0, even.p1, bdesc, 0, wg, true);
    wgmma_commit();
    wgmma_wait<1>();
  } else {
    wgmma_wait<0>();
  }
  fence_regs(a);
  odd.release();
  if (last) even.release();
  epilogue(a, out, ps, rb, m, tile, ntiles, y, x0, H2, W2, tid);
}

// One block per SM. tmap: the chain tensor (D+2, H+2, W+2, 32) as dims
// (32 ch, W+2, H+2, D+2), box (32, 2 SXP, SY, 1), element stride 2 on W,
// 64-byte swizzle.
// wt: [tap 27][octet 4][n 64][8 k] bf16. out: dense (D2, H2, W2, 64);
// ps (D2, tiles, 2, 64). Work item u = tile * D2 + m; block b takes
// [b * units / grid, (b + 1) * units / grid).
__global__ void __launch_bounds__(kThreads, 1)
conv_s2_kernel(const __grid_constant__ CUtensorMap tmap,
               const bf16* __restrict__ wt, bf16* __restrict__ out,
               float* __restrict__ ps, int D2, int H2, int W2, int tiles_x,
               int units) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + kRing * kSlot + kWBytes);
  const uint32_t ring_a = smem_u32(smem);
  const uint32_t w_a = ring_a + kRing * kSlot;
  const uint32_t bar_a = smem_u32(red + kRedFloats);
  // full[i] = bar_a + 8 i, empty[i] = bar_a + 8 (kRing + i), weights
  const uint32_t wbar = bar_a + 16 * kRing;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(bar_a + 8 * i, 1);
      mbar_init(bar_a + 8 * (kRing + i), kConsumers);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int ntiles = units / D2;
  const int begin = (int)((long long)blockIdx.x * units / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    // producer: the weights once, then the two column parities of every
    // stored slice of every segment of this block's share, in the order
    // the consumers use them
    mbar_expect_tx(wbar, kWBytes);
    for (int t = 0; t < 27; ++t)
      bulk_load(w_a + t * kTapBytes,
                reinterpret_cast<const unsigned char*>(wt) + t * kTapBytes,
                kTapBytes, wbar);
    int load = 0;
    for (int u = begin; u < end;) {
      const int tile = u / D2, m0 = u - tile * D2, n = min(D2 - m0, end - u);
      const int ty = tile / tiles_x;
      const int y0 = ty * TY, x0 = (tile - ty * tiles_x) * TX;
      // outputs m0 .. m0 + n - 1 read stored slices 2 m0 .. 2 (m0 + n)
      for (int s = 2 * m0; s <= 2 * (m0 + n); ++s) {
        for (int p = 0; p < 2; ++p, ++load) {
          const int slot = load % kRing, round = load / kRing;
          if (round > 0)
            mbar_wait(bar_a + 8 * (kRing + slot), (round - 1) & 1);
          const uint32_t full = bar_a + 8 * slot;
          mbar_expect_tx(full, kBox);
          tma_load_4d(ring_a + slot * kSlot, &tmap, full, 0, 2 * x0 + p,
                      2 * y0, s);
        }
      }
      u += n;
    }
    return;
  }

  // consumers: warpgroup wg owns output row wg of the tile (one m64
  // tile of 64 columns); warp wq owns columns 16 wq .. 16 wq + 15. Two
  // accumulator sets take turns: output slice m0 + i of a segment
  // completes in set i & 1 while the next one starts in the other.
  const int tid = threadIdx.x, wg = tid >> 7;
  const uint64_t bdesc = desc_hi(kN * 16, 128) | (w_a >> 4);
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  int load = 0, buf = 0;
  mbar_wait(wbar, 0);
  for (int u = begin; u < end;) {
    const int tile = u / D2, m0 = u - tile * D2, n = min(D2 - m0, end - u);
    const int ty = tile / tiles_x;
    const int y0 = ty * TY, x0 = (tile - ty * tiles_x) * TX;
    const int y = y0 + wg;
    // stored slice 2 m0 starts output m0 (dz = 0)
    const Slots first(ring_a, bar_a, load, 0);
    first.wait();
    __syncwarp();
    fence_regs(acc0);
    wgmma_fence();
    taps(acc0, first.p0, first.p1, bdesc, 0, wg, true);
    wgmma_commit();
    for (int i = 0; i < n; ++i, buf ^= 1) {
      float* rb = red + buf * (8 * 2 * kN);
      if (i & 1)
        output_slice(acc1, acc0, ring_a, bar_a, bdesc, load, i, n, wg, out,
                     ps, rb, m0 + i, tile, ntiles, y, x0, H2, W2, tid);
      else
        output_slice(acc0, acc1, ring_a, bar_a, bdesc, load, i, n, wg, out,
                     ps, rb, m0 + i, tile, ntiles, y, x0, H2, W2, tid);
    }
    load += 2 * (2 * n + 1);
    u += n;
  }
}

}  // namespace k5

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 32;                 // channels of the chain
constexpr int kChunks = kC / 8;        // 16-byte chunks of a chain voxel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ----------------------------------------------------------------- K6

// par: (8, D2, H2, W2, 32) bf16 as 16-byte chunks, sub-volume p = 4 rz +
// 2 ry + rx, with strides sp, sm, sn, st (in chunks) of its first four
// axes. chain: (D+2, H+2, W+2, 32) with D = 2 D2 and so on. ps:
// (D, H, 2, 32) f32. grid (H+2, D+2): one block per stored row.
__global__ void __launch_bounds__(kThreads)
pack_parity8_kernel(const uint4* __restrict__ par, uint4* __restrict__ chain,
                    float* __restrict__ ps, int D2, int H2, int W2,
                    long long sp, long long sm, long long sn, long long st) {
  __shared__ float red[kWarps][2 * kC];
  const int H = 2 * H2, W = 2 * W2, D = 2 * D2;
  const int py = blockIdx.x, pz = blockIdx.y;
  uint4* row = chain + ((long long)pz * (H + 2) + py) * (W + 2) * kChunks;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (pz == 0 || pz == D + 1 || py == 0 || py == H + 1) {
    for (int i = threadIdx.x; i < (W + 2) * kChunks; i += kThreads)
      row[i] = zero;
    return;
  }
  const int z = pz - 1, y = py - 1;
  // sub-volume row of column parity rx: (4 rz + 2 ry + rx, z/2, y/2)
  const uint4* src0 =
      par + (4 * (z & 1) + 2 * (y & 1)) * sp + (z >> 1) * sm + (y >> 1) * sn;
  const int q = threadIdx.x % kChunks;   // the same for every i below
  float sum[8], sq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sum[j] = sq[j] = 0.f;
  for (int i = threadIdx.x; i < (W + 2) * kChunks; i += kThreads) {
    const int px = i / kChunks;
    uint4 v = zero;
    if (px >= 1 && px <= W) {
      const int x = px - 1;
      v = __ldg(src0 + (x & 1) * sp + (x >> 1) * st + q);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        sum[j] += f;
        sq[j] += f * f;
      }
    }
    row[i] = v;
  }
  // lanes with the same q = lane % 4 hold the same channels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
      sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], off);
    }
  }
  if (lane < kChunks) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[warp][q * 8 + j] = sum[j];
      red[warp][kC + q * 8 + j] = sq[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w][threadIdx.x];
    ps[((long long)z * H + y) * (2 * kC) + threadIdx.x] = t;
  }
}

}  // namespace

// chain in (2 D2 + 2, 2 H2 + 2, 2 W2 + 2, 32) bf16, on 16 bytes -> dense
// out (D2, H2, W2, 64) + ps (D2, tiles, 2, 64) f32, tiles = ceil(H2/2) *
// ceil(W2/64), refused (cudaErrorInvalidValue) when the caller sized ps
// for another count; wt: [tap 27][octet 4][n 64][8 k] bf16; blocks = the
// persistent grid (one block per SM).
extern "C" int dfm_conv_s2(const void* in, const void* wt, void* out,
                           float* ps, int D2, int H2, int W2, int tiles,
                           int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W2 + k5::TX - 1) / k5::TX;
  const int tiles_y = (H2 + k5::TY - 1) / k5::TY;
  if (tiles != tiles_x * tiles_y || blocks < 1 ||
      (long long)tiles * D2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!hop::volume_tensor_map(&map, in, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2,
                              k5::kC, k5::kC, 2 * k5::SXP, k5::SY, 2,
                              CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      k5::conv_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k5::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int units = tiles * D2;
  k5::conv_s2_kernel<<<min(blocks, units), k5::kThreads, k5::kSmem, s>>>(
      map, static_cast<const bf16*>(wt), static_cast<bf16*>(out), ps, D2, H2,
      W2, tiles_x, units);
  return (int)cudaGetLastError();
}

// par (8, D2, H2, W2, 32) bf16, channels contiguous, the other axes with
// element strides sp, sm, sn, st (multiples of 8) -> chain (2 D2 + 2,
// 2 H2 + 2, 2 W2 + 2, 32) bf16 (border zeroed here) + ps
// (2 D2, 2 H2, 2, 32) f32.
extern "C" int dfm_pack_parity8(const void* par, void* chain, float* ps,
                                int D2, int H2, int W2, long long sp,
                                long long sm, long long sn, long long st,
                                void* stream) {
  if ((sp | sm | sn | st) % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid(2 * H2 + 2, 2 * D2 + 2);
  pack_parity8_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(par), static_cast<uint4*>(chain), ps, D2, H2,
      W2, sp / 8, sm / 8, sn / 8, st / 8);
  return (int)cudaGetLastError();
}
