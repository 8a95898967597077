// K9b conv3d_pallas and K9a conv3d_zpack on Hopper (conv3d.cu,
// dfm_conv3d_wgmma): the 3x3x3 stride-1 'same' bf16 convolution of a
// dense (D, H, W, C) volume, channels innermost, into N output channels
// of a dense (D, H, W, Cout) volume (a chunk [co0, co0 + N) of them),
// f32 accumulation; the kMoments instance (K9a) also writes the GroupNorm
// moments of the unrounded result. Replaces
// dfm_tpu/ops/pallas/conv3d.py:conv3d_pallas (pallas_call at :119) and
// dfm_tpu/ops/pallas/convgn.py:conv3d_zpack (pallas_call at :162) for
// bf16 with C % 8 == 0 and Cout % 8 == 0 (the wrappers route every other
// type and width to the direct kernel of conv3d.cu).
//
// Bound by operations: an implicit GEMM, M = output voxels, N = output
// channels, K = 27 taps x C input channels (101.9 GFLOP at 72x80x320,
// C = Cout = 32). It is K4's design (conv_p2p.cuh) on a dense tensor:
//   - The 'same' padding comes from TMA: one tiled tensor map over the
//     dense volume, boxes that start at -1 on D, H and W, and TMA's zero
//     fill outside the tensor. No padded copy, no stored border.
//   - A slice of the 8 x 64 output tile with its halo (10 x 66 voxels)
//     arrives as one box of 8 channels per octet plane ([octet][row]
//     [column][8 ch], the plane stride 128-aligned) into a ring of
//     mbarrier-guarded slots fed by one producer warp. K steps of 16
//     channels take two planes; for an odd number of octets the last
//     plane's box starts at channel C and is TMA's zero fill.
//   - wgmma m64nNk16 (N = 8, 16 or 32) with A and B read from shared
//     memory through no-swizzle K-major descriptors: a tap (dy, dx) only
//     moves A's start address. The weights, [tap 27][octet koct][n N]
//     [8 k] (zeros in a padding octet), are loaded once per block.
//   - Two consumer warpgroups own four output rows each (four m64 tiles).
//     Epilogue in registers: the bf16 pairs of four 16-byte chunks go
//     through the quad transpose, so every lane stores 16 bytes; masks
//     for a ragged last tile in H and W.
//   - A persistent grid of one block per SM walks an equal share of the
//     (tile, depth slice) work items, tile-major; each new tile in a
//     block's share costs two extra halo slices.
//   - Moments (kMoments, K9a): per (depth slice, row, 64-column tile) and
//     channel the f32 sum and sum of squares of the unrounded
//     accumulators, columns past W adding nothing: a granularity that
//     folds into the JAX layout for any row band th dividing H. One m64
//     tile (one row) at a time, so the sums stay transient: each thread
//     sums its two columns, a lane reduce-scatter over g8 sums the warp's
//     16 columns, and the four warps of the warpgroup are summed in a
//     fixed order through a double-buffered shared-memory area behind a
//     named barrier of that warpgroup's 128 threads (the other warpgroup
//     and the producer do not wait). Every product and sum rounded alone,
//     no atomics: identical bits on every run.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace k9 {

using namespace hop;
using bf16 = __nv_bfloat16;

constexpr int TY = 8, TX = 64;               // output tile (rows, columns)
constexpr int SY = TY + 2, SX = TX + 2;      // input slice with its halo
constexpr int kBox = SY * SX * 16;           // bytes of one octet plane
constexpr int kOct = (kBox + 127) / 128 * 128;   // plane stride, 128-aligned
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kMaxSmem = 232448;
constexpr int kMaxRing = 4;
// moment buffer bytes per output channel: [warpgroup 2][buffer 2][warp 4]
// [sum, sum of squares] f32
constexpr int kRedBytes = 2 * 2 * 4 * 2 * 4;

// Shared memory of a block: the ring, the weights, the moment buffer
// (kMoments), the barriers.
__host__ __device__ constexpr int smem_bytes(int koct, int n, int ring,
                                             bool moments) {
  return ring * koct * kOct + 27 * koct * n * 16 + moments * kRedBytes * n +
         (2 * ring + 1) * 8;
}

// The deepest ring (at most kMaxRing slots) that fits beside the weights
// of `koct` octets x n output channels; below 3 the kernel cannot run
// (an output slice reads three input slices at once).
__host__ __device__ constexpr int ring_slots(int koct, int n, bool moments) {
  int r = kMaxRing;
  while (r > 0 && smem_bytes(koct, n, r, moments) > kMaxSmem) --r;
  return r;
}

// One step of the reduce-scatter of `moments`: lanes `off` apart swap
// halves of their first LEN values, each keeps the half of its lane bit
// summed with its partner's copy.
template <int V, int LEN>
__device__ __forceinline__ void halve(float (&v)[V], int off) {
  const bool hi = threadIdx.x & off;
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float send = hi ? v[i] : v[LEN / 2 + i];
    const float keep = hi ? v[LEN / 2 + i] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
  }
}

// The moments of one output slice o of a tile (kMoments): row y0w + m of
// the warpgroup's four, for m = 0..3; this thread's columns x and x + 8
// (accumulator 4 j + 2 h + e: column x + 8 h, channel 8 j + 2 q + e).
// Per m: the thread's V = N / 2 values (the sums of its N / 4 channels,
// then their sums of squares) over its two columns; a reduce-scatter
// over g8 (lane offsets 16, 8, 4: the tree of a butterfly in that order)
// leaves lane g8 with values R g8 .. R g8 + R - 1 (R = V / 8; for N = 8
// the last step is a butterfly, lane pairs hold value g8 / 2); the lanes
// put them into buffer m & 1 of the warpgroup, and after the
// warpgroup's barrier its first 2 N threads add the four warps' sums in
// order 0..3 and write them. A buffer is written again two barriers
// later, which its readers pass only after reading it.
template <int N>
__device__ __forceinline__ void moments(float (&acc)[4][N / 2],
                                        float* __restrict__ red,
                                        float* __restrict__ ps, int o,
                                        int y0w, int x, int tx, int H, int W,
                                        int tiles_x, int cout, int co0) {
  constexpr int V = N / 2, R = V >= 8 ? V / 8 : 1;
  const int tid = threadIdx.x, wg = tid >> 7, wq = (tid >> 5) & 3;
  const int t = tid & 127, q = tid & 3, g8 = (tid & 31) >> 2;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float v[V];   // [k] sum of channel 8 (k >> 1) + 2 q + (k & 1), [V/2 + k]
                  // its sum of squares
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = x + 8 * h < W;
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const float f = ok ? acc[m][2 * k + 2 * h - (k & 1)] : 0.f;
        v[k] = __fadd_rn(v[k], f);
        v[V / 2 + k] = madd(f, f, v[V / 2 + k]);
      }
    }
    halve<V, V>(v, 16);
    halve<V, V / 2>(v, 8);
    if constexpr (V >= 8)
      halve<V, V / 4>(v, 4);
    else
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], 4));
    float* rb = red + (wg * 2 + (m & 1)) * 4 * 2 * N;
    if (V >= 8 || (g8 & 1) == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int idx = V >= 8 ? R * g8 + i : g8 >> 1;
        const int k = idx % (V / 2), sel = idx / (V / 2);
        rb[wq * 2 * N + sel * N + 8 * (k >> 1) + 2 * q + (k & 1)] = v[i];
      }
    }
    if (wg == 0)   // named barriers 1 and 2, one per warpgroup
      asm volatile("bar.sync 1, 128;" ::: "memory");
    else
      asm volatile("bar.sync 2, 128;" ::: "memory");
    const int y = y0w + m;
    if (t < 2 * N && y < H) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum = __fadd_rn(sum, rb[w * 2 * N + t]);
      ps[(((long long)o * H + y) * tiles_x + tx) * (2 * cout) +
         (t >= N) * cout + co0 + (t & (N - 1))] = sum;
    }
  }
}

// One block per SM. tmap: the dense input (D, H, W, C) as dims (C, W, H,
// D), box (8, SX, SY, 1). wt: [tap 27][octet 2 KS][n N][8 k] bf16 (KS
// k16 steps). out: (D, H, W, cout) bf16, this launch writes channels
// [co0, co0 + N); ps (kMoments; D, H, tiles_x, 2, cout) f32, the same
// channels. Work item u = tile * D + z; block b takes [b * units / grid,
// (b + 1) * units / grid).
template <int N, int KS, bool kMoments>
__global__ void __launch_bounds__(kThreads, 1)
conv_dense_kernel(const __grid_constant__ CUtensorMap tmap,
                  const bf16* __restrict__ wt, bf16* __restrict__ out,
                  float* __restrict__ ps, int D, int H, int W, int ring,
                  int tiles_x, int units, int cout, int co0) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int koct = 2 * KS;
  constexpr int slot_bytes = koct * kOct;
  constexpr int tap_bytes = koct * N * 16;
  const uint32_t ring_a = smem_u32(smem);
  const uint32_t w_a = ring_a + ring * slot_bytes;
  // after the weights the moment buffer (kMoments), [warpgroup][buffer]
  // [warp][sum, sum of squares][N] f32, then the barriers
  const uint32_t bar_a = w_a + 27 * tap_bytes + kMoments * kRedBytes * N;
  // full[i] = bar_a + 8 i, empty[i] = bar_a + 8 (ring + i), weights
  const uint32_t wbar = bar_a + 16 * ring;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(bar_a + 8 * i, 1);
      mbar_init(bar_a + 8 * (ring + i), kConsumers);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int begin = (int)((long long)blockIdx.x * units / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    // producer: the weights once, then every slice of every segment of
    // this block's share, in the order the consumers use them
    mbar_expect_tx(wbar, 27 * tap_bytes);
    for (int t = 0; t < 27; ++t)
      bulk_load(w_a + t * tap_bytes,
                reinterpret_cast<const unsigned char*>(wt) + t * tap_bytes,
                tap_bytes, wbar);
    int load = 0;
    for (int u = begin; u < end;) {
      const int tile = u / D, z0 = u - tile * D, n = min(D - z0, end - u);
      const int ty = tile / tiles_x;
      const int y0 = ty * TY, x0 = (tile - ty * tiles_x) * TX;
      // input slices z0 - 1 .. z0 + n: the halo slices of D's ends, and
      // rows and columns outside the volume, are TMA's zero fill
      for (int s = z0 - 1; s < z0 + n + 1; ++s, ++load) {
        const int slot = load % ring, round = load / ring;
        if (round > 0) mbar_wait(bar_a + 8 * (ring + slot), (round - 1) & 1);
        const uint32_t full = bar_a + 8 * slot;
        mbar_expect_tx(full, koct * kBox);
        for (int c8 = 0; c8 < koct; ++c8)
          tma_load_4d(ring_a + slot * slot_bytes + c8 * kOct, &tmap, full,
                      c8 * 8, x0 - 1, y0 - 1, s);
      }
      u += n;
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows 4 wg .. 4 wg + 3; in each m64
  // tile (one row, 64 columns) warp wq owns columns 16 wq .. 16 wq + 15
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int wq = warp & 3, lane = tid & 31, q = lane & 3, g8 = lane >> 2;
  const uint64_t a_hi = desc_hi(kOct, 128);
  const uint64_t bdesc = desc_hi(N * 16, 128) | (w_a >> 4);
  constexpr int NJ = N / 8;            // 16-byte chunks of a voxel's output
  float acc[4][N / 2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
  int load = 0;
  mbar_wait(wbar, 0);
  for (int u = begin; u < end;) {
    const int tile = u / D, z0 = u - tile * D, n = min(D - z0, end - u);
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int y0 = ty * TY, x0 = tx * TX;
    for (int i = 0; i < n; ++i) {
      // output slice o = z0 + i reads input slices o - 1, o, o + 1:
      // loads l0, l0 + 1, l0 + 2 of the ring
      const int o = z0 + i, l0 = load + i;
      for (int dz = 0; dz < 3; ++dz)
        mbar_wait(bar_a + 8 * ((l0 + dz) % ring), ((l0 + dz) / ring) & 1);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
      wgmma_fence();
      for (int dz = 0; dz < 3; ++dz) {
        const uint32_t sa = ring_a + ((l0 + dz) % ring) * slot_bytes;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int tap = (dz * 3 + dy) * 3 + dx;
              const uint64_t b =
                  bdesc + ((tap * tap_bytes + ks * 2 * N * 16) >> 4);
              const uint32_t scale = (dz | dy | dx | ks) ? 1u : 0u;
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const uint32_t a = sa + ks * 2 * kOct +
                                   ((wg * 4 + m + dy) * SX + dx) * 16;
                wgmma<N>(acc[m], a_hi | (a >> 4), b, scale);
              }
            }
        }
      }
      wgmma_commit_wait();
#pragma unroll
      for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
      mbar_arrive(bar_a + 8 * (ring + l0 % ring));   // slice o - 1 is done
      if (i == n - 1) {   // the segment's last two slices are done
        mbar_arrive(bar_a + 8 * (ring + (l0 + 1) % ring));
        mbar_arrive(bar_a + 8 * (ring + (l0 + 2) % ring));
      }

      // epilogue: chunk k = (m * 2 + h) * NJ + j of this thread is the
      // octet j of the voxel in row 4 wg + m, column 16 wq + g8 + 8 h;
      // the lane holds its bf16 pair q. Four chunks at a time go through
      // the quad transpose, after which the lane holds chunk 4 g + q.
#pragma unroll
      for (int g = 0; g < 2 * NJ; ++g) {
        uint32_t p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * g + k, m = c / (2 * NJ), h = (c / NJ) & 1;
          const int j = c % NJ;
          p[k] = pack_bf16x2(acc[m][4 * j + 2 * h], acc[m][4 * j + 2 * h + 1]);
        }
        quad_transpose(p, q);
        const int c = 4 * g + q, m = c / (2 * NJ), h = (c / NJ) & 1;
        const int j = c % NJ;
        const int y = y0 + wg * 4 + m, x = x0 + 16 * wq + g8 + 8 * h;
        if (y < H && x < W)
          *reinterpret_cast<uint4*>(
              out + (((long long)o * H + y) * W + x) * cout + co0 + 8 * j) =
              make_uint4(p[0], p[1], p[2], p[3]);
      }
      if constexpr (kMoments)
        moments<N>(acc,
                   reinterpret_cast<float*>(smem + ring * slot_bytes +
                                            27 * tap_bytes),
                   ps, o, y0 + wg * 4, x0 + 16 * wq + g8, tx, H, W, tiles_x,
                   cout, co0);
    }
    load += n + 2;
    u += n;
  }
}

// Launch one chunk of N output channels: in (D, H, W, C) bf16, C % 8 ==
// 0, C <= 16 KS, starting on 16 bytes; wt as the kernel's; out (D, H, W,
// cout); ps (D, H, ceil(W / TX), 2, cout) f32 for kMoments, else unused.
template <int N, int KS, bool kMoments>
int launch_dense(const void* in, const void* wt, void* out, float* ps,
                 int D, int H, int W, int C, int cout, int co0, int blocks,
                 cudaStream_t s) {
  constexpr int koct = 2 * KS;
  const int ring = ring_slots(koct, N, kMoments);
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  if (ring < 3 || blocks < 1 ||
      (long long)tiles_x * tiles_y * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!volume_tensor_map(&map, in, D, H, W, C, 8, SX, SY, 1))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(koct, N, ring, kMoments);
  const cudaError_t err = cudaFuncSetAttribute(
      conv_dense_kernel<N, KS, kMoments>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int units = tiles_x * tiles_y * D;
  conv_dense_kernel<N, KS, kMoments>
      <<<min(blocks, units), kThreads, smem, s>>>(
          map, static_cast<const bf16*>(wt), static_cast<bf16*>(out), ps, D,
          H, W, ring, tiles_x, units, cout, co0);
  return (int)cudaGetLastError();
}

// The kernel for C input channels: KS = ceil(C / 16) k16 steps, 1 to 3
// (C <= 48; wider inputs leave no room for three slots).
template <int N, bool kMoments>
int launch_dense_c(const void* in, const void* wt, void* out, float* ps,
                   int D, int H, int W, int C, int cout, int co0, int blocks,
                   cudaStream_t s) {
  switch ((C + 15) / 16) {
    case 1:
      return launch_dense<N, 1, kMoments>(in, wt, out, ps, D, H, W, C, cout,
                                          co0, blocks, s);
    case 2:
      return launch_dense<N, 2, kMoments>(in, wt, out, ps, D, H, W, C, cout,
                                          co0, blocks, s);
    case 3:
      return launch_dense<N, 3, kMoments>(in, wt, out, ps, D, H, W, C, cout,
                                          co0, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k9
