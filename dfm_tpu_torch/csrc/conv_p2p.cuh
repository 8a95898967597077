// K4 conv_p2p on Hopper: the 3x3x3 stride-1 C32 -> C32 bf16 convolution of
// a chain tensor (conv_chain.cu, dfm_conv_p2p), with an optional residual
// (the input) and the f32 GroupNorm moments of the unrounded result per
// (depth slice, tile). Replaces dfm_tpu/ops/pallas/conv_chain.py:
// conv_p2p -> _conv_p2p_call. K9a / K9b (conv_dense.cuh) are this
// design on a dense tensor.
//
// Bound by operations: an implicit GEMM, M = output voxels, N = 32 output
// channels, K = 27 taps x 32 input channels (101.9 GFLOP at 72x80x320).
// Design for sm_90a:
//   - wgmma.mma_async m64n32k16, bf16 operands, f32 accumulators, A and B
//     both read from shared memory through no-swizzle K-major descriptors.
//     A slice is stored channel-octet-major, [octet 4][row][column][8 ch],
//     so the 8 voxels x 16 bytes of a core matrix are contiguous (SBO 128)
//     and the next 8 channels lie one octet plane further (LBO). A tap
//     shift (dy, dx) only moves the descriptor's start address, by
//     (dy * SX + dx) * 16 bytes: the 27 taps need no register reload and
//     no ldmatrix. The weights, [tap 27][octet 4][n 32][8 k] (55 KB), are
//     loaded once per block in the B canonical layout (LBO 512, SBO 128).
//   - TMA (cp.async.bulk.tensor, tiled mode, one tensor map per call over
//     the (D+2, H+2, W+2, 32) chain tensor): a slice of the 8 x 64 output
//     tile with its halo (10 x 66 voxels) arrives as four boxes of 8
//     channels, one per octet plane, into a ring of four slots guarded by
//     mbarriers (full: the bytes have landed; empty: every consumer is done
//     with the slice). Outside the stored tensor (a ragged last tile) TMA
//     writes zeros. One producer warp issues the copies; two consumer
//     warpgroups own four output rows each (four m64 tiles, 64 f32
//     accumulators a thread).
//   - Epilogue in registers: the residual from the centre slice in shared
//     memory, the moments of the unrounded f32 result, a 4x4 transpose of
//     bf16 pairs among the four lanes of a quad (two xor-shuffle stages),
//     so each lane stores one 16-byte channel octet of a voxel and a warp
//     writes 512 contiguous bytes. No f32 staging tile. The producer
//     warp's 31 idle lanes write the output's zero border.
//   - Moments: per thread over its voxels, a fixed lane xor tree per warp,
//     then the eight warps summed in a fixed order by 64 threads: no
//     atomics, identical bits on every run.
//   - A persistent grid of one block per SM walks an equal share of the
//     (tile, depth slice) work items, tile-major: no partial last wave.
//     Each new tile in a block's share costs two extra halo slices.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace k4 {

using namespace hop;

using bf16 = __nv_bfloat16;

constexpr int kC = 32;                       // channels in and out
constexpr int TY = 8, TX = 64;               // output tile (rows, columns)
constexpr int SY = TY + 2, SX = TX + 2;      // input slice with its halo
constexpr int kBox = SY * SX * 16;           // bytes of one octet plane
constexpr int kOct = (kBox + 127) / 128 * 128;   // plane stride, 128-aligned
constexpr int kSlice = 4 * kOct;             // bytes of one ring slot
constexpr int kRing = 4;
constexpr int kTapBytes = kC * kC * 2;       // weights of one tap
constexpr int kWBytes = 27 * kTapBytes;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kRedFloats = 2 * 8 * 2 * kC;   // [buffer 2][warp 8][s, s2][32]
constexpr int kSmem = kRing * kSlice + kWBytes + kRedFloats * 4 +
                      (2 * kRing + 1) * 8;   // 229,448 bytes
static_assert(kSmem <= 232448, "more shared memory than a block may have");

// This block's share of the zero border of the chain tensor `out`, by the
// producer warp's idle lanes (lane `lane` of `lanes` >= 8): an equal
// share of the stored rows; a row of an end slice, and the first and last
// row of an inner slice, whole, other rows their first and last voxel.
__device__ __forceinline__ void zero_border_share(uint4* __restrict__ out,
                                                  int D, int H, int W,
                                                  int lane, int lanes) {
  const int HP = H + 2, WP = W + 2, rows = (D + 2) * HP;
  const int lo = (int)((long long)blockIdx.x * rows / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int row = lo; row < hi; ++row) {
    const int pz = row / HP, py = row - pz * HP;
    uint4* r = out + (long long)row * WP * 4;
    if (pz == 0 || pz == D + 1 || py == 0 || py == H + 1) {
      for (int i = lane; i < WP * 4; i += lanes) r[i] = zero;
    } else if (lane < 8) {
      r[(lane < 4 ? 0 : (W + 1) * 4) + (lane & 3)] = zero;
    }
  }
}

// One block per SM. tmap: the chain tensor `in` (D+2, H+2, W+2, 32) as
// dims (32 ch, W+2, H+2, D+2), box (8, SX, SY, 1). wt: [tap 27][octet
// 4][n 32][8 k] bf16. out: chain tensor, interior and border written
// here; ps (D, tiles, 2, 32). Work item u = tile * D + z; block b takes
// [b * units / grid, (b + 1) * units / grid).
__global__ void __launch_bounds__(kThreads, 1)
conv_p2p_kernel(const __grid_constant__ CUtensorMap tmap,
                const bf16* __restrict__ wt, bf16* __restrict__ out,
                float* __restrict__ ps, int D, int H, int W, int tiles_x,
                int units, int residual) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem + kRing * kSlice + kWBytes);
  const uint32_t ring_a = smem_u32(ring);
  const uint32_t w_a = ring_a + kRing * kSlice;
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

  const int ntiles = units / D;
  const int begin = (int)((long long)blockIdx.x * units / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) {
      zero_border_share(reinterpret_cast<uint4*>(out), D, H, W,
                        threadIdx.x - kConsumers - 1, 31);
      return;
    }
    // producer: the weights once, then every slice of every segment of
    // this block's share, in the order the consumers use them
    mbar_expect_tx(wbar, kWBytes);
    for (int t = 0; t < 27; ++t)
      bulk_load(w_a + t * kTapBytes,
                reinterpret_cast<const unsigned char*>(wt) + t * kTapBytes,
                kTapBytes, wbar);
    int load = 0;
    for (int u = begin; u < end;) {
      const int tile = u / D, z0 = u - tile * D, n = min(D - z0, end - u);
      const int ty = tile / tiles_x;
      const int y0 = ty * TY, x0 = (tile - ty * tiles_x) * TX;
      for (int s = z0; s < z0 + n + 2; ++s, ++load) {
        const int slot = load % kRing, round = load / kRing;
        if (round > 0) mbar_wait(bar_a + 8 * (kRing + slot), (round - 1) & 1);
        const uint32_t full = bar_a + 8 * slot;
        mbar_expect_tx(full, 4 * kBox);
        for (int c8 = 0; c8 < 4; ++c8)
          tma_load_4d(ring_a + slot * kSlice + c8 * kOct, &tmap, full, c8 * 8,
                      x0, y0, s);
      }
      u += n;
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows 4 wg .. 4 wg + 3; in each m64
  // tile (one row, 64 columns) warp wq owns columns 16 wq .. 16 wq + 15
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int wq = warp & 3, lane = tid & 31, q = lane & 3, g8 = lane >> 2;
  const int HP = H + 2, WP = W + 2;
  constexpr uint64_t kAHi = desc_hi(kOct, 128);
  const uint64_t bdesc = desc_hi(512, 128) | (w_a >> 4);
  float acc[4][16];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;
  int load = 0, buf = 0;
  mbar_wait(wbar, 0);
  for (int u = begin; u < end;) {
    const int tile = u / D, z0 = u - tile * D, n = min(D - z0, end - u);
    const int ty = tile / tiles_x;
    const int y0 = ty * TY, x0 = (tile - ty * tiles_x) * TX;
    for (int i = 0; i < n; ++i) {
      // output slice o = z0 + i reads chain slices o, o+1, o+2: loads
      // l0, l0 + 1, l0 + 2 of the ring
      const int o = z0 + i, l0 = load + i;
      for (int dz = 0; dz < 3; ++dz)
        mbar_wait(bar_a + 8 * ((l0 + dz) % kRing), ((l0 + dz) / kRing) & 1);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      for (int dz = 0; dz < 3; ++dz) {
        const uint32_t sa = ring_a + ((l0 + dz) % kRing) * kSlice;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              const int tap = (dz * 3 + dy) * 3 + dx;
              const uint64_t b = bdesc + ((tap * kTapBytes + ks * 1024) >> 4);
              const uint32_t scale = (dz | dy | dx | ks) ? 1u : 0u;
#pragma unroll
              for (int m = 0; m < 4; ++m) {
                const uint32_t a = sa + ks * 2 * kOct +
                                   ((wg * 4 + m + dy) * SX + dx) * 16;
                wgmma<32>(acc[m], kAHi | (a >> 4), b, scale);
              }
            }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int m = 0; m < 4; ++m) fence_regs(acc[m]);
      mbar_arrive(bar_a + 8 * (kRing + l0 % kRing));   // slice o is done

      // epilogue: accumulator i of row m is voxel column 16 wq + g8 +
      // 8 ((i >> 1) & 1), channel 8 (i >> 2) + 2 q + (i & 1)
      const bf16* centre =
          reinterpret_cast<const bf16*>(ring + ((l0 + 1) % kRing) * kSlice);
      float s[8], s2[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[c] = s2[c] = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = wg * 4 + m, y = y0 + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 16 * wq + g8 + 8 * h, x = x0 + col;
          float v[8];      // channel 8j + 2q + e at v[2j + e]
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = acc[m][4 * j + 2 * h];
            v[2 * j + 1] = acc[m][4 * j + 2 * h + 1];
          }
          if (residual) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const __nv_bfloat162 e = *reinterpret_cast<const __nv_bfloat162*>(
                  centre + j * (kOct / 2) + ((r + 1) * SX + col + 1) * 8 +
                  2 * q);
              v[2 * j] += __low2float(e);
              v[2 * j + 1] += __high2float(e);
            }
          }
          const bool ok = y < H && x < W;
          uint32_t p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float f = ok ? v[2 * j + e] : 0.f;
              s[2 * j + e] += f;
              s2[2 * j + e] += f * f;
            }
            p[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
          }
          quad_transpose(p, q);
          if (ok)
            *reinterpret_cast<uint4*>(
                out + ((long long)((o + 1) * HP + y + 1) * WP + x + 1) * kC +
                q * 8) = make_uint4(p[0], p[1], p[2], p[3]);
        }
      }
      if (i == n - 1) {   // the segment's last two halo slices are done
        mbar_arrive(bar_a + 8 * (kRing + (l0 + 1) % kRing));
        mbar_arrive(bar_a + 8 * (kRing + (l0 + 2) % kRing));
      }

      // moments of (o, tile): lanes with the same q hold the same
      // channels; fixed-order trees, no atomics
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
          s2[c] += __shfl_xor_sync(0xffffffffu, s2[c], off);
        }
      }
      float* rb = red + buf * (8 * 2 * kC);
      if (g8 == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rb[warp * 2 * kC + 8 * j + 2 * q + e] = s[2 * j + e];
            rb[warp * 2 * kC + kC + 8 * j + 2 * q + e] = s2[2 * j + e];
          }
      }
      // the two buffers alternate: a buffer is written again only after
      // the next slice's barrier, which its readers pass after reading
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
      if (tid < 2 * kC) {
        float t = 0.f;
        for (int w = 0; w < 8; ++w) t += rb[w * 2 * kC + tid];
        ps[((long long)o * ntiles + tile) * (2 * kC) + tid] = t;
      }
      buf ^= 1;
    }
    load += n + 2;
    u += n;
  }
}

// The chain tensor (D+2, H+2, W+2, 32) bf16 as K4's tensor map.
inline bool chain_tensor_map(CUtensorMap* map, const void* in, int D, int H,
                             int W) {
  return volume_tensor_map(map, in, D + 2, H + 2, W + 2, kC, 8, SX, SY, 1);
}

}  // namespace k4
