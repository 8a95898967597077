// K9a's tensor-core code (conv3d.cu, dfm_conv3d_tc): the 3x3x3 stride-1
// C32 -> C32 bf16 convolution of a dense (D, H, W, 32) volume, channels
// innermost, with f32 GroupNorm moments of the unrounded result in its
// epilogue. It is K4's first design (mma.sync through nvcuda::wmma, PR 2);
// K4 itself runs the Hopper kernel of conv_p2p.cuh (wgmma + TMA) since.
// A tap outside the volume is a zero written to shared memory at load.
// Moments per (depth slice, row, 32-column tile), a granularity that folds
// exactly into any row band.
//
// Bound by operations (101.9 GFLOP at 72x80x320 against ~120 MB): an
// implicit-GEMM convolution. M = output voxels, N = 32 output channels,
// K = 27 taps x 32 input channels; bf16 operands, f32 accumulators
// (nvcuda::wmma m16n16k16). A block owns a 16x32 (y, x) tile and walks a
// chunk of depth slices: the 27x32x32 weights stay in shared memory, the
// input slices with their halo sit in a ring of four (three in use, the
// next arriving by cp.async while the tensor cores work), so a voxel is
// read from device memory ~1.2 times and not 27. Each warp computes 2 rows
// x 32 voxels x 32 channels (4 x 2 accumulator tiles), so a weight tile
// read from shared memory feeds four products. Shared-memory tiles have
// 32-byte rows (16 channels): every wmma pointer is 32-byte aligned for
// any tap shift. The epilogue goes through a per-warp f32 staging tile:
// f32 moments of the unrounded result, bf16 store of 16 bytes a lane.
// Each warp reduces each of its rows in a fixed order (lane xor tree) with
// no atomics: identical bits on every run.
#pragma once

#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kC = 32;                 // channels in and out
constexpr int kChunks = kC / 8;        // 16-byte chunks of a voxel
constexpr int kThreads = 256;

constexpr int TY = 16, TX = 32;              // output tile (rows, columns)
constexpr int SY = TY + 2, SX = TX + 2;      // input tile with its halo
constexpr int kWarps = kThreads / 32;        // warp w: rows 2w, 2w+1
constexpr int kHalf = SY * SX * 16;          // elements of one channel half
constexpr int kSlice = 2 * kHalf;            // elements of one input slice
constexpr int kRing = 4;
constexpr int kWElems = 27 * kC * kC;
constexpr int kStageLd = 36;                 // floats; 16-byte reads of 8
                                             // lanes hit 32 distinct banks
constexpr int kStage = 16 * kStageLd;        // floats per warp
constexpr int kConvSmem =
    (kWElems + kRing * kSlice) * (int)sizeof(bf16) +
    kWarps * kStage * (int)sizeof(float);    // 230,400 bytes

// Input slice pz, rows py0.., columns px0.. in padded coordinates (the
// volume shifted by one voxel on each axis) -> shared memory as [channel
// half][row][column][16 channels]; what lies outside the volume is
// written as zeros.
__device__ __forceinline__ void load_slice(bf16* __restrict__ dst,
                                           const bf16* __restrict__ in,
                                           int pz, int py0, int px0, int D,
                                           int H, int W) {
  for (int i = threadIdx.x; i < SY * SX * kChunks; i += kThreads) {
    const int q = i % kChunks, v = i / kChunks;
    const int xx = v % SX, yy = v / SX;
    const int py = py0 + yy, px = px0 + xx;
    bf16* d = dst + (q >> 1) * kHalf + (yy * SX + xx) * 16 + (q & 1) * 8;
    const bool inside = pz >= 1 && pz <= D && py >= 1 && py <= H &&
                        px >= 1 && px <= W;
    const long long at =
        (((long long)(pz - 1) * H + (py - 1)) * W + (px - 1)) * kC;
    if (inside)
      __pipeline_memcpy_async(d, in + at + q * 8, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// wt: the weights as [tap 27][k half 2][n half 2][k 16][n 16] bf16 (k =
// input channel, n = output channel). in / out (D, H, W, 32); ps (D, H,
// tiles_x, 2, 32). grid (tiles, z chunks), block 256; a block computes
// slices [blockIdx.y * zc, +zc) of its tile.
__global__ void __launch_bounds__(kThreads, 1)
conv_wmma_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wt,
                 bf16* __restrict__ out, float* __restrict__ ps, int D, int H,
                 int W, int tiles_x, int zc) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* ss = sw + kWElems;
  float* stage = reinterpret_cast<float*>(ss + kRing * kSlice);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage += warp * kStage;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int y0 = (tile / tiles_x) * TY, x0 = tx * TX;
  const int z0 = blockIdx.y * zc;
  const int z1 = min(z0 + zc, D);

  for (int i = threadIdx.x; i < kWElems / 8; i += kThreads)
    __pipeline_memcpy_async(sw + i * 8, wt + i * 8, 16);
  // output slice z reads input slices z, z+1, z+2 (padded coordinates);
  // slice s lives in ring slot s & 3
  for (int s = z0; s < z0 + 3; ++s)
    load_slice(ss + (s & 3) * kSlice, in, s, y0, x0, D, H, W);
  __pipeline_commit();

  const int q = lane & 3, vl = lane >> 2;
  for (int z = z0; z < z1; ++z) {
    __pipeline_wait_prior(0);
    __syncthreads();  // slices z..z+2 have landed; slice z-1 is free
    if (z + 1 < z1)
      load_slice(ss + ((z + 3) & 3) * kSlice, in, z + 3, y0, x0, D, H, W);
    __pipeline_commit();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::fill_fragment(acc[m][0], 0.f);
      wmma::fill_fragment(acc[m][1], 0.f);
    }
    for (int dz = 0; dz < 3; ++dz) {
      const bf16* sl = ss + ((z + dz) & 3) * kSlice;
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const bf16* wtap = sw + ((dz * 3 + dy) * 3 + dx) * (kC * kC);
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                b0, b1;
            wmma::load_matrix_sync(b0, wtap + (kh * 2 + 0) * 256, 16);
            wmma::load_matrix_sync(b1, wtap + (kh * 2 + 1) * 256, 16);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const int r = 2 * warp + (m >> 1), xm = (m & 1) * 16;
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major> a;
              wmma::load_matrix_sync(
                  a, sl + kh * kHalf + ((r + dy) * SX + xm + dx) * 16, 16);
              wmma::mma_sync(acc[m][0], a, b0, acc[m][0]);
              wmma::mma_sync(acc[m][1], a, b1, acc[m][1]);
            }
          }
        }
      }
    }

    // epilogue: lane = (voxel vl of 8, channels 8q..8q+7)
    float s[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = s2[j] = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = 2 * warp + (m >> 1), xm = (m & 1) * 16;
      wmma::store_matrix_sync(stage, acc[m][0], kStageLd,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(stage + 16, acc[m][1], kStageLd,
                              wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int vx = vl + 8 * i;
        const int y = y0 + r, x = x0 + xm + vx;
        const float4 lo =
            *reinterpret_cast<const float4*>(stage + vx * kStageLd + q * 8);
        const float4 hi = *reinterpret_cast<const float4*>(
            stage + vx * kStageLd + q * 8 + 4);
        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (y < H && x < W) {
          uint4 oraw;
          bf16* o = reinterpret_cast<bf16*>(&oraw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[j] += v[j];
            s2[j] += v[j] * v[j];
            o[j] = __float2bfloat16(v[j]);
          }
          const long long at = (((long long)z * H + y) * W + x) * kC;
          *reinterpret_cast<uint4*>(out + at + q * 8) = oraw;
        }
      }
      __syncwarp();  // the staging tile is overwritten by the next m
      if (m & 1) {
        // row r is complete (both 16-column halves): lanes with the same q
        // hold the same channels, fixed-order tree, one write per (slice,
        // row, tile)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
            s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
          }
        }
        const int y = y0 + r;
        if (vl == 0 && y < H) {
          float* p = ps + (((long long)z * H + y) * tiles_x + tx) * (2 * kC);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            p[q * 8 + j] = s[j];
            p[kC + q * 8 + j] = s2[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] = s2[j] = 0.f;
      }
    }
  }
}

}  // namespace
