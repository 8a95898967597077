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
// K5 is bound by operations at the card's peak only barely (25.5 GFLOP at
// 72x80x320 against ~155 MB, 0.026 ms against 0.046 ms): an implicit-GEMM
// convolution on the tensor cores. M = output voxels, N = 64 output
// channels, K = 27 taps x 32 input channels; bf16 operands, f32
// accumulators (nvcuda::wmma m16n16k16). The stored zero border is the
// conv's padding: output (m, n, t) reads stored [2m .. 2m+2] of each axis
// with no bounds test. A block owns an 8x16 (y, x) output tile and walks
// a chunk of output depth slices; the 27x32x64 weights (110 KB) stay in
// shared memory, so the input can keep only a ring of two stored slices.
// That is enough because the stored slices are consumed in order: an odd
// stored slice 2m+1 feeds output slice m through the taps dz = 1, an even
// one 2m feeds m-1 through dz = 2 (which completes it: epilogue) and then
// m through dz = 0. The next slice arrives by cp.async while the tensor
// cores work on this one. A slice is split by column parity on its way
// into shared memory, [channel half][row][column parity][column / 2][16
// channels], so that the stride-2 column walk of every tap is a stride-1
// walk of 32-byte rows: every wmma pointer is 32-byte aligned and the A
// tiles are read as in K4. Warp w computes output row w of the tile: 16
// voxels x 64 channels (four accumulator tiles). The epilogue goes
// through a per-warp f32 staging tile: f32 moments of the unrounded
// result, bf16 store of 16 bytes a lane. Moments are reduced lane -> warp
// -> block in a fixed order and written per (output slice, tile): no
// atomics, identical bits on every run.
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
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kC = 32;                 // channels of the chain
constexpr int kChunks = kC / 8;        // 16-byte chunks of a chain voxel
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ----------------------------------------------------------------- K5

constexpr int kN = 64;                       // output channels
constexpr int TY = 8, TX = 16;               // output tile (rows, columns)
constexpr int SY = 2 * TY + 1;               // input rows of a tile
constexpr int SXH = TX + 1;                  // input columns of one parity
constexpr int kHalf = SY * 2 * SXH * 16;     // elements of one channel half
constexpr int kSlice = 2 * kHalf;            // elements of one input slice
constexpr int kWElems = 27 * kC * kN;
constexpr int kStageLd = kN + 4;             // floats; rows stay 16-byte
                                             // aligned and shift banks
constexpr int kStage = 16 * kStageLd;        // floats per warp
constexpr int kConvSmem =
    (kWElems + 2 * kSlice) * (int)sizeof(bf16) +
    kWarps * kStage * (int)sizeof(float);    // 219,392 bytes

// Stored slice pz of the input, rows py0 .. py0 + 16, columns px0 ..
// px0 + 32 -> shared memory as [channel half][row][column parity]
// [column / 2][16 channels]. What lies outside the stored tensor (a
// ragged last tile) is written as zeros.
__device__ __forceinline__ void load_slice_s2(bf16* __restrict__ dst,
                                              const bf16* __restrict__ in,
                                              int pz, int py0, int px0,
                                              int HP, int WP) {
  constexpr int kCols = 2 * TX + 1;
  for (int i = threadIdx.x; i < SY * kCols * kChunks; i += kThreads) {
    const int q = i % kChunks, v = i / kChunks;
    const int xx = v % kCols, yy = v / kCols;
    const int py = py0 + yy, px = px0 + xx;
    bf16* d = dst + (q >> 1) * kHalf +
              ((yy * 2 + (xx & 1)) * SXH + (xx >> 1)) * 16 + (q & 1) * 8;
    if (py < HP && px < WP) {
      const bf16* s =
          in + (((long long)pz * HP + py) * WP + px) * kC + q * 8;
      __pipeline_memcpy_async(d, s, 16);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc[n] += A(slice sl, taps (dz, *, *)) x W for the warp's output row.
__device__ __forceinline__ void conv_s2_taps(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[4],
    const bf16* __restrict__ sl, const bf16* __restrict__ sw, int dz,
    int row) {
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const bf16* wtap = sw + ((dz * 3 + dy) * 3 + dx) * (kC * kN);
      // output column t reads input column 2t + dx: parity dx & 1,
      // index t + (dx >> 1)
      const bf16* arow =
          sl + (((2 * row + dy) * 2 + (dx & 1)) * SXH + (dx >> 1)) * 16;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, arow + kh * kHalf, 16);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wtap + (kh * 4 + n) * 256, 16);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
    }
  }
}

// in: chain tensor (D+2, H+2, W+2, 32) bf16, D, H, W even. wt: the
// weights as [tap 27][k half 2][n quarter 4][k 16][n 16] bf16 (k = input
// channel, n = output channel). out: dense (D/2, H/2, W/2, 64) bf16. ps:
// (D/2, tiles, 2, 64) f32. grid (tiles, z chunks), block 256; a block
// computes output slices [blockIdx.y * zc, +zc) of its tile.
__global__ void __launch_bounds__(kThreads, 1)
conv_s2_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wt,
               bf16* __restrict__ out, float* __restrict__ ps, int D2, int H2,
               int W2, int tiles_x, int zc) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* ss = sw + kWElems;
  float* stage_all = reinterpret_cast<float*>(ss + 2 * kSlice);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = stage_all + warp * kStage;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int y0 = (tile / tiles_x) * TY, x0 = (tile % tiles_x) * TX;
  const int m0 = blockIdx.y * zc;
  const int m1 = min(m0 + zc, D2);
  const int HP = 2 * H2 + 2, WP = 2 * W2 + 2;
  // output slice m reads stored slices 2m, 2m+1, 2m+2: the block walks
  // stored slices s0 .. s1, slice s in ring slot s & 1
  const int s0 = 2 * m0, s1 = 2 * m1;

  for (int i = threadIdx.x; i < kWElems / 8; i += kThreads)
    __pipeline_memcpy_async(sw + i * 8, wt + i * 8, 16);
  load_slice_s2(ss + (s0 & 1) * kSlice, in, s0, 2 * y0, 2 * x0, HP, WP);
  __pipeline_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
  const int q = lane & 7, vl = lane >> 3;
  for (int s = s0; s <= s1; ++s) {
    __pipeline_wait_prior(0);
    __syncthreads();  // slice s has landed; the other slot is free
    if (s < s1)
      load_slice_s2(ss + ((s + 1) & 1) * kSlice, in, s + 1, 2 * y0, 2 * x0,
                    HP, WP);
    __pipeline_commit();
    const bf16* sl = ss + (s & 1) * kSlice;

    if (s & 1) {
      conv_s2_taps(acc, sl, sw, 1, warp);
      continue;
    }
    if (s > s0) {
      conv_s2_taps(acc, sl, sw, 2, warp);
      // epilogue of output slice m: lane = (voxel vl of 4, channels
      // 8q .. 8q+7)
      const int m = s / 2 - 1;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(stage + n * 16, acc[n], kStageLd,
                                wmma::mem_row_major);
      __syncwarp();
      float sum[8], sq[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[j] = sq[j] = 0.f;
      const int y = y0 + warp;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int vx = vl + 4 * i;
        const int x = x0 + vx;
        const float4 lo =
            *reinterpret_cast<const float4*>(stage + vx * kStageLd + q * 8);
        const float4 hi = *reinterpret_cast<const float4*>(
            stage + vx * kStageLd + q * 8 + 4);
        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (y < H2 && x < W2) {
          uint4 oraw;
          bf16* o = reinterpret_cast<bf16*>(&oraw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum[j] += v[j];
            sq[j] += v[j] * v[j];
            o[j] = __float2bfloat16(v[j]);
          }
          *reinterpret_cast<uint4*>(
              out + (((long long)m * H2 + y) * W2 + x) * kN + q * 8) = oraw;
        }
      }
      // lanes with the same q hold the same channels: fixed-order tree
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int off = 8; off < 32; off <<= 1) {
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
          sq[j] += __shfl_xor_sync(0xffffffffu, sq[j], off);
        }
      }
      __syncwarp();  // every lane has read its voxels of the staging tile
      if (vl == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          stage[q * 8 + j] = sum[j];
          stage[kN + q * 8 + j] = sq[j];
        }
      }
      __syncthreads();
      if (threadIdx.x < 2 * kN) {
        // [0, 64): sums (row 0 of each warp's tile); [64, 128): squares
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w)
          t += stage_all[w * kStage + threadIdx.x];
        ps[((long long)m * ntiles + tile) * (2 * kN) + threadIdx.x] = t;
      }
      // the staging tiles are next written two block barriers from here
    }
    if (s < s1) {
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
      conv_s2_taps(acc, sl, sw, 0, warp);
    }
  }
}

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

// chain in (2 D2 + 2, 2 H2 + 2, 2 W2 + 2, 32) -> dense out (D2, H2, W2, 64)
// + ps (D2, tiles, 2, 64) f32, tiles = ceil(H2/8) * ceil(W2/16), refused
// (cudaErrorInvalidValue) when the caller sized ps for another count;
// zc = output depth slices per block.
extern "C" int dfm_conv_s2(const void* in, const void* wt, void* out,
                           float* ps, int D2, int H2, int W2, int tiles,
                           int zc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W2 + TX - 1) / TX, tiles_y = (H2 + TY - 1) / TY;
  if (tiles != tiles_x * tiles_y || zc < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_s2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_x * tiles_y, (D2 + zc - 1) / zc);
  conv_s2_kernel<<<grid, kThreads, kConvSmem, s>>>(
      static_cast<const bf16*>(in), static_cast<const bf16*>(wt),
      static_cast<bf16*>(out), ps, D2, H2, W2, tiles_x, zc);
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
