// K4 conv_p2p, K7a unpack_affine_res, K7b gn_affine_res_packed, K8a
// pack_vol, K8b unpack_vol: the 3x3x3 conv chain of the DfM trunk on its
// storage format. (K5 conv_s2_p2d and K6 pack_parity8, the ends of the
// hourglass on the chain, are in hourglass_chain.cu.)
//
// Replace the TPU kernels of dfm_tpu/ops/pallas/conv_chain.py:
//   conv_p2p             -> _conv_p2p_call   (_conv_kernel)
//   unpack_affine_res    -> _unpack_ar_call  (_unpack_ar_kernel)
//   gn_affine_res_packed -> _affine_res_call (_affine_res_kernel)
//   pack_vol             -> _pack_call       (_pack_kernel0 / _pack_kernel2)
//   unpack_vol           -> _unpack_call     (_unpack_kernel)
// Plain versions and the format: dfm_tpu_torch/ops/conv_chain.py.
//
// The chain format: a (D, H, W, 32) bf16 volume stored as
// (D+2, H+2, W+2, 32), channels innermost, with a border of stored zeros.
// The TPU layout (four depth slices in 128 lanes, two phases, z-banded
// weight pairs, one-hot placement matmuls) exists for a 128-lane matrix
// unit and is not carried over.
//
// K8a / K8b / K7a / K7b are bound by bytes (one read and one write of the
// volume, a second read with a residual): one thread per 16 bytes,
// neighbouring threads on neighbouring addresses, a 3D grid so that no
// thread divides. K7a and K7b share their arithmetic (affine8) and differ
// in the store: K7a writes the dense volume, K7b the chain format with
// its zero border.
//
// K4 is bound by operations (101.9 GFLOP at 72x80x320 against ~250 MB):
// an implicit-GEMM convolution on the tensor cores. M = output voxels,
// N = 32 output channels, K = 27 taps x 32 input channels; bf16 operands,
// f32 accumulators (nvcuda::wmma m16n16k16). A block owns a 16x32 (y, x)
// tile and walks a chunk of depth slices: the 27x32x32 weights stay in
// shared memory, the input slices with their halo sit in a ring of four
// (three in use, the next arriving by cp.async while the tensor cores
// work), so a voxel is read from device memory ~1.2 times and not 27.
// Each warp computes 2 rows x 32 voxels x 32 channels (4 x 2 accumulator
// tiles), so a weight tile read from shared memory feeds four products.
// Shared-memory tiles have 32-byte rows (16 channels): every wmma pointer
// is 32-byte aligned for any tap shift. The epilogue goes through a
// per-warp f32 staging tile: residual from the centre tap's input, f32
// moments of the unrounded result, bf16 store of 16 bytes a lane. Moments
// are reduced lane -> warp -> block in a fixed order and written per
// (depth slice, tile): no atomics, identical bits on every run.
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kC = 32;                 // channels of the chain
constexpr int kChunks = kC / 8;        // 16-byte chunks of a voxel
constexpr int kThreads = 256;

// ---------------------------------------------------------------- K8a

// grid (ceil((W+2)*4 / 256), H+2, D+2): one thread per 16 bytes of the
// stored tensor; the border is written as zeros.
__global__ void pack_vol_kernel(const uint4* __restrict__ dense,
                                uint4* __restrict__ chain, int D, int H,
                                int W) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int px = t / kChunks, q = t % kChunks;
  const int py = blockIdx.y, pz = blockIdx.z;
  if (px >= W + 2) return;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pz >= 1 && pz <= D && py >= 1 && py <= H && px >= 1 && px <= W)
    v = __ldg(dense +
              (((long long)(pz - 1) * H + (py - 1)) * W + (px - 1)) * kChunks +
              q);
  chain[(((long long)pz * (H + 2) + py) * (W + 2) + px) * kChunks + q] = v;
}

// ---------------------------------------------------------------- K8b

// grid (ceil(W*4 / 256), H, D): one thread per 16 bytes of the dense
// output, the mirror of pack_vol_kernel.
__global__ void unpack_vol_kernel(const uint4* __restrict__ chain,
                                  uint4* __restrict__ dense, int H, int W) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int x = t / kChunks, q = t % kChunks;
  const int y = blockIdx.y, z = blockIdx.z;
  if (x >= W) return;
  dense[(((long long)z * H + y) * W + x) * kChunks + q] = __ldg(
      chain +
      (((long long)(z + 1) * (H + 2) + (y + 1)) * (W + 2) + (x + 1)) *
          kChunks +
      q);
}

// Zero border of a chain tensor whose interior another kernel writes.
// grid (H+2, D+2), one block per stored row.
__global__ void zero_border_kernel(uint4* __restrict__ chain, int D, int H,
                                   int W) {
  const int py = blockIdx.x, pz = blockIdx.y;
  uint4* row = chain + ((long long)pz * (H + 2) + py) * (W + 2) * kChunks;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  if (pz == 0 || pz == D + 1 || py == 0 || py == H + 1) {
    for (int i = threadIdx.x; i < (W + 2) * kChunks; i += blockDim.x)
      row[i] = z;
  } else if (threadIdx.x < 2 * kChunks) {
    const int side = threadIdx.x / kChunks, q = threadIdx.x % kChunks;
    row[(side ? W + 1 : 0) * kChunks + q] = z;
  }
}

// ---------------------------------------------------------- K7a, K7b

// Eight channels (chunk q of a voxel): y = u * sc + bs, relu, + res, each
// a separate f32 rounding (no fused multiply-add), as the plain version
// computes it.
template <bool RELU, bool RES>
__device__ __forceinline__ uint4 affine8(const uint4* __restrict__ u,
                                         const uint4* __restrict__ res,
                                         const float* __restrict__ sc,
                                         const float* __restrict__ bs,
                                         long long src, int q) {
  const uint4 raw = __ldg(u + src);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint4 rraw = make_uint4(0u, 0u, 0u, 0u);
  if (RES) rraw = __ldg(res + src);
  const bf16* r = reinterpret_cast<const bf16*>(&rraw);
  uint4 oraw;
  bf16* o = reinterpret_cast<bf16*>(&oraw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = q * 8 + j;
    float f = __fadd_rn(__fmul_rn(__bfloat162float(e[j]), __ldg(sc + c)),
                        __ldg(bs + c));
    if (RELU) f = fmaxf(f, 0.f);
    if (RES) f = __fadd_rn(f, __bfloat162float(r[j]));
    o[j] = __float2bfloat16(f);
  }
  return oraw;
}

// K7a. grid (ceil(W*4 / 256), H, D): one thread per 16 bytes of the dense
// output.
template <bool RELU, bool RES>
__global__ void unpack_affine_kernel(const uint4* __restrict__ u,
                                     const uint4* __restrict__ res,
                                     const float* __restrict__ sc,
                                     const float* __restrict__ bs,
                                     uint4* __restrict__ out, int H, int W) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int x = t / kChunks, q = t % kChunks;
  const int y = blockIdx.y, z = blockIdx.z;
  if (x >= W) return;
  const long long src =
      (((long long)(z + 1) * (H + 2) + (y + 1)) * (W + 2) + (x + 1)) *
          kChunks + q;
  out[(((long long)z * H + y) * W + x) * kChunks + q] =
      affine8<RELU, RES>(u, res, sc, bs, src, q);
}

// K7b. grid (ceil((W+2)*4 / 256), H+2, D+2): one thread per 16 bytes of
// the stored output, written at the address it was read from; the border
// is written as zeros.
template <bool RELU, bool RES>
__global__ void affine_chain_kernel(const uint4* __restrict__ u,
                                    const uint4* __restrict__ res,
                                    const float* __restrict__ sc,
                                    const float* __restrict__ bs,
                                    uint4* __restrict__ out, int D, int H,
                                    int W) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int px = t / kChunks, q = t % kChunks;
  const int py = blockIdx.y, pz = blockIdx.z;
  if (px >= W + 2) return;
  const long long at =
      (((long long)pz * (H + 2) + py) * (W + 2) + px) * kChunks + q;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pz >= 1 && pz <= D && py >= 1 && py <= H && px >= 1 && px <= W)
    v = affine8<RELU, RES>(u, res, sc, bs, at, q);
  out[at] = v;
}

// ----------------------------------------------------------------- K4

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

// Stored slice pz of the input, rows py0.., columns px0.. -> shared
// memory as [channel half][row][column][16 channels]. What lies outside
// the stored tensor (a ragged last tile) is written as zeros.
__device__ __forceinline__ void load_slice(bf16* __restrict__ dst,
                                           const bf16* __restrict__ in,
                                           int pz, int py0, int px0, int HP,
                                           int WP) {
  for (int i = threadIdx.x; i < SY * SX * kChunks; i += kThreads) {
    const int q = i % kChunks, v = i / kChunks;
    const int xx = v % SX, yy = v / SX;
    const int py = py0 + yy, px = px0 + xx;
    bf16* d = dst + (q >> 1) * kHalf + (yy * SX + xx) * 16 + (q & 1) * 8;
    if (py < HP && px < WP) {
      const bf16* s =
          in + (((long long)pz * HP + py) * WP + px) * kC + q * 8;
      __pipeline_memcpy_async(d, s, 16);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// in / out: chain tensors (D+2, H+2, W+2, 32) bf16. wt: the weights as
// [tap 27][k half 2][n half 2][k 16][n 16] bf16 (k = input channel, n =
// output channel). ps: (D, tiles, 2, 32) f32. grid (tiles, z chunks),
// block 256; a block computes slices [blockIdx.y * zc, +zc) of its tile.
__global__ void __launch_bounds__(kThreads, 1)
conv_p2p_kernel(const bf16* __restrict__ in, const bf16* __restrict__ wt,
                bf16* __restrict__ out, float* __restrict__ ps, int D, int H,
                int W, int tiles_x, int zc, int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* ss = sw + kWElems;
  float* stage_all = reinterpret_cast<float*>(ss + kRing * kSlice);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* stage = stage_all + warp * kStage;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int y0 = (tile / tiles_x) * TY, x0 = (tile % tiles_x) * TX;
  const int z0 = blockIdx.y * zc;
  const int z1 = min(z0 + zc, D);
  const int HP = H + 2, WP = W + 2;

  for (int i = threadIdx.x; i < kWElems / 8; i += kThreads)
    __pipeline_memcpy_async(sw + i * 8, wt + i * 8, 16);
  // output slice z reads stored slices z, z+1, z+2; stored slice s lives
  // in ring slot s & 3
  for (int s = z0; s < z0 + 3; ++s)
    load_slice(ss + (s & 3) * kSlice, in, s, y0, x0, HP, WP);
  __pipeline_commit();

  const int q = lane & 3, vl = lane >> 2;
  for (int z = z0; z < z1; ++z) {
    __pipeline_wait_prior(0);
    __syncthreads();  // slices z..z+2 have landed; slice z-1 is free
    if (z + 1 < z1)
      load_slice(ss + ((z + 3) & 3) * kSlice, in, z + 3, y0, x0, HP, WP);
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
    const bf16* centre = ss + ((z + 1) & 3) * kSlice;
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
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (residual) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              centre + (q >> 1) * kHalf + ((r + 1) * SX + xm + vx + 1) * 16 +
              (q & 1) * 8);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(e[j]);
        }
        if (y < H && x < W) {
          uint4 oraw;
          bf16* o = reinterpret_cast<bf16*>(&oraw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[j] += v[j];
            s2[j] += v[j] * v[j];
            o[j] = __float2bfloat16(v[j]);
          }
          *reinterpret_cast<uint4*>(
              out + (((long long)(z + 1) * HP + y + 1) * WP + x + 1) * kC +
              q * 8) = oraw;
        }
      }
      __syncwarp();  // the staging tile is overwritten by the next m
    }
    // lanes with the same q hold the same channels: fixed-order tree
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
      }
    }
    if (vl == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        stage[q * 8 + j] = s[j];
        stage[kC + q * 8 + j] = s2[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kC) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += stage_all[w * kStage + threadIdx.x];
      ps[((long long)z * ntiles + tile) * (2 * kC) + threadIdx.x] = t;
    }
    // the barrier at the top of the next slice keeps these reads ahead
    // of the next writes to the staging tiles
  }
}

}  // namespace

// dense (D, H, W, 32) bf16 -> chain (D+2, H+2, W+2, 32) bf16.
extern "C" int dfm_pack_vol(const void* dense, void* chain, int D, int H,
                            int W, void* stream) {
  const dim3 grid(((W + 2) * kChunks + kThreads - 1) / kThreads, H + 2, D + 2);
  pack_vol_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dense), static_cast<uint4*>(chain), D, H, W);
  return (int)cudaGetLastError();
}

// chain (D+2, H+2, W+2, 32) bf16 -> dense (D, H, W, 32) bf16.
extern "C" int dfm_unpack_vol(const void* chain, void* dense, int D, int H,
                              int W, void* stream) {
  const dim3 grid((W * kChunks + kThreads - 1) / kThreads, H, D);
  unpack_vol_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(chain), static_cast<uint4*>(dense), H, W);
  return (int)cudaGetLastError();
}

// chain u (+ chain res, may be null) -> dense (D, H, W, 32) bf16;
// sc, bs: (32,) f32.
extern "C" int dfm_unpack_affine(const void* u, const void* res,
                                 const float* sc, const float* bs, void* out,
                                 int D, int H, int W, int relu, void* stream) {
  const dim3 grid((W * kChunks + kThreads - 1) / kThreads, H, D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* pu = static_cast<const uint4*>(u);
  const uint4* pr = static_cast<const uint4*>(res);
  uint4* po = static_cast<uint4*>(out);
  if (relu && res)
    unpack_affine_kernel<true, true><<<grid, kThreads, 0, s>>>(pu, pr, sc, bs,
                                                              po, H, W);
  else if (relu)
    unpack_affine_kernel<true, false><<<grid, kThreads, 0, s>>>(pu, pr, sc,
                                                               bs, po, H, W);
  else if (res)
    unpack_affine_kernel<false, true><<<grid, kThreads, 0, s>>>(pu, pr, sc,
                                                               bs, po, H, W);
  else
    unpack_affine_kernel<false, false><<<grid, kThreads, 0, s>>>(pu, pr, sc,
                                                                bs, po, H, W);
  return (int)cudaGetLastError();
}

// chain u (+ chain res, may be null) -> chain out (border zeroed here),
// all (D+2, H+2, W+2, 32) bf16; sc, bs: (32,) f32.
extern "C" int dfm_affine_chain(const void* u, const void* res,
                                const float* sc, const float* bs, void* out,
                                int D, int H, int W, int relu, void* stream) {
  const dim3 grid(((W + 2) * kChunks + kThreads - 1) / kThreads, H + 2, D + 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* pu = static_cast<const uint4*>(u);
  const uint4* pr = static_cast<const uint4*>(res);
  uint4* po = static_cast<uint4*>(out);
  if (relu && res)
    affine_chain_kernel<true, true><<<grid, kThreads, 0, s>>>(pu, pr, sc, bs,
                                                             po, D, H, W);
  else if (relu)
    affine_chain_kernel<true, false><<<grid, kThreads, 0, s>>>(pu, pr, sc, bs,
                                                              po, D, H, W);
  else if (res)
    affine_chain_kernel<false, true><<<grid, kThreads, 0, s>>>(pu, pr, sc, bs,
                                                              po, D, H, W);
  else
    affine_chain_kernel<false, false><<<grid, kThreads, 0, s>>>(pu, pr, sc,
                                                               bs, po, D, H,
                                                               W);
  return (int)cudaGetLastError();
}

// chain in -> chain out (border zeroed here) + ps (D, tiles, 2, 32) f32,
// tiles = ceil(H/16) * ceil(W/32), refused (cudaErrorInvalidValue) when
// the caller sized ps for another count; zc = depth slices per block.
extern "C" int dfm_conv_p2p(const void* in, const void* wt, void* out,
                            float* ps, int D, int H, int W, int tiles,
                            int zc, int residual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  if (tiles != tiles_x * tiles_y || zc < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_p2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kConvSmem);
  if (err != cudaSuccess) return (int)err;
  zero_border_kernel<<<dim3(H + 2, D + 2), 128, 0, s>>>(
      static_cast<uint4*>(out), D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_x * tiles_y, (D + zc - 1) / zc);
  conv_p2p_kernel<<<grid, kThreads, kConvSmem, s>>>(
      static_cast<const bf16*>(in), static_cast<const bf16*>(wt),
      static_cast<bf16*>(out), ps, D, H, W, tiles_x, zc, residual);
  return (int)cudaGetLastError();
}
