// K9a conv3d_zpack / conv3d_gn and K9b conv3d_pallas: the 3x3x3 stride-1
// 'same' convolution of a dense (D, H, W, C) volume, channels innermost,
// with (K9a) or without (K9b) the GroupNorm moments of its unrounded f32
// result.
//
// Replace the TPU kernels of
//   dfm_tpu/ops/pallas/convgn.py:conv3d_zpack (pallas_call at :162) and
//   dfm_tpu/ops/pallas/conv3d.py:conv3d_pallas (pallas_call at :119).
// Plain versions: dfm_tpu_torch/ops/convgn.py, ops/conv3d.py. The TPU
// kernels' z-in-lanes packing with a banded weight (2x the products, to
// fill 128 MXU lanes) and dx-in-lanes packing exist for a 128-lane matrix
// unit and are not carried over.
//
// Two device codes:
//   dfm_conv3d_tc: bf16, C = C_out = 32 (the DfM trunk width), the wmma
//     tensor-core convolution of conv_wmma.cuh (K4's first design) on
//     dense tensors; bound by operations (101.9 GFLOP at 72x80x320
//     against ~120 MB).
//   dfm_conv3d_direct: every other width and type, and K9b: a direct
//     convolution on the CUDA cores, f32 fused multiply-adds (exact f32
//     products for f32 inputs; bf16 inputs and weights are exact in f32),
//     bound by operations. A block owns a 16x32 (y, x) output tile of one
//     depth slice and COC output channels; thread (warp w, lane l)
//     computes voxels (w, l) and (w + 8, l) x COC channels in registers.
//     The input channels pass through shared memory in chunks of 8 (a
//     3 x 18 x 34 haloed tile, converted to f32, [channel][z][y][x] so a
//     warp reads 32 neighbouring floats) with the chunk's 27 x 8 x COC
//     weights, so shared memory stays at 64-86 KB for any C and C_out
//     (the weights of a 42 -> 42 f32 conv alone are 190 KB): the output
//     channels are cut into chunks of COC = 8, 16 or 32 over the grid.
//     A weight read is one broadcast float4 that feeds 8 products.
// Moments (K9a): per (depth slice, row, 32-column tile), a granularity
// that folds exactly into the JAX layout for any row band th dividing H.
// Each warp reduces its rows in a fixed order (xor tree), no atomics:
// identical bits on every run.
#include <stdint.h>

#include "conv_dense.cuh"
#include "conv_wmma.cuh"

namespace {

constexpr int kDTY = 16, kDTX = 32;          // direct output tile (rows,
                                             // columns); kDTX == TX
constexpr int kDSY = kDTY + 2, kDSX = kDTX + 2;
constexpr int kCK = 8;                       // input channels per chunk
constexpr int kXTile = kCK * 3 * kDSY * kDSX;   // floats of an input chunk

template <int COC>
constexpr int direct_smem() {
  return (kXTile + 27 * kCK * COC) * (int)sizeof(float);   // <= 86,400
}

// in / out (D, H, W, C / Cout) of T; wt (Cout chunks, 27, Cp, COC) f32,
// Cp = C rounded up to kCK, zeros in the padding; ps (D, H, tiles_x, 2,
// Cout) f32 or null. grid (tiles, D, Cout chunks), block 256.
template <typename T, int COC>
__global__ void __launch_bounds__(kThreads)
conv3d_direct_kernel(const T* __restrict__ in, const float* __restrict__ wt,
                     T* __restrict__ out, float* __restrict__ ps, int D,
                     int H, int W, int C, int Cout, int tiles_x) {
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;              // [ci kCK][dz 3][row kDSY][column kDSX]
  float* ws = fsm + kXTile;     // [tap 27][ci kCK][co COC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = blockIdx.x % tiles_x;
  const int y0 = (blockIdx.x / tiles_x) * kDTY, x0 = tx * kDTX;
  const int z = blockIdx.y, co0 = blockIdx.z * COC;
  const int cp = (C + kCK - 1) / kCK * kCK;
  const float* wchunk = wt + (long long)blockIdx.z * 27 * cp * COC;

  float acc[2][COC];
#pragma unroll
  for (int j = 0; j < COC; ++j) acc[0][j] = acc[1][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < kXTile; i += kThreads) {
      const int ci = i % kCK;
      int v = i / kCK;
      const int xx = v % kDSX;
      v /= kDSX;
      const int yy = v % kDSY, dz = v / kDSY;
      const int zz = z + dz - 1, y = y0 + yy - 1, x = x0 + xx - 1;
      const int c = c0 + ci;
      float f = 0.f;
      if (zz >= 0 && zz < D && y >= 0 && y < H && x >= 0 && x < W && c < C)
        f = to_f<T>(in[(((long long)zz * H + y) * W + x) * C + c]);
      xs[((ci * 3 + dz) * kDSY + yy) * kDSX + xx] = f;
    }
    for (int i = threadIdx.x; i < 27 * kCK * COC; i += kThreads) {
      const int co = i % COC, r = i / COC;
      const int ci = r % kCK, tap = r / kCK;
      ws[i] = wchunk[((long long)tap * cp + c0 + ci) * COC + co];
    }
    __syncthreads();
    for (int dz = 0; dz < 3; ++dz) {
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int ci = 0; ci < kCK; ++ci) {
            const float* xr =
                xs + ((ci * 3 + dz) * kDSY + warp + dy) * kDSX + lane + dx;
            const float a0 = xr[0], a1 = xr[8 * kDSX];
            const float4* w4 = reinterpret_cast<const float4*>(
                ws + (((dz * 3 + dy) * 3 + dx) * kCK + ci) * COC);
#pragma unroll
            for (int j = 0; j < COC / 4; ++j) {
              const float4 b = w4[j];
              acc[0][4 * j + 0] = fmaf(a0, b.x, acc[0][4 * j + 0]);
              acc[0][4 * j + 1] = fmaf(a0, b.y, acc[0][4 * j + 1]);
              acc[0][4 * j + 2] = fmaf(a0, b.z, acc[0][4 * j + 2]);
              acc[0][4 * j + 3] = fmaf(a0, b.w, acc[0][4 * j + 3]);
              acc[1][4 * j + 0] = fmaf(a1, b.x, acc[1][4 * j + 0]);
              acc[1][4 * j + 1] = fmaf(a1, b.y, acc[1][4 * j + 1]);
              acc[1][4 * j + 2] = fmaf(a1, b.z, acc[1][4 * j + 2]);
              acc[1][4 * j + 3] = fmaf(a1, b.w, acc[1][4 * j + 3]);
            }
          }
        }
      }
    }
  }

  const int x = x0 + lane;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int y = y0 + warp + 8 * r;
    if (y >= H) continue;                     // the same for the whole warp
    const bool inside = x < W;
    if (inside) {
      T* o = out + (((long long)z * H + y) * W + x) * Cout;
#pragma unroll
      for (int j = 0; j < COC; ++j)
        if (co0 + j < Cout) o[co0 + j] = from_f<T>(acc[r][j]);
    }
    if (ps != nullptr) {
      float* p = ps + (((long long)z * H + y) * tiles_x + tx) * (2 * Cout);
#pragma unroll
      for (int j = 0; j < COC; ++j) {
        float s = inside ? acc[r][j] : 0.f;
        float s2 = s * s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (lane == 0 && co0 + j < Cout) {
          p[co0 + j] = s;
          p[Cout + co0 + j] = s2;
        }
      }
    }
  }
}

template <typename T, int COC>
int launch_direct(const void* in, const float* wt, void* out, float* ps,
                  int D, int H, int W, int C, int Cout, cudaStream_t s) {
  const int smem = direct_smem<COC>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_direct_kernel<T, COC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kDTX - 1) / kDTX;
  const dim3 grid(tiles_x * ((H + kDTY - 1) / kDTY), D,
                  (Cout + COC - 1) / COC);
  conv3d_direct_kernel<T, COC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(in), wt, static_cast<T*>(out), ps, D, H, W, C,
      Cout, tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_direct_coc(const void* in, const float* wt, void* out, float* ps,
                      int D, int H, int W, int C, int Cout, int coc,
                      cudaStream_t s) {
  switch (coc) {
    case 8:
      return launch_direct<T, 8>(in, wt, out, ps, D, H, W, C, Cout, s);
    case 16:
      return launch_direct<T, 16>(in, wt, out, ps, D, H, W, C, Cout, s);
    case 32:
      return launch_direct<T, 32>(in, wt, out, ps, D, H, W, C, Cout, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

static_assert(kDTX == TX, "both kernels write moments per 32-column tile");

}  // namespace

// dense in (D, H, W, 32) bf16 -> dense out (D, H, W, 32) bf16 + ps
// (D, H, tiles_x, 2, 32) f32, tiles_x = ceil(W/32); wt blocked as K5's;
// tiles = ceil(H/16) * tiles_x, refused (cudaErrorInvalidValue) when the
// caller counted otherwise; zc = depth slices per block.
extern "C" int dfm_conv3d_tc(const void* in, const void* wt, void* out,
                             float* ps, int D, int H, int W, int tiles,
                             int zc, void* stream) {
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + TY - 1) / TY;
  if (tiles != tiles_x * tiles_y || zc < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kConvSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, (D + zc - 1) / zc);
  conv_wmma_kernel<<<grid, kThreads, kConvSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(in), static_cast<const bf16*>(wt),
      static_cast<bf16*>(out), ps, D, H, W, tiles_x, zc);
  return (int)cudaGetLastError();
}

// dense in (D, H, W, C) -> dense out (D, H, W, Cout), both float32
// (dtype 0) or bf16 (dtype 1); wt as conv3d_direct_kernel's with COC =
// coc (8, 16 or 32); ps (D, H, ceil(W/32), 2, Cout) f32, or null for no
// moments.
extern "C" int dfm_conv3d_direct(const void* in, const float* wt, void* out,
                                 float* ps, int D, int H, int W, int C,
                                 int Cout, int coc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_direct_coc<float>(in, wt, out, ps, D, H, W, C, Cout, coc,
                                    s);
  if (dtype == 1)
    return launch_direct_coc<bf16>(in, wt, out, ps, D, H, W, C, Cout, coc,
                                   s);
  return (int)cudaErrorInvalidValue;
}

// K9b on the tensor cores: dense in (D, H, W, C) bf16, C % 8 == 0, on 16
// bytes -> channels [co0, co0 + n) of dense out (D, H, W, cout) bf16; wt
// (27, koct, n, 8) bf16, koct = C / 8 rounded up to even, zeros in the
// padding octet; n = 8, 16 or 32; blocks = the persistent grid (one
// block per SM). Refused (cudaErrorInvalidValue) for another n, C > 48,
// or when the weights leave no room for a ring of three slices.
extern "C" int dfm_conv3d_wgmma(const void* in, const void* wt, void* out,
                                int D, int H, int W, int C, int cout,
                                int co0, int n, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 || cout % 8 || co0 % 8 || co0 + n > cout)
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 8:
      return k9::launch_dense_c<8>(in, wt, out, D, H, W, C, cout, co0, blocks,
                                 s);
    case 16:
      return k9::launch_dense_c<16>(in, wt, out, D, H, W, C, cout, co0,
                                  blocks, s);
    case 32:
      return k9::launch_dense_c<32>(in, wt, out, D, H, W, C, cout, co0,
                                  blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
