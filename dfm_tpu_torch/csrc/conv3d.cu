// K9a conv3d_zpack / conv3d_gn and K9b conv3d_pallas: the 3x3x3 stride-1
// 'same' convolution of a dense (D, H, W, C) volume, channels innermost,
// with (K9a) or without (K9b) the GroupNorm moments of its unrounded f32
// result, and K9a's GroupNorm finish.
//
// Replace the TPU kernels of
//   dfm_tpu/ops/pallas/convgn.py:conv3d_zpack (pallas_call at :162) and
//   dfm_tpu/ops/pallas/conv3d.py:conv3d_pallas (pallas_call at :119),
// and the finish of dfm_tpu/ops/pallas/convgn.py:conv3d_gn (:210-221,
// which XLA fuses into one pass).
// Plain versions: dfm_tpu_torch/ops/convgn.py, ops/conv3d.py. The TPU
// kernels' z-in-lanes packing with a banded weight (2x the products, to
// fill 128 MXU lanes) and dx-in-lanes packing exist for a 128-lane matrix
// unit and are not carried over.
//
// Three device codes:
//   dfm_conv3d_wgmma: bf16 with C % 8 == 0 and Cout % 8 == 0, the wgmma +
//     TMA convolution of conv_dense.cuh, one launch per chunk of output
//     channels; with a moment tensor (K9a) its kMoments instance, which
//     writes the moments per (depth slice, row, 64-column tile). Bound by
//     operations (101.9 GFLOP at 72x80x320, C = Cout = 32, against
//     ~120 MB).
//   dfm_conv3d_direct: float32 and every other width: a direct
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
//     Moments (K9a) per (depth slice, row, 32-column tile); each warp
//     reduces its rows in a fixed order (xor tree), no atomics: identical
//     bits on every run.
//   dfm_conv3d_gn_finish: y = [relu](out * sc[c] + bs[c] [+ residual]) in
//     out's type, the product, each sum and the one rounding in the plain
//     version's order (ops/convgn.py:gn_finish_plain), so it returns its
//     bits. Bound by bytes: out and the residual read once, y written
//     once (354 MB at 72x80x320x32 bf16); 16-byte vectors, a grid-stride
//     loop.
#include <stdint.h>

#include "conv_dense.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                // direct and finish kernels
constexpr int kDTY = 16, kDTX = 32;          // direct output tile (rows,
                                             // columns)
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

// y = [relu](out * sc + bs [+ res]) over n / VEC vectors of VEC
// channels, C % VEC == 0 (a vector's channels are c0 .. c0 + VEC - 1).
template <typename T, int VEC, bool kRes, bool kRelu>
__global__ void __launch_bounds__(kThreads)
gn_finish_kernel(const T* __restrict__ out, const float* __restrict__ sc,
                 const float* __restrict__ bs, const T* __restrict__ res,
                 T* __restrict__ y, long long nvec, int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < nvec; i += stride) {
    const int c0 = (int)(i * VEC % C);
    float f[VEC], r[VEC];
    load_vec<T, VEC>(out + i * VEC, f);
    if constexpr (kRes) load_vec<T, VEC>(res + i * VEC, r);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float v = __fadd_rn(__fmul_rn(f[k], __ldg(sc + c0 + k)),
                          __ldg(bs + c0 + k));
      if constexpr (kRes) v = __fadd_rn(v, r[k]);
      if constexpr (kRelu) v = v < 0.f ? 0.f : v;   // NaN stays NaN
      f[k] = v;
    }
    store_vec<T, VEC>(y + i * VEC, f);
  }
}

template <typename T, int VEC>
int launch_finish(const void* out, const float* sc, const float* bs,
                  const void* res, void* y, long long n, int C, int relu,
                  cudaStream_t s) {
  const long long nvec = n / VEC;
  const long long need = (nvec + kThreads - 1) / kThreads;
  const int blocks = (int)(need < (1 << 20) ? need : (1 << 20));
  const T* o = static_cast<const T*>(out);
  const T* r = static_cast<const T*>(res);
  T* d = static_cast<T*>(y);
  if (res != nullptr && relu)
    gn_finish_kernel<T, VEC, true, true><<<blocks, kThreads, 0, s>>>(
        o, sc, bs, r, d, nvec, C);
  else if (res != nullptr)
    gn_finish_kernel<T, VEC, true, false><<<blocks, kThreads, 0, s>>>(
        o, sc, bs, r, d, nvec, C);
  else if (relu)
    gn_finish_kernel<T, VEC, false, true><<<blocks, kThreads, 0, s>>>(
        o, sc, bs, r, d, nvec, C);
  else
    gn_finish_kernel<T, VEC, false, false><<<blocks, kThreads, 0, s>>>(
        o, sc, bs, r, d, nvec, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_finish_vec(const void* out, const float* sc, const float* bs,
                      const void* res, void* y, long long n, int C, int vec,
                      int relu, cudaStream_t s) {
  if (vec == vec16<T>())
    return launch_finish<T, vec16<T>()>(out, sc, bs, res, y, n, C, relu, s);
  if (vec == 1)
    return launch_finish<T, 1>(out, sc, bs, res, y, n, C, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

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

// K9b / K9a on the tensor cores: dense in (D, H, W, C) bf16, C % 8 == 0,
// on 16 bytes -> channels [co0, co0 + n) of dense out (D, H, W, cout)
// bf16 and, when ps is given (K9a), of its moments ps (D, H, ceil(W /
// 64), 2, cout) f32; wt (27, koct, n, 8) bf16, koct = C / 8 rounded up
// to even, zeros in the padding octet; n = 8, 16 or 32; blocks = the
// persistent grid (one block per SM). Refused (cudaErrorInvalidValue) for
// another n, C > 48, or when the weights leave no room for a ring of
// three slices.
extern "C" int dfm_conv3d_wgmma(const void* in, const void* wt, void* out,
                                float* ps, int D, int H, int W, int C,
                                int cout, int co0, int n, int blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 || cout % 8 || co0 % 8 || co0 + n > cout)
    return (int)cudaErrorInvalidValue;
  if (ps != nullptr) {
    switch (n) {
      case 8:
        return k9::launch_dense_c<8, true>(in, wt, out, ps, D, H, W, C, cout,
                                           co0, blocks, s);
      case 16:
        return k9::launch_dense_c<16, true>(in, wt, out, ps, D, H, W, C,
                                            cout, co0, blocks, s);
      case 32:
        return k9::launch_dense_c<32, true>(in, wt, out, ps, D, H, W, C,
                                            cout, co0, blocks, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (n) {
    case 8:
      return k9::launch_dense_c<8, false>(in, wt, out, ps, D, H, W, C, cout,
                                          co0, blocks, s);
    case 16:
      return k9::launch_dense_c<16, false>(in, wt, out, ps, D, H, W, C, cout,
                                           co0, blocks, s);
    case 32:
      return k9::launch_dense_c<32, false>(in, wt, out, ps, D, H, W, C, cout,
                                           co0, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The GroupNorm finish: out and res (null for none) (n / C, C) of
// dtype 0 (float32) or 1 (bf16), sc, bs (C,) f32 -> y of out's type;
// vec = 16-byte vectors (8 bf16 or 4 floats, C % vec == 0, every pointer
// on 16 bytes) or 1; relu 0 or 1.
extern "C" int dfm_conv3d_gn_finish(const void* out, const float* sc,
                                    const float* bs, const void* res,
                                    void* y, long long n, int C, int vec,
                                    int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || vec < 1 || n % C || C % vec)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (dtype == 0)
    return launch_finish_vec<float>(out, sc, bs, res, y, n, C, vec, relu, s);
  if (dtype == 1)
    return launch_finish_vec<bf16>(out, sc, bs, res, y, n, C, vec, relu, s);
  return (int)cudaErrorInvalidValue;
}
