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
// K4 is bound by operations: the Hopper convolution of conv_p2p.cuh
// (wgmma + TMA, a persistent grid of one block per SM).
#include <stdint.h>

#include "conv_p2p.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunks = 4;             // 16-byte chunks of a 32-channel voxel
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

// chain in -> chain out (border zeroed by the kernel) + ps (D, tiles, 2,
// 32) f32, tiles = ceil(H/8) * ceil(W/64), refused (cudaErrorInvalidValue)
// when the caller sized ps for another count; blocks = the persistent
// grid (one block per SM). `in` and `wt` start on 16 bytes.
extern "C" int dfm_conv_p2p(const void* in, const void* wt, void* out,
                            float* ps, int D, int H, int W, int tiles,
                            int blocks, int residual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + k4::TX - 1) / k4::TX;
  const int tiles_y = (H + k4::TY - 1) / k4::TY;
  if (tiles != tiles_x * tiles_y || blocks < 1 ||
      (long long)tiles * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!k4::chain_tensor_map(&map, in, D, H, W))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      k4::conv_p2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k4::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int units = tiles * D;
  k4::conv_p2p_kernel<<<min(blocks, units), k4::kThreads, k4::kSmem, s>>>(
      map, static_cast<const bf16*>(wt), static_cast<bf16*>(out), ps, D, H,
      W, tiles_x, units, residual);
  return (int)cudaGetLastError();
}
