// K1 warp_prev: the prev-frame half of the plane-sweep cost volume.
//
// Replaces the TPU kernel dfm_tpu/ops/pallas/cost_warp.py:warp_prev_band
// (band DMA + hat-matrix matmuls, with a lax.cond gather fallback when a
// row's taps leave its 4-row band). Semantics: bilinear sample of
// prev (B, H, W, C) at (u, v) (B, D, Hq, Wq) in align-corners pixel
// index space, taps outside the map weigh zero, f32 accumulation; out
// (B, D, Hq, Wq, C) in the input type. Plain version:
// dfm_tpu_torch/ops/cost_volume.py:warp_prev_plain.
//
// Bound on the H100: bytes. At the DfM-KITTI shapes (prev 1x320x1280x32
// bf16, 72x80x320 samples) it writes ~118 MB and reads ~26 MB of
// features plus ~15 MB of coordinates, against ~9 flops per output
// element. Design: one thread per (output pixel, 16 bytes of channels):
// at C=32 bf16 four neighbouring threads read each 64-byte tap row of
// the NHWC map with 16-byte loads and write the 64-byte output row
// with 16-byte stores; they share the pixel's coordinates (one
// broadcast read). Channel counts that do not fill 16-byte vectors
// take one element per thread. There is no band limit, so the TPU
// kernel's band check and gather fallback collapse into this kernel.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One thread per (output pixel, VEC consecutive channels).
template <typename T, int VEC>
__global__ void warp_prev_kernel(const T* __restrict__ prev,
                                 const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 T* __restrict__ out, int H, int W, int C,
                                 long long per_b, long long n) {
  const int chunks = C / VEC;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pix = t / chunks;
  if (pix >= n) return;
  const int c0 = (int)(t - pix * chunks) * VEC;
  const long long b = pix / per_b;
  int yi[2], xi[2];
  float wy[2], wx[2];
  axis_taps(v[pix], H, yi, wy);
  axis_taps(u[pix], W, xi, wx);
  const T* base = prev + b * H * (long long)W * C + c0;
  float acc[VEC], f[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float wt = wx[dx] * wy[dy];
      load_vec<T, VEC>(base + ((long long)yi[dy] * W + xi[dx]) * C, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += f[i] * wt;
    }
  }
  store_vec<T, VEC>(out + pix * C + c0, acc);
}

template <typename T, int VEC>
int launch_vec(const void* prev, const float* u, const float* v, void* out,
               int H, int W, int C, long long per_b, long long n,
               cudaStream_t s) {
  const long long threads = n * (C / VEC);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  warp_prev_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(prev), u, v, static_cast<T*>(out), H, W, C,
      per_b, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* prev, const float* u, const float* v, void* out,
           int B, int H, int W, int C, long long per_b, cudaStream_t s) {
  const long long n = (long long)B * per_b;
  if (n == 0) return 0;
  if (C % vec16<T>() == 0)      // 16-byte rows: vector loads and stores
    return launch_vec<T, vec16<T>()>(prev, u, v, out, H, W, C, per_b, n, s);
  return launch_vec<T, 1>(prev, u, v, out, H, W, C, per_b, n, s);
}

}  // namespace

// per_b = D * Hq * Wq samples per batch element; is_bf16 selects the
// element type (bf16 or float). Returns cudaGetLastError() after launch.
extern "C" int dfm_warp_prev(const void* prev, const float* u,
                             const float* v, void* out, int B, int H, int W,
                             int C, long long per_b, int is_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(prev, u, v, out, B, H, W, C, per_b, s);
  return launch<float>(prev, u, v, out, B, H, W, C, per_b, s);
}
