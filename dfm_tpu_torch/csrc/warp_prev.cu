// K1 warp_prev: the prev-frame half of the plane-sweep cost volume.
//
// Replaces the TPU kernel dfm_tpu/ops/pallas/cost_warp.py:warp_prev_band
// (band DMA + hat-matrix matmuls, with a lax.cond gather fallback when a
// row's taps leave its 4-row band) and, on the main path, the sampling
// grid that dfm_tpu/ops/cost_volume.py:plane_sweep_grids builds for it.
// Semantics: bilinear sample of prev (B, H, W, C) at (u, v) in
// align-corners pixel index space, taps outside the map weigh zero, f32
// accumulation; out (B, D, Hq, Wq, C) in the input type. The sample
// point of output pixel (b, d, h, w) is computed here from the parameter
// row of sample b and the depth d (`dfm_warp_prev_sweep`):
//   x = w * step, y = h * step
//   u = (x + crop_x) / scale, v = (y + crop_y) / scale, u = org_w - u if
//   flipped (the augmentation undone)
//   (X, Y, Z) = depth * (M[:, 0] u + M[:, 1] v + M[:, 2]) + M[:, 3], with
//   M rows 0-2 of cam2img . cur2prev . cam2img^-1 (the camera point's
//   4th component taken as 1, as points_img2cam does)
//   pu = X / Z, pv = Y / Z, pu = org_w - pu if flipped,
//   (pu, pv) = ((pu, pv) * scale - crop) * (1 / feat_sample_factor)
// Each product, sum and quotient is rounded alone in that order, as
// dfm_tpu_torch/ops/cost_volume.py:sweep_coords_plain evaluates it
// (no fused multiply-add), and the bilinear sum in warp_prev_plain's
// order (csrc/common.cuh:madd), so on the card the kernel returns the
// plain versions' bits.
// Plain version: sweep_coords_plain + warp_prev_plain.
//
// Bound on the H100: bytes. At the DfM-KITTI shapes (prev 1x320x1280x32
// bf16, 72x80x320 samples) it writes 118 MB and reads the ~26 MB of prev
// rows the taps touch; the coordinates (15 MB of float32, and ~1.8 ms of
// PyTorch kernels to make them) are never made. Design: a block owns one
// (b, d) and kRows output rows; it loads the parameter row and the depth
// once into shared memory. A warp walks groups of 32 pixels: lane j
// computes the sample point of pixel j of the group once, then the point
// is passed by __shfl_sync to the LANES lanes that work on each pixel,
// LANES of 16 bytes of channels each
// (C = 32 bf16: 4 lanes, 8 pixels per warp step), which read the 4 tap
// rows of the NHWC map with 16-byte loads and write the pixel's output
// row with 16-byte stores. The taps of an output row lie in a narrow
// band of prev rows (the TPU kernel's own observation), and the 72
// depths sample nearly the same rows, so the tap rows stay in L2.
// What holds it back: PERF.md.
// Channel counts that do not fill 16-byte vectors take one element per
// lane. There is no band limit, so the TPU kernel's band check and
// gather fallback collapse into this kernel.
//
// K1 backward (`dfm_warp_prev_sweep_bwd`), the gradient of prev for
// training: the exact transpose of the forward's sampling, with the same
// sample points, taps and weights. Each output pixel's grad_out row is
// read once (16-byte loads) and each of its nonzero taps adds w * g to
// a float32 grad_prev (B, H, W, C) with atomicAdd (the wrapper zeroes it
// and casts it to prev's type); the work is laid out as the forward's, a
// warp per group of pixels, LANES lanes of 16 bytes each a pixel. The
// order of the atomic sums changes from run to run, so the result is not
// bit-reproducible. Plain version: torch.autograd.grad of warp_prev_plain.
// Bound on the H100: bytes, the grad_out read (236 MB in float32 at
// DfM-KITTI) and the grad_prev write; the atomics land in L2, where the
// taps of neighbouring pixels and depths meet.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kParams = 18;    // M rows 0-2, org_w, flip, crop x, y, scale,
                               // 1 / feat_sample_factor
constexpr int kRows = 4;      // output rows of one block

// The sample point of output pixel (h, w) from the parameter row `p`
// and the depth `dd`, each step rounded alone (sweep_coords_plain).
__device__ __forceinline__ void sweep_point(const float* __restrict__ p,
                                           float dd, int h, int w,
                                           float step, float& pu,
                                           float& pv) {
  const float org_w = p[12], cox = p[14], coy = p[15], sf = p[16];
  const bool flip = p[13] > 0.f;
  float u = __fdiv_rn(__fadd_rn(__fmul_rn((float)w, step), cox), sf);
  const float v = __fdiv_rn(__fadd_rn(__fmul_rn((float)h, step), coy), sf);
  if (flip) u = __fsub_rn(org_w, u);
  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = p + 4 * i;
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(m[0], u),
                                        __fmul_rn(m[1], v)), m[2]);
    r[i] = __fadd_rn(__fmul_rn(dd, s), m[3]);
  }
  pu = __fdiv_rn(r[0], r[2]);
  pv = __fdiv_rn(r[1], r[2]);
  if (flip) pu = __fsub_rn(org_w, pu);
  pu = __fmul_rn(__fsub_rn(__fmul_rn(pu, sf), cox), p[17]);
  pv = __fmul_rn(__fsub_rn(__fmul_rn(pv, sf), coy), p[17]);
}

// grid (ceil(Hq / kRows), D, B), block kThreads; params (B, kParams),
// depths (D,). The caller keeps every tensor below 2^31 elements.
template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads, 4)
warp_prev_kernel(const T* __restrict__ prev,
                 const float* __restrict__ params,
                 const float* __restrict__ depths, T* __restrict__ out,
                 int H, int W, int C, int D, int Hq, int Wq, float step) {
  constexpr int kPix = 32 / LANES;      // pixels of one warp step
  __shared__ float prm[kParams + 1];   // parameter row, depth
  const int b = blockIdx.z, d = blockIdx.y;
  const int h0 = blockIdx.x * kRows;
  const int npix = min(kRows, Hq - h0) * Wq;
  const int first = ((b * D + d) * Hq + h0) * Wq;   // block's first pixel
  if (threadIdx.x < kParams)
    prm[threadIdx.x] = params[b * kParams + threadIdx.x];
  else if (threadIdx.x == kParams)
    prm[kParams] = depths[d];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LANES, chunks = C / VEC;
  const T* base = prev + (size_t)b * H * W * C;
  for (int g = warp * 32; g < npix; g += kThreads) {
    const int p = g + lane;
    const int hl = p / Wq;
    float pu = 0.f, pv = 0.f;
    if (p < npix)
      sweep_point(prm, prm[kParams], h0 + hl, p - hl * Wq, step, pu, pv);
#pragma unroll
    for (int s = 0; s < LANES; ++s) {
      const int q = s * kPix + lane / LANES;     // pixel of the group
      const float qu = __shfl_sync(0xffffffffu, pu, q);
      const float qv = __shfl_sync(0xffffffffu, pv, q);
      if (g + q >= npix) continue;
      int yi[2], xi[2];
      float wy[2], wx[2];
      axis_taps(qv, H, yi, wy);
      axis_taps(qu, W, xi, wx);
      float wt[4];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          wt[dy * 2 + dx] = __fmul_rn(wx[dx], wy[dy]);
      T* dst = out + (size_t)(first + g + q) * C;
      for (int j = sub; j < chunks; j += LANES) {
        float acc[VEC];
        raw_t<T, VEC> f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {      // all four loads in flight
          if (wt[k] != 0.f)
            f[k] = load_raw<T, VEC>(base + ((size_t)yi[k >> 1] * W +
                                            xi[k & 1]) * C + j * VEC);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (wt[k] != 0.f)   // a zero weight adds an exact zero
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[i] = madd(raw_elem<T, VEC>(f[k], i), wt[k], acc[i]);
        store_vec<T, VEC>(dst + j * VEC, acc);
      }
    }
  }
}

// The transpose of warp_prev_kernel: grad_out (B, D, Hq, Wq, C) of type
// T -> float32 grad_prev (B, H, W, C), zeroed by the caller, by atomics.
template <typename T, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads, 4)
warp_prev_bwd_kernel(const T* __restrict__ gout,
                     const float* __restrict__ params,
                     const float* __restrict__ depths,
                     float* __restrict__ gprev, int H, int W, int C, int D,
                     int Hq, int Wq, float step) {
  constexpr int kPix = 32 / LANES;
  __shared__ float prm[kParams + 1];
  const int b = blockIdx.z, d = blockIdx.y;
  const int h0 = blockIdx.x * kRows;
  const int npix = min(kRows, Hq - h0) * Wq;
  const int first = ((b * D + d) * Hq + h0) * Wq;
  if (threadIdx.x < kParams)
    prm[threadIdx.x] = params[b * kParams + threadIdx.x];
  else if (threadIdx.x == kParams)
    prm[kParams] = depths[d];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LANES, chunks = C / VEC;
  float* base = gprev + (size_t)b * H * W * C;
  for (int g = warp * 32; g < npix; g += kThreads) {
    const int p = g + lane;
    const int hl = p / Wq;
    float pu = 0.f, pv = 0.f;
    if (p < npix)
      sweep_point(prm, prm[kParams], h0 + hl, p - hl * Wq, step, pu, pv);
#pragma unroll
    for (int s = 0; s < LANES; ++s) {
      const int q = s * kPix + lane / LANES;
      const float qu = __shfl_sync(0xffffffffu, pu, q);
      const float qv = __shfl_sync(0xffffffffu, pv, q);
      if (g + q >= npix) continue;
      int yi[2], xi[2];
      float wy[2], wx[2];
      axis_taps(qv, H, yi, wy);
      axis_taps(qu, W, xi, wx);
      float wt[4];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          wt[dy * 2 + dx] = __fmul_rn(wx[dx], wy[dy]);
      const T* src = gout + (size_t)(first + g + q) * C;
      for (int j = sub; j < chunks; j += LANES) {
        float gv[VEC];
        load_vec<T, VEC>(src + j * VEC, gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (wt[k] == 0.f) continue;   // out of the map: no tap
          float* dst = base + ((size_t)yi[k >> 1] * W + xi[k & 1]) * C +
                       j * VEC;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            atomicAdd(dst + i, __fmul_rn(wt[k], gv[i]));
        }
      }
    }
  }
}

template <typename T, int VEC>
int launch_bwd_vec(const void* gout, const float* params,
                   const float* depths, float* gprev, int B, int H, int W,
                   int C, int D, int Hq, int Wq, float step, cudaStream_t s) {
  const dim3 grid((Hq + kRows - 1) / kRows, D, B);
  const T* g = static_cast<const T*>(gout);
  if (C / VEC <= 4)
    warp_prev_bwd_kernel<T, VEC, 4><<<grid, kThreads, 0, s>>>(
        g, params, depths, gprev, H, W, C, D, Hq, Wq, step);
  else
    warp_prev_bwd_kernel<T, VEC, 8><<<grid, kThreads, 0, s>>>(
        g, params, depths, gprev, H, W, C, D, Hq, Wq, step);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gout, const float* params, const float* depths,
               float* gprev, int B, int H, int W, int C, int D, int Hq,
               int Wq, float step, cudaStream_t s) {
  if ((long long)B * D * Hq * Wq == 0) return 0;
  if (C % vec16<T>() == 0)
    return launch_bwd_vec<T, vec16<T>()>(gout, params, depths, gprev, B, H,
                                         W, C, D, Hq, Wq, step, s);
  return launch_bwd_vec<T, 1>(gout, params, depths, gprev, B, H, W, C, D, Hq,
                              Wq, step, s);
}

template <typename T, int VEC>
int launch_vec(const void* prev, const float* params, const float* depths,
               void* out, int B, int H, int W, int C, int D, int Hq, int Wq,
               float step, cudaStream_t s) {
  const dim3 grid((Hq + kRows - 1) / kRows, D, B);
  const T* p = static_cast<const T*>(prev);
  T* o = static_cast<T*>(out);
  if (C / VEC <= 4)
    warp_prev_kernel<T, VEC, 4><<<grid, kThreads, 0, s>>>(
        p, params, depths, o, H, W, C, D, Hq, Wq, step);
  else
    warp_prev_kernel<T, VEC, 8><<<grid, kThreads, 0, s>>>(
        p, params, depths, o, H, W, C, D, Hq, Wq, step);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* prev, const float* params, const float* depths,
           void* out, int B, int H, int W, int C, int D, int Hq, int Wq,
           float step, cudaStream_t s) {
  if ((long long)B * D * Hq * Wq == 0) return 0;
  if (C % vec16<T>() == 0)      // 16-byte rows: vector loads and stores
    return launch_vec<T, vec16<T>()>(prev, params, depths, out, B, H, W, C,
                                     D, Hq, Wq, step, s);
  return launch_vec<T, 1>(prev, params, depths, out, B, H, W, C, D, Hq, Wq,
                          step, s);
}

}  // namespace

// prev (B, H, W, C), params (B, 18) float32 rows of sweep_params, depths
// (D,) float32 -> out (B, D, Hq, Wq, C), output pixel (h, w) at feature
// position (w, h) * step; is_bf16 selects the element type (bf16 or
// float). Returns cudaGetLastError() after the launch.
extern "C" int dfm_warp_prev_sweep(const void* prev, const float* params,
                                   const float* depths, void* out, int B,
                                   int H, int W, int C, int D, int Hq,
                                   int Wq, float step, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(prev, params, depths, out, B, H, W, C, D,
                                 Hq, Wq, step, s);
  return launch<float>(prev, params, depths, out, B, H, W, C, D, Hq, Wq,
                       step, s);
}

// grad_out (B, D, Hq, Wq, C) of type bf16 / float (is_bf16), params and
// depths as dfm_warp_prev_sweep -> gprev (B, H, W, C) float32, which the
// caller zeroes first; the gradient of dfm_warp_prev_sweep's prev.
extern "C" int dfm_warp_prev_sweep_bwd(const void* gout, const float* params,
                                       const float* depths, float* gprev,
                                       int B, int H, int W, int C, int D,
                                       int Hq, int Wq, float step,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(gout, params, depths, gprev, B, H, W, C,
                                     D, Hq, Wq, step, s);
  return launch_bwd<float>(gout, params, depths, gprev, B, H, W, C, D, Hq, Wq,
                           step, s);
}
