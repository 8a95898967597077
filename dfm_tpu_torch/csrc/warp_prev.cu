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
// sample points (sweep_point, rounded as the forward rounds), taps and
// weights (fmul(wx, wy), zero outside the map), into a float32 grad_prev
// (B, H, W, C) (the wrapper casts it to prev's type). Plain version:
// torch.autograd.grad of warp_prev_plain. Bound on the H100: bytes, the
// grad_out read (236 MB in float32 at DfM-KITTI) and the grad_prev write
// (52 MB). Design (warp_prev_bwd_kernel): a gather, with no atomics. A
// block owns a tile of 8 prev rows (a warp a row) x 32 columns x 32
// channels (a lane a channel; wider maps take one block for each 32
// channels, any C) and writes each of its elements once, by plain stores,
// zeros where no tap lands. For each depth it bounds the output pixels
// whose taps can reach the tile by the preimage of the tile's rectangle
// under the sample map
// (candidate_box: the homography inverted in double; 21 pixels a box on
// average at DfM-KITTI, where samples lie 3-4 prev pixels apart); it
// computes the exact forward point of every candidate once, 256 at a time
// across the depths, in shared memory. Each warp then takes, in candidate order, the
// candidates with a tap in its row, loads their grad_out rows (a lane a
// channel, 8 pixels in flight) and adds w * g to its row of shared
// accumulators. Every (pixel, tap) is found by the one warp that owns its
// cell; the sums run in a fixed order (depth, candidate), so two calls
// return the same bits. Where the map is degenerate for a tile (the
// homography singular, or the tile's rectangle reaching its horizon) the
// box is the whole output plane: slower, the same sums. What holds it
// back: about 40 instructions a (pixel, row) item, latency-bound
// (PERF.md).
#include <math.h>
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

// ---- K1 backward: tile gathers (see the header).
constexpr int kBwdRows = kThreads / 32;   // prev rows of a tile: a warp each
constexpr int kBwdCols = 32;              // prev columns of a tile
constexpr int kBwdChunk = 32;             // channels of a block: a lane each
constexpr int kBwdBatch = 8;              // items a warp loads, then adds
constexpr int kBwdMinBlocks = 4;          // blocks an SM, for the registers
constexpr int kBwdDepths = kThreads;      // depths whose boxes a block holds
constexpr int kCand = kThreads;           // candidates staged per round
constexpr double kBoxMargin = 0.5;        // prev pixels around the tile

// The output pixels (hq, wq) of depth dd whose sample points can have a tap
// in prev rows [r0, r0 + nrows) x columns [c0, c0 + ncols): the box
// (h0, w0, width, count) that bounds the preimage of the rectangle
// [c0 - 1, c0 + ncols) x [r0 - 1, r0 + nrows) widened by kBoxMargin, in
// double. The forward maps (w, h) affinely to the image point (u, v),
// that by the homography Hm = [dd M0 | dd M1 | dd M2 + M3] to the prev
// image and back affinely to (pu, pv) (sweep_point); the inverse maps
// each rectangle corner back with adj(Hm). Where the adjugate's third
// row keeps one sign over the corners the preimage is the convex hull of
// the corners' images, so their bounding box holds every candidate; else
// (or for a singular Hm) the box is the whole output plane.
__device__ int4 candidate_box(const float* __restrict__ p, float depth,
                              int r0, int nrows, int c0, int ncols, int Hq,
                              int Wq, float step) {
  const double dd = depth, org_w = p[12], cox = p[14], coy = p[15];
  const double sf = p[16], fsf = 1.0 / (double)p[17];
  const bool flip = p[13] > 0.f;
  double m[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i][0] = dd * p[4 * i];
    m[i][1] = dd * p[4 * i + 1];
    m[i][2] = dd * p[4 * i + 2] + (double)p[4 * i + 3];
  }
  const double a[3][3] = {
      {m[1][1] * m[2][2] - m[1][2] * m[2][1],
       m[0][2] * m[2][1] - m[0][1] * m[2][2],
       m[0][1] * m[1][2] - m[0][2] * m[1][1]},
      {m[1][2] * m[2][0] - m[1][0] * m[2][2],
       m[0][0] * m[2][2] - m[0][2] * m[2][0],
       m[0][2] * m[1][0] - m[0][0] * m[1][2]},
      {m[1][0] * m[2][1] - m[1][1] * m[2][0],
       m[0][1] * m[2][0] - m[0][0] * m[2][1],
       m[0][0] * m[1][1] - m[0][1] * m[1][0]}};
  const double det = m[0][0] * a[0][0] + m[0][1] * a[1][0] + m[0][2] * a[2][0];
  bool ok = det != 0.0 && isfinite(det);
  double wlo = INFINITY, whi = -INFINITY, hlo = INFINITY, hhi = -INFINITY;
  int pos = 0, neg = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double px = (k & 1) ? c0 + ncols + kBoxMargin : c0 - 1 - kBoxMargin;
    const double py = (k & 2) ? r0 + nrows + kBoxMargin : r0 - 1 - kBoxMargin;
    double pu = (px * fsf + cox) / sf;       // undo (pu sf - cox) / fsf
    const double pv = (py * fsf + coy) / sf;
    if (flip) pu = org_w - pu;
    const double q0 = a[0][0] * pu + a[0][1] * pv + a[0][2];
    const double q1 = a[1][0] * pu + a[1][1] * pv + a[1][2];
    const double q2 = a[2][0] * pu + a[2][1] * pv + a[2][2];
    pos += q2 > 0.0;
    neg += q2 < 0.0;
    double u = q0 / q2;
    const double v = q1 / q2;
    if (flip) u = org_w - u;
    const double w = (u * sf - cox) / step, h = (v * sf - coy) / step;
    ok = ok && isfinite(w) && isfinite(h);
    wlo = fmin(wlo, w);
    whi = fmax(whi, w);
    hlo = fmin(hlo, h);
    hhi = fmax(hhi, h);
  }
  int h0 = 0, h1 = Hq - 1, w0 = 0, w1 = Wq - 1;
  if (ok && (pos == 4 || neg == 4)) {
    h0 = (int)fmax(ceil(hlo), 0.0);
    h1 = (int)fmin(floor(hhi), Hq - 1.0);
    w0 = (int)fmax(ceil(wlo), 0.0);
    w1 = (int)fmin(floor(whi), Wq - 1.0);
  }
  if (h0 > h1 || w0 > w1) return make_int4(0, 0, 1, 0);
  return make_int4(h0, w0, w1 - w0 + 1, (h1 - h0 + 1) * (w1 - w0 + 1));
}

// grid (ceil(W / kBwdCols), ceil(H / kBwdRows), B * ceil(C / kBwdChunk)),
// block kThreads: blockIdx.z = b * chunks + chunk, the block's channels
// [chunk * kBwdChunk, + kBwdChunk) of the tile. Static shared memory (45
// KB): the accumulators [kBwdRows][kBwdCols][kBwdChunk], the staged
// candidates (kCand each of pixel, row and column floors, and the four
// weights) and kBwdDepths boxes and their prefix sums. The caller keeps
// every tensor below 2^31 elements.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
warp_prev_bwd_kernel(const T* __restrict__ gout,
                     const float* __restrict__ params,
                     const float* __restrict__ depths,
                     float* __restrict__ gprev, int H, int W, int C, int D,
                     int Hq, int Wq, float step) {
  __shared__ float acc[kBwdRows][kBwdCols][kBwdChunk];
  __shared__ int4 c_pix[kCand];
  __shared__ float4 c_wts[kCand];
  __shared__ int4 box[kBwdDepths];
  __shared__ int cum[kBwdDepths + 1];
  __shared__ float prm[kParams];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (C + kBwdChunk - 1) / kBwdChunk;
  const int b = blockIdx.z / chunks, cc = blockIdx.z - b * chunks;
  const int r0 = blockIdx.y * kBwdRows, c0 = blockIdx.x * kBwdCols;
  const int nrows = min(kBwdRows, H - r0), ncols = min(kBwdCols, W - c0);
  const int ch = cc * kBwdChunk + lane;      // this lane's channel
  if (threadIdx.x < kParams)
    prm[threadIdx.x] = params[b * kParams + threadIdx.x];
  for (int e = threadIdx.x; e < kBwdRows * kBwdCols * kBwdChunk;
       e += kThreads)
    (&acc[0][0][0])[e] = 0.f;
  __syncthreads();
  const int r = r0 + warp;
  float* mine = &acc[warp][0][0] + lane;     // this warp's row, lane's channel

  for (int d0 = 0; d0 < D; d0 += kBwdDepths) {
    const int nd = min(kBwdDepths, D - d0);
    if (threadIdx.x < nd)
      box[threadIdx.x] = candidate_box(prm, __ldg(depths + d0 + threadIdx.x),
                                       r0, nrows, c0, ncols, Hq, Wq, step);
    __syncthreads();
    if (warp == 0) {                 // exclusive prefix of the box counts
      int run = 0;
      for (int i0 = 0; i0 < nd; i0 += 32) {
        const int i = i0 + lane, n = i < nd ? box[i].w : 0;
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        if (i < nd) cum[i] = run + incl - n;
        run += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) cum[nd] = run;
    }
    __syncthreads();
    const int total = cum[nd];
    // rounds of kCand candidates, depth by depth, each box row-major
    for (int k0 = 0; k0 < total; k0 += kCand) {
      const int cnt = min(kCand, total - k0);
      if ((int)threadIdx.x < cnt) {
        const int k = k0 + threadIdx.x;
        int lo = 0, hi = nd - 1;          // the last depth with cum <= k
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (cum[mid] <= k) lo = mid; else hi = mid - 1;
        }
        const int4 bx = box[lo];
        const int i = k - cum[lo], hq = bx.x + i / bx.z, wq = bx.y + i % bx.z;
        float pu, pv;
        sweep_point(prm, __ldg(depths + d0 + lo), hq, wq, step, pu, pv);
        int yi[2], xi[2];
        float wy[2], wx[2];
        axis_taps(pv, H, yi, wy);
        axis_taps(pu, W, xi, wx);
        // (pixel, row floor, column floor, 0), (wy0, wy1, wx0, wx1)
        c_pix[threadIdx.x] = make_int4(((b * D + d0 + lo) * Hq + hq) * Wq + wq,
                                       floor_tap(pv, H), floor_tap(pu, W), 0);
        c_wts[threadIdx.x] = make_float4(wy[0], wy[1], wx[0], wx[1]);
      }
      __syncthreads();
      if (warp < nrows) {                // warp-uniform
        for (int t0 = 0; t0 < cnt; t0 += 32) {
          const int t = t0 + lane;
          bool hit = false;
          if (t < cnt) {
            const int4 px = c_pix[t];
            const float4 wt = c_wts[t];
            const int j = px.z - c0;
            hit = ((px.y == r && wt.x != 0.f) || (px.y + 1 == r && wt.y != 0.f)) &&
                  ((j >= 0 && j < ncols && wt.z != 0.f) ||
                   (j >= -1 && j + 1 < ncols && wt.w != 0.f));
          }
          unsigned bits = __ballot_sync(0xffffffffu, hit);
          while (bits) {       // in candidate order, kBwdBatch at a time
            float gv[kBwdBatch];
            unsigned taken = 0u;
#pragma unroll
            for (int q = 0; q < kBwdBatch; ++q) {   // all loads in flight
              const unsigned low = bits & (0u - bits);
              gv[q] = low != 0u && ch < C
                          ? to_f<T>(gout[(size_t)c_pix[t0 + __ffs(low) - 1].x
                                             * C + ch])
                          : 0.f;
              taken |= low;
              bits ^= low;
            }
#pragma unroll
            for (int q = 0; q < kBwdBatch; ++q) {
              if (taken == 0u) break;
              const int c = t0 + __ffs(taken) - 1;
              taken &= taken - 1u;
              if (ch >= C) continue;
              const int4 px = c_pix[c];
              const float4 w4 = c_wts[c];
              const float wyr = px.y == r ? w4.x : w4.y;
              const int j = px.z - c0;
              if (j >= 0 && j < ncols) {
                const float wt = __fmul_rn(w4.z, wyr);
                if (wt != 0.f)
                  mine[j * kBwdChunk] = __fadd_rn(mine[j * kBwdChunk],
                                                  __fmul_rn(wt, gv[q]));
              }
              if (j >= -1 && j + 1 < ncols) {
                const float wt = __fmul_rn(w4.w, wyr);
                if (wt != 0.f)
                  mine[(j + 1) * kBwdChunk] = __fadd_rn(
                      mine[(j + 1) * kBwdChunk], __fmul_rn(wt, gv[q]));
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // every element of the tile's channels once, by plain stores
  const int cw = min(kBwdChunk, C - cc * kBwdChunk), per_row = ncols * cw;
  const size_t base = (((size_t)b * H + r0) * W + c0) * C + cc * kBwdChunk;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int rw = e / per_row, rest = e - rw * per_row;
    const int col = rest / cw, k = rest - col * cw;
    gprev[base + ((size_t)rw * W + col) * C + k] = acc[rw][col][k];
  }
}

template <typename T>
int launch_bwd(const void* gout, const float* params, const float* depths,
               float* gprev, int B, int H, int W, int C, int D, int Hq,
               int Wq, float step, cudaStream_t s) {
  if ((long long)B * H * W * C == 0) return 0;
  const long long z = (long long)B * ((C + kBwdChunk - 1) / kBwdChunk);
  if (z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBwdCols - 1) / kBwdCols, (H + kBwdRows - 1) / kBwdRows,
                  (unsigned)z);
  warp_prev_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(gout), params, depths, gprev, H, W, C, D, Hq, Wq,
      step);
  return (int)cudaGetLastError();
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
// depths as dfm_warp_prev_sweep -> gprev (B, H, W, C) float32, every
// element written; the gradient of dfm_warp_prev_sweep's prev.
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
