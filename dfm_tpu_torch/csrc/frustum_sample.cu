// K2 frustum_stereo_sample and K3 attention_sample: the two trilinear
// samples of the frustum -> voxel lifting (DfM FrustumToVoxel).
//
// Voxel (b, z, y, x) of the pseudo-lidar grid projects to
// u[b, x, y], v[b, x, z] (KITTI-form camera: u depends on (x, y), v on
// (x, z)) and to the static depth taps z0[x], z1[x] with weights
// w0[x], w1[x] (border-masked). Table indices:
// x_idx = u / (pad_w - 1) * (W - 1), y_idx = v / (pad_h - 1) * (H - 1);
// taps outside the table weigh zero. valid2d = 0 <= u <= pad_w and
// 0 <= v <= pad_h (inclusive); samples are zero unless
// valid2d & in_range[x]. Plain versions:
// dfm_tpu_torch/ops/frustum_separable.py:stereo_sample_plain and
// :attention_sample_plain.
//
// K2 replaces dfm_tpu/ops/pallas/frustum_sample.py:_call (and the
// _batched glue): per slab-group band DMA + hat-matrix matmuls on the
// TPU. Bound on the H100: bytes. At DfM-KITTI shapes it gathers from a
// 118 MB bf16 stereo volume (1x72x80x320x32) and writes a 112 MB voxel
// volume (1x20x304x288x32) plus a 1.75 MB mask. Design: one thread
// per (voxel, 16 bytes of channels): at C=32 bf16 four neighbouring
// threads read each of the 8 tap rows (64 bytes of the NDHWC volume)
// with 16-byte loads and write the voxel's output row with 16-byte
// stores; the per-voxel coordinates and depth taps come from small
// tables (broadcast reads). Channel counts that do not fill 16-byte
// vectors take one element per thread.
//
// K3 replaces dfm_tpu/ops/pallas/frustum_sample.py:_att_call (and the
// attention_sample_pallas glue). Bound on the H100: bytes. It gathers 8
// scalar taps per voxel from the 236 MB bf16 fine softmax volume
// (1x288x320x1280) and writes 7 MB of float32 attention. Design: one
// thread per voxel, f32 accumulation. The fine volume is still
// materialised by the caller; sampling the coarse cost directly (the
// JAX package's base27 idea, dfm_tpu/ops/frustum.py:108-215) would
// remove those 236 MB and is left to a later change.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct VoxelTaps {
  long long off[8];   // element offsets (before the channel stride)
  float wt[8];
  bool valid2d;
  bool keep;
};

// Decode voxel `vox` (x fastest) and compute its 8 trilinear taps into a
// (B, D, H, W) table.
__device__ __forceinline__ VoxelTaps voxel_taps(
    long long vox, const float* __restrict__ u, const float* __restrict__ v,
    const int* __restrict__ z0, const int* __restrict__ z1,
    const float* __restrict__ w0, const float* __restrict__ w1,
    const uint8_t* __restrict__ in_range, int D, int H, int W, int nz,
    int ny, int nx, float pad_h, float pad_w) {
  VoxelTaps t;
  const int x = (int)(vox % nx);
  long long r = vox / nx;
  const int y = (int)(r % ny);
  r /= ny;
  const int z = (int)(r % nz);
  const long long b = r / nz;
  const float uu = u[(b * nx + x) * ny + y];
  const float vv = v[(b * nx + x) * nz + z];
  t.valid2d = uu >= 0.f && uu <= pad_w && vv >= 0.f && vv <= pad_h;
  t.keep = t.valid2d && in_range[x] != 0;
  int yi[2], xi[2];
  float wy[2], wx[2];
  axis_taps(vv / (pad_h - 1.f) * (float)(H - 1), H, yi, wy);
  axis_taps(uu / (pad_w - 1.f) * (float)(W - 1), W, xi, wx);
  const int zi[2] = {z0[x], z1[x]};
  const float wz[2] = {w0[x], w1[x]};
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int k = (dz * 2 + dy) * 2 + dx;
        t.off[k] = ((b * D + zi[dz]) * H + yi[dy]) * (long long)W + xi[dx];
        t.wt[k] = wz[dz] * wy[dy] * wx[dx];
      }
  return t;
}

// One thread per (voxel, VEC consecutive channels).
template <typename T, int VEC>
__global__ void stereo_sample_kernel(
    const T* __restrict__ vol, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ z0,
    const int* __restrict__ z1, const float* __restrict__ w0,
    const float* __restrict__ w1, const uint8_t* __restrict__ in_range,
    T* __restrict__ out, uint8_t* __restrict__ valid2d, int D, int H, int W,
    int C, int nz, int ny, int nx, float pad_h, float pad_w, long long n) {
  const int chunks = C / VEC;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long vox = t / chunks;
  if (vox >= n) return;
  const int c0 = (int)(t - vox * chunks) * VEC;
  const VoxelTaps tp = voxel_taps(vox, u, v, z0, z1, w0, w1, in_range, D, H,
                                  W, nz, ny, nx, pad_h, pad_w);
  if (c0 == 0) valid2d[vox] = tp.valid2d ? 1 : 0;
  float acc[VEC], f[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (tp.keep) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      load_vec<T, VEC>(vol + tp.off[k] * C + c0, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += f[i] * tp.wt[k];
    }
  }
  store_vec<T, VEC>(out + vox * C + c0, acc);
}

template <typename T, int VEC>
int launch_stereo_vec(const void* vol, const float* u, const float* v,
                  const int* z0, const int* z1, const float* w0,
                  const float* w1, const uint8_t* in_range, void* out,
                  uint8_t* valid2d, int D, int H, int W, int C, int nz,
                  int ny, int nx, float pad_h, float pad_w, long long n,
                  cudaStream_t s) {
  const long long threads = n * (C / VEC);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  stereo_sample_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(vol), u, v, z0, z1, w0, w1, in_range,
      static_cast<T*>(out), valid2d, D, H, W, C, nz, ny, nx, pad_h, pad_w,
      n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stereo(const void* vol, const float* u, const float* v,
                  const int* z0, const int* z1, const float* w0,
                  const float* w1, const uint8_t* in_range, void* out,
                  uint8_t* valid2d, int D, int H, int W, int C, int nz,
                  int ny, int nx, float pad_h, float pad_w, long long n,
                  cudaStream_t s) {
  if (C % vec16<T>() == 0)      // 16-byte rows: vector loads and stores
    return launch_stereo_vec<T, vec16<T>()>(
        vol, u, v, z0, z1, w0, w1, in_range, out, valid2d, D, H, W, C, nz,
        ny, nx, pad_h, pad_w, n, s);
  return launch_stereo_vec<T, 1>(vol, u, v, z0, z1, w0, w1, in_range, out,
                                 valid2d, D, H, W, C, nz, ny, nx, pad_h,
                                 pad_w, n, s);
}

template <typename T>
__global__ void attention_sample_kernel(
    const T* __restrict__ sm, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ z0,
    const int* __restrict__ z1, const float* __restrict__ w0,
    const float* __restrict__ w1, const uint8_t* __restrict__ in_range,
    float* __restrict__ out, int D, int H, int W, int nz, int ny, int nx,
    float pad_h, float pad_w, long long n) {
  const long long vox = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (vox >= n) return;
  const VoxelTaps t = voxel_taps(vox, u, v, z0, z1, w0, w1, in_range, D, H,
                                 W, nz, ny, nx, pad_h, pad_w);
  float acc = 0.f;
  if (t.keep) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += to_f<T>(sm[t.off[k]]) * t.wt[k];
  }
  out[vox] = acc;
}

}  // namespace

// vol (B, D, H, W, C); u (B, nx, ny); v (B, nx, nz); z0, z1, w0, w1,
// in_range (nx,); out (B, nz, ny, nx, C); valid2d (B, nz, ny, nx).
extern "C" int dfm_frustum_stereo_sample(
    const void* vol, const float* u, const float* v, const int* z0,
    const int* z1, const float* w0, const float* w1, const uint8_t* in_range,
    void* out, uint8_t* valid2d, int B, int D, int H, int W, int C, int nz,
    int ny, int nx, float pad_h, float pad_w, int is_bf16, void* stream) {
  const long long n = (long long)B * nz * ny * nx;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_stereo<__nv_bfloat16>(vol, u, v, z0, z1, w0, w1, in_range,
                                        out, valid2d, D, H, W, C, nz, ny, nx,
                                        pad_h, pad_w, n, s);
  return launch_stereo<float>(vol, u, v, z0, z1, w0, w1, in_range, out,
                              valid2d, D, H, W, C, nz, ny, nx, pad_h, pad_w,
                              n, s);
}

// sm (B, D, H, W); out (B, nz, ny, nx) float32.
extern "C" int dfm_attention_sample(
    const void* sm, const float* u, const float* v, const int* z0,
    const int* z1, const float* w0, const float* w1, const uint8_t* in_range,
    float* out, int B, int D, int H, int W, int nz, int ny, int nx,
    float pad_h, float pad_w, int is_bf16, void* stream) {
  const long long n = (long long)B * nz * ny * nx;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  if (is_bf16)
    attention_sample_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(sm), u, v, z0, z1, w0, w1,
        in_range, out, D, H, W, nz, ny, nx, pad_h, pad_w, n);
  else
    attention_sample_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(sm), u, v, z0, z1, w0, w1, in_range, out,
        D, H, W, nz, ny, nx, pad_h, pad_w, n);
  return (int)cudaGetLastError();
}
