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
// taps per voxel from the 236 MB bf16 fine softmax volume
// (1x288x320x1280) and writes 7 MB of float32 attention. The taps are
// separable: the depth taps depend on x, the row taps on (x, z), the
// column taps on (x, y). Design (attention_sample_kernel): a block owns
// one (b, z) from blockIdx and a 32 x 32 (x, y) tile, 32-bit indices and
// no division but one per block. One warp first stages, per x of the
// tile, the four (depth, row) rows of the table it reads (element offsets)
// and their weights, from v[b, x, z] and the per-slab depth table, in
// shared memory. Then a warp's lanes run along y for one x at a time:
// the u reads are coalesced, the 32 lanes gather from the same two table
// rows a few columns apart, and each lane fetches the two column taps of
// a row with one 4-byte load where they are adjacent and aligned. The
// results pass through shared memory, transposed, so the float32 output
// is stored coalesced along x. (Lanes along x would read 32 different
// depth planes per load.) Products and sums are rounded one by one in the
// plain version's order (no fused multiply-add), so on the card the
// kernel returns the plain version's bits. The fine volume is still
// materialised by the caller; sampling the coarse cost directly (the JAX
// package's base27 idea, dfm_tpu/ops/frustum.py:108-215) would remove
// those 236 MB and is left to a later change.
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

// K2: decode voxel `vox` (x fastest) and compute its 8 trilinear taps
// into a (B, D, H, W) table.
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

constexpr int kAtt = 32;           // x and y extent of a K3 block's tile

// The two column taps of a table row as floats: one load of both where
// they are adjacent and their pair is aligned, else two.
template <typename T>
__device__ __forceinline__ void column_pair(const T* __restrict__ row,
                                            const int (&xi)[2], float& f0,
                                            float& f1) {
  const T* p = row + xi[0];
  if (xi[1] == xi[0] + 1 &&
      (reinterpret_cast<uintptr_t>(p) & (2 * sizeof(T) - 1)) == 0) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 e =
          __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
      f0 = __low2float(e);
      f1 = __high2float(e);
    } else {
      const float2 e = __ldg(reinterpret_cast<const float2*>(p));
      f0 = e.x;
      f1 = e.y;
    }
    return;
  }
  f0 = to_f<T>(__ldg(p));
  f1 = to_f<T>(__ldg(row + xi[1]));
}

// grid (ceil(ny / 32), ceil(nx / 32), B * nz), block 256. xtab (nx,) of
// (z0, z1, w0, w1): the slab's depth taps, both weights zero where the
// slab is out of the depth range. The caller keeps D * H * W and the
// sizes of u, v and out below 2^31.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_sample_kernel(const T* __restrict__ sm, const float* __restrict__ u,
                        const float* __restrict__ v,
                        const float4* __restrict__ xtab,
                        float* __restrict__ out, int D, int H, int W, int nz,
                        int ny, int nx, float pad_h, float pad_w) {
  __shared__ int rows[4][kAtt];      // per x: table row (dz, dy), elements
  __shared__ float wzy[4][kAtt];     // its weight wz * wy, 0 if dropped
  __shared__ float tile[kAtt][kAtt + 1];   // [x][y], padded
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z / nz, z = blockIdx.z - b * nz;
  const int x0 = blockIdx.y * kAtt, y0 = blockIdx.x * kAtt;
  const T* smb = sm + (size_t)b * D * H * W;

  if (warp == 0) {
    const int x = x0 + lane;
    int r[4] = {0, 0, 0, 0};
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    if (x < nx) {
      const float vv = __ldg(v + (b * nx + x) * nz + z);
      if (vv >= 0.f && vv <= pad_h) {
        const float4 t = __ldg(xtab + x);
        int yi[2];
        float wy[2];
        axis_taps(vv / (pad_h - 1.f) * (float)(H - 1), H, yi, wy);
        const int zi[2] = {(int)t.x, (int)t.y};
        const float wz[2] = {t.z, t.w};
#pragma unroll
        for (int dz = 0; dz < 2; ++dz)
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            r[dz * 2 + dy] = (zi[dz] * H + yi[dy]) * W;
            w[dz * 2 + dy] = __fmul_rn(wz[dz], wy[dy]);
          }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rows[k][lane] = r[k];
      wzy[k][lane] = w[k];
    }
  }
  __syncthreads();

  const int y = y0 + lane;
#pragma unroll
  for (int i = 0; i < kAtt / 8; ++i) {
    const int xl = warp + 8 * i, x = x0 + xl;
    float acc = 0.f;
    if (x < nx && y < ny) {
      const float uu = __ldg(u + (b * nx + x) * ny + y);
      if (uu >= 0.f && uu <= pad_w) {
        int xi[2];
        float wx[2];
        axis_taps(uu / (pad_w - 1.f) * (float)(W - 1), W, xi, wx);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = wzy[k][xl];
          if (wk != 0.f) {   // a zero weight adds an exact zero
            float f0, f1;
            column_pair(smb + rows[k][xl], xi, f0, f1);
            acc = __fadd_rn(acc, __fmul_rn(f0, __fmul_rn(wk, wx[0])));
            acc = __fadd_rn(acc, __fmul_rn(f1, __fmul_rn(wk, wx[1])));
          }
        }
      }
    }
    tile[xl][lane] = acc;
  }
  __syncthreads();

  const int x = x0 + lane;
#pragma unroll
  for (int i = 0; i < kAtt / 8; ++i) {
    const int yl = warp + 8 * i;
    if (x < nx && y0 + yl < ny)
      out[((b * nz + z) * ny + y0 + yl) * nx + x] = tile[lane][yl];
  }
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

// sm (B, D, H, W); xtab (nx,) float4 (z0, z1, w0, w1); out (B, nz, ny,
// nx) float32.
extern "C" int dfm_attention_sample(
    const void* sm, const float* u, const float* v, const void* xtab,
    float* out, int B, int D, int H, int W, int nz, int ny, int nx,
    float pad_h, float pad_w, int is_bf16, void* stream) {
  if ((long long)B * nz * ny * nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((ny + kAtt - 1) / kAtt, (nx + kAtt - 1) / kAtt, B * nz);
  const float4* xt = static_cast<const float4*>(xtab);
  if (is_bf16)
    attention_sample_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(sm), u, v, xt, out, D, H, W, nz,
        ny, nx, pad_h, pad_w);
  else
    attention_sample_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(sm), u, v, xt, out, D, H, W, nz, ny, nx,
        pad_h, pad_w);
  return (int)cudaGetLastError();
}
