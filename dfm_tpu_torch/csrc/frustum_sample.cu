// K2 frustum_voxel_features and K3 attention_sample: the samples of the
// frustum -> voxel lifting (DfM FrustumToVoxel).
//
// Voxel (b, z, y, x) of the pseudo-lidar grid projects to
// u[b, x, y], v[b, x, z] (KITTI-form camera: u depends on (x, y), v on
// (x, z)) and to the static depth taps z0[x], z1[x] with weights
// w0[x], w1[x] (border-masked). Table indices:
// x_idx = u / (pad_w - 1) * (W - 1), y_idx = v / (pad_h - 1) * (H - 1);
// taps outside the table weigh zero. valid2d = 0 <= u <= pad_w and
// 0 <= v <= pad_h (inclusive); samples are zero unless
// valid2d & in_range[x]. Both kernels take the per-slab depth table
// xtab (nx,) of (z0, z1, w0, w1), both weights zero where the slab is
// out of the depth range, one device tensor per table content
// (ops/cuda/sampling.py:depth_xtab). Plain versions:
// dfm_tpu_torch/ops/frustum_separable.py:frustum_voxel_features_plain
// and :attention_sample_plain.
//
// K2 replaces dfm_tpu/ops/pallas/frustum_sample.py:_call (and the
// _batched glue) together with the glue of the JAX neck's `_fused` cond
// (dfm_tpu/models/necks/frustum_to_voxel.py:100-131): the sem sample
// (dfm_tpu/ops/frustum_separable.py:separable_sem_sample), the
// attention multiply and the channel concat. Output row of voxel
// (b, z, y, x), C + Cs elements: [0, C) the trilinear sample of the
// stereo volume (B, D, H, W, C); [C, C + Cs) the bilinear sample of the
// sem map (B, Hs, Ws, Cs), summed in float32, rounded to the element
// type, zero unless valid2d, times att[b, z, y, x] rounded to the
// element type, the product rounded (sem_sample, then the neck's
// multiply); Cs > 0. Bound on the H100: bytes. At DfM-KITTI shapes it
// writes a 224 MB bf16 volume (1x20x304x288x64) and reads the rows of
// the 118 MB stereo volume (1x72x80x320x32) its taps touch, the 1.6 MB
// sem map (1x80x320x32) and 7 MB of float32 attention; the sem gather, its
// float32 temporaries, the attention multiply and the 224 MB concat of
// the unfused neck are gone. Design (voxel_features_kernel), K3's
// separable staging: a block owns one (b, z) from blockIdx.z (blocks
// walk z-major, so the stereo rows one z-row of blocks touches stay in
// L2) and an 8 x 32 (x, y) tile, with 32-bit indices. The first threads
// stage, per x of the tile, from v[b, x, z] and the depth table: the
// four (depth plane, row) tap rows of the stereo volume and their
// weights wz * wy, the sem map's two row taps and their weights, and
// whether v is valid, in shared memory. Then each pass takes 32 voxels
// along y (neighbouring y read neighbouring columns of the same rows)
// of one x: warps 0-3 the stereo halves of their rows, 4 lanes a voxel,
// warps 4-7 the sem halves, 4 lanes a voxel, so that every warp runs one
// instruction stream (a warp that holds both halves runs the 8-tap and
// the 4-tap code one after the other, each with half its lanes). Each lane
// computes the voxel's column taps from u[b, x, y] (a coalesced read),
// issues the loads of its 16-byte chunk (8 stereo or 4 sem tap rows)
// before it sums them, and makes one 16-byte store: at C = Cs = 32 bf16
// the stereo quad writes bytes 0-63 and the sem quad bytes 64-127 of the
// voxel's row. Invalid voxels skip their loads and store zeros; so do
// the sem chunks of a voxel whose attention is zero (outside the depth
// range). Products and sums are rounded one by one in the plain
// version's order (csrc/common.cuh:madd) and the index divisions are
// true ones, as the plain version's, so the kernel returns its bits.
// Channel counts that do not fill 16-byte vectors take one element per
// lane. What holds it back: PERF.md.
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

// A K2 block's (x, y) tile: one pass for each x, a pass takes kVoxY
// voxels along y; the sums: csrc/common.cuh:madd.
constexpr int kVoxX = 8;               // x extent: passes of a block
constexpr int kVoxY = 32;              // y extent: voxels of a pass
constexpr int kQuad = 4;               // lanes of one half of a voxel row
static_assert(kVoxX <= kThreads && kVoxX % 2 == 0 &&
                  kVoxY * 2 * kQuad == kThreads,
              "K2 tile");

// grid (ceil(ny / kVoxY), ceil(nx / kVoxX), B * nz), block kThreads.
// The caller keeps every tensor below 2^31 elements and C, Cs (> 0)
// multiples of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
voxel_features_kernel(const T* __restrict__ vol, const T* __restrict__ sem,
                      const float* __restrict__ att,
                      const float* __restrict__ u,
                      const float* __restrict__ v,
                      const float4* __restrict__ xtab, T* __restrict__ out,
                      int D, int H, int W, int C, int Hs, int Ws, int Cs,
                      int nz, int ny, int nx, float pad_h, float pad_w) {
  // per x of the tile:
  __shared__ int srow[4][kVoxX];       // stereo row (dz, dy), pixels
  __shared__ float swt[4][kVoxX];      // its weight wz * wy, 0 if dropped
  __shared__ int mrow[2][kVoxX];       // sem row dy, pixels
  __shared__ float mwt[2][kVoxX];      // its weight, 0 if dropped
  __shared__ bool vok[kVoxX];          // 0 <= v <= pad_h
  const int b = blockIdx.z / nz, z = blockIdx.z - b * nz;
  const int x0 = blockIdx.y * kVoxX, y0 = blockIdx.x * kVoxY;
  const T* volb = vol + (size_t)b * D * H * W * C;
  const T* semb = sem + (size_t)b * Hs * Ws * Cs;

  if (threadIdx.x < kVoxX) {
    const int e = threadIdx.x, x = x0 + e;
    int r[4] = {0, 0, 0, 0}, mr[2] = {0, 0};
    float w[4] = {0.f, 0.f, 0.f, 0.f}, mw[2] = {0.f, 0.f};
    bool ok = false;
    if (x < nx) {
      const float vv = __ldg(v + (b * nx + x) * nz + z);
      ok = vv >= 0.f && vv <= pad_h;
      if (ok) {
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
        axis_taps(vv / (pad_h - 1.f) * (float)(Hs - 1), Hs, yi, wy);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          mr[dy] = yi[dy] * Ws;
          mw[dy] = wy[dy];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      srow[k][e] = r[k];
      swt[k][e] = w[k];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mrow[k][e] = mr[k];
      mwt[k][e] = mw[k];
    }
    vok[e] = ok;
  }
  __syncthreads();

  // warps 0-3 take the stereo halves of a pass's 32 voxels, warps 4-7 the
  // sem halves (a role per warp, so that no warp runs both instruction
  // streams)
  const bool is_sem = threadIdx.x >= kThreads / 2;
  const int t = threadIdx.x % (kThreads / 2);
  const int slot = t / kQuad, q = t % kQuad;
  const int cst = C / VEC, csm = Cs / VEC;
#pragma unroll 1
  for (int e = 0; e < kVoxX; ++e) {
    const int x = x0 + e, y = y0 + slot;
    if (x >= nx || y >= ny) continue;
    const float un = __ldg(u + (b * nx + x) * ny + y);
    const int vox = ((b * nz + z) * ny + y) * nx + x;
    const bool valid = vok[e] && un >= 0.f && un <= pad_w;
    T* dst = out + (size_t)vox * (C + Cs);
    if (!is_sem) {             // the stereo half: 8 taps
      int xi[2];
      float wx[2], wt[8];
      axis_taps(un / (pad_w - 1.f) * (float)(W - 1), W, xi, wx);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        wt[k] = valid ? __fmul_rn(swt[k >> 1][e], wx[k & 1]) : 0.f;
      for (int j = q; j < cst; j += kQuad) {
        raw_t<T, VEC> f[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)     // all loads in flight
          if (wt[k] != 0.f)
            f[k] = load_raw<T, VEC>(volb + (size_t)(srow[k >> 1][e] +
                                                    xi[k & 1]) * C + j * VEC);
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (wt[k] != 0.f)   // a zero weight adds an exact zero
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[i] = madd(raw_elem<T, VEC>(f[k], i), wt[k], acc[i]);
        store_vec<T, VEC>(dst + j * VEC, acc);
      }
    } else {                   // the sem half: 4 taps, times the attention
      const float a = to_f<T>(from_f<T>(__ldg(att + vox)));
      int xi[2];
      float wx[2], wt[4];
      axis_taps(un / (pad_w - 1.f) * (float)(Ws - 1), Ws, xi, wx);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wt[k] = valid && a != 0.f ? __fmul_rn(mwt[k >> 1][e], wx[k & 1])
                                  : 0.f;
      for (int j = q; j < csm; j += kQuad) {
        raw_t<T, VEC> f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (wt[k] != 0.f)
            f[k] = load_raw<T, VEC>(semb + (size_t)(mrow[k >> 1][e] +
                                                    xi[k & 1]) * Cs + j * VEC);
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (wt[k] != 0.f)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc[i] = madd(raw_elem<T, VEC>(f[k], i), wt[k], acc[i]);
#pragma unroll
        for (int i = 0; i < VEC; ++i)   // sem_sample's rounding, then att
          acc[i] = __fmul_rn(to_f<T>(from_f<T>(acc[i])), a);
        store_vec<T, VEC>(dst + C + j * VEC, acc);
      }
    }
  }
}

template <typename T>
int launch_voxel(const void* vol, const void* sem, const float* att,
                 const float* u, const float* v, const float4* xtab,
                 void* out, int B, int D, int H, int W, int C, int Hs,
                 int Ws, int Cs, int nz, int ny, int nx, float pad_h,
                 float pad_w, cudaStream_t s) {
  const dim3 grid((ny + kVoxY - 1) / kVoxY, (nx + kVoxX - 1) / kVoxX,
                  B * nz);
  const T* vt = static_cast<const T*>(vol);
  const T* st = static_cast<const T*>(sem);
  T* o = static_cast<T*>(out);
  if (C % vec16<T>() == 0 && Cs % vec16<T>() == 0)   // 16-byte chunks
    voxel_features_kernel<T, vec16<T>()><<<grid, kThreads, 0, s>>>(
        vt, st, att, u, v, xtab, o, D, H, W, C, Hs, Ws, Cs, nz, ny, nx, pad_h,
        pad_w);
  else
    voxel_features_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        vt, st, att, u, v, xtab, o, D, H, W, C, Hs, Ws, Cs, nz, ny, nx, pad_h,
        pad_w);
  return (int)cudaGetLastError();
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

// vol (B, D, H, W, C); sem (B, Hs, Ws, Cs), Cs > 0; att (B, nz, ny, nx)
// float32; u (B, nx, ny); v (B, nx, nz); xtab (nx,) float4 (z0, z1, w0,
// w1); out (B, nz, ny, nx, C + Cs).
extern "C" int dfm_voxel_features(
    const void* vol, const void* sem, const float* att, const float* u,
    const float* v, const void* xtab, void* out, int B, int D, int H, int W,
    int C, int Hs, int Ws, int Cs, int nz, int ny, int nx, float pad_h,
    float pad_w, int is_bf16, void* stream) {
  if (Cs < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * nz * ny * nx == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* xt = static_cast<const float4*>(xtab);
  if (is_bf16)
    return launch_voxel<__nv_bfloat16>(vol, sem, att, u, v, xt, out, B, D,
                                       H, W, C, Hs, Ws, Cs, nz, ny, nx,
                                       pad_h, pad_w, s);
  return launch_voxel<float>(vol, sem, att, u, v, xt, out, B, D, H, W, C, Hs,
                             Ws, Cs, nz, ny, nx, pad_h, pad_w, s);
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
