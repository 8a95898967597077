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
// K2 backward (`dfm_voxel_features_bwd`), the gradients of the stereo
// volume and the sem map for training (none of att: the attention comes
// from a detached cost). It is the exact transpose of K2's sampling:
// grad_vol gets w * g of the stereo half's eight trilinear taps, grad_sem
// w * att * g of the sem half's four bilinear taps (att rounded to the
// element type, a zero att skipped), both float32, nothing outside
// valid2d & in_range; the same taps and weights as the forward, each
// product rounded alone in the forward's order. Bound on the H100:
// bytes, the grad_out read (448 MB in float32 at DfM-KITTI) and the two
// gradient writes (236 MB + 3.3 MB). Design (voxel_features_bwd_kernel):
// a gather, with no atomics. A block of 16 warps owns a tile of one
// gradient map and 32 of its channels (a lane a channel; wider maps take
// one block for each 32 channels, any C and Cs) and writes each of its
// elements once, by plain stores, zeros where no tap lands: a stereo tile
// is 4 rows x 32 columns of one depth plane d (a warp a row and one of 4
// groups of the plane's slabs), a sem tile 1 row x 32 columns of the sem
// map (a warp one of 16 slab groups, x = 16 i + group). The depth taps
// depend on x only, so plane d is read by the few slabs with z0[x] == d
// or z1[x] == d (about 8 of 288 at DfM-KITTI), listed by the block from
// xtab; the sem map by every slab. Each warp then works on its own, with no barrier: for each slab
// of its group it takes the row taps of every z (from v[b, x, z], a lane
// a z) and keeps the z with a tap in its row; it finds the y whose
// column taps land in its columns, 32 at a time (u[b, x, y], a lane a y:
// first a superset by a multiply, then the forward's division for the
// words that may hold one); for each such z and y, in order, it loads
// the voxel's grad_out row (a lane a channel, 4 voxels in flight) and
// adds w * g to its row of accumulators in shared memory, the column
// taps passed by shuffle. Every (voxel, tap) is found by the one warp
// that owns its cell; nothing rests on u or v being monotonic. The sums
// run in a fixed order (slab, 32-y word, z, y; the groups added in group
// order at the end), so two calls return the same bits. What holds it
// back: the horizon's rows gather most of the taps, and the walk is
// latency-bound (PERF.md). Plain
// version: torch.autograd.grad of frustum_voxel_features_plain.
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
#include <limits.h>
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

// ---- K2 backward: tile gathers (see the header).
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;   // a row of the tile and a
                                              // slab group each
constexpr int kBwdCols = 32;               // columns of a gradient tile
constexpr int kBwdChunk = 32;              // channels of a block: a lane each
constexpr int kBwdBatch = 4;               // items a warp loads, then adds
constexpr int kBwdMinBlocks = 2;           // blocks an SM, for the registers
constexpr int kYWords = 10;                // 32-y words a warp tests at once
constexpr int kSemGroups = 16;             // sem tiles: slab groups
constexpr int kSemRows = kBwdWarps / kSemGroups;   // sem tiles: rows
constexpr int kStGroups = 4;               // stereo tiles: slab groups
constexpr int kStRows = kBwdWarps / kStGroups;     // stereo tiles: rows
static_assert(kBwdWarps % kSemGroups == 0 && kBwdWarps % kStGroups == 0,
              "K2-bwd tiles");

// The taps of val (v of a z, u of a y) along a map axis of n, as the
// forward takes them: the floor (floor_tap) and the two weights, zero
// unless 0 <= val <= pad.
__device__ __forceinline__ int slab_taps(float val, float pad, int n,
                                         float (&w)[2]) {
  w[0] = w[1] = 0.f;
  if (!(val >= 0.f && val <= pad)) return -2;
  const float idx = val / (pad - 1.f) * (float)(n - 1);
  int i[2];
  axis_taps(idx, n, i, w);
  return floor_tap(idx, n);
}

// One launch, 1-D grid: first B x ceil(Cs / kBwdChunk) x sem tiles
// (kSemRows x kBwdCols cells of the sem map, kSemGroups slab groups,
// x = kSemGroups i + group), then B x D x ceil(C / kBwdChunk) x stereo
// tiles (kStRows x kBwdCols cells of one depth plane, kStGroups groups of
// the plane's slabs, listed from xtab); a block sums kBwdChunk channels of
// its tile (a lane each). Warp g * rows + row walks its group's slabs for
// its row on its own; shared memory holds the accumulators
// [warp][kBwdCols][kBwdChunk] and the plane's (x, wz) list (2 nx entries)
// with its flags. The caller keeps every tensor below 2^31 elements.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
voxel_features_bwd_kernel(const T* __restrict__ gout,
                          const float* __restrict__ att,
                          const float* __restrict__ u,
                          const float* __restrict__ v,
                          const float4* __restrict__ xtab,
                          float* __restrict__ gvol, float* __restrict__ gsem,
                          int B, int D, int H, int W, int C, int Hs, int Ws,
                          int Cs, int nz, int ny, int nx, float pad_h,
                          float pad_w) {
  extern __shared__ float4 smem4[];
  __shared__ int nlist;
  float* acc = reinterpret_cast<float*>(smem4);
  int* list_x = reinterpret_cast<int*>(acc + kBwdWarps * kBwdCols * kBwdChunk);
  float* list_w = reinterpret_cast<float*>(list_x + 2 * nx);
  unsigned* flags = reinterpret_cast<unsigned*>(list_w + 2 * nx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the block's tile
  const int sem_ct = (Ws + kBwdCols - 1) / kBwdCols;
  const int nsem = (Hs + kSemRows - 1) / kSemRows * sem_ct;
  const int sem_ch = (Cs + kBwdChunk - 1) / kBwdChunk;
  const int st_rt = (H + kStRows - 1) / kStRows;
  const int st_ct = (W + kBwdCols - 1) / kBwdCols;
  const int st_ch = (C + kBwdChunk - 1) / kBwdChunk;
  int t = blockIdx.x, b, d = 0, cc, r0, c0, hm, wm, ct, rows, groups;
  const bool stereo = t >= B * sem_ch * nsem;
  if (!stereo) {
    b = t / (sem_ch * nsem);
    t -= b * sem_ch * nsem;
    cc = t / nsem;
    t -= cc * nsem;
    r0 = t / sem_ct * kSemRows;
    c0 = t % sem_ct * kBwdCols;
    hm = Hs, wm = Ws, ct = Cs, rows = kSemRows, groups = kSemGroups;
  } else {
    t -= B * sem_ch * nsem;
    const int per = st_rt * st_ct;
    b = t / (D * st_ch * per);
    t -= b * D * st_ch * per;
    d = t / (st_ch * per);
    t -= d * st_ch * per;
    cc = t / per;
    t -= cc * per;
    r0 = t / st_ct * kStRows;
    c0 = t % st_ct * kBwdCols;
    hm = H, wm = W, ct = C, rows = kStRows, groups = kStGroups;
  }
  const int nrows = min(rows, hm - r0), ncols = min(kBwdCols, wm - c0);
  for (int e = threadIdx.x; e < kBwdWarps * kBwdCols * kBwdChunk / 4;
       e += kBwdThreads)
    smem4[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the slabs: a stereo plane's (x, wz) entries from xtab in x order (both
  // taps of a slab, tap 0 first), every x for the sem map
  int nslab = nx;
  if (stereo) {                    // every warp loads 32 slabs' taps at once
    for (int xb = warp * 32; xb < nx; xb += kBwdThreads) {
      const int x = xb + lane;
      bool f0 = false, f1 = false;
      if (x < nx) {
        const float4 tb = __ldg(xtab + x);
        f0 = (int)tb.x == d && tb.z != 0.f;
        f1 = (int)tb.y == d && tb.w != 0.f;
      }
      const unsigned m0 = __ballot_sync(0xffffffffu, f0);
      const unsigned m1 = __ballot_sync(0xffffffffu, f1);
      if (lane == 0) {
        flags[2 * (xb >> 5)] = m0;
        flags[2 * (xb >> 5) + 1] = m1;
      }
    }
    __syncthreads();
    if (warp == 0) {               // then warp 0 lists them in order
      int n = 0;
      for (int xb = 0; xb < nx; xb += 32) {
        const unsigned m0 = flags[2 * (xb >> 5)], m1 = flags[2 * (xb >> 5) + 1];
        if ((m0 | m1) == 0u) continue;
        const int x = xb + lane;
        const bool f0 = (m0 >> lane) & 1u, f1 = (m1 >> lane) & 1u;
        const unsigned below = (1u << lane) - 1u;
        const int pos = n + __popc(m0 & below) + __popc(m1 & below);
        if (f0 || f1) {
          const float4 tb = __ldg(xtab + x);
          if (f0) {
            list_x[pos] = x;
            list_w[pos] = tb.z;
          }
          if (f1) {
            list_x[pos + f0] = x;
            list_w[pos + f0] = tb.w;
          }
        }
        n += __popc(m0) + __popc(m1);
      }
      if (lane == 0) nlist = n;
    }
  }
  __syncthreads();
  if (stereo) nslab = nlist;

  // each warp on its own: the slabs k = g, g + groups, ... of its group,
  // for its row r
  const int g = warp / rows, rr = warp - g * rows, r = r0 + rr;
  const int ch = cc * kBwdChunk + lane;       // this lane's channel
  const int choff = stereo ? 0 : C;
  const size_t row_elems = (size_t)(C + Cs);
  float* mine = acc + warp * kBwdCols * kBwdChunk + lane;   // warp's row
  for (int k = g; rr < nrows && k < nslab; k += groups) {
    const int x = stereo ? list_x[k] : k;
    const float wz = stereo ? list_w[k] : 1.f;
    const float* vcol = v + (size_t)(b * nx + x) * nz;
    const float* urow = u + (size_t)(b * nx + x) * ny;
    for (int zb = 0; zb < nz; zb += 32) {
      // lane i: the weight of z = zb + i's row tap in row r (the stereo
      // half's times wz, as the forward's wz * wy), zero if none
      float wzy = 0.f;
      if (zb + lane < nz) {
        float w[2];
        const int fr = slab_taps(__ldg(vcol + zb + lane), pad_h, hm, w);
        const float wy = fr == r ? w[0] : fr + 1 == r ? w[1] : 0.f;
        wzy = stereo ? __fmul_rn(wz, wy) : wy;
      }
      const unsigned zbits = __ballot_sync(0xffffffffu, wzy != 0.f);
      if (zbits == 0u) continue;
      for (int yb = 0; yb < ny; yb += 32 * kYWords) {
        // first a superset of the y masks, 32 y a word: the column taps
        // by a multiply (within one column of the forward's division),
        // widened by a column; all loads in flight
        const float scale = 1.f / (pad_w - 1.f) * (float)(wm - 1);
        unsigned words = 0u;
#pragma unroll
        for (int c = 0; c < kYWords; ++c) {
          const int y = yb + c * 32 + lane;
          const float un = y < ny ? __ldg(urow + y) : -1.f;
          const int jc = un >= 0.f && un <= pad_w
                             ? (int)floorf(un * scale) - c0 : INT_MIN;
          words |= (__ballot_sync(0xffffffffu, jc >= -2 && jc <= ncols)
                        != 0u ? 1u : 0u) << c;
        }
        while (words) {              // then the exact taps of those words
          const int c = __ffs(words) - 1;
          words &= words - 1u;
          const int y = yb + c * 32 + lane;
          float wx[2];
          const int jl = slab_taps(y < ny ? __ldg(urow + y) : -1.f, pad_w,
                                   wm, wx) - c0;
          const unsigned ym = __ballot_sync(
              0xffffffffu, (jl >= 0 && jl < ncols && wx[0] != 0.f) ||
                               (jl >= -1 && jl + 1 < ncols && wx[1] != 0.f));
          if (ym == 0u) continue;
          const int y0 = yb + c * 32;
          unsigned zs = zbits;
          while (zs) {                 // the walked z, in order
            const int zl = __ffs(zs) - 1;
            zs &= zs - 1u;
            const float wzz = __shfl_sync(0xffffffffu, wzy, zl);
            const size_t zrow0 = (size_t)(b * nz + zb + zl) * ny + y0;
            unsigned m = ym;
            while (m) {                // the masked y, kBwdBatch at a time
              unsigned taken = 0u;
#pragma unroll
              for (int q = 0; q < kBwdBatch; ++q) {
                const unsigned low = m & (0u - m);
                taken |= low;
                m ^= low;
              }
              float gv[kBwdBatch], a[kBwdBatch];
              unsigned tk = taken;
#pragma unroll
              for (int q = 0; q < kBwdBatch; ++q) {   // all loads in flight
                const bool ok = tk != 0u;
                const size_t vox = (zrow0 + __ffs(tk) - 1) * nx + x;
                tk &= tk - 1u;
                a[q] = 1.f;              // the forward's att, in T
                if (!stereo && ok)
                  a[q] = to_f<T>(from_f<T>(__ldg(att + vox)));
                gv[q] = ok && ch < ct
                            ? to_f<T>(gout[vox * row_elems + choff + ch])
                            : 0.f;
              }
              tk = taken;
#pragma unroll
              for (int q = 0; q < kBwdBatch; ++q) {
                if (tk == 0u) break;
                const int yl = __ffs(tk) - 1;
                tk &= tk - 1u;
                const int j = __shfl_sync(0xffffffffu, jl, yl);
                const float w0 = __shfl_sync(0xffffffffu, wx[0], yl);
                const float w1 = __shfl_sync(0xffffffffu, wx[1], yl);
                if (ch >= ct || a[q] == 0.f) continue;
                const float gq = stereo ? gv[q] : __fmul_rn(a[q], gv[q]);
                if (j >= 0 && j < ncols) {
                  const float wt = __fmul_rn(wzz, w0);
                  if (wt != 0.f)
                    mine[j * kBwdChunk] =
                        __fadd_rn(mine[j * kBwdChunk], __fmul_rn(wt, gq));
                }
                if (j >= -1 && j + 1 < ncols) {
                  const float wt = __fmul_rn(wzz, w1);
                  if (wt != 0.f)
                    mine[(j + 1) * kBwdChunk] = __fadd_rn(
                        mine[(j + 1) * kBwdChunk], __fmul_rn(wt, gq));
                }
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // every element of the tile's channels once, by plain stores: the
  // groups' sums added in group order (zeros where no tap landed)
  float* out = stereo ? gvol : gsem;
  const size_t base =
      (stereo ? (((size_t)(b * D + d) * H + r0) * W + c0) * C
              : (((size_t)b * Hs + r0) * Ws + c0) * Cs) + cc * kBwdChunk;
  const int cw = min(kBwdChunk, ct - cc * kBwdChunk);
  if (ct % 4 == 0) {               // 16 bytes at a time
    const int cw4 = cw / 4, per4 = ncols * cw4;
    for (int e = threadIdx.x; e < nrows * per4; e += kBwdThreads) {
      const int rw = e / per4, rest = e - rw * per4;
      const int col = rest / cw4, k4 = rest - col * cw4;
      const int at = col * kBwdChunk / 4 + k4;
      float4 sum = smem4[rw * kBwdCols * kBwdChunk / 4 + at];
      for (int gg = 1; gg < groups; ++gg) {
        const float4 a = smem4[(gg * rows + rw) * kBwdCols * kBwdChunk / 4 + at];
        sum = make_float4(__fadd_rn(sum.x, a.x), __fadd_rn(sum.y, a.y),
                          __fadd_rn(sum.z, a.z), __fadd_rn(sum.w, a.w));
      }
      *reinterpret_cast<float4*>(out + base + ((size_t)rw * wm + col) * ct +
                                 4 * k4) = sum;
    }
    return;
  }
  const int per_row = ncols * cw;
  for (int e = threadIdx.x; e < nrows * per_row; e += kBwdThreads) {
    const int rw = e / per_row, rest = e - rw * per_row;
    const int col = rest / cw, k = rest - col * cw;
    const int at = col * kBwdChunk + k;
    float sum = acc[rw * kBwdCols * kBwdChunk + at];
    for (int gg = 1; gg < groups; ++gg)
      sum = __fadd_rn(sum, acc[(gg * rows + rw) * kBwdCols * kBwdChunk + at]);
    out[base + ((size_t)rw * wm + col) * ct + k] = sum;
  }
}

template <typename T>
int launch_voxel_bwd(const void* gout, const float* att, const float* u,
                     const float* v, const float4* xtab, float* gvol,
                     float* gsem, int B, int D, int H, int W, int C, int Hs,
                     int Ws, int Cs, int nz, int ny, int nx, float pad_h,
                     float pad_w, cudaStream_t s) {
  const size_t smem = (size_t)kBwdWarps * kBwdCols * kBwdChunk * 4 +
                      (size_t)nx * 16 + (size_t)(nx + 31) / 32 * 8;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        voxel_features_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long sem = (long long)(Hs + kSemRows - 1) / kSemRows *
                        ((Ws + kBwdCols - 1) / kBwdCols) *
                        ((Cs + kBwdChunk - 1) / kBwdChunk);
  const long long st = (long long)D * ((H + kStRows - 1) / kStRows) *
                       ((W + kBwdCols - 1) / kBwdCols) *
                       ((C + kBwdChunk - 1) / kBwdChunk);
  const long long blocks = B * (sem + st);
  if (blocks == 0) return 0;
  if (blocks >= INT_MAX) return (int)cudaErrorInvalidValue;
  voxel_features_bwd_kernel<T><<<(unsigned)blocks, kBwdThreads, smem, s>>>(
      static_cast<const T*>(gout), att, u, v, xtab, gvol, gsem, B, D, H, W,
      C, Hs, Ws, Cs, nz, ny, nx, pad_h, pad_w);
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

// grad_out (B, nz, ny, nx, C + Cs) of type bf16 / float (is_bf16); att,
// u, v, xtab as dfm_voxel_features -> gvol (B, D, H, W, C) and gsem
// (B, Hs, Ws, Cs) float32, every element written; the gradients of
// dfm_voxel_features' vol and sem. Cs > 0.
extern "C" int dfm_voxel_features_bwd(
    const void* gout, const float* att, const float* u, const float* v,
    const void* xtab, float* gvol, float* gsem, int B, int D, int H, int W,
    int C, int Hs, int Ws, int Cs, int nz, int ny, int nx, float pad_h,
    float pad_w, int is_bf16, void* stream) {
  if (Cs < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);   // an empty grid
  const float4* xt = static_cast<const float4*>(xtab);  // still writes 0s
  if (is_bf16)
    return launch_voxel_bwd<__nv_bfloat16>(gout, att, u, v, xt, gvol, gsem, B,
                                           D, H, W, C, Hs, Ws, Cs, nz, ny, nx,
                                           pad_h, pad_w, s);
  return launch_voxel_bwd<float>(gout, att, u, v, xt, gvol, gsem, B, D, H, W,
                                 C, Hs, Ws, Cs, nz, ny, nx, pad_h, pad_w, s);
}
