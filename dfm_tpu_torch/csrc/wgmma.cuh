// Hopper building blocks of the wgmma + TMA convolutions (K4 conv_p2p.cuh,
// K5 hourglass_chain.cu, K9b conv_dense.cuh): mbarriers, TMA copies,
// no-swizzle K-major shared-memory descriptors, wgmma.mma_async for
// m64nNk16 with bf16 operands and f32 accumulators, the quad transpose
// of the register epilogues, and the driver's tensor-map encoder.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 4D box of the tensor map -> shared memory, completion on `bar`.
// Coordinates may be negative or past the tensor: TMA writes zeros there
// and still counts the whole box's bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Contiguous bytes -> shared memory, completion on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// No-swizzle K-major shared-memory matrix descriptor: start address, LBO
// (next 8 k), SBO (next 8 rows), all in 16-byte units; layout type 0.
__host__ __device__ constexpr uint64_t desc_hi(uint32_t lbo, uint32_t sbo) {
  return (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}

// 64-byte-swizzle K-major descriptor (layout type 2): rows of 64 bytes
// (32 bf16 of k), 8 rows 512 bytes apart (SBO), the 16-byte chunks of a
// row XORed with bits 7-8 of their shared-memory address, as TMA's
// SWIZZLE_64B writes them. The XOR is taken on the absolute address, so
// the start may be any row (`python -m dfm_tpu_torch.probe_k5` checks
// that on the card) and a k16 step adds 32 bytes; LBO is unused.
__host__ __device__ constexpr uint64_t desc_hi_sw64() {
  return (uint64_t)1 << 16 | (uint64_t)(512 >> 4) << 32 | (uint64_t)2 << 62;
}

// d (+)= A (64 x 16, desc a) * B (16 x N, desc b); scale_d 0 overwrites.
// Accumulator i of a thread: row 16 (warp % 4) + lane / 4 + 8 ((i >> 1)
// & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, uint32_t scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t a,
                                         uint64_t b, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a,
                                          uint64_t b, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a,
                                          uint64_t b, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                          uint64_t b, uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving accumulator reads across the wgmma wait.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most `PENDING` committed groups are still running.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Lane q of a quad holds in p[k] the bf16 pair q of 16-byte chunk k (for
// K4: p[j] = channels (8j + 2q, +1) of a voxel); after the transpose it
// holds chunk q whole, pair k in p[k] (for K4: octet q of the voxel).
// Stage 1 swaps the off-diagonal 2x2 blocks (lanes q ^ 2), stage 2 the
// off-diagonal elements of each block (lanes q ^ 1).
__device__ __forceinline__ void quad_transpose(uint32_t (&p)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
  if (hi) {
    p[0] = r0;
    p[1] = r1;
  } else {
    p[2] = r0;
    p[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[1], 1);
  r1 = __shfl_xor_sync(0xffffffffu, odd ? p[2] : p[3], 1);
  if (odd) {
    p[0] = r0;
    p[2] = r1;
  } else {
    p[1] = r0;
    p[3] = r1;
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// libraries link no libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (D, H, W, C) bf16 tensor, channels innermost, C % 8 == 0, as a 4D
// tensor map with dims (C, W, H, D), box (bc, bw, bh, 1) and element
// stride `xstride` along W (the box then holds ceil(bw / xstride)
// columns), written to shared memory with `swizzle`; zeros outside the
// tensor.
inline bool volume_tensor_map(
    CUtensorMap* map, const void* base, int D, int H, int W, int C, int bc,
    int bw, int bh, int xstride,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)D};
  const cuuint64_t voxel = (cuuint64_t)C * 2;
  const cuuint64_t strides[3] = {voxel, voxel * W, voxel * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t elem[4] = {1, (cuuint32_t)xstride, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
