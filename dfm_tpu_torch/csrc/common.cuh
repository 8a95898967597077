// Shared helpers of the sampling kernels: element <-> float conversion
// for the two element types the kernels take (float, bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Two floor taps of a fractional index along an axis of length n: the
// clamped tap index and its weight, zero when the tap lies outside
// [0, n-1] (zero padding).
__device__ __forceinline__ void axis_taps(float idx, int n, int i[2],
                                          float w[2]) {
  const float i0 = floorf(idx);
  const float f = idx - i0;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float ii = i0 + d;
    const bool ok = ii >= 0.f && ii <= (float)(n - 1);
    w[d] = ok ? (d ? f : 1.f - f) : 0.f;
    i[d] = (int)fminf(fmaxf(ii, 0.f), (float)(n - 1));
  }
}

// The floor tap of axis_taps unclamped, as an int limited to [-2, n + 1]
// (a NaN gives -2): no index outside [-1, n - 1] has a tap of nonzero
// weight in the map, so the limit changes no tap the caller keeps. The
// backward kernels match taps against the cells of a tile with it.
__device__ __forceinline__ int floor_tap(float idx, int n) {
  return (int)fminf(fmaxf(floorf(idx), -2.f), (float)(n + 1));
}

// VEC consecutive elements <-> floats; one 16-byte access when VEC
// elements fill 16 bytes (8 bf16 or 4 float), else element by element.
// The caller keeps p 16-byte aligned in the vector case.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f<T>(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(f[i]);
  }
}

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int vec16() { return 16 / (int)sizeof(T); }

// The weighted sums of the sampling kernels K1 and K2: each product and
// sum rounded alone (no fused multiply-add), in the plain versions'
// order, so that the kernels return the plain versions' bits.
__device__ __forceinline__ float madd(float f, float w, float acc) {
  return __fadd_rn(acc, __fmul_rn(f, w));
}

// VEC consecutive elements kept as they were loaded (one 16-byte vector
// or one element), so that a kernel can keep many loads in flight in
// few registers and convert each element where it uses it.
template <typename T, int VEC>
using raw_t = typename std::conditional<VEC * sizeof(T) == 16, uint4, T>::type;

template <typename T, int VEC>
__device__ __forceinline__ raw_t<T, VEC> load_raw(const T* __restrict__ p) {
  static_assert(VEC * sizeof(T) == 16 || VEC == 1, "16 bytes or 1 element");
  if constexpr (VEC * sizeof(T) == 16)
    return __ldg(reinterpret_cast<const uint4*>(p));
  else
    return __ldg(p);
}

template <typename T, int VEC>
__device__ __forceinline__ float raw_elem(const raw_t<T, VEC>& r, int i) {
  if constexpr (VEC * sizeof(T) == 16)
    return to_f<T>(reinterpret_cast<const T*>(&r)[i]);
  else
    return to_f<T>(r);
}
