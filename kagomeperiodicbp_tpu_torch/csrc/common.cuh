// Scalar helpers shared by the port's kernels: one template body serves
// float, double, complex64 (float2) and complex128 (double2), with complex
// numbers kept in their interleaved storage.
#pragma once

#include <cuda_runtime.h>

// dtype codes passed across the C interface (ops/kernels.py _DTYPE_CODE)
enum KpbpDtype { KPBP_F32 = 0, KPBP_F64 = 1, KPBP_C64 = 2, KPBP_C128 = 3 };

template <typename T> struct Scalar;

__device__ __forceinline__ float kfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double kfma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float krsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double krsqrt(double a) { return rsqrt(a); }
// the value of `v` in lane `src` of the warp (all lanes take part)
__device__ __forceinline__ float kshfl(float v, int src) { return __shfl_sync(0xffffffffu, v, src); }
__device__ __forceinline__ double kshfl(double v, int src) { return __shfl_sync(0xffffffffu, v, src); }

// max(x, tiny): K2's clamp of a pivot or a diagonal divisor
template <typename R>
__device__ __forceinline__ R clamped(R x, R tiny) { return x > tiny ? x : tiny; }

// The most dynamic shared memory one block can ask for on Hopper (227 KB);
// above the 48 KB default a kernel must opt in (kpbp_allow_smem).
constexpr int KPBP_SMEM_MAX = 232448;

// Lets `kernel` take up to KPBP_SMEM_MAX of dynamic shared memory. Called
// before every launch that needs more than 48 KB: it is a host-side
// attribute write, and calling it each time keeps it right on every device.
template <typename K>
static cudaError_t kpbp_allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KPBP_SMEM_MAX);
}

template <typename R> struct RealScalar {
  using real = R;
  static __device__ __forceinline__ R zero() { return R(0); }
  static __device__ __forceinline__ R from_real(R a) { return a; }
  static __device__ __forceinline__ R re(R a) { return a; }
  static __device__ __forceinline__ R scale(R a, R s) { return a * s; }
  static __device__ __forceinline__ R shfl(R a, int src) { return kshfl(a, src); }
  // acc + x·y
  static __device__ __forceinline__ R mul_add(R acc, R x, R y) { return kfma(x, y, acc); }
  // acc − x·y
  static __device__ __forceinline__ R mul_sub(R acc, R x, R y) { return kfma(-x, y, acc); }
  // acc + x·conj(y)
  static __device__ __forceinline__ R mul_add_conj(R acc, R x, R y) { return kfma(x, y, acc); }
  // acc − x·conj(y)
  static __device__ __forceinline__ R mul_sub_conj(R acc, R x, R y) { return kfma(-x, y, acc); }
};

template <typename C, typename R> struct ComplexScalar {
  using real = R;
  static __device__ __forceinline__ C make(R re, R im) { C c; c.x = re; c.y = im; return c; }
  static __device__ __forceinline__ C zero() { return make(R(0), R(0)); }
  static __device__ __forceinline__ C from_real(R a) { return make(a, R(0)); }
  static __device__ __forceinline__ R re(C a) { return a.x; }
  static __device__ __forceinline__ C scale(C a, R s) { return make(a.x * s, a.y * s); }
  static __device__ __forceinline__ C shfl(C a, int src) { return make(kshfl(a.x, src), kshfl(a.y, src)); }
  static __device__ __forceinline__ C mul_add(C acc, C x, C y) {
    return make(kfma(x.x, y.x, kfma(-x.y, y.y, acc.x)), kfma(x.x, y.y, kfma(x.y, y.x, acc.y)));
  }
  static __device__ __forceinline__ C mul_sub(C acc, C x, C y) {
    return make(kfma(-x.x, y.x, kfma(x.y, y.y, acc.x)), kfma(-x.x, y.y, kfma(-x.y, y.x, acc.y)));
  }
  static __device__ __forceinline__ C mul_add_conj(C acc, C x, C y) {
    return make(kfma(x.x, y.x, kfma(x.y, y.y, acc.x)), kfma(x.y, y.x, kfma(-x.x, y.y, acc.y)));
  }
  static __device__ __forceinline__ C mul_sub_conj(C acc, C x, C y) {
    return make(kfma(-x.x, y.x, kfma(-x.y, y.y, acc.x)), kfma(-x.y, y.x, kfma(x.x, y.y, acc.y)));
  }
};

template <> struct Scalar<float> : RealScalar<float> {};
template <> struct Scalar<double> : RealScalar<double> {};
template <> struct Scalar<float2> : ComplexScalar<float2, float> {};
template <> struct Scalar<double2> : ComplexScalar<double2, double> {};

// Runs `launch<T>()` for the scalar type named by `dtype`; returns
// cudaErrorInvalidValue for an unknown code.
#define KPBP_DISPATCH(dtype, launch)                         \
  switch (dtype) {                                           \
    case KPBP_F32: launch(float); break;                     \
    case KPBP_F64: launch(double); break;                    \
    case KPBP_C64: launch(float2); break;                    \
    case KPBP_C128: launch(double2); break;                  \
    default: return (int)cudaErrorInvalidValue;             \
  }
