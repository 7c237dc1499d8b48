// Shared helpers of the port's hand-written sm_90a kernels.
//
// Every kernel is exposed through a plain C function that launches it on
// the caller's stream (PyTorch's current stream, passed as an opaque
// pointer) and returns cudaGetLastError() as an int, so the Python wrapper
// (loaded with ctypes, no PyTorch headers) can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#define TSNE_API extern "C" __attribute__((visibility("default")))

namespace tsne {

constexpr unsigned kFullMask = 0xffffffffu;

// the embedding widths with a register-blocked instance each (the JAX
// package's MPAD); a wider m takes a kernel's wide form (the *_wide_* C
// entries of csrc/repulsion.cu and csrc/attraction.cu), which takes any m
constexpr int M_NARROW = 8;

// Calls f(std::integral_constant<int, M>{}) for m = M in 1 .. M_NARROW —
// the one place a source turns the runtime width into its template
// argument — or returns cudaErrorInvalidValue.
template <class F>
int with_m(int m, F&& f) {
  switch (m) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  // butterfly: every lane ends with the same sum, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The scalar type's separately rounded operations (nothing contracted into
// an FMA unless asked for), so one template gives a kernel's float32 and
// float64 forms the same operation order.
template <class T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return sqrtf(a); }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
};

template <>
struct Num<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return ::fma(a, b, c); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static __device__ __forceinline__ double min(double a, double b) { return fmin(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
};

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace tsne
