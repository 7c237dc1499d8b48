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

// the embedding widths the kernels take: the JAX package's MPAD
constexpr int M_MAX = 8;

// Calls f(std::integral_constant<int, M>{}) for m = M in 1 .. M_MAX — the
// one place a source turns the runtime width into its template argument —
// or returns cudaErrorInvalidValue.
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

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace tsne
