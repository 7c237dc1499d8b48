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

#define TSNE_API extern "C" __attribute__((visibility("default")))

namespace tsne {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace tsne
