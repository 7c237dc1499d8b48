// B6 — the refine funnel's candidate scorer: squared distances from each
// chunk row to its Z candidates.
//
// Replaces tsne_flink_tpu/ops/knn_pallas.py::_cand_kernel (launched by
// _run_cand, driven by cand_sqdist_fused for ops/knn._cand_sqdist).
//
// Computes, for row r of the chunk (point i = rows[r]) and candidate z
// (point j = cand[r, z]):
//     out[r, z] = max((sq[i] + sq[j]) − 2·Σ_f base[i, f]·base[j, f], 0)
// — the TPU kernel's norm-trick formula, with the squared norms sq cached
// by the caller.
//
// What bounds it on an H100: bytes.  The work is 2·c·Z·F operations; the
// bytes that must move are the U distinct rows of base the chunk touches
// and their norms (U·(F + 1)·4), the ids (c·4 + c·Z·4) and the scores
// written (c·Z·4): well under one operation a byte, far below the card's
// ~20 (FP32).  The kernel reads c·Z·F·4 bytes of gathered rows; a row
// shared by several candidates comes from L2 after its first fetch, so
// that traffic is not all HBM traffic.
//
// Design: one block of 128 threads per chunk row; the row vector sits in
// shared memory, read by every thread.  The kernel gathers base[cand] by
// index itself: the JAX form gathers the [c, Z, F] candidate operand into
// device memory before its kernel runs, the port never builds it.  That
// also makes the JAX package's dedup-then-gather (_compact_gather, which
// fetches each unique candidate row once) moot here: a row that several
// candidates share is served from L2 after its first fetch.  For small F
// (< 64, the 1.3M x 50 shape) each thread scores whole candidates, lanes
// striding the row's Z slots; for wide F (the 128-dim cascade, the
// 784-dim exact stage) each warp scores one candidate at a time, lanes
// splitting F into coalesced loads and combining by a butterfly shuffle.
// No atomics; every output is written once.
//
// Rounding: the norm combine rounds each sum and product on its own
// (__fadd_rn / __fmul_rn), in the plain version's order
// (sq_i + sq_j) − 2·g; only the dot product g is summed in another order
// than the plain version's, which the card's checks bound at rtol 2e-5.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int WIDE_F = 64;  // from this F on, a warp scores one candidate

__device__ __forceinline__ float combine(float sq_i, float sq_j, float g) {
  return fmaxf(__fsub_rn(__fadd_rn(sq_i, sq_j), __fmul_rn(2.f, g)), 0.f);
}

__global__ void __launch_bounds__(THREADS)
cand_kernel(const float* __restrict__ base, const float* __restrict__ sq,
            const int* __restrict__ rows, const int* __restrict__ cand,
            int z, int f, float* __restrict__ out) {
  extern __shared__ float r_s[];  // [f]: this row's vector
  const int r = blockIdx.x;
  const int i = rows[r];
  const float* __restrict__ bi = base + (size_t)i * f;
  for (int t = threadIdx.x; t < f; t += THREADS) r_s[t] = bi[t];
  __syncthreads();
  const float sq_i = sq[i];
  const int* __restrict__ crow = cand + (size_t)r * z;
  float* __restrict__ orow = out + (size_t)r * z;

  if (f < WIDE_F) {
    for (int s = threadIdx.x; s < z; s += THREADS) {
      const int j = crow[s];
      const float* __restrict__ bj = base + (size_t)j * f;
      float g = 0.f;
#pragma unroll 4
      for (int t = 0; t < f; ++t) g = fmaf(r_s[t], __ldg(bj + t), g);
      orow[s] = combine(sq_i, sq[j], g);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int s = warp; s < z; s += WARPS) {
    const int j = crow[s];
    const float* __restrict__ bj = base + (size_t)j * f;
    float g = 0.f;
    for (int t = lane; t < f; t += 32) g = fmaf(r_s[t], __ldg(bj + t), g);
    g = tsne::warp_sum(g);
    if (lane == 0) orow[s] = combine(sq_i, sq[j], g);
  }
}

}  // namespace

// base [n, f] f32 (contiguous), sq [n] f32, rows [c] i32, cand [c, z] i32
// (every id in [0, n)), out [c, z] f32.  Requires c >= 1, z >= 1 and
// f * 4 bytes of shared memory (f <= 12,288).
TSNE_API int tsne_cand_sqdist_f32(const float* base, const float* sq,
                                  const int* rows, const int* cand, int c,
                                  int z, int f, float* out, void* stream) {
  cand_kernel<<<c, THREADS, sizeof(float) * f, (cudaStream_t)stream>>>(
      base, sq, rows, cand, z, f, out);
  return tsne::launch_status();
}
