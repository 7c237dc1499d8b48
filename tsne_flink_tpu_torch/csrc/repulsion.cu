// B2 — exact Student-t repulsion, one row against every point.
//
// Replaces tsne_flink_tpu/ops/repulsion_pallas.py::_kernel (launched by
// _run, driven by pallas_exact_repulsion).
//
// Per row i: q_ij = 1 / (1 + |y_i − y_j|²), zeroed at the global i == j
// (row_offset) and at invalid rows/columns; rep_i = Σ_j q_ij² (y_i − y_j)
// and the per-row partial Z_i = Σ_j q_ij.  The global Z is a fixed-order
// torch.sum of the per-row partials outside the kernel: no atomics, so a
// run is deterministic.
//
// What bounds it on an H100: ~20 FP32 operations per pair, N² pairs —
// 7.2e10 at N = 60,000, 1.1 ms at 67 TFLOP/s; the bytes (y once, rep and
// Z out) are under a megabyte.  The embedding dimension m is 2 or 3, so a
// tensor core would waste most of its depth: this is FMA work.
//
// Design: a block owns 64 rows with 4 threads per row; tiles of 512
// points of y_full are staged in shared memory and each of a row's 4
// threads sweeps a contiguous quarter of the tile (all lanes of a warp read
// the same point: a broadcast).  d² is computed directly as Σ(y_i − y_j)²,
// more accurate than the norm trick.  Each thread sums a tile into a
// partial before adding it to its running total (two-level summation), and
// the 4 partial rows are combined in a fixed order through shared memory.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;
constexpr int SPLIT = 4;
constexpr int THREADS = ROWS * SPLIT;
constexpr int TJ = 512;

template <int M>
__global__ void __launch_bounds__(THREADS)
repulsion_kernel(const float* __restrict__ y_loc,
                 const float* __restrict__ y_full,
                 const unsigned char* __restrict__ valid, int nloc, int nfull,
                 int row_offset, float* __restrict__ rep,
                 float* __restrict__ zrow) {
  __shared__ float ys[TJ * M];
  __shared__ unsigned char vs[TJ];
  __shared__ float red[SPLIT][ROWS][M + 1];

  const int t = threadIdx.x;
  const int r = t % ROWS;
  const int part = t / ROWS;
  const int i = blockIdx.x * ROWS + r;
  const bool live = i < nloc;
  const int gi = row_offset + i;

  float yi[M];
#pragma unroll
  for (int d = 0; d < M; ++d) yi[d] = live ? y_loc[(size_t)i * M + d] : 0.f;
  float acc[M];
#pragma unroll
  for (int d = 0; d < M; ++d) acc[d] = 0.f;
  float z = 0.f;

  for (int j0 = 0; j0 < nfull; j0 += TJ) {
    const int cnt = min(TJ, nfull - j0);
    __syncthreads();
    for (int e = t; e < cnt * M; e += THREADS) ys[e] = y_full[(size_t)j0 * M + e];
    if (valid != nullptr)
      for (int e = t; e < cnt; e += THREADS) vs[e] = valid[j0 + e];
    __syncthreads();

    const int per = (cnt + SPLIT - 1) / SPLIT;
    const int jb = part * per;
    const int je = min(cnt, jb + per);
    const int self = gi - j0;  // tile-local column of the diagonal
    float tacc[M];
#pragma unroll
    for (int d = 0; d < M; ++d) tacc[d] = 0.f;
    float tz = 0.f;
    for (int jj = jb; jj < je; ++jj) {
      float diff[M];
      float d2 = 0.f;
#pragma unroll
      for (int d = 0; d < M; ++d) {
        diff[d] = yi[d] - ys[jj * M + d];
        d2 = fmaf(diff[d], diff[d], d2);
      }
      float q = __frcp_rn(1.f + d2);
      if (jj == self || (valid != nullptr && !vs[jj])) q = 0.f;
      tz += q;
      const float q2 = q * q;
#pragma unroll
      for (int d = 0; d < M; ++d) tacc[d] = fmaf(q2, diff[d], tacc[d]);
    }
#pragma unroll
    for (int d = 0; d < M; ++d) acc[d] += tacc[d];
    z += tz;
  }

#pragma unroll
  for (int d = 0; d < M; ++d) red[part][r][d] = acc[d];
  red[part][r][M] = z;
  __syncthreads();
  if (part == 0 && live) {
    const bool row_ok = valid == nullptr || valid[gi];
#pragma unroll
    for (int d = 0; d <= M; ++d) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < SPLIT; ++p) s += red[p][r][d];
      if (!row_ok) s = 0.f;
      if (d < M)
        rep[(size_t)i * M + d] = s;
      else
        zrow[i] = s;
    }
  }
}

}  // namespace

// y_loc [nloc, m] = rows [row_offset, row_offset + nloc) of y_full
// [nfull, m] (m = 2 or 3, f32), valid [nfull] uint8 or null (all valid);
// writes rep [nloc, m] and the per-row partial Z zrow [nloc].
TSNE_API int tsne_repulsion_f32(const float* y_loc, const float* y_full,
                                const unsigned char* valid, int nloc,
                                int nfull, int m, int row_offset, float* rep,
                                float* zrow, void* stream) {
  const int blocks = (nloc + ROWS - 1) / ROWS;
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 2)
    repulsion_kernel<2><<<blocks, THREADS, 0, s>>>(y_loc, y_full, valid, nloc,
                                                   nfull, row_offset, rep, zrow);
  else if (m == 3)
    repulsion_kernel<3><<<blocks, THREADS, 0, s>>>(y_loc, y_full, valid, nloc,
                                                   nfull, row_offset, rep, zrow);
  else
    return (int)cudaErrorInvalidValue;
  return tsne::launch_status();
}
