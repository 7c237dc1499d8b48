// B2 — exact Student-t repulsion, every row against every point.
//
// Replaces tsne_flink_tpu/ops/repulsion_pallas.py::_kernel (launched by
// _run, driven by pallas_exact_repulsion).
//
// Per row i: q_ij = 1 / (1 + |y_i − y_j|²), zeroed at the global i == j
// (row_offset) and at invalid columns; rep_i = Σ_j q_ij² (y_i − y_j) and
// the per-row partial Z_i = Σ_j q_ij.  Invalid rows get zeros.  Without a
// mask the rows may lie past y_full (row_offset >= nfull: query rows
// against a frozen base), and then no tile holds a diagonal.
//
// What bounds it on an H100: the N² pairs, each ~9 FP32 operations (m
// differences, m FMAs for d², 1 add, q², m FMAs of the force, 1 add of Z)
// and one reciprocal.  Counted as 20·N² operations at 67 TFLOP/s that is
// 1.07 ms at N = 60,000; the FP32 pipe at ~9 ops a pair and the MUFU pipe
// at 16 reciprocals a clock per SM (~0.9 ms) both sit near it.  The bytes
// (y once, rep and Z out) are under a megabyte.  m is small (1 to 8, the
// JAX package's MPAD), so a tensor core would waste most of its depth:
// this is FP32 and SFU work.
//
// Design:
// - Register blocking: each thread owns R = 4 rows (strided by the block
//   size, so loads coalesce), holds their coordinates and R·(m+1)
//   accumulators in registers, and reuses every y_j it reads from shared
//   memory (for m <= 3 one float4 broadcast: x, y, z and the column's 0/1
//   weight; for m >= 4 two or three float4s, the weight last) across its
//   R rows: one shared-memory staging per R pairs.
// - One MUFU op a pair: q = rcp.approx.ftz(1 + d²) (1 + d² >= 1, so
//   flushing denormals costs nothing; at most ~1 ulp).
// - Masks out of the inner loop: the sweep is templated on whether
//   col_valid is given (the weight multiplies q only then) and on whether
//   the tile holds the diagonal; only the tiles whose columns meet the
//   block's global rows (row_offset) take the path that zeroes i == j.
// - Filling the card: a second grid dimension splits the columns into S
//   ranges (the wrapper picks S for at least two waves of blocks); each
//   block writes its rows' partial rep and Z to part[S, part_rows, m + 1]
//   (part_rows >= nloc: the wrapper rounds the slab up to a multiple of 4
//   rows, so that the sum over S takes the same order whatever the row
//   count), and the wrapper sums over S in a fixed order.  No float atomics: a run is
//   deterministic.  d² is computed directly as Σ(y_i − y_j)², and each
//   thread sums a tile into a partial before adding it to its running
//   total (two-level summation).
//
// The float64 form (B2_f64, tsne_repulsion_f64) is the same template over
// the scalar type.  A column is staged as 16-byte double2 pieces (the
// coordinates, zeros, the weight last), and q = 1 / (1 + d²) is an IEEE
// reciprocal (__drcp_rn, the plain version's division: the FP64 units have
// no approximate reciprocal at full precision), so every operation runs on
// the FP64 pipe, 34 TFLOP/s on an H100 outside the tensor cores.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int R = 4;                       // rows a thread owns
constexpr int ROWS = THREADS * R;          // rows a block owns
constexpr int TJ = 512;                    // columns a tile stages

// a staged column is V 16-byte pieces of L values each: float4 at float32,
// double2 at float64
template <class T>
struct Piece;
template <>
struct Piece<float> {
  using type = float4;
  static constexpr int L = 4;
  static __device__ __forceinline__ void get(const float4& p, float* out) {
    out[0] = p.x;
    out[1] = p.y;
    out[2] = p.z;
    out[3] = p.w;
  }
  static __device__ __forceinline__ float4 make(const float* c) {
    return make_float4(c[0], c[1], c[2], c[3]);
  }
};
template <>
struct Piece<double> {
  using type = double2;
  static constexpr int L = 2;
  static __device__ __forceinline__ void get(const double2& p, double* out) {
    out[0] = p.x;
    out[1] = p.y;
  }
  static __device__ __forceinline__ double2 make(const double* c) {
    return make_double2(c[0], c[1]);
  }
};

// a staged column: its M coordinates, zeros, and its 0/1 weight last, in
// V pieces (one float4 for m <= 3 at float32, as x, y, z, w)
template <class T, int M>
__host__ __device__ constexpr int vecs_for() {
  return (M + 1 + Piece<T>::L - 1) / Piece<T>::L;
}

__device__ __forceinline__ float inv(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ double inv(double x) { return __drcp_rn(x); }

template <class T, int M, bool VALID, bool DIAG>
__device__ __forceinline__ void sweep(
    const typename Piece<T>::type* __restrict__ ys, int cnt, int j0,
    const T (&yi)[R][M], const int (&gi)[R], T (&tacc)[R][M + 1]) {
  constexpr int V = vecs_for<T, M>(), L = Piece<T>::L;
  using N = tsne::Num<T>;
#pragma unroll 2
  for (int jj = 0; jj < cnt; ++jj) {
    T pj[L * V];
#pragma unroll
    for (int v = 0; v < V; ++v) Piece<T>::get(ys[jj * V + v], pj + L * v);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T diff[M];
      T d2 = T(0);
#pragma unroll
      for (int d = 0; d < M; ++d) {
        diff[d] = yi[r][d] - pj[d];
        d2 = N::fma(diff[d], diff[d], d2);
      }
      T q = inv(T(1) + d2);
      if (VALID) q *= pj[L * V - 1];
      if (DIAG) q = (j0 + jj == gi[r]) ? T(0) : q;
      tacc[r][M] += q;
      const T q2 = q * q;
#pragma unroll
      for (int d = 0; d < M; ++d) tacc[r][d] = N::fma(q2, diff[d], tacc[r][d]);
    }
  }
}

template <class T, int M, bool VALID>
__global__ void __launch_bounds__(THREADS)
repulsion_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
                 const unsigned char* __restrict__ valid, int nloc, int nfull,
                 int row_offset, int col_span, int part_rows,
                 T* __restrict__ part) {
  constexpr int V = vecs_for<T, M>(), L = Piece<T>::L;
  __shared__ typename Piece<T>::type ys[TJ * V];

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int grow0 = row_offset + row0;     // the block's first global row
  const int c_begin = blockIdx.y * col_span;
  const int c_end = min(nfull, c_begin + col_span);

  T yi[R][M];
  int gi[R];
  T acc[R][M + 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * THREADS + t;
    gi[r] = row_offset + i;
#pragma unroll
    for (int d = 0; d < M; ++d) yi[r][d] = i < nloc ? y_loc[(size_t)i * M + d] : T(0);
#pragma unroll
    for (int d = 0; d <= M; ++d) acc[r][d] = T(0);
  }

  for (int j0 = c_begin; j0 < c_end; j0 += TJ) {
    const int cnt = min(TJ, c_end - j0);
    __syncthreads();
    for (int e = t; e < cnt; e += THREADS) {
      const T* src = y_full + (size_t)(j0 + e) * M;
      T c[L * V];
#pragma unroll
      for (int d = 0; d < L * V - 1; ++d) c[d] = d < M ? src[d] : T(0);
      c[L * V - 1] = VALID ? (valid[j0 + e] ? T(1) : T(0)) : T(1);
#pragma unroll
      for (int v = 0; v < V; ++v) ys[e * V + v] = Piece<T>::make(c + L * v);
    }
    __syncthreads();

    T tacc[R][M + 1];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d <= M; ++d) tacc[r][d] = T(0);
    // block-uniform: does this tile hold one of the block's diagonals?
    if (j0 < grow0 + ROWS && grow0 < j0 + cnt)
      sweep<T, M, VALID, true>(ys, cnt, j0, yi, gi, tacc);
    else
      sweep<T, M, VALID, false>(ys, cnt, j0, yi, gi, tacc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d <= M; ++d) acc[r][d] += tacc[r][d];
  }

  T* out = part + (size_t)blockIdx.y * part_rows * (M + 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * THREADS + t;
    if (i >= nloc) continue;
    const bool row_ok = !VALID || valid[gi[r]];
#pragma unroll
    for (int d = 0; d <= M; ++d)
      out[(size_t)i * (M + 1) + d] = row_ok ? acc[r][d] : T(0);
  }
}

template <class T, int M>
int launch(const T* y_loc, const T* y_full, const unsigned char* valid,
           int nloc, int nfull, int row_offset, int splits, int part_rows,
           T* part, cudaStream_t s) {
  const int col_span = (nfull + splits - 1) / splits;
  const dim3 grid((nloc + ROWS - 1) / ROWS, splits);
  if (valid != nullptr)
    repulsion_kernel<T, M, true><<<grid, THREADS, 0, s>>>(
        y_loc, y_full, valid, nloc, nfull, row_offset, col_span, part_rows,
        part);
  else
    repulsion_kernel<T, M, false><<<grid, THREADS, 0, s>>>(
        y_loc, y_full, valid, nloc, nfull, row_offset, col_span, part_rows,
        part);
  return tsne::launch_status();
}

template <class T>
int repulsion(const T* y_loc, const T* y_full, const unsigned char* valid,
              int nloc, int nfull, int m, int row_offset, int splits,
              int part_rows, T* part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (splits < 1 || splits > 65535 || part_rows < nloc)
    return (int)cudaErrorInvalidValue;
  return tsne::with_m(m, [&](auto mc) {
    return launch<T, decltype(mc)::value>(y_loc, y_full, valid, nloc, nfull,
                                          row_offset, splits, part_rows, part,
                                          s);
  });
}

}  // namespace

// y_loc [nloc, m] = rows [row_offset, row_offset + nloc) of y_full
// [nfull, m] (1 <= m <= 8, f32), valid [nfull] uint8 or null (all valid);
// the columns split into `splits` equal ranges, one per grid row; writes
// part [splits, part_rows, m + 1] (part_rows >= nloc; rows past nloc are
// left untouched): per split, each row's partial rep and Z.
TSNE_API int tsne_repulsion_f32(const float* y_loc, const float* y_full,
                                const unsigned char* valid, int nloc,
                                int nfull, int m, int row_offset, int splits,
                                int part_rows, float* part, void* stream) {
  return repulsion<float>(y_loc, y_full, valid, nloc, nfull, m, row_offset,
                          splits, part_rows, part, stream);
}

// The float64 form of tsne_repulsion_f32: y_loc, y_full and part float64.
TSNE_API int tsne_repulsion_f64(const double* y_loc, const double* y_full,
                                const unsigned char* valid, int nloc,
                                int nfull, int m, int row_offset, int splits,
                                int part_rows, double* part, void* stream) {
  return repulsion<double>(y_loc, y_full, valid, nloc, nfull, m, row_offset,
                           splits, part_rows, part, stream);
}
