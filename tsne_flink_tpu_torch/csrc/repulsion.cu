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
// this is FP32 and SFU work.  A wider m takes the wide form at the end of
// this file (B2w, tsne_repulsion_wide_*).
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

// ---- the wide form (B2w, B2w_f64): any m, meant for m > 8 -----------------
//
// The sweep above keeps R = 4 rows' coordinates and m + 1 sums a thread in
// registers: past m = 8 that passes the register file.  The wide form
// gives a thread one row and splits each pair's work in two:
// - d² over the whole width, a piece of WD dimensions at a time: per
//   sub-tile of WJ columns a thread keeps the WJ running d² in registers
//   while the block stages the rows' and the columns' next piece in shared
//   memory, zero-padded (a padded dimension adds an exact 0 to d²), and
//   adds d = 0 .. m − 1 in order with one FMA each, as the sweep does;
// - the force over C of the m dimensions: a third grid dimension runs
//   ceil(m / C) force chunks, each recomputing q from the full d² — the
//   same operations in the same order in every chunk, so each chunk sees
//   q's bits — and chunk 0 also writes Z.
// So no m is refused, and at m <= C one chunk does all of it.  The
// partials, the column splits, the diagonal and the masks keep the
// sweep's contract (part[S, part_rows, m + 1], no atomics), each sub-tile
// summed before it is added to the row's total.
template <class T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int WJ = 32, WD = 32;  // columns a sub-tile, dims a piece
};
template <>
struct Wide<double> {
  static constexpr int WJ = 16, WD = 16;
};
constexpr int WT = 128;  // rows (threads) a block of the wide form

// the wide form's force chunk: 16 dims, 32 at float32 past m = 16
// (ops/repulsion_cuda.wide_chunk)
template <class T>
__host__ __device__ constexpr int wide_chunk(int m) {
  return std::is_same_v<T, double> || m <= 16 ? 16 : 32;
}

template <class T>
__device__ __forceinline__ void get4(const T* p, T (&v)[4]) {
  if constexpr (std::is_same_v<T, double>) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}

template <class T, int C>
__global__ void __launch_bounds__(WT)
repulsion_wide_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
                      const unsigned char* __restrict__ valid, int nloc,
                      int nfull, int m, int row_offset, int col_span,
                      int part_rows, T* __restrict__ part) {
  constexpr int WJ = Wide<T>::WJ, WD = Wide<T>::WD;
  using N = tsne::Num<T>;
  __shared__ T rs[WD][WT + 1];                  // the rows' piece, transposed
  __shared__ __align__(16) T cs[WJ][WD];        // the columns' piece
  __shared__ __align__(16) T cf[WJ][C];         // the columns' force chunk
  __shared__ T cw[WJ];                          // their weights, 0 past the end

  const int t = threadIdx.x;
  const int row0 = blockIdx.x * WT;
  const int i = row0 + t;
  const int gi = row_offset + i;
  const int f0 = blockIdx.z * C;
  const int c_begin = blockIdx.y * col_span;
  const int c_end = min(nfull, c_begin + col_span);

  T yf[C];
#pragma unroll
  for (int d = 0; d < C; ++d)
    yf[d] = i < nloc && f0 + d < m ? y_loc[(size_t)i * m + f0 + d] : T(0);
  T acc[C + 1];
#pragma unroll
  for (int d = 0; d <= C; ++d) acc[d] = T(0);

  auto stage_rows = [&](int s0, int sd) {
    for (int e = t; e < WT * WD; e += WT) {
      const int r = e / WD, d = e % WD;
      rs[d][r] = row0 + r < nloc && d < sd
                     ? y_loc[(size_t)(row0 + r) * m + s0 + d] : T(0);
    }
  };
  const bool rows_once = m <= WD;  // one piece: the rows stay staged
  if (rows_once) stage_rows(0, m);

  for (int j0 = c_begin; j0 < c_end; j0 += WJ) {
    const int cnt = min(WJ, c_end - j0);
    T d2[WJ];
#pragma unroll
    for (int c = 0; c < WJ; ++c) d2[c] = T(0);
    for (int s0 = 0; s0 < m; s0 += WD) {
      const int sd = min(WD, m - s0);
      __syncthreads();
      if (!rows_once) stage_rows(s0, sd);
      for (int e = t; e < WJ * WD; e += WT) {
        const int c = e / WD, d = e % WD;
        cs[c][d] = c < cnt && d < sd ? y_full[(size_t)(j0 + c) * m + s0 + d]
                                     : T(0);
      }
      if (s0 == 0) {
        for (int e = t; e < WJ * C; e += WT) {
          const int c = e / C, d = e % C;
          cf[c][d] = c < cnt && f0 + d < m
                         ? y_full[(size_t)(j0 + c) * m + f0 + d] : T(0);
        }
        if (t < WJ)
          cw[t] = t >= cnt ? T(0)
                  : valid == nullptr || valid[j0 + t] ? T(1) : T(0);
      }
      __syncthreads();
      for (int d = 0; d < sd; d += 4) {
        T yi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) yi[u] = rs[d + u][t];
#pragma unroll
        for (int c = 0; c < WJ; ++c) {
          T pj[4];
          get4(&cs[c][d], pj);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const T diff = yi[u] - pj[u];
            d2[c] = N::fma(diff, diff, d2[c]);
          }
        }
      }
    }
    T tacc[C + 1];
#pragma unroll
    for (int d = 0; d <= C; ++d) tacc[d] = T(0);
#pragma unroll
    for (int c = 0; c < WJ; ++c) {
      T q = inv(T(1) + d2[c]) * cw[c];
      q = j0 + c == gi ? T(0) : q;
      tacc[C] += q;
      const T q2 = q * q;
#pragma unroll
      for (int d = 0; d < C; d += 4) {
        T pj[4];
        get4(&cf[c][d], pj);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          tacc[d + u] = N::fma(q2, yf[d + u] - pj[u], tacc[d + u]);
      }
    }
#pragma unroll
    for (int d = 0; d <= C; ++d) acc[d] += tacc[d];
  }

  if (i >= nloc) return;
  const bool row_ok = valid == nullptr || valid[gi];
  T* out = part + ((size_t)blockIdx.y * part_rows + i) * (m + 1);
#pragma unroll
  for (int d = 0; d < C; ++d)
    if (f0 + d < m) out[f0 + d] = row_ok ? acc[d] : T(0);
  if (blockIdx.z == 0) out[m] = row_ok ? acc[C] : T(0);
}

template <class T>
int repulsion_wide(const T* y_loc, const T* y_full, const unsigned char* valid,
                   int nloc, int nfull, int m, int row_offset, int splits,
                   int part_rows, T* part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int c = wide_chunk<T>(m);
  const int chunks = m < 1 ? 0 : (m + c - 1) / c;
  if (m < 1 || chunks > 65535 || splits < 1 || splits > 65535 ||
      part_rows < nloc)
    return (int)cudaErrorInvalidValue;
  const int col_span = (nfull + splits - 1) / splits;
  const dim3 grid((nloc + WT - 1) / WT, splits, chunks);
  auto go = [&](auto cc) {
    repulsion_wide_kernel<T, decltype(cc)::value><<<grid, WT, 0, s>>>(
        y_loc, y_full, valid, nloc, nfull, m, row_offset, col_span,
        part_rows, part);
    return tsne::launch_status();
  };
  if constexpr (std::is_same_v<T, double>)
    return go(std::integral_constant<int, 16>{});
  else
    return c == 16 ? go(std::integral_constant<int, 16>{})
                   : go(std::integral_constant<int, 32>{});
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

// The wide form (B2w): the operands and the partials of
// tsne_repulsion_f32, any m >= 1 (the wrapper sends it m > 8); the grid's
// third dimension runs ceil(m / C) force chunks (C = 16, or 32 past m =
// 16).
TSNE_API int tsne_repulsion_wide_f32(const float* y_loc, const float* y_full,
                                     const unsigned char* valid, int nloc,
                                     int nfull, int m, int row_offset,
                                     int splits, int part_rows, float* part,
                                     void* stream) {
  return repulsion_wide<float>(y_loc, y_full, valid, nloc, nfull, m,
                               row_offset, splits, part_rows, part, stream);
}

// The float64 form of tsne_repulsion_wide_f32 (B2w_f64; C = 16).
TSNE_API int tsne_repulsion_wide_f64(const double* y_loc,
                                     const double* y_full,
                                     const unsigned char* valid, int nloc,
                                     int nfull, int m, int row_offset,
                                     int splits, int part_rows, double* part,
                                     void* stream) {
  return repulsion_wide<double>(y_loc, y_full, valid, nloc, nfull, m,
                                row_offset, splits, part_rows, part, stream);
}

// The wide form's geometry at width m and dtype (float64 != 0: B2w_f64):
// *rows the rows a block (one a thread), *chunk the dims of a force chunk
// (ops/repulsion_cuda mirrors both for the memory model on any device;
// the card's checks hold the mirror to this).  Returns M_NARROW.
TSNE_API int tsne_repulsion_wide_config(int m, int float64, int* rows,
                                        int* chunk) {
  *rows = WT;
  *chunk = float64 ? wide_chunk<double>(m) : wide_chunk<float>(m);
  return tsne::M_NARROW;
}
