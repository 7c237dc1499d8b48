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

// ---- the wide form at float32 (B2w): tiles, d² once a pair ---------------
//
// What bounds it: the FP32 pipe.  A pair costs m subtractions and m FMAs
// for d², one reciprocal (MUFU) and m FMAs of the force: (5m + 3) FP32
// operations and a reciprocal, 4.89 ms at 60k x 16 and 17.8 at 60k x 64
// at 67 TFLOP/s (ops/repulsion_cuda).  The bytes (y once, the partials)
// are a few megabytes.
// Design, m <= 16 (the class of 16): rows in registers.  A thread owns
// RR = 2 rows (strided by the block) and their coordinates; each staged
// column (16 values as four float4 broadcasts, zeros past m; a ring of two
// tiles of RJ columns that cp.async fills while the tile before computes)
// feeds both rows: a pair's 16 differences are formed once and give its
// d² (one FMA each) and, once q = rcp.approx(1 + d²)·weight is known, its
// force (one FMA each): 3m + 8 operations a pair, d² once.  A tile's sums
// run in float and are then added to the rows' totals, doubles in shared
// memory.
// Design, m > 16: tiles.
// - A block owns TR = 4096 / MP rows and walks its column split in tiles of
//   TC = MP columns, MP the width class (32 or 64; 64 past it), so a
//   tile is 4,096 pairs for every class.
// - d² once a pair: a thread takes 4 rows x 4 columns of the tile and, for
//   d = 0 .. m − 1 in order, reads the 4 rows' and the 4 columns' value as
//   two float4s from shared memory (the rows staged once, dims-major; the
//   columns' tiles in a ring of two that cp.async fills while the tile
//   before computes), adding 16 squared differences with one FMA each.
//   Then q = rcp.approx(1 + d²)·weight (0 on the diagonal), Z's part, and
//   q², which stays in shared memory for the force.
// - The force from the tile's q²: a thread takes 4 rows x 4 dims and walks
//   the tile's columns in order, reading 4 columns' q² and each column's
//   4 dims as float4s (the ring holds each tile a second time, columns-
//   major, for these reads): F_id += q²_ij·(y_id − y_jd), the difference
//   formed from the coordinates.  The tensor cores are not used: Σ_j q²_ij·y_j as a product
//   (y_i·Σq² − Σq²·y_j) cancels for rows far from the origin, as d² by the
//   norm trick does, and the plain version's differences do not.
// - A tile's sums are taken from 0 in float and then added to the row's
//   totals, held in double (a float sum over thousands of tiles would
//   drift past the plain version's pairwise sums); Z's parts from the
//   tile's column groups meet in a fixed order at the end.  Past m = 64 the tiles walk the width in blocks of 64 dims: d²
//   over every block, then the force block by block, added to the
//   partials slab rows the block owns (read, add, write: no other block
//   writes those rows of its split).
// A row's sums take the same operations in the same order whatever block,
// split position or shard holds it, and the column splits and the slab
// keep B2's contract (no atomics: two launches give the same bits).
constexpr int TW = 256;        // threads a block of the float32 wide form
constexpr int TPAIRS = 4096;   // pairs a tile

constexpr int RT = 128;  // threads a block of the m <= 16 path
constexpr int RR = 2;    // rows a thread there
constexpr int RJ = 128;  // columns a tile there

// the float32 wide form's width class (ops/repulsion_cuda.wide_class)
__host__ __device__ constexpr int wide_class(int m) {
  return m <= 16 ? 16 : m <= 32 ? 32 : 64;
}

// a class's tile and its dynamic shared memory, in floats: the rows'
// dims [MP][RS], the columns' ring of two slots, each the tile's columns
// dims-major [MP][CS] (d²'s reads: 4 columns of a dim) and columns-major
// [TC][CT] (the force's: 4 dims of a column), q² [TC][RS] (Z's parts at
// the end) and the columns' weights [2][TC]; the strides padded by a
// float4 so that a warp's float4 reads spread over the banks
template <int MP>
struct TileGeom {
  static constexpr int TR = TPAIRS / MP, TC = MP;
  static constexpr int RS = TR + 4, CS = TC + 4, CT = MP + 4;
  static constexpr int SLOT = MP * CS + TC * CT;
  static constexpr int ROWS = 0, COLS = MP * RS, Q2 = COLS + 2 * SLOT,
                       WGT = Q2 + TC * RS, FLOATS = WGT + 2 * TC;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void unpack(const float4 v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

template <int MP>
__global__ void __launch_bounds__(TW, 2)
repulsion_tile_kernel(const float* __restrict__ y_loc,
                      const float* __restrict__ y_full,
                      const unsigned char* __restrict__ valid, int nloc,
                      int nfull, int m, int row_offset, int col_span,
                      int part_rows, float* __restrict__ part) {
  using G = TileGeom<MP>;
  constexpr int TR = G::TR, TC = G::TC, RS = G::RS, CS = G::CS, CT = G::CT;
  extern __shared__ __align__(16) float sm[];
  float* rs = sm + G::ROWS;
  float* cs = sm + G::COLS;
  float* q2s = sm + G::Q2;
  float* cw = sm + G::WGT;
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * TR;
  const int c_begin = blockIdx.y * col_span;
  const int c_end = min(nfull, c_begin + col_span);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + TC - 1) / TC : 0;
  const bool blocked = m > MP;  // MP = 64 alone is launched past its width
  const int dcg = t % (TC / 4), drg = t / (TC / 4);  // d²: 4 rows x 4 cols
  const int fdg = t % (MP / 4), frg = t / (MP / 4);  // force: 4 rows x 4 dims
  float* out = part + (size_t)blockIdx.y * part_rows * (m + 1);

  // dims [d0, d0 + MP) of the block's rows, zeros past m or nloc
  auto stage_rows = [&](int d0) {
    for (int e = t; e < TR * MP; e += TW) {
      const int d = e % MP, r = e / MP;
      rs[d * RS + r] = row0 + r < nloc && d0 + d < m
                           ? y_loc[(size_t)(row0 + r) * m + d0 + d] : 0.f;
    }
  };
  // columns [j0, j0 + TC) dims [d0, d0 + MP) into ring slot b, both
  // layouts (cp.async, zero-filled past the split or m), and their weights
  auto stage_cols = [&](int j0, int d0, int b) {
    float* dst = cs + b * G::SLOT;
    for (int e = t; e < TC * MP; e += TW) {
      const int d = e % MP, c = e / MP;
      const bool ok = j0 + c < c_end && d0 + d < m;
      const float* src = ok ? y_full + (size_t)(j0 + c) * m + d0 + d : y_full;
      cp_async4(dst + d * CS + c, src, ok);
      cp_async4(dst + MP * CS + c * CT + d, src, ok);
    }
    if (t < TC) {
      const int j = j0 + t;
      cw[b * TC + t] =
          j >= c_end ? 0.f : valid == nullptr || valid[j] ? 1.f : 0.f;
    }
  };
  // d² of the thread's 16 pairs over dims [0, dm) of the staged block
  auto add_d2 = [&](const float* csb, int dm, float (&d2)[4][4]) {
#pragma unroll 4
    for (int d = 0; d < dm; ++d) {
      float rv[4], cv[4];
      unpack(*reinterpret_cast<const float4*>(rs + d * RS + drg * 4), rv);
      unpack(*reinterpret_cast<const float4*>(csb + d * CS + dcg * 4), cv);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float diff = rv[a] - cv[c];
          d2[a][c] = fmaf(diff, diff, d2[a][c]);
        }
    }
  };
  // the thread's 4 rows x 4 dims of the staged block (force mapping)
  auto load_yi = [&](float (&yi)[4][4]) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v[4];
      unpack(*reinterpret_cast<const float4*>(rs + (fdg * 4 + u) * RS +
                                              frg * 4), v);
#pragma unroll
      for (int a = 0; a < 4; ++a) yi[a][u] = v[a];
    }
  };
  // the force of the thread's 4 rows x 4 dims over the tile's columns
  auto tile_force = [&](const float* csb, const float (&yi)[4][4],
                        float (&ft)[4][4]) {
    const float* ctb = csb + MP * CS;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u) ft[a][u] = 0.f;
#pragma unroll 2
    for (int c = 0; c < TC; c += 4) {
      float q[4][4], y[4][4];  // q[column][row], y[column][dim]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        unpack(*reinterpret_cast<const float4*>(q2s + (c + e) * RS + frg * 4),
               q[e]);
        unpack(*reinterpret_cast<const float4*>(ctb + (c + e) * CT + fdg * 4),
               y[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            ft[a][u] = fmaf(q[e][a], yi[a][u] - y[e][u], ft[a][u]);
    }
  };

  double acc[4][4], zacc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    zacc[a] = 0.0;
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[a][u] = 0.0;
  }
  float yi[4][4];  // the force's rows, held across the tiles (m <= MP)
  if (!blocked) {
    stage_rows(0);
    if (ntiles > 0) stage_cols(c_begin, 0, 0);
    cp_async_commit();
    __syncthreads();
    load_yi(yi);
  }
  for (int k = 0; k < ntiles; ++k) {
    const int j0 = c_begin + k * TC;
    const int b = blocked ? 0 : k & 1;
    const float* csb = cs + b * G::SLOT;
    float d2[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) d2[a][c] = 0.f;
    if (!blocked) {
      if (k + 1 < ntiles) {  // the next tile fills behind this one
        stage_cols(j0 + TC, 0, b ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      add_d2(csb, m, d2);
    } else {
      for (int d0 = 0; d0 < m; d0 += MP) {
        __syncthreads();  // the block before is read
        stage_rows(d0);
        stage_cols(j0, d0, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        add_d2(csb, min(MP, m - d0), d2);
      }
    }
    // q, Z's part and q² of the thread's 16 pairs
    float zt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jc = dcg * 4 + c;
      const float w = cw[b * TC + jc];
      float q2[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float q = inv(1.f + d2[a][c]) * w;
        q = j0 + jc == row_offset + row0 + drg * 4 + a ? 0.f : q;
        zt[a] += q;
        q2[a] = q * q;
      }
      *reinterpret_cast<float4*>(q2s + jc * RS + drg * 4) =
          make_float4(q2[0], q2[1], q2[2], q2[3]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) zacc[a] += (double)zt[a];
    __syncthreads();
    float ft[4][4];
    if (!blocked) {
      tile_force(csb, yi, ft);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[a][u] += (double)ft[a][u];
    } else {
      for (int d0 = 0; d0 < m; d0 += MP) {
        if (d0) __syncthreads();  // the block before is read
        stage_rows(d0);
        stage_cols(j0, d0, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        load_yi(yi);
        tile_force(csb, yi, ft);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = row0 + frg * 4 + a;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = d0 + fdg * 4 + u;
            if (i < nloc && d < m) {
              float* o = out + (size_t)i * (m + 1) + d;
              *o = (k == 0 ? 0.f : *o) + ft[a][u];
            }
          }
        }
      }
    }
    __syncthreads();  // q² and the ring slot are rewritten
  }
  cp_async_wait<0>();

  // Z: the column groups' parts of each row, in order
  double* zs = reinterpret_cast<double*>(q2s);  // [TC / 4][TR]
#pragma unroll
  for (int a = 0; a < 4; ++a) zs[dcg * TR + drg * 4 + a] = zacc[a];
  __syncthreads();
  if (t < TR && row0 + t < nloc) {
    const int i = row0 + t;
    double z = 0.0;
    for (int g = 0; g < TC / 4; ++g) z += zs[g * TR + t];
    const bool row_ok = valid == nullptr || valid[row_offset + i];
    out[(size_t)i * (m + 1) + m] = row_ok ? (float)z : 0.f;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = row0 + frg * 4 + a;
    if (i >= nloc) continue;
    const bool row_ok = valid == nullptr || valid[row_offset + i];
    for (int d0 = 0; d0 < (blocked ? m : 1); d0 += MP) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = d0 + fdg * 4 + u;
        if (d >= m) continue;
        float* o = out + (size_t)i * (m + 1) + d;
        if (!blocked)
          *o = row_ok ? (float)acc[a][u] : 0.f;
        else if (!row_ok || ntiles == 0)
          *o = 0.f;
      }
    }
  }
}

// the m <= 16 path's dynamic shared memory: the columns' ring [2][RJ][16]
// and weights [2][RJ] in floats, then the rows' totals [RR][17][RT]
constexpr size_t ROWS_COLS = 2 * RJ * 16 + 2 * RJ;
constexpr size_t ROWS_BYTES = 4 * ROWS_COLS + 8 * (size_t)RR * 17 * RT;

__global__ void __launch_bounds__(RT, 4)
repulsion_rows_kernel(const float* __restrict__ y_loc,
                      const float* __restrict__ y_full,
                      const unsigned char* __restrict__ valid, int nloc,
                      int nfull, int m, int row_offset, int col_span,
                      int part_rows, float* __restrict__ part) {
  extern __shared__ __align__(16) float smr[];
  float* cs = smr;                       // [2][RJ][16]
  float* cw = smr + 2 * RJ * 16;         // [2][RJ]
  double* tot = reinterpret_cast<double*>(smr + ROWS_COLS);  // [RR][17][RT]
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * RT * RR;
  const int c_begin = blockIdx.y * col_span;
  const int c_end = min(nfull, c_begin + col_span);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + RJ - 1) / RJ : 0;

  float yi[RR][16];
  int gi[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int i = row0 + r * RT + t;
    gi[r] = row_offset + i;
#pragma unroll
    for (int d = 0; d < 16; ++d)
      yi[r][d] = i < nloc && d < m ? y_loc[(size_t)i * m + d] : 0.f;
#pragma unroll
    for (int d = 0; d <= 16; ++d) tot[(r * 17 + d) * RT + t] = 0.0;
  }
  // columns [j0, j0 + RJ) into ring slot b (zeros past the split or m)
  auto stage = [&](int j0, int b) {
    float* dst = cs + b * RJ * 16;
    for (int e = t; e < RJ * 16; e += RT) {
      const int d = e % 16, c = e / 16;
      const bool ok = j0 + c < c_end && d < m;
      cp_async4(dst + e, ok ? y_full + (size_t)(j0 + c) * m + d : y_full,
                ok);
    }
    const int j = j0 + t;  // RT == RJ: a weight a thread
    cw[b * RJ + t] =
        j >= c_end ? 0.f : valid == nullptr || valid[j] ? 1.f : 0.f;
  };
  if (ntiles > 0) stage(c_begin, 0);
  cp_async_commit();
  for (int k = 0; k < ntiles; ++k) {
    const int j0 = c_begin + k * RJ;
    const int b = k & 1;
    if (k + 1 < ntiles) {  // the next tile fills behind this one
      stage(j0 + RJ, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* col = reinterpret_cast<const float4*>(cs + b * RJ * 16);
    const float* wb = cw + b * RJ;
    float acc[RR][17];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int d = 0; d <= 16; ++d) acc[r][d] = 0.f;
    const int cnt = min(RJ, c_end - j0);
#pragma unroll 2
    for (int c = 0; c < cnt; ++c) {
      float pj[16];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 a = col[c * 4 + v];
        pj[4 * v] = a.x;
        pj[4 * v + 1] = a.y;
        pj[4 * v + 2] = a.z;
        pj[4 * v + 3] = a.w;
      }
      const float w = wb[c];
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        float diff[16], d2 = 0.f;
#pragma unroll
        for (int d = 0; d < 16; ++d) {
          diff[d] = yi[r][d] - pj[d];
          d2 = fmaf(diff[d], diff[d], d2);
        }
        float q = inv(1.f + d2) * w;
        q = j0 + c == gi[r] ? 0.f : q;
        acc[r][16] += q;
        const float q2 = q * q;
#pragma unroll
        for (int d = 0; d < 16; ++d) acc[r][d] = fmaf(q2, diff[d], acc[r][d]);
      }
    }
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int d = 0; d <= 16; ++d)
        tot[(r * 17 + d) * RT + t] += (double)acc[r][d];
    __syncthreads();  // the ring slot is rewritten
  }
  cp_async_wait<0>();
  float* out = part + (size_t)blockIdx.y * part_rows * (m + 1);
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int i = row0 + r * RT + t;
    if (i >= nloc) continue;
    const bool row_ok = valid == nullptr || valid[gi[r]];
    for (int d = 0; d < m; ++d)
      out[(size_t)i * (m + 1) + d] =
          row_ok ? (float)tot[(r * 17 + d) * RT + t] : 0.f;
    out[(size_t)i * (m + 1) + m] =
        row_ok ? (float)tot[(r * 17 + 16) * RT + t] : 0.f;
  }
}

int launch_rows(const float* y_loc, const float* y_full,
                const unsigned char* valid, int nloc, int nfull, int m,
                int row_offset, int splits, int part_rows, float* part,
                cudaStream_t s) {
  static_assert(RT == RJ, "a weight a thread");
  const cudaError_t err = cudaFuncSetAttribute(
      repulsion_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ROWS_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int col_span = (nfull + splits - 1) / splits;
  const dim3 grid((nloc + RT * RR - 1) / (RT * RR), splits);
  repulsion_rows_kernel<<<grid, RT, ROWS_BYTES, s>>>(
      y_loc, y_full, valid, nloc, nfull, m, row_offset, col_span, part_rows,
      part);
  return tsne::launch_status();
}

template <int MP>
int launch_tile(const float* y_loc, const float* y_full,
                const unsigned char* valid, int nloc, int nfull, int m,
                int row_offset, int splits, int part_rows, float* part,
                cudaStream_t s) {
  using G = TileGeom<MP>;
  const size_t bytes = sizeof(float) * G::FLOATS;
  auto kern = repulsion_tile_kernel<MP>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int col_span = (nfull + splits - 1) / splits;
  const dim3 grid((nloc + G::TR - 1) / G::TR, splits);
  kern<<<grid, TW, bytes, s>>>(y_loc, y_full, valid, nloc, nfull, m,
                               row_offset, col_span, part_rows, part);
  return tsne::launch_status();
}

int repulsion_tiles(const float* y_loc, const float* y_full,
                    const unsigned char* valid, int nloc, int nfull, int m,
                    int row_offset, int splits, int part_rows, float* part,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m < 1 || splits < 1 || splits > 65535 || part_rows < nloc)
    return (int)cudaErrorInvalidValue;
  switch (wide_class(m)) {
    case 16:
      return launch_rows(y_loc, y_full, valid, nloc, nfull, m, row_offset,
                         splits, part_rows, part, s);
    case 32:
      return launch_tile<32>(y_loc, y_full, valid, nloc, nfull, m,
                             row_offset, splits, part_rows, part, s);
    default:
      return launch_tile<64>(y_loc, y_full, valid, nloc, nfull, m,
                             row_offset, splits, part_rows, part, s);
  }
}


// ---- the wide form at float64 (B2w_f64): d² once a pair ------------------
//
// What bounds it: the FP64 pipe, half the FP32 pipe's rate (34 TFLOP/s on
// an H100 outside the tensor cores).  A pair costs m subtractions and m
// FMAs for d², the IEEE reciprocal (__drcp_rn, the plain version's
// division: a MUFU seed refined by FMAs, counted as 8 operations) and m
// FMAs of the force.  With the force's Σq²·y_j on the FP64 tensor cores
// (67 TFLOP/s) the pipe keeps (3m + 11) operations a pair: 6.25 ms at 60k
// x 16 and 21.49 at 60k x 64 (chip_smoke.wide_b2_bound).  The bytes (y
// once, the partials) are a few megabytes.
// Design, m <= 16 (repulsion_rows64_kernel): a row in registers.  A
// thread owns one row and its 16 coordinates; each staged column (16
// doubles, zeros past m, read as eight double2 broadcasts; a ring of two
// tiles of RJ64 columns that cp.async fills with 8-byte copies while the
// tile before computes) gives a pair's 16 differences once, its d² (one
// FMA each) and, once q = rcp(1 + d²)·weight is known, its force (one FMA
// each): 3m + 12 FP64 operations a pair, the force on the pipe.  A
// tile's sums start from 0 and are then added to the row's totals, held
// in shared memory.  One row a thread: the FP64 pipe, not the column
// reads, sets the pace, and a second row's 16 coordinates and 17 sums
// would cost the SM a block (two rows a thread ran 10% slower).
// Design, m > 16 (repulsion_tile64_kernel): tiles of TR64 rows x TC64
// columns.
// - d² once a pair: a thread takes 4 rows x 2 columns of the tile and, for
//   d = 0 .. m − 1 in order, reads the 4 rows' value as two double2
//   broadcasts and the 2 columns' value (columns lg and lg + 16, so a half
//   warp reads 16 neighbouring doubles) from shared memory — the rows
//   staged once, dims-major; the columns' tiles dims-major in a ring of
//   two that cp.async fills while the tile before computes —, one
//   subtraction and one FMA a pair and dim.  Then q = rcp(1 + d²)·weight
//   (0 on the diagonal), Z's and Σq²'s parts, and q², which stays in
//   shared memory for the force.
// - The force in product form, F_i = y_i·Σ_j q²_ij − Σ_j q²_ij·y_j, with
//   Σ_j q²_ij·y_j a product on the FP64 tensor cores (mma.sync m8n8k4,
//   67 TFLOP/s): q² [rows x columns] times the tile's columns [columns x
//   dims], each warp 8 rows x 64 dims, 8 k-steps of 4 columns — the
//   differences are not formed a second time, and the FP64 pipe keeps d²
//   and q alone.  Far from the origin the product cancels (at |y| ~ 1e3
//   and spreads ~10 about 100x, two of float64's sixteen digits: within
//   the 1e-12 bar, where at float32 it would not be); d² keeps the
//   differences, whose norm-trick form would cancel ~5,000x.
// - A tile's force sums start from 0 and are then added to the rows'
//   totals; Z's and Σq²'s parts from the tile's 16 column groups meet in a
//   fixed order at the end.  Past m = 64 the tiles walk the width in
//   blocks of DB64 dims: d² over every block, then the force block by
//   block, added to the partials slab rows the block owns (read, add,
//   write: no other block writes those rows of its split).
// At m <= 16 the force stays on the FP64 pipe: the differences are in
// registers already.  A row's sums take the same operations in the same
// order whatever block, split position or shard holds it; the column
// splits and the slab keep B2's contract (no atomics: two launches give
// the same bits).
constexpr int RT64 = 128;  // threads (and rows) a block of the float64
                           // m <= 16 path
constexpr int RJ64 = 64;   // columns a tile there
// its dynamic shared memory in doubles: the columns' ring [2][RJ64][16]
// and their weights [2][RJ64], then the rows' totals [17][RT64]
constexpr int ROWS64_COLS = 2 * RJ64 * 16 + 2 * RJ64;
constexpr size_t ROWS64_BYTES = 8 * ((size_t)ROWS64_COLS + 17 * RT64);

constexpr int TW64 = 128;  // threads a block of the float64 tiles
constexpr int TR64 = 32;   // rows a block there
constexpr int TC64 = 32;   // columns a tile
constexpr int DB64 = 64;   // dims a block of the width
// the tiles' dynamic shared memory, in doubles: the rows' dims [DB64][RS],
// the columns' ring of two slots [DB64][CS], q² [TC64][QS] (Z's and Σq²'s
// parts at the end) and the columns' weights [2][TC64] (the rows' Σq² at
// the end); RS keeps the rows' double2 reads aligned, CS = 4 (mod 16) and
// QS = 8 (mod 16) spread the tensor cores' B and A fragment reads over the
// banks (two wavefronts a warp, the least for 32 doubles)
struct Tile64 {
  static constexpr int RS = TR64 + 2, CS = TC64 + 4, QS = TR64 + 8;
  static constexpr int ROWS = 0, COLS = DB64 * RS, Q2 = COLS + 2 * DB64 * CS,
                       WGT = Q2 + TC64 * QS, DOUBLES = WGT + 2 * TC64;
};

// the float64 wide form's width class: 16 (rows in registers) or 64
// (tiles) (ops/repulsion_cuda.wide_class64)
__host__ __device__ constexpr int wide_class64(int m) {
  return m <= 16 ? 16 : DB64;
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0));
}

__global__ void __launch_bounds__(RT64, 3)
repulsion_rows64_kernel(const double* __restrict__ y_loc,
                        const double* __restrict__ y_full,
                        const unsigned char* __restrict__ valid, int nloc,
                        int nfull, int m, int row_offset, int col_span,
                        int part_rows, double* __restrict__ part) {
  extern __shared__ __align__(16) double smd[];
  double* cs = smd;                     // [2][RJ64][16]
  double* cw = smd + 2 * RJ64 * 16;     // [2][RJ64]
  double* tot = smd + ROWS64_COLS;      // [17][RT64]
  const int t = threadIdx.x;
  const int i = blockIdx.x * RT64 + t;
  const int gi = row_offset + i;
  const int c_begin = blockIdx.y * col_span;
  const int c_end = min(nfull, c_begin + col_span);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + RJ64 - 1) / RJ64 : 0;

  double yi[16];
#pragma unroll
  for (int d = 0; d < 16; ++d)
    yi[d] = i < nloc && d < m ? y_loc[(size_t)i * m + d] : 0.0;
#pragma unroll
  for (int d = 0; d <= 16; ++d) tot[d * RT64 + t] = 0.0;
  // columns [j0, j0 + RJ64) into ring slot b (zeros past the split or m)
  auto stage = [&](int j0, int b) {
    double* dst = cs + b * RJ64 * 16;
    for (int e = t; e < RJ64 * 16; e += RT64) {
      const int d = e % 16, c = e / 16;
      const bool ok = j0 + c < c_end && d < m;
      cp_async8(dst + e, ok ? y_full + (size_t)(j0 + c) * m + d : y_full,
                ok);
    }
    if (t < RJ64) {
      const int j = j0 + t;
      cw[b * RJ64 + t] =
          j >= c_end ? 0.0 : valid == nullptr || valid[j] ? 1.0 : 0.0;
    }
  };
  if (ntiles > 0) stage(c_begin, 0);
  cp_async_commit();
  for (int k = 0; k < ntiles; ++k) {
    const int j0 = c_begin + k * RJ64;
    const int b = k & 1;
    if (k + 1 < ntiles) {  // the next tile fills behind this one
      stage(j0 + RJ64, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const double2* col = reinterpret_cast<const double2*>(cs + b * RJ64 * 16);
    const double* wb = cw + b * RJ64;
    double acc[17];
#pragma unroll
    for (int d = 0; d <= 16; ++d) acc[d] = 0.0;
    const int cnt = min(RJ64, c_end - j0);
#pragma unroll 2
    for (int c = 0; c < cnt; ++c) {
      double pj[16];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const double2 a = col[c * 8 + v];
        pj[2 * v] = a.x;
        pj[2 * v + 1] = a.y;
      }
      const double w = wb[c];
      double diff[16], d2 = 0.0;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        diff[d] = yi[d] - pj[d];
        d2 = fma(diff[d], diff[d], d2);
      }
      double q = inv(1.0 + d2) * w;
      q = j0 + c == gi ? 0.0 : q;
      acc[16] += q;
      const double q2 = q * q;
#pragma unroll
      for (int d = 0; d < 16; ++d) acc[d] = fma(q2, diff[d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d <= 16; ++d) tot[d * RT64 + t] += acc[d];
    __syncthreads();  // the ring slot is rewritten
  }
  cp_async_wait<0>();
  if (i >= nloc) return;
  double* out = part + (size_t)blockIdx.y * part_rows * (m + 1);
  const bool row_ok = valid == nullptr || valid[gi];
  for (int d = 0; d < m; ++d)
    out[(size_t)i * (m + 1) + d] = row_ok ? tot[d * RT64 + t] : 0.0;
  out[(size_t)i * (m + 1) + m] = row_ok ? tot[16 * RT64 + t] : 0.0;
}

// D += A·B on the FP64 tensor cores: one m8n8k4 step of a warp (a: A's
// element at row lane / 4, k lane % 4; b: B's at k lane % 4, column
// lane / 4; c: D's at row lane / 4, columns 2·(lane % 4) and + 1)
__device__ __forceinline__ void dmma_m8n8k4(double (&c)[2], double a,
                                            double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(TW64, 3)
repulsion_tile64_kernel(const double* __restrict__ y_loc,
                        const double* __restrict__ y_full,
                        const unsigned char* __restrict__ valid, int nloc,
                        int nfull, int m, int row_offset, int col_span,
                        int part_rows, double* __restrict__ part) {
  using G = Tile64;
  constexpr int RS = G::RS, CS = G::CS, QS = G::QS;
  extern __shared__ __align__(16) double smt[];
  double* rs = smt + G::ROWS;
  double* cs = smt + G::COLS;
  double* q2s = smt + G::Q2;
  double* cw = smt + G::WGT;
  const int t = threadIdx.x;
  // d²: rows rg·4 + a, columns lg and lg + 16
  const int lg = t % 16, rg = t / 16;
  // the force: warp wp's rows 8·wp .. + 7 on the tensor cores, the lane
  // holding row 8·wp + gid, dims 8·nt + 2·tig and + 1 of each 8-dim tile nt
  const int wp = t / 32, gid = (t % 32) / 4, tig = t % 4;
  const int row0 = blockIdx.x * TR64;
  const int c_begin = blockIdx.y * col_span;
  const int c_end = min(nfull, c_begin + col_span);
  const int ntiles = c_end > c_begin ? (c_end - c_begin + TC64 - 1) / TC64 : 0;
  const bool blocked = m > DB64;
  double* out = part + (size_t)blockIdx.y * part_rows * (m + 1);

  // dims [d0, d0 + DB64) of the block's rows, zeros past m or nloc
  auto stage_rows = [&](int d0) {
    for (int e = t; e < TR64 * DB64; e += TW64) {
      const int d = e % DB64, r = e / DB64;
      rs[d * RS + r] = row0 + r < nloc && d0 + d < m
                           ? y_loc[(size_t)(row0 + r) * m + d0 + d] : 0.0;
    }
  };
  // columns [j0, j0 + TC64) dims [d0, d0 + DB64) into ring slot b,
  // dims-major (cp.async, zero-filled past the split or m; a warp copies
  // 8 dims of 4 columns, so its stores spread over the banks), and their
  // weights
  auto stage_cols = [&](int j0, int d0, int b) {
    double* dst = cs + b * DB64 * CS;
    for (int e = t; e < TC64 * DB64; e += TW64) {
      const int q = e / 32, r = e % 32;
      const int d = 8 * (q % 8) + r % 8, c = 4 * (q / 8) + r / 8;
      const bool ok = j0 + c < c_end && d0 + d < m;
      cp_async8(dst + d * CS + c,
                ok ? y_full + (size_t)(j0 + c) * m + d0 + d : y_full, ok);
    }
    if (t < TC64) {
      const int j = j0 + t;
      cw[b * TC64 + t] =
          j >= c_end ? 0.0 : valid == nullptr || valid[j] ? 1.0 : 0.0;
    }
  };
  // d² of the thread's 8 pairs over dims [0, dm) of the staged block
  auto add_d2 = [&](const double* csb, int dm, double (&d2)[4][2]) {
#pragma unroll 4
    for (int d = 0; d < dm; ++d) {
      const double2 r01 =
          *reinterpret_cast<const double2*>(rs + d * RS + rg * 4);
      const double2 r23 =
          *reinterpret_cast<const double2*>(rs + d * RS + rg * 4 + 2);
      const double rv[4] = {r01.x, r01.y, r23.x, r23.y};
      const double cv[2] = {csb[d * CS + lg], csb[d * CS + lg + 16]};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const double diff = rv[a] - cv[c];
          d2[a][c] = fma(diff, diff, d2[a][c]);
        }
    }
  };
  // Σ_j q²_ij·y_j over the tile's columns for the warp's 8 rows and the
  // staged block's first nt8 8-dim tiles: q² [row][column] (A) times the
  // columns' dims [column][dim] (B), 8 k-steps of 4 columns
  auto tile_force = [&](const double* csb, int nt8, double (&ft)[8][2]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) ft[nt][0] = ft[nt][1] = 0.0;
#pragma unroll
    for (int k0 = 0; k0 < TC64; k0 += 4) {
      const double a = q2s[(k0 + tig) * QS + 8 * wp + gid];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (nt < nt8)
          dmma_m8n8k4(ft[nt], a, csb[(8 * nt + gid) * CS + k0 + tig]);
    }
  };

  double acc[8][2];                      // Σ q²·y_j of the lane's 16 dims
  double zacc[4], sacc[4];               // Z and Σ q² of the d² rows
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = 0.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) zacc[a] = sacc[a] = 0.0;
  if (!blocked) {
    stage_rows(0);
    if (ntiles > 0) stage_cols(c_begin, 0, 0);
    cp_async_commit();
  }
  for (int k = 0; k < ntiles; ++k) {
    const int j0 = c_begin + k * TC64;
    const int b = blocked ? 0 : k & 1;
    const double* csb = cs + b * DB64 * CS;
    double d2[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) d2[a][0] = d2[a][1] = 0.0;
    if (!blocked) {
      if (k + 1 < ntiles) {  // the next tile fills behind this one
        stage_cols(j0 + TC64, 0, b ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      add_d2(csb, m, d2);
    } else {
      for (int d0 = 0; d0 < m; d0 += DB64) {
        __syncthreads();  // the block before is read
        stage_rows(d0);
        stage_cols(j0, d0, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        add_d2(csb, min(DB64, m - d0), d2);
      }
    }
    // q, Z's and Σq²'s parts, and q² of the thread's 8 pairs
    double zt[4] = {0.0, 0.0, 0.0, 0.0}, st[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int jc = lg + 16 * c;
      const double w = cw[b * TC64 + jc];
      double q2[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        double q = inv(1.0 + d2[a][c]) * w;
        q = j0 + jc == row_offset + row0 + rg * 4 + a ? 0.0 : q;
        zt[a] += q;
        q2[a] = q * q;
        st[a] += q2[a];
      }
      *reinterpret_cast<double2*>(q2s + jc * QS + rg * 4) =
          make_double2(q2[0], q2[1]);
      *reinterpret_cast<double2*>(q2s + jc * QS + rg * 4 + 2) =
          make_double2(q2[2], q2[3]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      zacc[a] += zt[a];
      sacc[a] += st[a];
    }
    __syncthreads();
    double ft[8][2];
    if (!blocked) {
      tile_force(csb, (m + 7) / 8, ft);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[nt][0] += ft[nt][0];
        acc[nt][1] += ft[nt][1];
      }
    } else {
      const int i = row0 + 8 * wp + gid;
      for (int d0 = 0; d0 < m; d0 += DB64) {
        if (d0) __syncthreads();  // the block before is read
        stage_cols(j0, d0, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        tile_force(csb, (min(DB64, m - d0) + 7) / 8, ft);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = d0 + 8 * nt + 2 * tig + h;
            if (i < nloc && d < m) {
              double* o = out + (size_t)i * (m + 1) + d;
              *o = (k == 0 ? 0.0 : *o) + ft[nt][h];
            }
          }
      }
    }
    __syncthreads();  // q² and the ring slot are rewritten
  }
  cp_async_wait<0>();

  // Z and Σq²: the column groups' parts of each row, in order
  double* zs = q2s;  // [16][TR64] Z's parts, then [16][TR64] Σq²'s
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    zs[lg * TR64 + rg * 4 + a] = zacc[a];
    zs[(16 + lg) * TR64 + rg * 4 + a] = sacc[a];
  }
  __syncthreads();
  if (t < TR64) {
    double z = 0.0, s2 = 0.0;
    for (int g = 0; g < 16; ++g) {
      z += zs[g * TR64 + t];
      s2 += zs[(16 + g) * TR64 + t];
    }
    cw[t] = s2;  // 2·TC64 >= TR64 doubles
    const int i = row0 + t;
    if (i < nloc) {
      const bool row_ok = valid == nullptr || valid[row_offset + i];
      out[(size_t)i * (m + 1) + m] = row_ok ? z : 0.0;
    }
  }
  __syncthreads();
  // F_i = y_i·Σq² − Σq²·y_j
  const int i = row0 + 8 * wp + gid;
  if (i >= nloc) return;
  const bool row_ok = valid == nullptr || valid[row_offset + i];
  const double s2 = cw[8 * wp + gid];
  for (int d0 = 0; d0 < (blocked ? m : 1); d0 += DB64) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + 8 * nt + 2 * tig + h;
        if (d >= m) continue;
        double* o = out + (size_t)i * (m + 1) + d;
        const double sy = blocked ? (ntiles > 0 ? *o : 0.0) : acc[nt][h];
        *o = row_ok ? fma(y_loc[(size_t)i * m + d], s2, -sy) : 0.0;
      }
  }
}

int repulsion_wide64(const double* y_loc, const double* y_full,
                     const unsigned char* valid, int nloc, int nfull, int m,
                     int row_offset, int splits, int part_rows, double* part,
                     void* stream) {
  static_assert(2 * TC64 >= TR64, "the rows' Σq² fit the weights' space");
  static_assert(32 * TR64 <= TC64 * Tile64::QS, "Z's parts fit q²'s space");
  cudaStream_t s = (cudaStream_t)stream;
  if (m < 1 || splits < 1 || splits > 65535 || part_rows < nloc)
    return (int)cudaErrorInvalidValue;
  const int col_span = (nfull + splits - 1) / splits;
  if (wide_class64(m) == 16) {
    const cudaError_t err = cudaFuncSetAttribute(
        repulsion_rows64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ROWS64_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nloc + RT64 - 1) / RT64, splits);
    repulsion_rows64_kernel<<<grid, RT64, ROWS64_BYTES, s>>>(
        y_loc, y_full, valid, nloc, nfull, m, row_offset, col_span,
        part_rows, part);
    return tsne::launch_status();
  }
  const size_t bytes = sizeof(double) * Tile64::DOUBLES;
  const cudaError_t err = cudaFuncSetAttribute(
      repulsion_tile64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nloc + TR64 - 1) / TR64, splits);
  repulsion_tile64_kernel<<<grid, TW64, bytes, s>>>(
      y_loc, y_full, valid, nloc, nfull, m, row_offset, col_span, part_rows,
      part);
  return tsne::launch_status();
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
// tsne_repulsion_f32, any m >= 1 (the wrapper sends it m > 8); blocks of
// 4,096 / wide_class(m) rows, the columns in tiles of wide_class(m).
TSNE_API int tsne_repulsion_wide_f32(const float* y_loc, const float* y_full,
                                     const unsigned char* valid, int nloc,
                                     int nfull, int m, int row_offset,
                                     int splits, int part_rows, float* part,
                                     void* stream) {
  return repulsion_tiles(y_loc, y_full, valid, nloc, nfull, m, row_offset,
                         splits, part_rows, part, stream);
}

// The float64 form of tsne_repulsion_wide_f32 (B2w_f64): blocks of 128
// rows at m <= 16, of 32 rows past it, the columns in tiles of 64 / 32.
TSNE_API int tsne_repulsion_wide_f64(const double* y_loc,
                                     const double* y_full,
                                     const unsigned char* valid, int nloc,
                                     int nfull, int m, int row_offset,
                                     int splits, int part_rows, double* part,
                                     void* stream) {
  return repulsion_wide64(y_loc, y_full, valid, nloc, nfull, m, row_offset,
                          splits, part_rows, part, stream);
}

// The wide form's geometry at width m and dtype (float64 != 0: B2w_f64):
// *rows the rows a block, *chunk the dims the force takes at once (the
// width class: at float64 16 or 64, at float32 16, 32 or 64, the dims of a
// block past it) (ops/repulsion_cuda mirrors both for the memory model on
// any device; the card's checks hold the mirror to this).  Returns
// M_NARROW.
TSNE_API int tsne_repulsion_wide_config(int m, int float64, int* rows,
                                        int* chunk) {
  *rows = float64 ? (wide_class64(m) == 16 ? RT64 : TR64)
          : m <= 16 ? RT * RR : TPAIRS / wide_class(m);
  *chunk = float64 ? wide_class64(m) : wide_class(m);
  return tsne::M_NARROW;
}
