// B3 — the CSR step: a row's head and tail forces, rep/Z, the vdM gains,
//      the momentum update and y += update, in one launch,
// B4 — the per-row KL over a row block and a ragged edge part, and
// B5 — the attraction forces over a row block and a ragged edge part.
//
// B3 replaces tsne_flink_tpu/ops/attraction_pallas.py::_fused_kernel
// (launched by _run_fused, driven by fused_step_update); B4 replaces
// ::_loss_kernel (launched by _run_loss, driven by attraction_loss); B5
// replaces ::_forces_kernel (launched by _run_forces, driven by
// attraction_forces).  The three also take over what the JAX package
// leaves to XLA beside them: the segment sums of a src-sorted edge list
// (tsne_flink_tpu/models/tsne.py, jax.ops.segment_sum) — the blocks
// layout's reverse edges, the edges layout's whole list and the CSR tail
// — and, in B3, the rep/Z division the JAX step does before its kernel.
// Row i's forces are F_i = Σ_j P_ij q_ij (y_i − y_j) over the row's
// forward slots (jidx/jval [nloc, W], W may be 0) and its ragged segment
// (dst/val [E] from rowptr[i] to rowptr[i + 1]); B5 writes
// att_i = forward + ragged in that grouping, B4 the KL the same way, and
// B3 goes on to grad_i = (att_i − rep_i / Z)·mask_i and the update.
//
// What bounds them on an H100: bytes.  Each row reads its W slots (int32
// index + f32 value: N·W·8 bytes), its E_i edges (8 bytes each), the row
// pointer and a few [N, m] state planes; the ~20 operations a slot are far
// below the card's rate.  Each neighbour row y_full[j] is gathered from a
// [N, m] array that stays in the 50 MB L2, one 32-byte sector a gather:
// at the 60k CSR head those sectors (~245 MB) outweigh the streams, and
// they run at the L2's rate.
//
// Design: one warp per row, the lanes taking slot lane + 32·u.  A lane
// walks its slots U at a time and, before any arithmetic, issues the U
// value loads of the forward part and the U index and value loads of the
// ragged part together, then the forward part's index loads where a value
// is set, then the 2·U gathers together (each neighbour one 8- or 16-byte
// load where m allows), so a batch of a row costs three memory latencies
// in sequence (two on an edge list) rather than three a slot; padding
// slots (value 0) predicate their index and gather off and add exactly 0,
// with no branch.  A hub row, whose reverse segment runs to thousands of
// edges, loops longer in its own warp while the other warps of the SM go
// on.  The lane partials are combined by a butterfly shuffle (a fixed
// order), and a lane meets its slots in increasing order, so two launches
// give the same bits.  The TPU wrapper materialises the [c, W, m] gather
// in device memory first; the port does not.
//
// B3 may visit its rows in a given order (a permutation: warp s of the
// grid takes row order[s]).  Each row's arithmetic is its own — per-row
// outputs, a fixed lane order — so the order moves no bit; it decides
// when a row runs.  A CSR tail is hub rows' overflow, thousands of edges
// walked by one warp each, and in index order some hubs start in the
// grid's last wave and run on alone after it; the wrapper's order puts
// the rows with the longest tails first, so they run beside the rest.
//
// The arithmetic mirrors the plain versions operation for operation.  The
// forward part: norm-trick distances clamped at 0, att = y_i·Σw − Σw·y_j,
// each product and sum rounded on its own (__fmul_rn / __fadd_rn: nothing
// contracted into an FMA), in the plain version's order — the norm-trick
// d² cancels for a spread embedding, and an FMA there alone moved forces
// by more than 2e-5.  The ragged part: d² = Σ(y_i − y_j)² and Σ w·(y_i −
// y_j), as the plain edge-list sum computes it.  B3 and B5 share the walk
// (pair_q, edge_q, walk_row, row_forces) and the instance rule, so B3's
// att_i is the bits of B5 over the same parts, and rep/Z is an IEEE
// division (__fdiv_rn, as PyTorch divides by a 0-d device tensor; the
// build has no fast-math): the fused CSR step (B3 over head + tail)
// reproduces the unfused one (B5 over head + tail, att − rep/Z, the vdM
// update in PyTorch) bit for bit.  Each part keeps its own accumulators
// and lane order, so one walk over both parts is the head's sum plus the
// tail's, bit for bit.  B3 writes y, update and gains to fresh buffers,
// B5 its forces: other warps are still gathering from y_full, so an
// in-place y would race.  B3 and B4 read the global Z from device memory
// (no host round trip); B4 writes per-row partials only, their sum a
// fixed-order torch.sum outside.  No kernel here uses atomics.  Every m
// from 1 to 8 (the JAX package's MPAD) is a template instance; a wider m
// takes the wide forms below (B3w, B4w, B5w: the *_wide_* entries).
//
// The float64 forms (B3_f64, B4_f64, B5_f64: the C entries ending in _f64)
// are the same templates over the scalar type: tsne::Num<double> gives
// each separately rounded operation its __d*_rn counterpart (the
// reciprocal __drcp_rn, rep/Z __ddiv_rn), and the gathers load 16-byte
// double2 vectors where m is even.  What bounds them is still bytes, with
// 8-byte values and planes.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

// slots a lane walks a batch, per part: registers for the gathered points
// grow with m
template <int M>
__host__ __device__ constexpr int batch_for() { return M <= 4 ? 4 : 2; }

template <class T, int M>
__device__ __forceinline__ void load_row(const T* __restrict__ y_loc, int i,
                                         T (&yc)[M], T& rr) {
  using N = tsne::Num<T>;
  rr = T(0);
#pragma unroll
  for (int d = 0; d < M; ++d) {
    yc[d] = y_loc[(size_t)i * M + d];
    rr = N::add(rr, N::mul(yc[d], yc[d]));
  }
}

// y_full[j] into p when `take`, else zeros: one load for m = 1, 2 and 4,
// two for m = 8, 16-byte or 8-byte vectors where m allows (y_full's rows
// are then aligned: the wrapper checks the base); at float64 16-byte
// double2 vectors for an even m
template <class T, int M>
__device__ __forceinline__ void gather(bool take, const T* __restrict__ y_full,
                                       int j, T (&p)[M]) {
#pragma unroll
  for (int d = 0; d < M; ++d) p[d] = T(0);
  if (!take) return;
  const T* src = y_full + (size_t)j * M;
  if constexpr (std::is_same_v<T, double>) {
    if constexpr (M % 2 == 0) {
#pragma unroll
      for (int v = 0; v < M / 2; ++v) {
        const double2 t = __ldg(reinterpret_cast<const double2*>(src) + v);
        p[2 * v] = t.x;
        p[2 * v + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int d = 0; d < M; ++d) p[d] = __ldg(src + d);
    }
  } else if constexpr (M % 4 == 0) {
#pragma unroll
    for (int v = 0; v < M / 4; ++v) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src) + v);
      p[4 * v] = t.x;
      p[4 * v + 1] = t.y;
      p[4 * v + 2] = t.z;
      p[4 * v + 3] = t.w;
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int v = 0; v < M / 2; ++v) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(src) + v);
      p[2 * v] = t.x;
      p[2 * v + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int d = 0; d < M; ++d) p[d] = __ldg(src + d);
  }
}

// the Student-t q = 1/(1 + max(d², 0)) of a forward slot, d² = (|y_i|² +
// |y_j|²) − 2 y_i·y_j: every product and sum rounded on its own, in the
// plain version's order, so d² — which cancels badly for a spread
// embedding — carries the plain version's bits
template <class T, int M>
__device__ __forceinline__ T pair_q(const T (&yc)[M], T rr, const T (&yj)[M]) {
  using N = tsne::Num<T>;
  T rc = T(0), g = T(0);
#pragma unroll
  for (int d = 0; d < M; ++d) {
    rc = N::add(rc, N::mul(yj[d], yj[d]));
    g = N::add(g, N::mul(yc[d], yj[d]));
  }
  const T d2 = N::max(N::sub(N::add(rr, rc), N::mul(T(2), g)), T(0));
  return N::rcp(N::add(T(1), d2));
}

// the q = 1/(1 + Σ(y_i − y_j)²) of a ragged edge and its differences
template <class T, int M>
__device__ __forceinline__ T edge_q(const T (&yc)[M], const T (&yj)[M],
                                    T (&diff)[M]) {
  using N = tsne::Num<T>;
  T d2 = T(0);
#pragma unroll
  for (int d = 0; d < M; ++d) {
    diff[d] = N::sub(yc[d], yj[d]);
    d2 = N::add(d2, N::mul(diff[d], diff[d]));
  }
  return N::rcp(N::add(T(1), d2));
}

// Walks row i's forward slots [0, w) of ir/vr (FWD) and its ragged edges
// [e0, e1) of dst/val (RAG), 32·U slots of each part a batch: every lane
// loads its U values and ids of both parts (a forward id only where its
// value is set), then gathers their points, then hands each (value,
// point) to fwd / rag in slot order.  A slot past a part's end has value
// 0, like padding: its gather is skipped and the callbacks add exactly 0
// for it.
template <class T, int M, bool FWD, bool RAG, class Fwd, class Rag>
__device__ __forceinline__ void walk_row(const T* __restrict__ y_full,
                                         const int* __restrict__ ir,
                                         const T* __restrict__ vr, int w,
                                         const int* __restrict__ dst,
                                         const T* __restrict__ val,
                                         long long e0, long long e1, int lane,
                                         Fwd&& fwd, Rag&& rag) {
  constexpr int U = batch_for<M>();
  const long long len = RAG ? e1 - e0 : 0;
  const long long span = FWD && w > len ? (long long)w : len;
  for (long long at = 0; at < span; at += 32 * U) {
    int fj[U], rj[U];
    T fv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = at + lane + 32 * u;
      if constexpr (FWD) fv[u] = c < w ? vr[c] : T(0);
      if constexpr (RAG) {
        const bool in = c < len;
        rv[u] = in ? val[e0 + c] : T(0);
        rj[u] = in ? dst[e0 + c] : 0;
      }
    }
    // a row block's index only where its value is set: a padded layout
    // (the [N, S] rows of a hub-heavy graph, ~4% filled) reads no index
    // for a padding slot; an edge list carries no padding by the time
    // it arrives here, so its index loads with its value
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = at + lane + 32 * u;
      if constexpr (FWD) fj[u] = fv[u] > T(0) ? ir[c] : 0;
    }
    T fy[U][M], ry[U][M];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (FWD) gather<T, M>(fv[u] > T(0), y_full, fj[u], fy[u]);
      if constexpr (RAG) gather<T, M>(rv[u] > T(0), y_full, rj[u], ry[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (FWD) fwd(fv[u], fy[u]);
      if constexpr (RAG) rag(rv[u], ry[u]);
    }
  }
}

// Row i's forces: the forward part att = y_i·Σw − Σw·y_j (w = v·exag·q)
// and the ragged part Σ w·(y_i − y_j), the same values in every lane.
template <class T, int M, bool FWD, bool RAG>
__device__ __forceinline__ void row_forces(
    const T* __restrict__ y_full, const int* __restrict__ ir,
    const T* __restrict__ vr, int w, const int* __restrict__ dst,
    const T* __restrict__ val, long long e0, long long e1, const T (&yc)[M],
    T rr, T exag, int lane, T (&fwd)[M], T (&rag)[M]) {
  using N = tsne::Num<T>;
  T sw = T(0), swy[M];
#pragma unroll
  for (int d = 0; d < M; ++d) swy[d] = rag[d] = T(0);
  walk_row<T, M, FWD, RAG>(
      y_full, ir, vr, w, dst, val, e0, e1, lane,
      [&](T v, const T (&yj)[M]) {
        const T wt = v * exag * pair_q<T, M>(yc, rr, yj);
        sw += wt;
#pragma unroll
        for (int d = 0; d < M; ++d) swy[d] = N::fma(wt, yj[d], swy[d]);
      },
      [&](T v, const T (&yj)[M]) {
        T diff[M];
        const T wt = N::mul(N::mul(v, exag), edge_q<T, M>(yc, yj, diff));
#pragma unroll
        for (int d = 0; d < M; ++d) rag[d] = N::add(rag[d], N::mul(wt, diff[d]));
      });
  if constexpr (FWD) {
    sw = tsne::warp_sum(sw);
#pragma unroll
    for (int d = 0; d < M; ++d)
      fwd[d] = N::sub(N::mul(yc[d], sw), tsne::warp_sum(swy[d]));
  }
  if constexpr (RAG) {
#pragma unroll
    for (int d = 0; d < M; ++d) rag[d] = tsne::warp_sum(rag[d]);
  }
}

// pe·log(pe·Z/q) of one slot, 0 for padding
template <class T>
__device__ __forceinline__ T kl_term(T v, T exag, T z, T q) {
  const T pe = v * exag;
  return v > T(0) ? pe * tsne::Num<T>::log(pe * z / q) : T(0);
}

// the vdM gain rule's constants in the scalar type
template <class T>
struct Gain;
template <>
struct Gain<float> {
  static constexpr float down = 0.8f, up = 0.2f;
};
template <>
struct Gain<double> {
  static constexpr double down = 0.8, up = 0.2;
};

// B3: row order[s] (row s without an order) — its forces over the head
// block and then its ragged tail, grad = (att − rep/Z)·mask with att =
// fwd + rag as B5 adds them, then the vdM gains, the momentum update and
// y += update, and ‖grad‖² — all written by lane 0.
template <class T, int M, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
                  const int* __restrict__ hidx, const T* __restrict__ hval,
                  int nloc, int w, const long long* __restrict__ rowptr,
                  const int* __restrict__ dst, const T* __restrict__ val,
                  const int* __restrict__ order, const T* __restrict__ rep,
                  const T* __restrict__ z_ptr, const T* __restrict__ mask,
                  const T* __restrict__ upd, const T* __restrict__ gains,
                  T exag, T momentum, T eta, T min_gain, T* __restrict__ y_out,
                  T* __restrict__ upd_out, T* __restrict__ gains_out,
                  T* __restrict__ gsq_out) {
  using N = tsne::Num<T>;
  const int s = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= nloc) return;  // whole warp
  const int i = order != nullptr ? order[s] : s;
  T yc[M], rr, fwd[M], rag[M], unused[M];
  load_row<T, M>(y_loc, i, yc, rr);
  // the head's walk, then the tail's: each part's sums keep their own
  // order, so this is B5's interleaved walk bit for bit, and a part's
  // batch holds only its own loads — 40 registers a thread at m = 2
  // rather than the interleaved walk's 64, so 6 blocks an SM, not 4
  if constexpr (FWD)
    row_forces<T, M, true, false>(y_full, hidx + (size_t)i * w,
                                  hval + (size_t)i * w, w, nullptr, nullptr,
                                  0, 0, yc, rr, exag, lane, fwd, unused);
  if constexpr (RAG)
    row_forces<T, M, false, true>(y_full, nullptr, nullptr, 0, dst, val,
                                  rowptr[i], rowptr[i + 1], yc, rr, exag,
                                  lane, unused, rag);
  if (lane != 0) return;
  const T z = *z_ptr;
  const T mk = mask != nullptr ? mask[i] : T(1);
  T gsq = T(0);
#pragma unroll
  for (int d = 0; d < M; ++d) {
    const size_t o = (size_t)i * M + d;
    const T att = FWD && RAG ? N::add(fwd[d], rag[d]) : FWD ? fwd[d] : rag[d];
    const T grad = N::mul(N::sub(att, N::div(rep[o], z)), mk);
    const T u = upd[o];
    const T g0 = gains[o];
    const T g = N::max((grad > T(0)) == (u > T(0)) ? N::mul(g0, Gain<T>::down)
                                                   : N::add(g0, Gain<T>::up),
                       min_gain);
    const T un = N::sub(N::mul(momentum, u), N::mul(N::mul(eta, g), grad));
    y_out[o] = N::add(yc[d], un);
    upd_out[o] = un;
    gains_out[o] = g;
    gsq = N::fma(grad, grad, gsq);
  }
  gsq_out[i] = gsq;
}

template <class T, int M, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
forces_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
              const int* __restrict__ jidx, const T* __restrict__ jval,
              int nloc, int w, const long long* __restrict__ rowptr,
              const int* __restrict__ dst, const T* __restrict__ val, T exag,
              T* __restrict__ att_out) {
  using N = tsne::Num<T>;
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;  // whole warp
  T yc[M], rr, fwd[M], rag[M];
  load_row<T, M>(y_loc, i, yc, rr);
  const long long e0 = RAG ? rowptr[i] : 0, e1 = RAG ? rowptr[i + 1] : 0;
  row_forces<T, M, FWD, RAG>(y_full, jidx + (size_t)i * w,
                             jval + (size_t)i * w, w, dst, val, e0, e1, yc,
                             rr, exag, lane, fwd, rag);
  if (lane != 0) return;
#pragma unroll
  for (int d = 0; d < M; ++d)
    att_out[(size_t)i * M + d] = FWD && RAG ? N::add(fwd[d], rag[d])
                                 : FWD      ? fwd[d]
                                            : rag[d];
}

template <class T, int M, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
loss_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
            const int* __restrict__ jidx, const T* __restrict__ jval,
            int nloc, int w, const long long* __restrict__ rowptr,
            const int* __restrict__ dst, const T* __restrict__ val, T exag,
            const T* __restrict__ z_ptr, T* __restrict__ loss_rows) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;
  T yc[M], rr;
  load_row<T, M>(y_loc, i, yc, rr);
  const T z = *z_ptr;
  const long long e0 = RAG ? rowptr[i] : 0, e1 = RAG ? rowptr[i + 1] : 0;
  T fwd = T(0), rag = T(0);
  walk_row<T, M, FWD, RAG>(
      y_full, jidx + (size_t)i * w, jval + (size_t)i * w, w, dst, val, e0,
      e1, lane,
      [&](T v, const T (&yj)[M]) {
        fwd += kl_term<T>(v, exag, z, pair_q<T, M>(yc, rr, yj));
      },
      [&](T v, const T (&yj)[M]) {
        T diff[M];
        rag += kl_term<T>(v, exag, z, edge_q<T, M>(yc, yj, diff));
      });
  fwd = tsne::warp_sum(fwd);
  rag = tsne::warp_sum(rag);
  if (lane == 0) loss_rows[i] = FWD && RAG ? fwd + rag : FWD ? fwd : rag;
}

// A compensated (Kahan) running sum.  At a converged m = 16 embedding the
// forward part's y_i·Σw − Σw·y_j cancels, and plain sequential sums over
// a row's slots lose several times the plain version's accuracy against
// float64; compensated ones stay within it.  Each step is separately
// rounded (no FMA contraction).
template <class T>
struct Kahan {
  T s, c;
  __device__ __forceinline__ Kahan() : s(T(0)), c(T(0)) {}
  __device__ __forceinline__ void add(T x) {
    using N = tsne::Num<T>;
    const T y = N::sub(x, c);
    const T t = N::add(s, y);
    c = N::sub(N::sub(t, s), y);
    s = t;
  }
};

// ---- the wide forms of B3 and B5 (B3w, B5w and their _f64 forms): any m --
//
// At wide m a lane cannot hold a neighbour's whole point, but a few lanes
// can.  A point is cut into pieces of 32 bytes (DL = 8 dims at float32, 4
// at float64: two 16-byte vectors), and a group of G lanes — the pieces
// of m rounded up to a power of two, at most 32 — takes one slot at a
// time, lane g of the group holding piece g of the row and of the slot's
// point.  So a warp has 32 / G slots in flight (16 at m = 16 in float32, 8
// at float64): the lanes take slots, as in the narrow forms, not dims.  A
// group walks its slots of a part in order: it loads a slot's value and,
// where the value is set, its id, then each lane gathers its piece of the
// point (16-byte vectors where m and the bases allow), the loads running
// two slots ahead of the arithmetic.  A slot's d² — the forward part's
// norm-trick terms |y_j|² and y_i·y_j, the ragged part's Σ(y_i − y_j)² —
// is the lane's partial over its piece and a log2(G)-step butterfly
// inside the group, the same bits in every lane of the group.  Each lane
// keeps running sums of its own slots for its piece's dims (Σw and Σw·y_j
// of the forward part, Σw·(y_i − y_j) of the ragged one; compensated at
// float32, LaneSum), and the groups meet once a part, in a fixed
// butterfly order.  The row's force passes through shared memory (the
// forward part parked there while the ragged one walks), so that the
// epilogue (B5w's store, B3w's update and ‖grad‖²) takes a dim a lane,
// coalesced.  What bounds the walk is the latency of its dependent loads
// (value, id, point), so a lane holds few registers and an SM keeps many
// warps in flight.  Past 32 pieces (256 dims at float32, 128 at float64)
// a lane holds one piece of each force chunk: a second grid dimension runs
// the chunks, each recomputing d² over all the lane's pieces in the same
// order, and B3w writes a ‖grad‖² partial a chunk.
//
// The contract is the narrow kernels': the forward part's distances by the
// norm trick clamped at 0, the ragged part's by differences, each part's
// sums in its own accumulators, every product and sum rounded on its own,
// no atomics; a padding slot (value 0) gathers nothing and adds nothing.
// B3w and B5w share the walk (slot_row, slot_walk, slot_row_force), so
// B3w's att is B5w's bits and the fused step the unfused one's.
//
// blocks of THREADS an SM keeps of B3w / B5w (their registers capped to
// fit): more warps in flight beat spare registers
constexpr int SLOT_BLOCKS = 3;

// a lane's piece of a point: DL dims, L of them a 16-byte vector
template <class T>
struct Slice {
  static constexpr int DL = 32 / (int)sizeof(T), L = 16 / (int)sizeof(T);
  using V = std::conditional_t<std::is_same_v<T, double>, double2, float4>;
};

__device__ __forceinline__ void unpack_vec(const float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void unpack_vec(const double2 v, double* o) {
  o[0] = v.x;
  o[1] = v.y;
}

// piece p of a row of m values into out, zeros past m or without `take`;
// 16-byte vectors when `vec` (m a multiple of L and the base aligned)
template <class T>
__device__ __forceinline__ void load_piece(const T* __restrict__ row, int m,
                                           int p, bool take, bool vec,
                                           T (&out)[Slice<T>::DL]) {
  constexpr int DL = Slice<T>::DL, L = Slice<T>::L;
  using V = typename Slice<T>::V;
  const int d0 = p * DL;
#pragma unroll
  for (int e = 0; e < DL; ++e) out[e] = T(0);
  if (!take) return;
  if (vec) {
#pragma unroll
    for (int v = 0; v < DL / L; ++v)
      if (d0 + v * L < m)
        unpack_vec(__ldg(reinterpret_cast<const V*>(row + d0) + v),
                   out + v * L);
  } else {
#pragma unroll
    for (int e = 0; e < DL; ++e)
      if (d0 + e < m) out[e] = __ldg(row + d0 + e);
  }
}

// the sum over the G lanes of a group (every lane ends with the same bits)
template <class T>
__device__ __forceinline__ T group_sum(T v, int g) {
  for (int off = 1; off < g; off <<= 1)
    v = tsne::Num<T>::add(v, __shfl_xor_sync(tsne::kFullMask, v, off));
  return v;
}

// the sum over the 32 / G groups of a warp, lane by lane of a group
template <class T>
__device__ __forceinline__ T cross_sum(T v, int g) {
  for (int off = g; off < 32; off <<= 1)
    v = tsne::Num<T>::add(v, __shfl_xor_sync(tsne::kFullMask, v, off));
  return v;
}

template <class T>
struct SlotRow {
  int m, g, s, gl;    // the width, the lanes a slot, the lane's group, its
                      // lane in the group
  int r, chunk;       // the pieces a lane walks, the launch's chunk
  bool vec;           // 16-byte gathers
  const T* yi;        // the row in y_loc
  T yc[Slice<T>::DL]; // the row's piece in the chunk (piece gl + g·chunk)
  T rr;               // |y_i|², the same in every lane
};

template <class T>
__device__ __forceinline__ void slot_row(const T* __restrict__ y_loc, int i,
                                         int m, int chunk, bool vec, int lane,
                                         SlotRow<T>& w) {
  using N = tsne::Num<T>;
  constexpr int DL = Slice<T>::DL;
  const int pieces = (m + DL - 1) / DL;
  int g = 1;
  while (g < pieces && g < 32) g <<= 1;
  w.m = m;
  w.g = g;
  w.s = lane / g;
  w.gl = lane % g;
  w.r = (pieces + g - 1) / g;
  w.chunk = chunk;
  w.vec = vec;
  w.yi = y_loc + (size_t)i * m;
  load_piece<T>(w.yi, m, w.gl + g * chunk, true, vec, w.yc);
  T rr = T(0);
  for (int r = 0; r < w.r; ++r) {
    T v[DL];
    load_piece<T>(w.yi, m, w.gl + g * r, true, vec, v);
#pragma unroll
    for (int e = 0; e < DL; ++e) rr = N::add(rr, N::mul(v[e], v[e]));
  }
  w.rr = group_sum(rr, g);
}

// The lane's partials of a slot's d² over its pieces in order (the
// chunk's from registers, any other — past one force chunk — a value at a
// time from memory): FWD |y_j|² in pa and y_i·y_j in pb, else Σ(y_i −
// y_j)² in pa.
template <class T, bool FWD>
__device__ __forceinline__ void slot_partial(const SlotRow<T>& w,
                                             const T* __restrict__ yrow,
                                             bool take,
                                             const T (&yj)[Slice<T>::DL],
                                             T& pa, T& pb) {
  using N = tsne::Num<T>;
  constexpr int DL = Slice<T>::DL;
  pa = pb = T(0);
  auto add = [&](T a, T b) {
    if constexpr (FWD) {
      pa = N::add(pa, N::mul(b, b));
      pb = N::add(pb, N::mul(a, b));
    } else {
      const T df = N::sub(a, b);
      pa = N::add(pa, N::mul(df, df));
    }
  };
  for (int r = 0; r < w.r; ++r) {
    if (r == w.chunk) {
#pragma unroll
      for (int e = 0; e < DL; ++e) add(w.yc[e], yj[e]);
    } else {
      const int d0 = (w.gl + w.g * r) * DL;
      for (int e = 0; e < DL; ++e) {
        const int d = d0 + e;
        add(d < w.m ? __ldg(w.yi + d) : T(0),
            take && d < w.m ? __ldg(yrow + d) : T(0));
      }
    }
  }
}

// slot c of a part: its value (0 past len) and, where it is set, its id
// (a padded layout reads no id for a padding slot)
template <class T>
__device__ __forceinline__ T slot_val(const T* __restrict__ vals,
                                      long long len, long long c) {
  return c < len ? vals[c] : T(0);
}
__device__ __forceinline__ int slot_id(const int* __restrict__ ids,
                                       long long c, bool set) {
  return set ? ids[c] : 0;
}

// Walks a part's slots [0, len) (value vals[c], id ids[c]): the group
// takes slots s, s + 32/G, ..., handing each set one to f(value, the
// lane's piece of its point, q).  The loads run two slots ahead: while a
// slot's point is gathered and summed, the next slot's id and the one
// after's value load, so a slot waits on one memory latency, not three.
template <class T, bool FWD, class F>
__device__ __forceinline__ void slot_walk(const SlotRow<T>& w,
                                          const T* __restrict__ y_full,
                                          const int* __restrict__ ids,
                                          const T* __restrict__ vals,
                                          long long len, F&& f) {
  using N = tsne::Num<T>;
  constexpr int DL = Slice<T>::DL;
  const int step = 32 / w.g;
  const int p = w.gl + w.g * w.chunk;
  if (len <= 0) return;
  long long c = w.s;
  T v = slot_val(vals, len, c), vn = slot_val(vals, len, c + step);
  int j = slot_id(ids, c, v > T(0));
  for (long long at = 0; at < len; at += step, c += step) {
    T yj[DL];
    load_piece<T>(y_full + (size_t)j * w.m, w.m, p, v > T(0), w.vec, yj);
    const int jn = slot_id(ids, c + step, vn > T(0));
    const T vnn = slot_val(vals, len, c + 2 * step);
    if (__any_sync(tsne::kFullMask, v > T(0))) {  // else padding
      T pa, pb;
      slot_partial<T, FWD>(w, y_full + (size_t)j * w.m, v > T(0), yj, pa,
                           pb);
      T d2;
      if constexpr (FWD)
        d2 = N::max(N::sub(N::add(w.rr, group_sum(pa, w.g)),
                           N::mul(T(2), group_sum(pb, w.g))),
                    T(0));
      else
        d2 = group_sum(pa, w.g);
      const T q = N::rcp(N::add(T(1), d2));
      if (v > T(0)) f(v, yj, q);
    }
    v = vn;
    vn = vnn;
    j = jn;
  }
}

// A lane's running sum over its slots: compensated at float32, where a
// group of many lanes a slot leaves a lane a long run of slots (all of a
// row's at 32 lanes a slot); plain at float64, whose rounding sits far
// below its bars.
template <class T>
struct PlainSum {
  T s = T(0);
  __device__ __forceinline__ void add(T x) { s = tsne::Num<T>::add(s, x); }
};
template <class T>
using LaneSum =
    std::conditional_t<std::is_same_v<T, float>, Kahan<float>, PlainSum<T>>;

// the dims of one force chunk of B3w / B5w: 32 lanes x a piece each
// (ops/attraction_cuda.wide_dims)
template <class T>
__host__ __device__ constexpr int slot_chunk_dims() {
  return 32 * Slice<T>::DL;
}

// Row i's force over the launch's chunk into the warp's buffer sh (the
// chunk's dims [base, base + n) as sh[0 .. n)): the forward part y_i·Σw −
// Σw·y_j (w = v·exag·q) and the ragged part Σ w·(y_i − y_j), each summed
// by the lanes over their own slots and then by a butterfly over the
// groups; sh takes the forward part, then forward + ragged as B5 adds
// them.  Returns n.
template <class T, bool FWD, bool RAG>
__device__ __forceinline__ int slot_row_force(
    const T* __restrict__ y_loc, const T* __restrict__ y_full,
    const int* __restrict__ ir, const T* __restrict__ vr, int w,
    const long long* __restrict__ rowptr, const int* __restrict__ dst,
    const T* __restrict__ val, int m, int i, int vec, T exag, int lane,
    T* sh, int& base) {
  using N = tsne::Num<T>;
  constexpr int DL = Slice<T>::DL;
  SlotRow<T> row;
  slot_row<T>(y_loc, i, m, blockIdx.y, vec != 0, lane, row);
  base = row.g * blockIdx.y * DL;
  const int n = min(row.g * DL, m - base);
  const int at = row.gl * DL;  // the lane's piece in the chunk
  const bool mine = row.s == 0;
  if constexpr (FWD) {
    LaneSum<T> sw, swy[DL];
    slot_walk<T, true>(row, y_full, ir + (size_t)i * w, vr + (size_t)i * w,
                       w, [&](T v, const T (&yj)[DL], T q) {
                         const T wt = N::mul(N::mul(v, exag), q);
                         sw.add(wt);
#pragma unroll
                         for (int e = 0; e < DL; ++e)
                           swy[e].add(N::mul(wt, yj[e]));
                       });
    const T swt = cross_sum(sw.s, row.g);
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const T f = N::sub(N::mul(row.yc[e], swt), cross_sum(swy[e].s, row.g));
      if (mine && at + e < n) sh[at + e] = f;
    }
  }
  if constexpr (RAG) {
    const long long e0 = rowptr[i], e1 = rowptr[i + 1];
    LaneSum<T> rag[DL];
    slot_walk<T, false>(row, y_full, dst + e0, val + e0, e1 - e0,
                        [&](T v, const T (&yj)[DL], T q) {
                          const T wt = N::mul(N::mul(v, exag), q);
#pragma unroll
                          for (int e = 0; e < DL; ++e)
                            rag[e].add(N::mul(wt, N::sub(row.yc[e], yj[e])));
                        });
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const T r = cross_sum(rag[e].s, row.g);
      if (mine && at + e < n) sh[at + e] = FWD ? N::add(sh[at + e], r) : r;
    }
  }
  __syncwarp();
  return n;
}

// the warp's force buffer: shared memory of ROWS_PER_BLOCK x
// min(m, slot_chunk_dims) values
template <class T>
__device__ __forceinline__ T* warp_buffer(int m) {
  extern __shared__ __align__(16) unsigned char slot_sh[];
  return reinterpret_cast<T*>(slot_sh) +
         (threadIdx.x >> 5) * min(m, slot_chunk_dims<T>());
}

template <class T, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS, SLOT_BLOCKS)
forces_wide_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
                   const int* __restrict__ jidx, const T* __restrict__ jval,
                   int nloc, int w, const long long* __restrict__ rowptr,
                   const int* __restrict__ dst, const T* __restrict__ val,
                   int m, int vec, T exag, T* __restrict__ att_out) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;  // whole warp
  T* sh = warp_buffer<T>(m);
  int base;
  const int n = slot_row_force<T, FWD, RAG>(y_loc, y_full, jidx, jval, w,
                                            rowptr, dst, val, m, i, vec, exag,
                                            lane, sh, base);
  for (int d = lane; d < n; d += 32) att_out[(size_t)i * m + base + d] = sh[d];
}

// B3w: as fused_step_kernel, over the launch's chunk of dims, a dim a
// lane; gsq_out [chunks, nloc] takes each chunk's ‖grad‖² partial
template <class T, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS, SLOT_BLOCKS)
fused_step_wide_kernel(const T* __restrict__ y_loc,
                       const T* __restrict__ y_full,
                       const int* __restrict__ hidx,
                       const T* __restrict__ hval, int nloc, int w,
                       const long long* __restrict__ rowptr,
                       const int* __restrict__ dst, const T* __restrict__ val,
                       int m, int vec, const int* __restrict__ order,
                       const T* __restrict__ rep, const T* __restrict__ z_ptr,
                       const T* __restrict__ mask, const T* __restrict__ upd,
                       const T* __restrict__ gains, T exag, T momentum, T eta,
                       T min_gain, T* __restrict__ y_out,
                       T* __restrict__ upd_out, T* __restrict__ gains_out,
                       T* __restrict__ gsq_out) {
  using N = tsne::Num<T>;
  const int s = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= nloc) return;  // whole warp
  const int i = order != nullptr ? order[s] : s;
  T* sh = warp_buffer<T>(m);
  int base;
  const int n = slot_row_force<T, FWD, RAG>(y_loc, y_full, hidx, hval, w,
                                            rowptr, dst, val, m, i, vec, exag,
                                            lane, sh, base);
  const T z = *z_ptr;
  const T mk = mask != nullptr ? mask[i] : T(1);
  T gsq = T(0);
  for (int d = lane; d < n; d += 32) {
    const size_t o = (size_t)i * m + base + d;
    const T att = sh[d];
    const T grad = N::mul(N::sub(att, N::div(rep[o], z)), mk);
    const T up = upd[o];
    const T g0 = gains[o];
    const T g = N::max((grad > T(0)) == (up > T(0)) ? N::mul(g0, Gain<T>::down)
                                                    : N::add(g0, Gain<T>::up),
                       min_gain);
    const T un = N::sub(N::mul(momentum, up), N::mul(N::mul(eta, g), grad));
    y_out[o] = N::add(y_loc[o], un);
    upd_out[o] = un;
    gains_out[o] = g;
    gsq = N::fma(grad, grad, gsq);
  }
  gsq = tsne::warp_sum(gsq);
  if (lane == 0) gsq_out[(size_t)blockIdx.y * nloc + i] = gsq;
}

// ---- B4w's walk: a warp a row, the lanes splitting its dims --------------
//
// B4w keeps the wide forms' first walk (B3w and B5w walk slots instead,
// above).  The lanes of a warp split a row's dimensions: lane l owns
// dimensions l + 32·g (g a group of 32), one coalesced load of y_full[j] a
// group serves the warp, and the warp walks the row's slots in order, LU
// at a time, skipping padding (value 0 adds exactly 0).  A slot's d² — the
// forward part's norm-trick terms |y_j|² and y_i·y_j, the ragged part's
// Σ(y_i − y_j)² — is a per-lane partial over the groups in order, then a
// butterfly (a fixed order: every lane holds the same bits), so each lane
// has the slot's q; the running KL sums are the same in every lane and
// compensated (Kahan).  Its contract is the narrow B4's.
constexpr int LG = 4;  // groups of 32 dims a lane keeps: 128 dims
constexpr int LU = 4;  // slots a warp takes at a time

template <class T>
struct LossRow {
  int m, ng, g0, gn;  // the width, its groups, the chunk's first and count
  const T* yi;        // the row in y_loc
  T yc[LG];           // the lane's coordinates in the chunk's groups
  T rr;               // |y_i|², the same in every lane
};

template <class T>
__device__ __forceinline__ T dim_of(const T* __restrict__ row, int m, int g,
                                    int lane) {
  const int d = 32 * g + lane;
  return d < m ? row[d] : T(0);
}

template <class T>
__device__ __forceinline__ void loss_row(const T* __restrict__ y_loc, int i,
                                         int m, int chunk, int lane,
                                         LossRow<T>& w) {
  using N = tsne::Num<T>;
  w.m = m;
  w.ng = (m + 31) / 32;
  w.g0 = chunk * LG;
  w.gn = min(LG, w.ng - w.g0);
  w.yi = y_loc + (size_t)i * m;
#pragma unroll
  for (int u = 0; u < LG; ++u)
    w.yc[u] = u < w.gn ? dim_of(w.yi, m, w.g0 + u, lane) : T(0);
  T rr = T(0);
  for (int g = 0; g < w.ng; ++g) {
    const T v = dim_of(w.yi, m, g, lane);
    rr = N::add(rr, N::mul(v, v));
  }
  w.rr = tsne::warp_sum(rr);
}

// q of LU slots (ids j, live where a slot is taken; FWD: the norm trick,
// else differences) and the chunk's groups of their points in yj
template <class T, bool FWD>
__device__ __forceinline__ void loss_slots(const LossRow<T>& w,
                                           const T* __restrict__ y_full,
                                           const int (&j)[LU],
                                           const bool (&live)[LU], int lane,
                                           T (&yj)[LU][LG], T (&q)[LU]) {
  using N = tsne::Num<T>;
  T pa[LU], pb[LU];
#pragma unroll
  for (int u = 0; u < LU; ++u) pa[u] = pb[u] = T(0);
  auto add = [&](int u, T a, T b) {
    if constexpr (FWD) {
      pa[u] = N::add(pa[u], N::mul(b, b));
      pb[u] = N::add(pb[u], N::mul(a, b));
    } else {
      const T df = N::sub(a, b);
      pa[u] = N::add(pa[u], N::mul(df, df));
    }
  };
  // the groups before the chunk, the chunk's, the groups after it: the
  // partials take g = 0 .. ng − 1 in order whatever the chunk
  for (int g = 0; g < w.g0; ++g)
#pragma unroll
    for (int u = 0; u < LU; ++u)
      if (live[u])
        add(u, dim_of(w.yi, w.m, g, lane),
            dim_of(y_full + (size_t)j[u] * w.m, w.m, g, lane));
#pragma unroll
  for (int ug = 0; ug < LG; ++ug)
#pragma unroll
    for (int u = 0; u < LU; ++u)
      yj[u][ug] = live[u] && ug < w.gn
                      ? dim_of(y_full + (size_t)j[u] * w.m, w.m, w.g0 + ug,
                               lane)
                      : T(0);
#pragma unroll
  for (int ug = 0; ug < LG; ++ug)
    if (ug < w.gn)
#pragma unroll
      for (int u = 0; u < LU; ++u)
        if (live[u]) add(u, w.yc[ug], yj[u][ug]);
  for (int g = w.g0 + w.gn; g < w.ng; ++g)
#pragma unroll
    for (int u = 0; u < LU; ++u)
      if (live[u])
        add(u, dim_of(w.yi, w.m, g, lane),
            dim_of(y_full + (size_t)j[u] * w.m, w.m, g, lane));
#pragma unroll
  for (int u = 0; u < LU; ++u) {
    T d2;
    if constexpr (FWD)
      d2 = N::max(N::sub(N::add(w.rr, tsne::warp_sum(pa[u])),
                         N::mul(T(2), tsne::warp_sum(pb[u]))),
                  T(0));
    else
      d2 = tsne::warp_sum(pa[u]);
    q[u] = N::rcp(N::add(T(1), d2));
  }
}

// Walks a part's slots [0, len) (value vals[c], id ids[c], read only where
// the value is set) in order: 32 a batch, one a lane, then the set ones LU
// at a time, each handed to f(value, its point's chunk groups, q).
template <class T, bool FWD, class F>
__device__ __forceinline__ void loss_walk(const LossRow<T>& w,
                                          const T* __restrict__ y_full,
                                          const int* __restrict__ ids,
                                          const T* __restrict__ vals,
                                          long long len, int lane, F&& f) {
  for (long long at = 0; at < len; at += 32) {
    const long long c = at + lane;
    const T v = c < len ? vals[c] : T(0);
    const int jid = v > T(0) ? ids[c] : 0;
    unsigned set = __ballot_sync(tsne::kFullMask, v > T(0));
    while (set) {
      int j[LU];
      bool live[LU];
      T vv[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        live[u] = set != 0u;
        const int src = live[u] ? __ffs((int)set) - 1 : 0;
        set &= set - 1u;
        vv[u] = __shfl_sync(tsne::kFullMask, v, src);
        j[u] = __shfl_sync(tsne::kFullMask, jid, src);
      }
      T yj[LU][LG], q[LU];
      loss_slots<T, FWD>(w, y_full, j, live, lane, yj, q);
#pragma unroll
      for (int u = 0; u < LU; ++u)
        if (live[u]) f(vv[u], yj[u], q[u]);
    }
  }
}

template <class T, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
loss_wide_kernel(const T* __restrict__ y_loc, const T* __restrict__ y_full,
                 const int* __restrict__ jidx, const T* __restrict__ jval,
                 int nloc, int w, const long long* __restrict__ rowptr,
                 const int* __restrict__ dst, const T* __restrict__ val,
                 int m, T exag, const T* __restrict__ z_ptr,
                 T* __restrict__ loss_rows) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;
  LossRow<T> row;
  loss_row<T>(y_loc, i, m, 0, lane, row);
  const T z = *z_ptr;
  Kahan<T> fwd, rag;
  if constexpr (FWD)
    loss_walk<T, true>(row, y_full, jidx + (size_t)i * w,
                       jval + (size_t)i * w, w, lane,
                       [&](T v, const T (&)[LG], T q) {
                         fwd.add(kl_term<T>(v, exag, z, q));
                       });
  if constexpr (RAG) {
    const long long e0 = rowptr[i], e1 = rowptr[i + 1];
    loss_walk<T, false>(row, y_full, dst + e0, val + e0, e1 - e0, lane,
                        [&](T v, const T (&)[LG], T q) {
                          rag.add(kl_term<T>(v, exag, z, q));
                        });
  }
  if (lane == 0)
    loss_rows[i] = FWD && RAG ? fwd.s + rag.s : FWD ? fwd.s : rag.s;
}

// the force chunks of a B3w / B5w launch (ops/attraction_cuda.wide_chunks)
template <class T>
int wide_chunks(int m) {
  return (m + slot_chunk_dims<T>() - 1) / slot_chunk_dims<T>();
}

// whether the slot walk gathers 16-byte vectors: m a multiple of a
// vector's values and both bases aligned (a row then starts aligned)
template <class T>
int slot_vec(const T* y_loc, const T* y_full, int m) {
  return m % Slice<T>::L == 0 && (uintptr_t)y_loc % 16 == 0 &&
         (uintptr_t)y_full % 16 == 0;
}

// a B3w / B5w block's force buffers (warp_buffer)
template <class T>
size_t slot_shared(int m) {
  return sizeof(T) * ROWS_PER_BLOCK * min(m, slot_chunk_dims<T>());
}

int grid_for(int nloc) { return (nloc + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

// the instance for the parts a launch has: the forward block when w > 0 or
// there is no ragged part, the ragged part when rowptr is given
template <class T, int M>
auto forces_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? forces_kernel<T, M, true, false>
         : w == 0          ? forces_kernel<T, M, false, true>
                           : forces_kernel<T, M, true, true>;
}

template <class T, int M>
auto fused_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? fused_step_kernel<T, M, true, false>
         : w == 0          ? fused_step_kernel<T, M, false, true>
                           : fused_step_kernel<T, M, true, true>;
}

template <class T, int M>
auto loss_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? loss_kernel<T, M, true, false>
         : w == 0          ? loss_kernel<T, M, false, true>
                           : loss_kernel<T, M, true, true>;
}

template <class T>
int fused_step(const T* y_loc, const T* y_full, const int* hidx,
               const T* hval, int nloc, int w, const long long* rowptr,
               const int* dst, const T* val, int m, const int* order,
               const T* rep, const T* z_ptr, const T* mask, const T* upd,
               const T* gains, T exag, T momentum, T eta, T min_gain,
               T* y_out, T* upd_out, T* gains_out, T* gsq_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return tsne::with_m(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const auto kern = fused_for<T, M>(w, rowptr);
    kern<<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, hidx, hval, nloc, w, rowptr, dst, val, order, rep,
        z_ptr, mask, upd, gains, exag, momentum, eta, min_gain, y_out,
        upd_out, gains_out, gsq_out);
    return tsne::launch_status();
  });
}

template <class T>
int attraction_loss(const T* y_loc, const T* y_full, const int* jidx,
                    const T* jval, int nloc, int w, const long long* rowptr,
                    const int* dst, const T* val, int m, T exag,
                    const T* z_ptr, T* loss_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return tsne::with_m(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const auto kern = loss_for<T, M>(w, rowptr);
    kern<<<grid_for(nloc), THREADS, 0, s>>>(y_loc, y_full, jidx, jval, nloc,
                                            w, rowptr, dst, val, exag, z_ptr,
                                            loss_rows);
    return tsne::launch_status();
  });
}

template <class T>
int attraction_forces(const T* y_loc, const T* y_full, const int* jidx,
                      const T* jval, int nloc, int w, const long long* rowptr,
                      const int* dst, const T* val, int m, T exag, T* att,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return tsne::with_m(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const auto kern = forces_for<T, M>(w, rowptr);
    kern<<<grid_for(nloc), THREADS, 0, s>>>(y_loc, y_full, jidx, jval, nloc,
                                            w, rowptr, dst, val, exag, att);
    return tsne::launch_status();
  });
}

// the wide instance for the parts a launch has, as forces_for picks it
template <class T>
auto forces_wide_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? forces_wide_kernel<T, true, false>
         : w == 0          ? forces_wide_kernel<T, false, true>
                           : forces_wide_kernel<T, true, true>;
}

template <class T>
auto fused_wide_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? fused_step_wide_kernel<T, true, false>
         : w == 0          ? fused_step_wide_kernel<T, false, true>
                           : fused_step_wide_kernel<T, true, true>;
}

template <class T>
auto loss_wide_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? loss_wide_kernel<T, true, false>
         : w == 0          ? loss_wide_kernel<T, false, true>
                           : loss_wide_kernel<T, true, true>;
}

template <class T>
int fused_step_wide(const T* y_loc, const T* y_full, const int* hidx,
                    const T* hval, int nloc, int w, const long long* rowptr,
                    const int* dst, const T* val, int m, const int* order,
                    const T* rep, const T* z_ptr, const T* mask, const T* upd,
                    const T* gains, T exag, T momentum, T eta, T min_gain,
                    T* y_out, T* upd_out, T* gains_out, T* gsq_out,
                    void* stream) {
  if (m < 1 || wide_chunks<T>(m) > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_for(nloc), wide_chunks<T>(m));
  const auto kern = fused_wide_for<T>(w, rowptr);
  kern<<<grid, THREADS, slot_shared<T>(m), (cudaStream_t)stream>>>(
      y_loc, y_full, hidx, hval, nloc, w, rowptr, dst, val, m,
      slot_vec(y_loc, y_full, m), order, rep, z_ptr, mask, upd, gains, exag,
      momentum, eta, min_gain, y_out, upd_out, gains_out, gsq_out);
  return tsne::launch_status();
}

template <class T>
int attraction_loss_wide(const T* y_loc, const T* y_full, const int* jidx,
                         const T* jval, int nloc, int w,
                         const long long* rowptr, const int* dst,
                         const T* val, int m, T exag, const T* z_ptr,
                         T* loss_rows, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const auto kern = loss_wide_for<T>(w, rowptr);
  kern<<<grid_for(nloc), THREADS, 0, (cudaStream_t)stream>>>(
      y_loc, y_full, jidx, jval, nloc, w, rowptr, dst, val, m, exag, z_ptr,
      loss_rows);
  return tsne::launch_status();
}

template <class T>
int attraction_forces_wide(const T* y_loc, const T* y_full, const int* jidx,
                           const T* jval, int nloc, int w,
                           const long long* rowptr, const int* dst,
                           const T* val, int m, T exag, T* att,
                           void* stream) {
  if (m < 1 || wide_chunks<T>(m) > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_for(nloc), wide_chunks<T>(m));
  const auto kern = forces_wide_for<T>(w, rowptr);
  kern<<<grid, THREADS, slot_shared<T>(m), (cudaStream_t)stream>>>(
      y_loc, y_full, jidx, jval, nloc, w, rowptr, dst, val, m,
      slot_vec(y_loc, y_full, m), exag, att);
  return tsne::launch_status();
}

}  // namespace

// y_loc [nloc, m] (rows of y_full [*, m]); the head block hidx/hval
// [nloc, w] int32/f32 (w may be 0); the ragged tail, or null: rowptr
// [nloc + 1] int64 into dst/val [E] int32/f32; order [nloc] int32, a
// permutation of the rows to visit them in, or null (index order);
// rep/upd/gains [nloc, m] f32; z_ptr -> the global Z (one f32 in device
// memory); mask [nloc] f32 or null.  Writes y_out/upd_out/gains_out
// [nloc, m] and gsq_out [nloc] (fresh buffers).  1 <= m <= 8.
TSNE_API int tsne_fused_step_f32(const float* y_loc, const float* y_full,
                                 const int* hidx, const float* hval, int nloc,
                                 int w, const long long* rowptr,
                                 const int* dst, const float* val, int m,
                                 const int* order, const float* rep,
                                 const float* z_ptr, const float* mask,
                                 const float* upd, const float* gains,
                                 float exag, float momentum, float eta,
                                 float min_gain, float* y_out, float* upd_out,
                                 float* gains_out, float* gsq_out,
                                 void* stream) {
  return fused_step<float>(y_loc, y_full, hidx, hval, nloc, w, rowptr, dst,
                           val, m, order, rep, z_ptr, mask, upd, gains, exag,
                           momentum, eta, min_gain, y_out, upd_out, gains_out,
                           gsq_out, stream);
}

// The float64 form of tsne_fused_step_f32: every value, plane and scalar
// float64 (the ids, the row pointer and the order as there).
TSNE_API int tsne_fused_step_f64(const double* y_loc, const double* y_full,
                                 const int* hidx, const double* hval,
                                 int nloc, int w, const long long* rowptr,
                                 const int* dst, const double* val, int m,
                                 const int* order, const double* rep,
                                 const double* z_ptr, const double* mask,
                                 const double* upd, const double* gains,
                                 double exag, double momentum, double eta,
                                 double min_gain, double* y_out,
                                 double* upd_out, double* gains_out,
                                 double* gsq_out, void* stream) {
  return fused_step<double>(y_loc, y_full, hidx, hval, nloc, w, rowptr, dst,
                            val, m, order, rep, z_ptr, mask, upd, gains,
                            exag, momentum, eta, min_gain, y_out, upd_out,
                            gains_out, gsq_out, stream);
}

// y_loc [nloc, m] (rows of y_full [*, m]); the forward block jidx/jval
// [nloc, w] int32/f32 (w may be 0); the ragged part, or null: rowptr
// [nloc + 1] int64 into dst/val [E] int32/f32, row i's edges from
// rowptr[i] to rowptr[i + 1]; z_ptr -> the global Z (one f32 in device
// memory).  Writes the per-row partial KL loss_rows [nloc]: forward +
// ragged.  1 <= m <= 8.
TSNE_API int tsne_attraction_loss_f32(const float* y_loc, const float* y_full,
                                      const int* jidx, const float* jval,
                                      int nloc, int w, const long long* rowptr,
                                      const int* dst, const float* val, int m,
                                      float exag, const float* z_ptr,
                                      float* loss_rows, void* stream) {
  return attraction_loss<float>(y_loc, y_full, jidx, jval, nloc, w, rowptr,
                                dst, val, m, exag, z_ptr, loss_rows, stream);
}

// The float64 form of tsne_attraction_loss_f32.
TSNE_API int tsne_attraction_loss_f64(const double* y_loc,
                                      const double* y_full, const int* jidx,
                                      const double* jval, int nloc, int w,
                                      const long long* rowptr, const int* dst,
                                      const double* val, int m, double exag,
                                      const double* z_ptr, double* loss_rows,
                                      void* stream) {
  return attraction_loss<double>(y_loc, y_full, jidx, jval, nloc, w, rowptr,
                                 dst, val, m, exag, z_ptr, loss_rows, stream);
}

// The same operands as tsne_attraction_loss_f32, without Z; writes the
// attraction forces att [nloc, m] (a fresh buffer): forward + ragged.
// 1 <= m <= 8.
TSNE_API int tsne_attraction_forces_f32(const float* y_loc,
                                        const float* y_full, const int* jidx,
                                        const float* jval, int nloc, int w,
                                        const long long* rowptr,
                                        const int* dst, const float* val,
                                        int m, float exag, float* att,
                                        void* stream) {
  return attraction_forces<float>(y_loc, y_full, jidx, jval, nloc, w, rowptr,
                                  dst, val, m, exag, att, stream);
}

// The float64 form of tsne_attraction_forces_f32.
TSNE_API int tsne_attraction_forces_f64(const double* y_loc,
                                        const double* y_full, const int* jidx,
                                        const double* jval, int nloc, int w,
                                        const long long* rowptr,
                                        const int* dst, const double* val,
                                        int m, double exag, double* att,
                                        void* stream) {
  return attraction_forces<double>(y_loc, y_full, jidx, jval, nloc, w,
                                   rowptr, dst, val, m, exag, att, stream);
}

// The wide forms (B3w, B4w, B5w; the wrappers send them m > 8): the
// operands of the narrow entries above, any m >= 1.  The fused step's
// gsq_out is [chunks, nloc] (tsne_attraction_wide_config): each force
// chunk's ‖grad‖² partial.
TSNE_API int tsne_fused_step_wide_f32(
    const float* y_loc, const float* y_full, const int* hidx,
    const float* hval, int nloc, int w, const long long* rowptr,
    const int* dst, const float* val, int m, const int* order,
    const float* rep, const float* z_ptr, const float* mask, const float* upd,
    const float* gains, float exag, float momentum, float eta,
    float min_gain, float* y_out, float* upd_out, float* gains_out,
    float* gsq_out, void* stream) {
  return fused_step_wide<float>(y_loc, y_full, hidx, hval, nloc, w, rowptr,
                                dst, val, m, order, rep, z_ptr, mask, upd,
                                gains, exag, momentum, eta, min_gain, y_out,
                                upd_out, gains_out, gsq_out, stream);
}

TSNE_API int tsne_fused_step_wide_f64(
    const double* y_loc, const double* y_full, const int* hidx,
    const double* hval, int nloc, int w, const long long* rowptr,
    const int* dst, const double* val, int m, const int* order,
    const double* rep, const double* z_ptr, const double* mask,
    const double* upd, const double* gains, double exag, double momentum,
    double eta, double min_gain, double* y_out, double* upd_out,
    double* gains_out, double* gsq_out, void* stream) {
  return fused_step_wide<double>(y_loc, y_full, hidx, hval, nloc, w, rowptr,
                                 dst, val, m, order, rep, z_ptr, mask, upd,
                                 gains, exag, momentum, eta, min_gain, y_out,
                                 upd_out, gains_out, gsq_out, stream);
}

TSNE_API int tsne_attraction_loss_wide_f32(
    const float* y_loc, const float* y_full, const int* jidx,
    const float* jval, int nloc, int w, const long long* rowptr,
    const int* dst, const float* val, int m, float exag, const float* z_ptr,
    float* loss_rows, void* stream) {
  return attraction_loss_wide<float>(y_loc, y_full, jidx, jval, nloc, w,
                                     rowptr, dst, val, m, exag, z_ptr,
                                     loss_rows, stream);
}

TSNE_API int tsne_attraction_loss_wide_f64(
    const double* y_loc, const double* y_full, const int* jidx,
    const double* jval, int nloc, int w, const long long* rowptr,
    const int* dst, const double* val, int m, double exag,
    const double* z_ptr, double* loss_rows, void* stream) {
  return attraction_loss_wide<double>(y_loc, y_full, jidx, jval, nloc, w,
                                      rowptr, dst, val, m, exag, z_ptr,
                                      loss_rows, stream);
}

TSNE_API int tsne_attraction_forces_wide_f32(
    const float* y_loc, const float* y_full, const int* jidx,
    const float* jval, int nloc, int w, const long long* rowptr,
    const int* dst, const float* val, int m, float exag, float* att,
    void* stream) {
  return attraction_forces_wide<float>(y_loc, y_full, jidx, jval, nloc, w,
                                       rowptr, dst, val, m, exag, att,
                                       stream);
}

TSNE_API int tsne_attraction_forces_wide_f64(
    const double* y_loc, const double* y_full, const int* jidx,
    const double* jval, int nloc, int w, const long long* rowptr,
    const int* dst, const double* val, int m, double exag, double* att,
    void* stream) {
  return attraction_forces_wide<double>(y_loc, y_full, jidx, jval, nloc, w,
                                        rowptr, dst, val, m, exag, att,
                                        stream);
}

// The wide forms' geometry at width m and dtype (float64 != 0), as the
// launches above use it: *dims the dims of one B3w / B5w force chunk (32
// lanes x a 32-byte piece: 256 at float32, 128 at float64), *chunks the
// chunks of a launch (B3w writes a ‖grad‖² partial each; the wrapper sizes
// that buffer from this).  Returns M_NARROW, the widest m with a
// register-held instance.
TSNE_API int tsne_attraction_wide_config(int m, int float64, int* dims,
                                         int* chunks) {
  *dims = float64 ? slot_chunk_dims<double>() : slot_chunk_dims<float>();
  *chunks = float64 ? wide_chunks<double>(m) : wide_chunks<float>(m);
  return tsne::M_NARROW;
}
