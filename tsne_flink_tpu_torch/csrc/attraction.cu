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
// from 1 to 8 (the JAX package's MPAD) is a template instance.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

// slots a lane walks a batch, per part: registers for the gathered points
// grow with m
template <int M>
__host__ __device__ constexpr int batch_for() { return M <= 4 ? 4 : 2; }

template <int M>
__device__ __forceinline__ void load_row(const float* __restrict__ y_loc,
                                         int i, float (&yc)[M], float& rr) {
  rr = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    yc[d] = y_loc[(size_t)i * M + d];
    rr = __fadd_rn(rr, __fmul_rn(yc[d], yc[d]));
  }
}

// y_full[j] into p when `take`, else zeros: one load for m = 1, 2 and 4,
// two for m = 8, 16-byte or 8-byte vectors where m allows (y_full's rows
// are then aligned: the wrapper checks the base)
template <int M>
__device__ __forceinline__ void gather(bool take,
                                       const float* __restrict__ y_full,
                                       int j, float (&p)[M]) {
#pragma unroll
  for (int d = 0; d < M; ++d) p[d] = 0.f;
  if (!take) return;
  const float* src = y_full + (size_t)j * M;
  if constexpr (M % 4 == 0) {
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
template <int M>
__device__ __forceinline__ float pair_q(const float (&yc)[M], float rr,
                                        const float (&yj)[M]) {
  float rc = 0.f, g = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    rc = __fadd_rn(rc, __fmul_rn(yj[d], yj[d]));
    g = __fadd_rn(g, __fmul_rn(yc[d], yj[d]));
  }
  const float d2 = fmaxf(__fsub_rn(__fadd_rn(rr, rc), __fmul_rn(2.f, g)),
                         0.f);
  return __frcp_rn(__fadd_rn(1.f, d2));
}

// the q = 1/(1 + Σ(y_i − y_j)²) of a ragged edge and its differences
template <int M>
__device__ __forceinline__ float edge_q(const float (&yc)[M],
                                        const float (&yj)[M],
                                        float (&diff)[M]) {
  float d2 = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    diff[d] = __fsub_rn(yc[d], yj[d]);
    d2 = __fadd_rn(d2, __fmul_rn(diff[d], diff[d]));
  }
  return __frcp_rn(__fadd_rn(1.f, d2));
}

// Walks row i's forward slots [0, w) of ir/vr (FWD) and its ragged edges
// [e0, e1) of dst/val (RAG), 32·U slots of each part a batch: every lane
// loads its U values and ids of both parts (a forward id only where its
// value is set), then gathers their points, then hands each (value,
// point) to fwd / rag in slot order.  A slot past a part's end has value
// 0, like padding: its gather is skipped and the callbacks add exactly 0
// for it.
template <int M, bool FWD, bool RAG, class Fwd, class Rag>
__device__ __forceinline__ void walk_row(const float* __restrict__ y_full,
                                         const int* __restrict__ ir,
                                         const float* __restrict__ vr, int w,
                                         const int* __restrict__ dst,
                                         const float* __restrict__ val,
                                         long long e0, long long e1, int lane,
                                         Fwd&& fwd, Rag&& rag) {
  constexpr int U = batch_for<M>();
  const long long len = RAG ? e1 - e0 : 0;
  const long long span = FWD && w > len ? (long long)w : len;
  for (long long at = 0; at < span; at += 32 * U) {
    int fj[U], rj[U];
    float fv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = at + lane + 32 * u;
      if constexpr (FWD) fv[u] = c < w ? vr[c] : 0.f;
      if constexpr (RAG) {
        const bool in = c < len;
        rv[u] = in ? val[e0 + c] : 0.f;
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
      if constexpr (FWD) fj[u] = fv[u] > 0.f ? ir[c] : 0;
    }
    float fy[U][M], ry[U][M];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (FWD) gather<M>(fv[u] > 0.f, y_full, fj[u], fy[u]);
      if constexpr (RAG) gather<M>(rv[u] > 0.f, y_full, rj[u], ry[u]);
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
template <int M, bool FWD, bool RAG>
__device__ __forceinline__ void row_forces(
    const float* __restrict__ y_full, const int* __restrict__ ir,
    const float* __restrict__ vr, int w, const int* __restrict__ dst,
    const float* __restrict__ val, long long e0, long long e1,
    const float (&yc)[M], float rr, float exag, int lane, float (&fwd)[M],
    float (&rag)[M]) {
  float sw = 0.f, swy[M];
#pragma unroll
  for (int d = 0; d < M; ++d) swy[d] = rag[d] = 0.f;
  walk_row<M, FWD, RAG>(
      y_full, ir, vr, w, dst, val, e0, e1, lane,
      [&](float v, const float (&yj)[M]) {
        const float wt = v * exag * pair_q<M>(yc, rr, yj);
        sw += wt;
#pragma unroll
        for (int d = 0; d < M; ++d) swy[d] = fmaf(wt, yj[d], swy[d]);
      },
      [&](float v, const float (&yj)[M]) {
        float diff[M];
        const float wt = __fmul_rn(__fmul_rn(v, exag), edge_q<M>(yc, yj, diff));
#pragma unroll
        for (int d = 0; d < M; ++d)
          rag[d] = __fadd_rn(rag[d], __fmul_rn(wt, diff[d]));
      });
  if constexpr (FWD) {
    sw = tsne::warp_sum(sw);
#pragma unroll
    for (int d = 0; d < M; ++d)
      fwd[d] = __fsub_rn(__fmul_rn(yc[d], sw), tsne::warp_sum(swy[d]));
  }
  if constexpr (RAG) {
#pragma unroll
    for (int d = 0; d < M; ++d) rag[d] = tsne::warp_sum(rag[d]);
  }
}

// pe·log(pe·Z/q) of one slot, 0 for padding
__device__ __forceinline__ float kl_term(float v, float exag, float z,
                                         float q) {
  const float pe = v * exag;
  return v > 0.f ? pe * logf(pe * z / q) : 0.f;
}

// B3: row order[s] (row s without an order) — its forces over the head
// block and then its ragged tail, grad = (att − rep/Z)·mask with att =
// fwd + rag as B5 adds them, then the vdM gains, the momentum update and
// y += update, and ‖grad‖² — all written by lane 0.
template <int M, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ y_loc,
                  const float* __restrict__ y_full,
                  const int* __restrict__ hidx, const float* __restrict__ hval,
                  int nloc, int w, const long long* __restrict__ rowptr,
                  const int* __restrict__ dst, const float* __restrict__ val,
                  const int* __restrict__ order,
                  const float* __restrict__ rep,
                  const float* __restrict__ z_ptr,
                  const float* __restrict__ mask,
                  const float* __restrict__ upd,
                  const float* __restrict__ gains, float exag, float momentum,
                  float eta, float min_gain, float* __restrict__ y_out,
                  float* __restrict__ upd_out, float* __restrict__ gains_out,
                  float* __restrict__ gsq_out) {
  const int s = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= nloc) return;  // whole warp
  const int i = order != nullptr ? order[s] : s;
  float yc[M], rr, fwd[M], rag[M], unused[M];
  load_row<M>(y_loc, i, yc, rr);
  // the head's walk, then the tail's: each part's sums keep their own
  // order, so this is B5's interleaved walk bit for bit, and a part's
  // batch holds only its own loads — 40 registers a thread at m = 2
  // rather than the interleaved walk's 64, so 6 blocks an SM, not 4
  if constexpr (FWD)
    row_forces<M, true, false>(y_full, hidx + (size_t)i * w,
                               hval + (size_t)i * w, w, nullptr, nullptr, 0,
                               0, yc, rr, exag, lane, fwd, unused);
  if constexpr (RAG)
    row_forces<M, false, true>(y_full, nullptr, nullptr, 0, dst, val,
                               rowptr[i], rowptr[i + 1], yc, rr, exag, lane,
                               unused, rag);
  if (lane != 0) return;
  const float z = *z_ptr;
  const float mk = mask != nullptr ? mask[i] : 1.f;
  float gsq = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    const size_t o = (size_t)i * M + d;
    const float att = FWD && RAG ? __fadd_rn(fwd[d], rag[d])
                      : FWD      ? fwd[d]
                                 : rag[d];
    const float grad = __fmul_rn(__fsub_rn(att, __fdiv_rn(rep[o], z)), mk);
    const float u = upd[o];
    const float g0 = gains[o];
    const float g = fmaxf((grad > 0.f) == (u > 0.f) ? __fmul_rn(g0, 0.8f)
                                                     : __fadd_rn(g0, 0.2f),
                          min_gain);
    const float un = __fsub_rn(__fmul_rn(momentum, u),
                               __fmul_rn(__fmul_rn(eta, g), grad));
    y_out[o] = __fadd_rn(yc[d], un);
    upd_out[o] = un;
    gains_out[o] = g;
    gsq = fmaf(grad, grad, gsq);
  }
  gsq_out[i] = gsq;
}

template <int M, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
forces_kernel(const float* __restrict__ y_loc,
              const float* __restrict__ y_full,
              const int* __restrict__ jidx, const float* __restrict__ jval,
              int nloc, int w, const long long* __restrict__ rowptr,
              const int* __restrict__ dst, const float* __restrict__ val,
              float exag, float* __restrict__ att_out) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;  // whole warp
  float yc[M], rr, fwd[M], rag[M];
  load_row<M>(y_loc, i, yc, rr);
  const long long e0 = RAG ? rowptr[i] : 0, e1 = RAG ? rowptr[i + 1] : 0;
  row_forces<M, FWD, RAG>(y_full, jidx + (size_t)i * w, jval + (size_t)i * w,
                          w, dst, val, e0, e1, yc, rr, exag, lane, fwd, rag);
  if (lane != 0) return;
#pragma unroll
  for (int d = 0; d < M; ++d)
    att_out[(size_t)i * M + d] = FWD && RAG ? __fadd_rn(fwd[d], rag[d])
                                 : FWD      ? fwd[d]
                                            : rag[d];
}

template <int M, bool FWD, bool RAG>
__global__ void __launch_bounds__(THREADS)
loss_kernel(const float* __restrict__ y_loc, const float* __restrict__ y_full,
            const int* __restrict__ jidx, const float* __restrict__ jval,
            int nloc, int w, const long long* __restrict__ rowptr,
            const int* __restrict__ dst, const float* __restrict__ val,
            float exag, const float* __restrict__ z_ptr,
            float* __restrict__ loss_rows) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;
  float yc[M], rr;
  load_row<M>(y_loc, i, yc, rr);
  const float z = *z_ptr;
  const long long e0 = RAG ? rowptr[i] : 0, e1 = RAG ? rowptr[i + 1] : 0;
  float fwd = 0.f, rag = 0.f;
  walk_row<M, FWD, RAG>(
      y_full, jidx + (size_t)i * w, jval + (size_t)i * w, w, dst, val, e0,
      e1, lane,
      [&](float v, const float (&yj)[M]) {
        fwd += kl_term(v, exag, z, pair_q<M>(yc, rr, yj));
      },
      [&](float v, const float (&yj)[M]) {
        float diff[M];
        rag += kl_term(v, exag, z, edge_q<M>(yc, yj, diff));
      });
  fwd = tsne::warp_sum(fwd);
  rag = tsne::warp_sum(rag);
  if (lane == 0)
    loss_rows[i] = FWD && RAG ? fwd + rag : FWD ? fwd : rag;
}

int grid_for(int nloc) { return (nloc + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

// the instance for the parts a launch has: the forward block when w > 0 or
// there is no ragged part, the ragged part when rowptr is given
template <int M>
auto forces_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? forces_kernel<M, true, false>
         : w == 0          ? forces_kernel<M, false, true>
                           : forces_kernel<M, true, true>;
}

template <int M>
auto fused_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? fused_step_kernel<M, true, false>
         : w == 0          ? fused_step_kernel<M, false, true>
                           : fused_step_kernel<M, true, true>;
}

template <int M>
auto loss_for(int w, const long long* rowptr) {
  return rowptr == nullptr ? loss_kernel<M, true, false>
         : w == 0          ? loss_kernel<M, false, true>
                           : loss_kernel<M, true, true>;
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
  cudaStream_t s = (cudaStream_t)stream;
  return tsne::with_m(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const auto kern = fused_for<M>(w, rowptr);
    kern<<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, hidx, hval, nloc, w, rowptr, dst, val, order, rep,
        z_ptr, mask, upd, gains, exag, momentum, eta, min_gain, y_out,
        upd_out, gains_out, gsq_out);
    return tsne::launch_status();
  });
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
  cudaStream_t s = (cudaStream_t)stream;
  return tsne::with_m(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const auto kern = loss_for<M>(w, rowptr);
    kern<<<grid_for(nloc), THREADS, 0, s>>>(y_loc, y_full, jidx, jval, nloc,
                                            w, rowptr, dst, val, exag, z_ptr,
                                            loss_rows);
    return tsne::launch_status();
  });
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
  cudaStream_t s = (cudaStream_t)stream;
  return tsne::with_m(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    const auto kern = forces_for<M>(w, rowptr);
    kern<<<grid_for(nloc), THREADS, 0, s>>>(y_loc, y_full, jidx, jval, nloc,
                                            w, rowptr, dst, val, exag, att);
    return tsne::launch_status();
  });
}
