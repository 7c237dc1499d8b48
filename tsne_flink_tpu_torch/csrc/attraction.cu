// B3 — the fused CSR-head attraction + gains/momentum step,
// B4 — the per-row KL pass over the same head, and
// B5 — the attraction forces alone over any row layout.
//
// B3 replaces tsne_flink_tpu/ops/attraction_pallas.py::_fused_kernel
// (launched by _run_fused, driven by fused_step_update); B4 replaces
// ::_loss_kernel (launched by _run_loss, driven by attraction_loss); B5
// replaces ::_forces_kernel (launched by _run_forces, driven by
// attraction_forces: the rows layout, the blocks layout's forward block and
// the unfused CSR step).
//
// What bounds them on an H100: bytes.  Each row reads its W slots (int32
// index + f32 value: N·W·8 bytes) and a few [N, m] state planes; the ~20
// operations per slot are far below the card's rate.  The neighbour rows
// y_full[j] are gathered from a [N, m] array that stays in the 50 MB L2.
//
// Design: one warp per row.  Lanes stride the row's W slots with
// coalesced index/value loads and gather y_full[jidx] inside the kernel —
// the TPU wrapper materialises that [c, W, m] gather in device memory
// first, the port does not.  Any W runs: a wide row (the rows layout of a
// hub-heavy graph, W in the thousands) only makes each lane loop longer,
// where the TPU kernel had to hand wide rows to XLA for want of VMEM.
// The lane partials are combined by a butterfly shuffle (a fixed order).
// The arithmetic mirrors the TPU kernels operation for operation:
// norm-trick distances clamped at 0, att = y_i·Σw − Σw·y_j, and grad =
// ((att + tail) − rep/Z) · mask in that grouping.  The distances, att and
// B3's epilogue round each product and sum on their own (__fmul_rn /
// __fadd_rn: nothing is contracted into an FMA), in the order the plain
// PyTorch versions evaluate them: the norm-trick d² cancels for a spread
// embedding, and an FMA there alone moved forces by more than 2e-5.  B3
// and B5 share one head routine, so B5's forces are the bits B3 computes
// inside its step, and the unfused step (B5 + tail + the vdM update in
// PyTorch) reproduces B3's output bit for bit.  B3
// writes y, update and gains to fresh buffers, B5 its forces: other warps
// are still gathering from y_full, so an in-place y would race.  B4 reads
// the global Z from device memory (no host round trip) and writes per-row
// partials only; their sum is a fixed-order torch.sum outside.  No
// kernel here uses atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

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

// gathers yj = y_full[j] and returns the Student-t q = 1/(1 + max(d², 0))
// with d² = (|y_i|² + |y_j|²) − 2 y_i·y_j: every product and sum rounded
// on its own, in the plain version's order, so d² — which cancels badly
// for a spread embedding — carries the plain version's bits
template <int M>
__device__ __forceinline__ float pair_q(const float* __restrict__ y_full,
                                        int j, const float (&yc)[M],
                                        float rr, float (&yj)[M]) {
  float rc = 0.f, g = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    yj[d] = y_full[(size_t)j * M + d];
    rc = __fadd_rn(rc, __fmul_rn(yj[d], yj[d]));
    g = __fadd_rn(g, __fmul_rn(yc[d], yj[d]));
  }
  const float d2 = fmaxf(__fsub_rn(__fadd_rn(rr, rc), __fmul_rn(2.f, g)),
                         0.f);
  return __frcp_rn(__fadd_rn(1.f, d2));
}

// lane-partial Σw and Σw·y_j over row i's head slots; the caller reduces
template <int M>
__device__ __forceinline__ void head_pass(const float* __restrict__ y_full,
                                          const int* __restrict__ ir,
                                          const float* __restrict__ vr, int w,
                                          const float (&yc)[M], float rr,
                                          float exag, int lane, float& sw,
                                          float (&swy)[M]) {
  for (int c = lane; c < w; c += 32) {
    const float v = vr[c];
    if (!(v > 0.f)) continue;  // padding slots add exactly 0
    float yj[M];
    const float q = pair_q<M>(y_full, ir[c], yc, rr, yj);
    const float wt = v * exag * q;
    sw += wt;
#pragma unroll
    for (int d = 0; d < M; ++d) swy[d] = fmaf(wt, yj[d], swy[d]);
  }
}

// row i's head forces att = y_i·Σw − Σw·y_j, the same value in every lane
template <int M>
__device__ __forceinline__ void head_forces(const float* __restrict__ y_full,
                                            const int* __restrict__ ir,
                                            const float* __restrict__ vr,
                                            int w, const float (&yc)[M],
                                            float rr, float exag, int lane,
                                            float (&att)[M]) {
  float sw = 0.f;
  float swy[M];
#pragma unroll
  for (int d = 0; d < M; ++d) swy[d] = 0.f;
  head_pass<M>(y_full, ir, vr, w, yc, rr, exag, lane, sw, swy);
  sw = tsne::warp_sum(sw);
#pragma unroll
  for (int d = 0; d < M; ++d)
    att[d] = __fsub_rn(__fmul_rn(yc[d], sw), tsne::warp_sum(swy[d]));
}

template <int M>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(const float* __restrict__ y_loc,
                  const float* __restrict__ y_full,
                  const int* __restrict__ hidx, const float* __restrict__ hval,
                  int nloc, int w, const float* __restrict__ tail,
                  const float* __restrict__ repz,
                  const float* __restrict__ mask,
                  const float* __restrict__ upd,
                  const float* __restrict__ gains, float exag, float momentum,
                  float eta, float min_gain, float* __restrict__ y_out,
                  float* __restrict__ upd_out, float* __restrict__ gains_out,
                  float* __restrict__ gsq_out) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;  // whole warp
  float yc[M], rr, att[M];
  load_row<M>(y_loc, i, yc, rr);
  head_forces<M>(y_full, hidx + (size_t)i * w, hval + (size_t)i * w, w, yc,
                 rr, exag, lane, att);
  if (lane != 0) return;
  const float mk = mask != nullptr ? mask[i] : 1.f;
  float gsq = 0.f;
#pragma unroll
  for (int d = 0; d < M; ++d) {
    const size_t o = (size_t)i * M + d;
    const float grad = __fmul_rn(__fsub_rn(__fadd_rn(att[d], tail[o]),
                                           repz[o]), mk);
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

template <int M>
__global__ void __launch_bounds__(THREADS)
forces_kernel(const float* __restrict__ y_loc,
              const float* __restrict__ y_full,
              const int* __restrict__ jidx, const float* __restrict__ jval,
              int nloc, int w, float exag, float* __restrict__ att_out) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;  // whole warp
  float yc[M], rr, att[M];
  load_row<M>(y_loc, i, yc, rr);
  head_forces<M>(y_full, jidx + (size_t)i * w, jval + (size_t)i * w, w, yc,
                 rr, exag, lane, att);
  if (lane != 0) return;
#pragma unroll
  for (int d = 0; d < M; ++d) att_out[(size_t)i * M + d] = att[d];
}

template <int M>
__global__ void __launch_bounds__(THREADS)
loss_kernel(const float* __restrict__ y_loc, const float* __restrict__ y_full,
            const int* __restrict__ hidx, const float* __restrict__ hval,
            int nloc, int w, float exag, const float* __restrict__ z_ptr,
            float* __restrict__ loss_rows) {
  const int i = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nloc) return;
  float yc[M], rr;
  load_row<M>(y_loc, i, yc, rr);
  const float z = *z_ptr;
  const int* ir = hidx + (size_t)i * w;
  const float* vr = hval + (size_t)i * w;
  float acc = 0.f;
  for (int c = lane; c < w; c += 32) {
    const float v = vr[c];
    if (!(v > 0.f)) continue;  // padding slots add exactly 0
    float yj[M];
    const float q = pair_q<M>(y_full, ir[c], yc, rr, yj);
    const float pe = v * exag;
    acc += pe * logf(pe * z / q);
  }
  acc = tsne::warp_sum(acc);
  if (lane == 0) loss_rows[i] = acc;
}

int grid_for(int nloc) { return (nloc + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

}  // namespace

// y_loc [nloc, m] (rows of y_full [*, m]), hidx/hval [nloc, w] int32/f32,
// tail/repz/upd/gains [nloc, m] f32, mask [nloc] f32 or null; writes
// y_out/upd_out/gains_out [nloc, m] and gsq_out [nloc] (fresh buffers).
TSNE_API int tsne_fused_step_f32(const float* y_loc, const float* y_full,
                                 const int* hidx, const float* hval, int nloc,
                                 int w, int m, const float* tail,
                                 const float* repz, const float* mask,
                                 const float* upd, const float* gains,
                                 float exag, float momentum, float eta,
                                 float min_gain, float* y_out, float* upd_out,
                                 float* gains_out, float* gsq_out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 2)
    fused_step_kernel<2><<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, hidx, hval, nloc, w, tail, repz, mask, upd, gains, exag,
        momentum, eta, min_gain, y_out, upd_out, gains_out, gsq_out);
  else if (m == 3)
    fused_step_kernel<3><<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, hidx, hval, nloc, w, tail, repz, mask, upd, gains, exag,
        momentum, eta, min_gain, y_out, upd_out, gains_out, gsq_out);
  else
    return (int)cudaErrorInvalidValue;
  return tsne::launch_status();
}

// same head inputs; z_ptr -> the global Z (one f32 in device memory);
// writes the per-row partial KL loss_rows [nloc].
TSNE_API int tsne_attraction_loss_f32(const float* y_loc, const float* y_full,
                                      const int* hidx, const float* hval,
                                      int nloc, int w, int m, float exag,
                                      const float* z_ptr, float* loss_rows,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 2)
    loss_kernel<2><<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, hidx, hval, nloc, w, exag, z_ptr, loss_rows);
  else if (m == 3)
    loss_kernel<3><<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, hidx, hval, nloc, w, exag, z_ptr, loss_rows);
  else
    return (int)cudaErrorInvalidValue;
  return tsne::launch_status();
}

// y_loc [nloc, m] (rows of y_full [*, m]), jidx/jval [nloc, w] int32/f32;
// writes the attraction forces att [nloc, m] (a fresh buffer).
TSNE_API int tsne_attraction_forces_f32(const float* y_loc,
                                        const float* y_full, const int* jidx,
                                        const float* jval, int nloc, int w,
                                        int m, float exag, float* att,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 2)
    forces_kernel<2><<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, jidx, jval, nloc, w, exag, att);
  else if (m == 3)
    forces_kernel<3><<<grid_for(nloc), THREADS, 0, s>>>(
        y_loc, y_full, jidx, jval, nloc, w, exag, att);
  else
    return (int)cudaErrorInvalidValue;
  return tsne::launch_status();
}
