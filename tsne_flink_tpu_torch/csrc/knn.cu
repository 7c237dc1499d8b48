// B1 — exact self-kNN: distance tiles with an in-block running top-k.
//
// Replaces tsne_flink_tpu/ops/knn_pallas.py::_fused_kernel (launched by
// _fused_sweep, driven by fused_knn).
//
// What bounds it on an H100: the 2·N²·F multiply-adds of the distance
// tiles.  In FP32 outside the tensor cores (67 TFLOP/s at 700 W) that is
// 84 ms at N = 60,000, F = 784; the bytes (x once, [N, k] out) are noise.
// The top-k merge is ~k·log(N/k) insertions per row, far below the FMAs.
//
// Design: one block owns TR = 64 query rows and walks all column tiles of
// TC = 64 points.  Each tile is a register-blocked SGEMM (16 x 16 threads,
// 4 x 4 outputs each) over the feature axis, staged through shared memory
// in BK = 16 slices.  The 64 x 64 distance tile goes to shared memory and
// is merged at once into each row's k-list, which stays in shared memory
// for the whole sweep: no [chunk, N] block ever reaches device memory.
// One warp merges a row: a ballot finds the tile columns that beat the
// row's current worst entry, and each is inserted over that worst entry in
// column order, after which the warp re-derives the worst by a shuffle
// reduction.  Order is lexicographic on (distance, column), so ties go to
// the lower column, as lax.top_k does.  The k-list leaves unordered; the
// wrapper orders it (the _fused_final step of the TPU path).
//
// Precision: full FP32 (no TF32), the norm trick d = |a|² + |b|² − 2a·b
// clamped at 0, like ops/metrics.pairwise; cosine takes L2-normalised rows
// and computes 1 − a·b.  Row norms come in precomputed from the wrapper.
#include "common.cuh"

namespace {

constexpr int TR = 64;
constexpr int TC = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int DSTRIDE = TC + 1;

__device__ __forceinline__ bool lex_less(float d, int j, float d2, int j2) {
  return d < d2 || (d == d2 && j < j2);
}

// stage rows [base, base + 64) x features [k0, k0 + BK) transposed into
// dst[BK][64]; rows past n read as zero
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, int n,
                                           int f, int base, int k0,
                                           float* dst, int tid) {
  const int r = tid >> 2;
  const int kk = (tid & 3) * 4;
  const int g = base + r;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < n) v = *reinterpret_cast<const float4*>(x + (size_t)g * f + k0 + kk);
  dst[(kk + 0) * 64 + r] = v.x;
  dst[(kk + 1) * 64 + r] = v.y;
  dst[(kk + 2) * 64 + r] = v.z;
  dst[(kk + 3) * 64 + r] = v.w;
}

__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ x, const float* __restrict__ norms,
           int n, int f, int k, int cosine, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                    // [BK][TR]
  float* Bs = As + BK * TR;            // [BK][TC]
  float* Dt = Bs + BK * TC;            // [TR][DSTRIDE]
  float* Ld = Dt + TR * DSTRIDE;       // [TR][k] list distances
  int* Li = reinterpret_cast<int*>(Ld + TR * k);  // [TR][k] list columns
  float* Wd = reinterpret_cast<float*>(Li + TR * k);  // [TR] worst distance
  int* Wj = reinterpret_cast<int*>(Wd + TR);          // [TR] worst column
  int* Ws = Wj + TR;                                   // [TR] worst slot

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TR;

  for (int e = tid; e < TR * k; e += THREADS) {
    Ld[e] = INFINITY;
    Li[e] = INT_MAX;
  }
  for (int r = tid; r < TR; r += THREADS) {
    Wd[r] = INFINITY;
    Wj[r] = INT_MAX;
    Ws[r] = 0;
  }
  float nr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int g = row0 + ty * 4 + a;
    nr[a] = (g < n && !cosine) ? norms[g] : 0.f;
  }
  __syncthreads();

  for (int col0 = 0; col0 < n; col0 += TC) {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int k0 = 0; k0 < f; k0 += BK) {
      stage_tile(x, n, f, row0, k0, As, tid);
      stage_tile(x, n, f, col0, k0, Bs, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(As + kk * TR + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * TC + tx * 4);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx * 4 + b;
      const int gc = col0 + c;
      const float nc = (gc < n && !cosine) ? norms[gc] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
        float d = cosine ? 1.f - acc[a][b]
                         : fmaxf(nr[a] + nc - 2.f * acc[a][b], 0.f);
        if (gc >= n || gc == row0 + r) d = INFINITY;  // never a candidate
        Dt[r * DSTRIDE + c] = d;
      }
    }
    __syncthreads();

    // merge: warp w owns rows [w * 8, w * 8 + 8)
    for (int rw = 0; rw < TR / 8; ++rw) {
      const int r = warp * (TR / 8) + rw;
      if (row0 + r >= n) break;  // warp-uniform
      float wd = Wd[r];
      int wj = Wj[r];
      int ws = Ws[r];
      float* ld = Ld + r * k;
      int* li = Li + r * k;
      for (int half = 0; half < TC; half += 32) {
        const float d = Dt[r * DSTRIDE + half + lane];
        const int gc = col0 + half + lane;
        unsigned cand = __ballot_sync(tsne::kFullMask,
                                      d < INFINITY && lex_less(d, gc, wd, wj));
        while (cand) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float cd = __shfl_sync(tsne::kFullMask, d, src);
          const int cj = col0 + half + src;
          if (!lex_less(cd, cj, wd, wj)) continue;  // warp-uniform
          if (lane == 0) {
            ld[ws] = cd;
            li[ws] = cj;
          }
          __syncwarp();
          // the new worst: lexicographic max over the k slots
          float bd = -INFINITY;
          int bj = INT_MIN;
          int bs = INT_MAX;
          for (int s = lane; s < k; s += 32) {
            const float sd = ld[s];
            const int sj = li[s];
            if (lex_less(bd, bj, sd, sj)) {
              bd = sd;
              bj = sj;
              bs = s;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_xor_sync(tsne::kFullMask, bd, off);
            const int oj = __shfl_xor_sync(tsne::kFullMask, bj, off);
            const int os = __shfl_xor_sync(tsne::kFullMask, bs, off);
            if (lex_less(bd, bj, od, oj) || (od == bd && oj == bj && os < bs)) {
              bd = od;
              bj = oj;
              bs = os;
            }
          }
          wd = bd;
          wj = bj;
          ws = bs;
          __syncwarp();
        }
      }
      if (lane == 0) {
        Wd[r] = wd;
        Wj[r] = wj;
        Ws[r] = ws;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < TR * k; e += THREADS) {
    const int g = row0 + e / k;
    if (g < n) {
      out_d[(size_t)g * k + e % k] = Ld[e];
      out_i[(size_t)g * k + e % k] = Li[e];
    }
  }
}

size_t smem_bytes(int k) {
  return sizeof(float) * (BK * TR + BK * TC + TR * DSTRIDE + 2 * TR * k + 3 * TR);
}

}  // namespace

// x [n, f] f32 (f a multiple of 16, 16-byte aligned rows), norms [n] f32
// (unused for cosine), out_d/out_i [n, k]: each row's k nearest columns,
// unordered.  Requires 1 <= k <= n - 1.
TSNE_API int tsne_knn_f32(const float* x, const float* norms, int n, int f,
                          int k, int cosine, float* out_d, int* out_i,
                          void* stream) {
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TR - 1) / TR;
  knn_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, norms, n, f, k, cosine, out_d, out_i);
  return tsne::launch_status();
}

TSNE_API const char* tsne_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
