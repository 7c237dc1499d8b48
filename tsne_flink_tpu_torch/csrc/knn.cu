// B1 — exact self-kNN: distance tiles on the tensor cores (3xTF32) with a
// running top-k merged by warps of their own.
//
// Replaces tsne_flink_tpu/ops/knn_pallas.py::_fused_kernel (launched by
// _fused_sweep, driven by fused_knn).
//
// One kernel serves two sweeps.  The single sweep takes x as its rows and
// its columns.  The cross sweep (the multi-controller ring's hop,
// parallel/knn.ring_knn, as the TPU kernel's _fused_sweep(rows, cols, nv))
// takes a row block and a column block, each with the global id of its
// first point: columns at or past n_global (mesh padding) and each row's
// own global id are masked, and the keys carry global column ids.  A
// pair's distance is computed the same way in both (the same K-loop, the
// same norm pairs of its two points), so the ring's merged top-k is the
// single sweep's, bit for bit.  A row with fewer than k unmasked columns
// in the block gets (inf, -1) in its empty slots.
//
// What bounds it on an H100: the N²·F multiply-adds of the distance tiles.
// They run as three TF32 tensor-core passes (see Precision), 3·2·N²·F
// operations at 495 TFLOP/s: 34 ms at N = 60,000, F = 784, against 84 ms
// for one FP32 pass outside the tensor cores (67 TFLOP/s).  The bytes the
// function must move (x once, [N, k] out) are noise, but a block re-reads
// every column of x from L2, so what a block keeps per byte it loads, and
// the serial top-k merge, decide how near the bound it gets.
//
// Design:
// - A block owns TR = 64 query rows and walks every column tile of TC = 128
//   points.  Eight compute warps (2 x 4, 32 x 32 outputs each) run
//   mma.sync.m16n8k8 TF32.  mma.sync rather than wgmma: TF32 wgmma needs
//   its operands in swizzled shared-memory layouts described by matrix
//   descriptors, while the split below happens on the way from shared
//   memory to the fragments, which mma.sync takes from registers; the
//   padded ring (row stride 36 floats) serves the fragments without bank
//   conflicts.
// - Feature slices of BK = 32 FP32 values stream through a ring of STAGES
//   shared-memory stages filled by cp.async (16 bytes a thread, zero-filled
//   past N and F): the next slice loads while the current one multiplies,
//   across column-tile boundaries, with one 256-thread named barrier per
//   slice.  The ring holds x itself, not its TF32 parts: splitting in
//   registers (an integer rounding, a subtraction, a rounding again)
//   halves the L2 traffic that a pre-split hi/lo pair doubled.
// - The epilogue forms d for its 32 outputs, drops every entry that does
//   not beat its row's current k-th distance (thr, kept by the merge warps),
//   writes the survivors into a distance tile Dt (DTB buffers) and flags
//   the rows that kept any.  Four merge warps, 16 rows each, merge tile t
//   while the compute warps multiply tile t + 1, visiting only the flagged
//   rows: FULL/EMPTY named barriers hand each Dt buffer over (bar.arrive by
//   the producer, bar.sync by the consumer).
// - A row's k-list is kept as 64-bit keys, (order-preserving distance bits)
//   << 32 | column, so the lexicographic (distance, column) order is one
//   integer compare: ties go to the lower column, as lax.top_k does.  While
//   a flagged row merges, its list sits in the merge warp's registers (slot
//   s·32 + lane in lane's reg[s]); the list first fills, then each survivor
//   that beats the worst replaces it in the lane that holds the worst, which
//   rescans its own slots, and two redux.sync max steps re-derive the worst.
//   The list leaves unordered; the wrapper orders it (the _fused_final step
//   of the TPU path).
// - Shared memory: the ring (28 KB a stage, with the columns' norms), Dt (34 KB a buffer) and the
//   k-lists (64·k·8 bytes) share the 227 KB a block may have, so the stage
//   and buffer counts are templated on k's class (tsne_knn_config):
//   k <= 128: 3 stages, 2 buffers; k <= 160: 2 and 2; k <= 256: 2 and 1.
// - Past k = 256 the lists of 64 rows no longer fit (64·k·8 bytes), so the
//   deep class (k <= 1,024) gives a block 16 rows: four compute warps of
//   16 x 32 outputs, one merge warp holding a row's list in 32 slots a
//   lane (16·k·8 = 128 KB at k = 1,024), a 3-stage ring (22 KB a stage)
//   and 2 Dt buffers (9 KB each).  Every column tile is then read by four
//   times as many blocks; the k <= 256 classes keep their shape and code.
// - Past k = 1,024 a lane's registers no longer hold a list (32 slots a
//   lane are already 64 registers), nor does shared memory hold 16 rows'
//   lists, so the pending class (any k) keeps each row's k-list in the
//   outputs themselves (out_d's words hold the key's upper half, the
//   distance bits, out_i the column) and gives each of its 16 rows a
//   pending area of PEND = 1,024 keys in shared memory (128 KB).  The
//   merge warp appends a flagged row's survivors (key < the row's worst,
//   warp-ballot order) to its pending area; when fewer than TC slots are
//   left, and after the last tile, it keeps the k smallest of list ∪
//   pending in the list (pending_merge): a warp radix select over the
//   same 64-bit keys, one byte a pass, finds a bound that exactly k keys
//   do not pass, the pending keys within it are compacted in order, they
//   fill the list's slots whose keys are past it, and the largest kept
//   key is the row's new worst (its distance the threshold).  The keys
//   are unique, so the kept set is the plain sweep's whatever the order
//   of the survivors; the shape, ring and buffers are the deep class's.
//
// Precision ("3xTF32"): each x splits into hi = tf32(x) and lo = tf32(x -
// hi) (ops/knn_cuda.tf32_split states the same split); each slice
// accumulates lo·hiᵀ + hi·loᵀ + hi·hiᵀ (small terms first) in FP32 on the
// tensor cores, dropping lo·loᵀ (~2^-22 relative).  The tensor cores
// truncate when they add, and a norm-trick distance cancels ~8x at F =
// 784, so one FP32 accumulator over all of F would lose to cuBLAS's FP32.
// The accumulator is therefore flushed every 32 features into a
// double-float sum (hi, lo) by an exact TwoSum, and the epilogue forms d =
// |a|² + |b|² − 2g in double-float from row norms the wrapper passes as
// (hi, lo) pairs of their float64 values, clamped at 0; cosine
// (L2-normalised rows) takes 1 − g.
//
// The bf16-operand form (mixed precision, ``--dtype bfloat16``; the TPU
// kernel's ``cast_dtype``, knn_pallas.py:81-84) is the same kernel with
// the template flag BF16: the C entry first rounds x into a bf16 copy the
// wrapper allocates (cvt.rn.bf16.f32, one pass over x), the ring stages
// bf16 tiles (a stage's 144-byte rows hold BK = 64 features instead of
// 32, so a column tile takes half the stages and barriers), and each
// 16-feature step is one mma.sync.m16n8k16 bf16 in place of the three
// TF32 passes.  A product of two bf16 values is exact in FP32, so the
// flush into double-float sums, the norms (of the unrounded x, as the
// TPU kernel's rr/rc) and everything after the product are the 3xTF32
// form's.  What bounds it: 2·N²·F at the bf16 rate (989 TFLOP/s), 5.7 ms
// at 60,000 x 784; the top-k merge does not shrink with the operands.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int TC = 128;                // columns a tile sweeps
constexpr int BK = 32;                 // 32-bit words of a staged row
constexpr int LDS = BK + 4;            // padded smem row stride (words)
constexpr int DSTRIDE = TC + 8;        // Dt row stride (floats)
constexpr int MROWS = 16;              // rows a merge warp owns

// A block's shape, by k's class: MI m16 row tiles a compute warp owns, WM
// compute warps down the rows (four across the columns), KREG k-list slots
// a merge lane holds (k <= 32·KREG), or, in the pending class (PEND > 0),
// a row's pending keys in shared memory (its k-list in the outputs).
template <int MI_, int WM_, int KREG_, int PEND_ = 0>
struct Shape {
  static constexpr int MI = MI_, WM = WM_, KREG = KREG_, PEND = PEND_;
  static constexpr int TR = 16 * MI * WM;            // rows a block owns
  static constexpr int COMPUTE = 128 * WM;           // compute threads
  static constexpr int MERGE_WARPS = TR / MROWS;
  static constexpr int THREADS = COMPUTE + 32 * MERGE_WARPS;
  static constexpr int OPER_FLOATS = (TR + TC) * LDS;  // row tile, column tile
  static constexpr int STAGE_FLOATS = OPER_FLOATS + 2 * TC;  // + col norms
  static constexpr int DT_FLOATS = TR * DSTRIDE;
};
// k <= 256: 64 rows a block, 8 compute warps of 32 x 32 outputs, 4 merge
// warps; k <= 1,024: 16 rows a block (the k-lists of 64 rows would not fit
// in shared memory), 4 compute warps of 16 x 32, 1 merge warp
using Wide = Shape<2, 2, 8>;
using Deep = Shape<1, 1, 32>;
// k > 1,024: the deep class's shape, the k-lists in the outputs and 1,024
// pending keys a row in shared memory
using Pending = Shape<1, 1, 1, 1024>;
constexpr int K_REG_MAX = 32 * Deep::KREG;  // the largest k held in registers
constexpr int BINS = 256;                   // radix-select digit: one byte

// named barriers: 0 is __syncthreads
constexpr int BAR_COMPUTE = 1;
constexpr int BAR_FULL = 2;            // + buffer
constexpr int BAR_EMPTY = 4;           // + buffer

using u64 = unsigned long long;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x -> (hi, lo): hi = tf32(x) rounded to nearest (ties away from zero),
// lo = tf32(x - hi), by integer rounding of the bits (as cvt.rna.tf32.f32
// rounds, and faster: scripts/b1_breakdown_cuda.py times both); the split
// ops/knn_cuda.tf32_split states in PyTorch
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 operands (two a 32-bit register, the lower index in the low half),
// FP32 accumulate: one pass, exact products
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x -> its bf16 rounding (nearest, ties to even), n values
__global__ void cast_bf16_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(x[i]);
}

int cast_bf16(const float* x, void* out, size_t n, cudaStream_t stream) {
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  cast_bf16_kernel<<<blocks, threads, 0, stream>>>(
      x, static_cast<__nv_bfloat16*>(out), n);
  return tsne::launch_status();
}

// (distance, column) -> a key whose unsigned order is the lexicographic one
__device__ __forceinline__ u64 make_key(float d, int j) {
  const unsigned bits = __float_as_uint(d);
  const unsigned u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(j);
}

__device__ __forceinline__ float key_dist(u64 key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 shfl64(u64 v, int src) {
  const unsigned lo = __shfl_sync(tsne::kFullMask, static_cast<unsigned>(v), src);
  const unsigned hi = __shfl_sync(tsne::kFullMask, static_cast<unsigned>(v >> 32), src);
  return (static_cast<u64>(hi) << 32) | lo;
}

// the largest key over the warp (keys are unique: columns differ)
__device__ __forceinline__ u64 warp_max(u64 v) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned mhi = __reduce_max_sync(tsne::kFullMask, hi);
  const unsigned lo = hi == mhi ? static_cast<unsigned>(v) : 0u;
  return (static_cast<u64>(mhi) << 32) | __reduce_max_sync(tsne::kFullMask, lo);
}

// a lane's largest held key and its register slot
template <int KREG>
__device__ __forceinline__ void lane_max(const u64 (&reg)[KREG], u64& lm,
                                         int& ls) {
  lm = 0;
  ls = 0;
#pragma unroll
  for (int s = 0; s < KREG; ++s)
    if (reg[s] > lm) {
      lm = reg[s];
      ls = s;
    }
}

template <int KREG>
__device__ __forceinline__ void reg_set(u64 (&reg)[KREG], int slot, u64 v) {
#pragma unroll
  for (int s = 0; s < KREG; ++s)
    if (s == slot) reg[s] = v;
}

// exact s + e = a + b (TwoSum; no products, so no FMA contraction)
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bp = s - a;
  e = (a - (s - bp)) + (b - bp);
}

// ---- the pending class's merge (both forms) --------------------------------
//
// A key of up to 96 bits, compared lexicographically: (hi, lo).  The
// float32 form's 64-bit (distance bits, column) key is hi with lo = 0 (8
// radix levels); the float64 form's is (distance bits, column) (12).
struct WKey {
  u64 hi;
  unsigned lo;
};

__device__ __forceinline__ bool wkey_le(WKey a, WKey b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo <= b.lo);
}

__device__ __forceinline__ WKey wkey_max(WKey a, WKey b) {
  return wkey_le(a, b) ? b : a;
}

// byte l of the key, the most significant first
__device__ __forceinline__ int wkey_digit(WKey a, int l) {
  return l < 8 ? (int)((a.hi >> (56 - 8 * l)) & 0xff)
               : (int)((a.lo >> (24 - 8 * (l - 8))) & 0xff);
}

// the largest key over the warp
__device__ __forceinline__ WKey warp_wkey_max(WKey v) {
  const unsigned h1 = static_cast<unsigned>(v.hi >> 32);
  const unsigned m1 = __reduce_max_sync(tsne::kFullMask, h1);
  const unsigned h0 = h1 == m1 ? static_cast<unsigned>(v.hi) : 0u;
  const unsigned m0 = __reduce_max_sync(tsne::kFullMask, h0);
  const u64 mh = (static_cast<u64>(m1) << 32) | m0;
  const unsigned m2 = __reduce_max_sync(tsne::kFullMask, v.hi == mh ? v.lo : 0u);
  return {mh, m2};
}

// The bound b such that exactly `need` of the n unique keys at(0 .. n)
// are <= b (1 <= need <= n).  A warp's radix select: one byte a pass, the
// most significant first, over a 256-bin histogram in shared memory
// (lanes adding to one bin add once, by __match_any_sync), stopping as
// soon as the chosen bin holds exactly the keys still wanted.  Every lane
// of the warp calls and gets the same bound.
template <int LEVELS, class At>
__device__ WKey warp_select(At at, int n, int need, unsigned* hist) {
  const int lane = threadIdx.x & 31;
  WKey pre{0ull, 0u}, msk{0ull, 0u};
  for (int l = 0; l < LEVELS; ++l) {
    for (int b = lane; b < BINS; b += 32) hist[b] = 0u;
    __syncwarp();
    for (int i0 = 0; i0 < n; i0 += 32) {  // the same trips in the warp
      const int i = i0 + lane;
      int bin = -1;
      if (i < n) {
        const WKey key = at(i);
        if ((key.hi & msk.hi) == pre.hi && (key.lo & msk.lo) == pre.lo)
          bin = wkey_digit(key, l);
      }
      const unsigned peers = __match_any_sync(tsne::kFullMask, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
    }
    __syncwarp();
    unsigned v[BINS / 32], sum = 0;
#pragma unroll
    for (int j = 0; j < BINS / 32; ++j) {
      v[j] = hist[lane * (BINS / 32) + j];
      sum += v[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(tsne::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    const unsigned want = static_cast<unsigned>(need);
    const bool mine = incl - sum < want && want <= incl;
    const int owner = __ffs(__ballot_sync(tsne::kFullMask, mine)) - 1;
    int dg = 0;
    unsigned below = 0, cnt = 0;
    if (mine) {
      unsigned run = incl - sum;
#pragma unroll
      for (int j = 0; j < BINS / 32; ++j) {
        if (cnt == 0 && run + v[j] >= want) {
          dg = lane * (BINS / 32) + j;
          below = run;
          cnt = v[j];
        }
        run += v[j];
      }
    }
    dg = __shfl_sync(tsne::kFullMask, dg, owner);
    below = __shfl_sync(tsne::kFullMask, below, owner);
    cnt = __shfl_sync(tsne::kFullMask, cnt, owner);
    need -= static_cast<int>(below);
    if (l < 8) {
      pre.hi |= static_cast<u64>(dg) << (56 - 8 * l);
      msk.hi |= 0xffull << (56 - 8 * l);
    } else {
      pre.lo |= static_cast<unsigned>(dg) << (24 - 8 * (l - 8));
      msk.lo |= 0xffu << (24 - 8 * (l - 8));
    }
    __syncwarp();  // the next pass rewrites hist
    if (static_cast<int>(cnt) == need) break;
  }
  return {pre.hi | ~msk.hi, pre.lo | ~msk.lo};
}

// Keep the k smallest of a row's list (cnt held keys, list.get / set) and
// its p pending keys (pend.get / set) in the list; returns the list's new
// count and, when it holds k, its largest key in `worst`.  One warp calls;
// the pending keys are compacted in place (in order), and the list's
// slots whose keys are past the bound take them in that order.
template <int LEVELS, class List, class Pend>
__device__ int pending_merge(List list, Pend pend, int cnt, int p, int k,
                             unsigned* hist, WKey& worst) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  __syncwarp();
  WKey w{0ull, 0u};
  if (cnt + p <= k) {
    for (int i = lane; i < p; i += 32) list.set(cnt + i, pend.get(i));
    cnt += p;
    if (cnt < k) {
      __syncwarp();
      return cnt;
    }
    __syncwarp();
    for (int i = lane; i < k; i += 32) w = wkey_max(w, list.get(i));
  } else {
    const WKey b = warp_select<LEVELS>(
        [&](int i) { return i < cnt ? list.get(i) : pend.get(i - cnt); },
        cnt + p, k, hist);
    int q = 0;  // the pending keys within the bound, compacted
    for (int i0 = 0; i0 < p; i0 += 32) {
      const int i = i0 + lane;
      WKey key{0ull, 0u};
      bool take = false;
      if (i < p) {
        key = pend.get(i);
        take = wkey_le(key, b);
      }
      const unsigned m = __ballot_sync(tsne::kFullMask, take);
      if (take) pend.set(q + __popc(m & below), key);
      q += __popc(m);
      __syncwarp();
    }
    int e = 0;  // the list's slots past the bound, refilled
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int i = i0 + lane;
      WKey key{0ull, 0u};
      bool out = false;
      if (i < cnt) {
        key = list.get(i);
        out = !wkey_le(key, b);
      }
      const unsigned m = __ballot_sync(tsne::kFullMask, out);
      if (out) {
        key = pend.get(e + __popc(m & below));
        list.set(i, key);
      }
      e += __popc(m);
      if (i < cnt) w = wkey_max(w, key);
    }
    for (int i = e + lane; i < q; i += 32) {  // and the rest fill cnt .. k
      const WKey key = pend.get(i);
      list.set(cnt + i - e, key);
      w = wkey_max(w, key);
    }
    cnt = k;
  }
  worst = warp_wkey_max(w);
  __syncwarp();
  return cnt;
}

// the float32 form's k-list in its outputs: out_d's word the key's upper
// half, out_i its column
struct ListF32 {
  unsigned* d;
  int* i;
  __device__ WKey get(int s) const {
    return {(static_cast<u64>(d[s]) << 32) | static_cast<unsigned>(i[s]), 0u};
  }
  __device__ void set(int s, WKey key) const {
    d[s] = static_cast<unsigned>(key.hi >> 32);
    i[s] = static_cast<int>(static_cast<unsigned>(key.hi));
  }
};

// the float32 form's pending keys in shared memory
struct PendF32 {
  u64* k;
  __device__ WKey get(int s) const { return {k[s], 0u}; }
  __device__ void set(int s, WKey key) const { k[s] = key.hi; }
};

// the two operands of a sweep: rows [nr, f] and columns [nc, f] (the same
// array in the single sweep; f32, or bf16 in the BF16 form), each with its
// norm pairs [n + 1, 2] and the global id of its first point; columns
// with global id >= n_global are masked
struct Sweep {
  const void* xr;
  const float* nr_pairs;
  int nr, r_off;
  const void* xc;
  const float* nc_pairs;
  int nc, c_off, n_global;
};

template <class T, int STAGES, int DTB, bool BF16>
__global__ void __launch_bounds__(T::THREADS, 1)
knn_kernel(const Sweep sw, int f, int k, int cosine,
           float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int MI = T::MI, KREG = T::KREG, TR = T::TR;
  constexpr int COMPUTE = T::COMPUTE, MERGE_WARPS = T::MERGE_WARPS;
  constexpr int THREADS = T::THREADS, OPER_FLOATS = T::OPER_FLOATS;
  constexpr int STAGE_FLOATS = T::STAGE_FLOATS, DT_FLOATS = T::DT_FLOATS;
  constexpr int PEND = T::PEND;
  constexpr bool BIG = PEND > 0;  // the pending class
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // [STAGES][STAGE_FLOATS]
  float* dt = ring + STAGES * STAGE_FLOATS;            // [DTB][TR][DSTRIDE]
  // [TR][k] the k-lists, or [TR][PEND] the pending keys (the pending class)
  u64* lists = reinterpret_cast<u64*>(dt + DTB * DT_FLOATS);
  u64* wkey = lists + TR * (BIG ? PEND : k);           // [TR] worst key
  int* fill = reinterpret_cast<int*>(wkey + TR);       // [TR] filled slots
  volatile float* thr = reinterpret_cast<float*>(fill + TR);  // [TR] k-th d
  unsigned* rowmask = reinterpret_cast<unsigned*>(fill + 2 * TR);
  // rowmask [DTB][MERGE_WARPS]: the rows of a Dt buffer with survivors;
  // the pending class's pending counts [TR] and histograms [MERGE_WARPS]
  // [BINS] follow it
  int* pcount = reinterpret_cast<int*>(rowmask + DTB * MERGE_WARPS);
  unsigned* hist = reinterpret_cast<unsigned*>(pcount + TR);

  // a 16-byte copy carries EPC features; a stage holds BKF of a row
  constexpr int ESZ = BF16 ? 2 : 4, EPC = 16 / ESZ, BKF = BK * 4 / ESZ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * TR;
  const int ks_per_tile = (f + BKF - 1) / BKF;
  const int tiles = (sw.nc + TC - 1) / TC;
  const int total = tiles * ks_per_tile;

  for (int r = tid; r < TR; r += THREADS) {
    wkey[r] = ~0ull;
    fill[r] = 0;
    thr[r] = INFINITY;
    if constexpr (BIG) pcount[r] = 0;
  }
  for (int e = tid; e < DTB * MERGE_WARPS; e += THREADS) rowmask[e] = 0;
  __syncthreads();

  if (tid < COMPUTE) {
    // ---------------- compute warps: products + filtering epilogue
    const int warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, tq = lane & 3;

    auto load_stage = [&](int s, int buf) {
      const int col0 = (s / ks_per_tile) * TC;
      const int kk = s % ks_per_tile;
      const int k0 = kk * BKF;
      float* st = ring + buf * STAGE_FLOATS;
      for (int c = tid; c < (TR + TC) * (BK / 4); c += COMPUTE) {
        const int row = c / (BK / 4), q = c % (BK / 4);
        const bool is_row = row < TR;
        const int gr = is_row ? row0 + row : col0 + row - TR;
        const char* src = static_cast<const char*>(is_row ? sw.xr : sw.xc);
        const int fk = k0 + q * EPC;
        const bool valid = gr < (is_row ? sw.nr : sw.nc) && fk < f;
        cp_async16(st + row * LDS + q * 4,
                   src + (valid ? ((size_t)gr * f + fk) * ESZ : 0), valid);
      }
      // the tile's last stage also brings its columns' norm pairs (16
      // bytes = two columns a copy; the pairs have a zero row past nc)
      if (kk == ks_per_tile - 1 && !cosine && tid < TC / 2) {
        const bool valid = col0 + 2 * tid < sw.nc;
        cp_async16(st + OPER_FLOATS + 4 * tid,
                   sw.nc_pairs + (valid ? 2 * ((size_t)col0 + 2 * tid) : 0),
                   valid);
      }
    };

    // this thread's 2·MI rows (m-tile i, half h) and their norms
    float nah[MI][2], nal[MI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wm * 16 * MI + i * 16 + g + 8 * h;
        const bool ok = gr < sw.nr && !cosine;
        nah[i][h] = ok ? sw.nr_pairs[2 * (size_t)gr] : 0.f;
        nal[i][h] = ok ? sw.nr_pairs[2 * (size_t)gr + 1] : 0.f;
      }

    float acc[MI][4][4], sh[MI][4][4], sl[MI][4][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = sh[i][j][e] = sl[i][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load_stage(s, s);
      cp_async_commit();
    }

    for (int s = 0; s < total; ++s) {
      cp_async_wait<STAGES - 2>();
      bar_sync(BAR_COMPUTE, COMPUTE);
      {
        const int nx = s + STAGES - 1;
        if (nx < total) load_stage(nx, nx % STAGES);
        cp_async_commit();
      }
      const float* as = ring + (s % STAGES) * STAGE_FLOATS;
      const float* bs = as + TR * LDS;
      if constexpr (BF16) {
        // each 32-bit word holds two features: a step of 8 words is one
        // m16n8k16 product, the fragments at the TF32 form's offsets
        const unsigned* au = reinterpret_cast<const unsigned*>(as);
        const unsigned* bu = reinterpret_cast<const unsigned*>(bs);
#pragma unroll
        for (int kb = 0; kb < BK; kb += 8) {
          unsigned a[MI][4], b[4][2];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int o0 = (wm * 16 * MI + i * 16 + g) * LDS + kb + tq;
            const int o1 = o0 + 8 * LDS;
            a[i][0] = au[o0];
            a[i][1] = au[o1];
            a[i][2] = au[o0 + 4];
            a[i][3] = au[o1 + 4];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = (wn * 32 + j * 8 + g) * LDS + kb + tq;
            b[j][0] = bu[o];
            b[j][1] = bu[o + 4];
          }
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
        }
      } else {
#pragma unroll
        for (int kb = 0; kb < BK; kb += 8) {
          unsigned ah[MI][4], al[MI][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const int o0 = (wm * 16 * MI + i * 16 + g) * LDS + kb + tq;
            const int o1 = o0 + 8 * LDS;
            split_tf32(as[o0], ah[i][0], al[i][0]);
            split_tf32(as[o1], ah[i][1], al[i][1]);
            split_tf32(as[o0 + 4], ah[i][2], al[i][2]);
            split_tf32(as[o1 + 4], ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = (wn * 32 + j * 8 + g) * LDS + kb + tq;
            split_tf32(bs[o], bh[j][0], bl[j][0]);
            split_tf32(bs[o + 4], bh[j][1], bl[j][1]);
          }
          // pass-major: eight independent products between two that share
          // an accumulator; each output still sums lo·hi, hi·lo, hi·hi
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
        }
      }

      // flush the stage's FP32 sums (BKF features) into the double-float
      // totals
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float hi, err;
            two_sum(sh[i][j][e], acc[i][j][e], hi, err);
            sh[i][j][e] = hi;
            sl[i][j][e] += err;
            acc[i][j][e] = 0.f;
          }
      if (s % ks_per_tile != ks_per_tile - 1) continue;

      // ---- epilogue of column tile t: filter into Dt, hand it over
      const int t = s / ks_per_tile;
      const int col0 = t * TC;
      const int buf = t % DTB;
      if (t >= DTB) bar_sync(BAR_EMPTY + buf, THREADS);
      float* d_tile = dt + buf * DT_FLOATS;
      const float* nb_tile = as + OPER_FLOATS;  // [TC][2], staged above
      unsigned live = 0;  // bit i*16 + g + 8h: row (i, h) kept an entry
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + 2 * tq;
        const float4 nb = cosine ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : *reinterpret_cast<const float4*>(nb_tile + 2 * c);
        const float nbh[2] = {nb.x, nb.z}, nbl[2] = {nb.y, nb.w};
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 16 * MI + i * 16 + g + 8 * h;
            const int gr = row0 + r;
            const float bar = thr[r];
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float gh = sh[i][j][2 * h + e], gl = sl[i][j][2 * h + e];
              float d;
              if (cosine) {
                d = (1.f - gh) - gl;
              } else {
                float s1, e1;
                two_sum(nah[i][h], nbh[e], s1, e1);
                const float s2 = s1 - 2.f * gh;
                const float lo = (e1 + (nal[i][h] + nbl[e])) - 2.f * gl;
                d = fmaxf(s2 + lo, 0.f);
              }
              d = d + 0.f;  // -0 -> +0, so the key order is the value order
              const int gc = col0 + c + e;
              const int gid = sw.c_off + gc;  // the column's global id
              const bool keep = gr < sw.nr && gc < sw.nc &&
                                gid != sw.r_off + gr && gid < sw.n_global &&
                                d <= bar;
              v[e] = keep ? d : INFINITY;
              if (keep) live |= 1u << (i * 16 + g + 8 * h);
            }
            *reinterpret_cast<float2*>(d_tile + r * DSTRIDE + c) =
                make_float2(v[0], v[1]);
          }
      }
      live = __reduce_or_sync(tsne::kFullMask, live);
      if (lane == 0) {
        // merge warp w owns rows [16w, 16w + 16): words wm·MI + i
        unsigned* word = rowmask + buf * MERGE_WARPS + wm * MI;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const unsigned bits = (live >> (16 * i)) & 0xffffu;
          if (bits) atomicOr(word + i, bits);
        }
      }
      bar_arrive(BAR_FULL + buf, THREADS);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sh[i][j][e] = sl[i][j][e] = 0.f;
    }
  } else if constexpr (BIG) {
    // ---------------- the pending class's merge warps: each flagged row's
    // survivors join its pending keys, merged into its k-list (in the
    // outputs) when fewer than TC slots are left, and after the last tile
    const int mw = (tid - COMPUTE) >> 5;
    unsigned* h = hist + mw * BINS;
    auto merge = [&](int r) {
      const size_t o = (size_t)(row0 + r) * k;
      WKey worst;
      const int cnt = pending_merge<8>(
          ListF32{reinterpret_cast<unsigned*>(out_d) + o, out_i + o},
          PendF32{lists + (size_t)r * PEND}, fill[r], pcount[r], k, h,
          worst);
      if (lane == 0) {
        fill[r] = cnt;
        pcount[r] = 0;
        if (cnt == k) {
          wkey[r] = worst.hi;
          thr[r] = key_dist(worst.hi);
        }
      }
      __syncwarp();
    };
    for (int t = 0; t < tiles; ++t) {
      const int buf = t % DTB;
      const int col0 = t * TC;
      bar_sync(BAR_FULL + buf, THREADS);
      const float* d_tile = dt + buf * DT_FLOATS;
      unsigned rows = rowmask[buf * MERGE_WARPS + mw];
      while (rows) {
        const int r = mw * MROWS + __ffs(rows) - 1;
        rows &= rows - 1;
        u64* pk = lists + (size_t)r * PEND;
        const u64 wk = wkey[r];
        int p = pcount[r];
#pragma unroll
        for (int h0 = 0; h0 < TC; h0 += 32) {
          const float d = d_tile[r * DSTRIDE + h0 + lane];
          const u64 key = make_key(d, sw.c_off + col0 + h0 + lane);
          const bool take = d < INFINITY && key < wk;
          const unsigned m = __ballot_sync(tsne::kFullMask, take);
          if (take) pk[p + __popc(m & ((1u << lane) - 1u))] = key;
          p += __popc(m);
        }
        __syncwarp();
        if (lane == 0) pcount[r] = p;
        __syncwarp();
        if (p > PEND - TC) merge(r);
      }
      __syncwarp();
      if (lane == 0) rowmask[buf * MERGE_WARPS + mw] = 0;
      if (t + DTB < tiles) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
    for (int r = mw * MROWS; r < (mw + 1) * MROWS; ++r)
      if (pcount[r] > 0) merge(r);
  } else {
    // ---------------- merge warps: fold each filtered tile into the k-lists
    const int mw = (tid - COMPUTE) >> 5;
    for (int t = 0; t < tiles; ++t) {
      const int buf = t % DTB;
      const int col0 = t * TC;
      bar_sync(BAR_FULL + buf, THREADS);
      const float* d_tile = dt + buf * DT_FLOATS;
      unsigned rows = rowmask[buf * MERGE_WARPS + mw];
      while (rows) {
        const int r = mw * MROWS + __ffs(rows) - 1;
        rows &= rows - 1;
        u64* lk = lists + (size_t)r * k;
        u64 wk = wkey[r];
        int cnt = fill[r];
        // the row's k-list in registers: slot s*32 + lane in reg[s]
        u64 reg[KREG];
#pragma unroll
        for (int s = 0; s < KREG; ++s) {
          const int slot = s * 32 + lane;
          reg[s] = slot < cnt ? lk[slot] : 0ull;
        }
        u64 lm;
        int ls;
        lane_max(reg, lm, ls);
#pragma unroll
        for (int h = 0; h < TC; h += 32) {
          const float d = d_tile[r * DSTRIDE + h + lane];
          const u64 key = make_key(d, sw.c_off + col0 + h + lane);
          unsigned cand = __ballot_sync(tsne::kFullMask, d < INFINITY && key < wk);
          while (cand) {
            const int src = __ffs(cand) - 1;
            cand &= cand - 1;
            const u64 ck = shfl64(key, src);
            if (ck >= wk) continue;  // warp-uniform
            if (cnt < k) {
              if (lane == (cnt & 31)) reg_set(reg, cnt >> 5, ck);
              if (++cnt < k) continue;
              lane_max(reg, lm, ls);
            } else if (lm == wk) {   // the lane holding the worst
              reg_set(reg, ls, ck);
              lane_max(reg, lm, ls);
            }
            wk = warp_max(lm);
          }
        }
#pragma unroll
        for (int s = 0; s < KREG; ++s) {
          const int slot = s * 32 + lane;
          if (slot < cnt) lk[slot] = reg[s];
        }
        if (lane == 0) {
          wkey[r] = wk;
          fill[r] = cnt;
          thr[r] = cnt == k ? key_dist(wk) : INFINITY;
        }
      }
      __syncwarp();
      if (lane == 0) rowmask[buf * MERGE_WARPS + mw] = 0;
      if (t + DTB < tiles) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
  }
  __syncthreads();

  if constexpr (BIG) {
    // the lists' key bits become distances; (inf, -1) past a row's held
    // slots (a cross-sweep row may have fewer than k unmasked columns)
    unsigned* ld = reinterpret_cast<unsigned*>(out_d);
    for (int e = tid; e < TR * k; e += THREADS) {
      const int g = row0 + e / k;
      if (g < sw.nr) {
        const size_t o = (size_t)g * k + e % k;
        const bool held = e % k < fill[e / k];
        ld[o] = __float_as_uint(
            held ? key_dist(static_cast<u64>(ld[o]) << 32) : INFINITY);
        if (!held) out_i[o] = -1;
      }
    }
  } else {
    for (int e = tid; e < TR * k; e += THREADS) {
      const int g = row0 + e / k;
      if (g < sw.nr) {
        // a cross-sweep row may have fewer than k unmasked columns
        const bool held = e % k < fill[e / k];
        const u64 v = lists[e];
        out_d[(size_t)g * k + e % k] = held ? key_dist(v) : INFINITY;
        out_i[(size_t)g * k + e % k] =
            held ? static_cast<int>(v & 0xffffffffu) : -1;
      }
    }
  }
}

// k's class: its shape, ring stages, Dt buffers and dynamic shared memory
struct Config {
  int rows, stages, bufs;
  size_t smem;
};

template <class T>
size_t smem_for(int stages, int bufs, int k) {
  const size_t per_row = T::PEND > 0 ? T::PEND : k;
  return sizeof(float) * ((size_t)stages * T::STAGE_FLOATS +
                          (size_t)bufs * T::DT_FLOATS) +
         sizeof(u64) * ((size_t)T::TR * per_row + T::TR) +
         sizeof(int) * 2 * T::TR +
         sizeof(unsigned) * (size_t)bufs * T::MERGE_WARPS +
         (T::PEND > 0 ? sizeof(int) * T::TR +
                            sizeof(unsigned) * T::MERGE_WARPS * BINS
                      : 0);
}

// k <= 128: 3 stages, 2 buffers; k <= 160: 2 and 2; k <= 256: 2 and 1 (64
// rows a block); k <= 1,024: 3 and 2 (16 rows a block); past it the
// pending class, 3 and 2 (16 rows a block, 1,024 pending keys a row)
Config config(int k) {
  if (k > K_REG_MAX)
    return {Pending::TR, 3, 2, smem_for<Pending>(3, 2, k)};
  if (k > 256) return {Deep::TR, 3, 2, smem_for<Deep>(3, 2, k)};
  const int stages = k <= 128 ? 3 : 2, bufs = k <= 160 ? 2 : 1;
  return {Wide::TR, stages, bufs, smem_for<Wide>(stages, bufs, k)};
}

template <class T, int STAGES, int DTB, bool BF16>
int launch(const Sweep& sw, int f, int k, int cosine, float* out_d,
           int* out_i, size_t smem, cudaStream_t stream) {
  auto kern = knn_kernel<T, STAGES, DTB, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (sw.nr + T::TR - 1) / T::TR;
  kern<<<blocks, T::THREADS, smem, stream>>>(sw, f, k, cosine, out_d, out_i);
  return tsne::launch_status();
}

template <bool BF16>
int sweep(const Sweep& sw, int f, int k, int cosine, float* out_d,
          int* out_i, cudaStream_t s) {
  const Config c = config(k);
  if (k > K_REG_MAX)
    return launch<Pending, 3, 2, BF16>(sw, f, k, cosine, out_d, out_i,
                                       c.smem, s);
  if (c.rows == Deep::TR)
    return launch<Deep, 3, 2, BF16>(sw, f, k, cosine, out_d, out_i, c.smem,
                                    s);
  if (c.stages == 3)
    return launch<Wide, 3, 2, BF16>(sw, f, k, cosine, out_d, out_i, c.smem,
                                    s);
  if (c.bufs == 2)
    return launch<Wide, 2, 2, BF16>(sw, f, k, cosine, out_d, out_i, c.smem,
                                    s);
  return launch<Wide, 2, 1, BF16>(sw, f, k, cosine, out_d, out_i, c.smem, s);
}

}  // namespace

// B1's configuration for k: writes the rows a block owns, the ring's stage
// count, the Dt buffer count and the pending keys a row (0: the k-list
// classes, whose lists a merge lane holds in registers), returns the
// dynamic shared memory in bytes.
TSNE_API int tsne_knn_config(int k, int* rows, int* stages, int* bufs,
                             int* pend) {
  const Config c = config(k);
  *rows = c.rows;
  *stages = c.stages;
  *bufs = c.bufs;
  *pend = k > K_REG_MAX ? Pending::PEND : 0;
  return (int)c.smem;
}

// x [n, f] f32 (f a multiple of 16, 16-byte aligned rows); norms [n + 1,
// 2] f32: each row's squared norm as a (hi, lo) pair, then a zero row, 16-
// byte aligned (unused for cosine);
// out_d/out_i [n, k]: each row's k nearest columns, unordered; pend is
// unused (the float32 form's pending keys live in shared memory: the
// operands are tsne_knn_f64's).  Requires 1 <= k <= n - 1.
TSNE_API int tsne_knn_f32(const float* x, const float* norms, int n, int f,
                          int k, int cosine, float* out_d, int* out_i,
                          void* pend, void* stream) {
  if (k < 1 || k > n - 1 || f % 16)
    return (int)cudaErrorInvalidValue;
  const Sweep sw{x, norms, n, 0, x, norms, n, 0, n};
  return sweep<false>(sw, f, k, cosine, out_d, out_i, (cudaStream_t)stream);
}

// The bf16-operand form of tsne_knn_f32: x is first rounded into xb [n,
// f] (bf16, 16-byte aligned, the wrapper's scratch), which the sweep
// streams; the norms are x's, unrounded.
TSNE_API int tsne_knn_bf16(const float* x, const float* norms, void* xb,
                           int n, int f, int k, int cosine, float* out_d,
                           int* out_i, void* stream) {
  if (k < 1 || k > n - 1 || f % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = cast_bf16(x, xb, (size_t)n * f, s);
  if (rc) return rc;
  const Sweep sw{xb, norms, n, 0, xb, norms, n, 0, n};
  return sweep<true>(sw, f, k, cosine, out_d, out_i, s);
}

// The cross sweep: rows xr [nr, f] (global ids r_off ..) against columns
// xc [nc, f] (global ids c_off ..), each with its norm pairs [n + 1, 2]
// as tsne_knn_f32 takes them; columns with global id >= n_global and each
// row's own id are masked.  out_d/out_i [nr, k]: each row's k nearest
// columns by (distance, global id), unordered, global ids, (inf, -1) in
// slots past a row's unmasked columns; pend unused, as tsne_knn_f32's.
// Requires k, nr, nc >= 1.
TSNE_API int tsne_knn_cross_f32(const float* xr, const float* norms_r,
                                int nr, int r_off, const float* xc,
                                const float* norms_c, int nc, int c_off,
                                int n_global, int f, int k, int cosine,
                                float* out_d, int* out_i, void* pend,
                                void* stream) {
  if (k < 1 || nr < 1 || nc < 1 || r_off < 0 || c_off < 0 ||
      f % 16)
    return (int)cudaErrorInvalidValue;
  const Sweep sw{xr, norms_r, nr, r_off, xc, norms_c, nc, c_off, n_global};
  return sweep<false>(sw, f, k, cosine, out_d, out_i, (cudaStream_t)stream);
}

// The bf16-operand form of tsne_knn_cross_f32: the blocks are first
// rounded into xbr [nr, f] and xbc [nc, f] (bf16 scratch); the norm pairs
// are the unrounded blocks'.
TSNE_API int tsne_knn_cross_bf16(const float* xr, const float* norms_r,
                                 void* xbr, int nr, int r_off,
                                 const float* xc, const float* norms_c,
                                 void* xbc, int nc, int c_off, int n_global,
                                 int f, int k, int cosine, float* out_d,
                                 int* out_i, void* stream) {
  if (k < 1 || nr < 1 || nc < 1 || r_off < 0 || c_off < 0 ||
      f % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = cast_bf16(xr, xbr, (size_t)nr * f, s);
  if (rc) return rc;
  rc = cast_bf16(xc, xbc, (size_t)nc * f, s);
  if (rc) return rc;
  const Sweep sw{xbr, norms_r, nr, r_off, xbc, norms_c, nc, c_off, n_global};
  return sweep<true>(sw, f, k, cosine, out_d, out_i, s);
}

// ---------------------------------------------------------------------------
// The float64 form (B1_f64).  Its own kernel, beside the one above: it
// shares the cp.async ring, the named barriers, the Dt hand-over and the
// flagged-row merge, but three of that kernel's choices do not carry over.
// - Products: FP64 tensor cores, mma.sync.m16n8k8 .f64 (sm_90), each
//   output accumulated in FP64 over all of F: no split, no double-float
//   flush, and the norms are plain float64 sums (one double a point, a
//   zero after the last).  d = (|a|² + |b|²) − 2g is formed in float64
//   and clamped at 0; cosine takes 1 − g.  The A/B fragments sit at the
//   TF32 m16n8k8 offsets, one double a register pair.
// - Keys: a float64 distance fills 64 bits, so a k-list entry is a pair
//   (order-preserving distance bits, column), compared lexicographically:
//   ties still go to the lower column.
// - Shared memory: pair keys (12 bytes) for 64 rows would take 64·k·12
//   bytes — 69 KB at k = 90, 196 KB at k = 256 — beside float64 stages and
//   float64 Dt buffers (70 KB each).  So the k-lists live in the outputs
//   themselves (out_d holds the key bits, out_i the columns, [nr, k]); a
//   merge warp loads a flagged row's list into its registers, merges the
//   tile, and stores it back (coalesced, L2-resident for the rows a block
//   owns).  Every k up to 1,024 then has the k <= 256 class's shape: 64
//   rows, eight compute warps of 32 x 32, four merge warps, a 2-stage
//   ring of 16 doubles a row (stride 20 doubles: the fragments' 64-bit
//   loads are conflict-free), two Dt buffers; only the registers a merge
//   lane holds (KREG slots) differ: k <= 256 and k <= 1,024.  Past k =
//   1,024 the pending class merges as the float32 form's does, with the
//   (distance bits, column) pairs as 96-bit keys (12 radix levels): no
//   room is left beside the float64 stages and Dt buffers, so a row's
//   PEND = 1,024 pending pairs live in device memory the wrapper
//   allocates ([nr, PEND] keys and columns, 12 bytes a slot).
// What bounds it: 2·N²·F at the FP64 tensor-core rate, 67 TFLOP/s: 84.25
// ms at 60,000 x 784.

namespace {

namespace f64 {

constexpr int TR = 64, MI = 2, WM = 2;
constexpr int COMPUTE = 128 * WM;                   // 8 compute warps
constexpr int MERGE_WARPS = TR / MROWS;             // 4
constexpr int THREADS = COMPUTE + 32 * MERGE_WARPS;  // 384
constexpr int BKD = 16;                             // doubles a staged row
constexpr int LDD = BKD + 4;                        // its stride (doubles)
constexpr int OPER_D = (TR + TC) * LDD;
constexpr int STAGE_D = OPER_D + TC;                // + the columns' norms
constexpr int DSD = TC + 8;                         // Dt row stride (doubles)
constexpr int DT_D = TR * DSD;
constexpr int STAGES = 2, DTB = 2;
constexpr int PEND = 1024;  // the pending class's pending pairs a row

// the dynamic shared memory; the pending class adds its pending counts
// and the merge warps' histograms
size_t smem_bytes(bool pending) {
  return sizeof(double) * ((size_t)STAGES * STAGE_D + (size_t)DTB * DT_D) +
         (sizeof(u64) + sizeof(double) + 2 * sizeof(int)) * TR +
         sizeof(unsigned) * DTB * MERGE_WARPS +
         (pending ? sizeof(int) * TR + sizeof(unsigned) * MERGE_WARPS * BINS
                  : 0);
}

// the float64 form's k-list in its outputs (key bits in out_d's words,
// columns in out_i), and its pending pairs in device memory
struct ListF64 {
  u64* d;
  int* i;
  __device__ WKey get(int s) const {
    return {d[s], static_cast<unsigned>(i[s])};
  }
  __device__ void set(int s, WKey key) const {
    d[s] = key.hi;
    i[s] = static_cast<int>(key.lo);
  }
};

struct PendF64 {
  u64* k;
  unsigned* c;
  __device__ WKey get(int s) const { return {k[s], c[s]}; }
  __device__ void set(int s, WKey key) const {
    k[s] = key.hi;
    c[s] = key.lo;
  }
};

__device__ __forceinline__ void cp_async16d(double* dst, const void* src,
                                            bool valid) {
  cp_async16(reinterpret_cast<float*>(dst), src, valid);
}

// D = A·B + D, 16 x 8 x 8 in FP64 on the tensor cores
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// a float64 distance -> bits whose unsigned order is the value order
__device__ __forceinline__ u64 dkey(double d) {
  const u64 bits = static_cast<u64>(__double_as_longlong(d));
  return (bits >> 63) ? ~bits : (bits | 0x8000000000000000ull);
}

__device__ __forceinline__ double key_dist(u64 key) {
  const u64 bits = (key >> 63) ? (key & 0x7fffffffffffffffull) : ~key;
  return __longlong_as_double(static_cast<long long>(bits));
}

// the lexicographic (distance key, column) order
__device__ __forceinline__ bool less(u64 a, unsigned ac, u64 b, unsigned bc) {
  return a < b || (a == b && ac < bc);
}

// the largest (key, column) pair over the warp
__device__ __forceinline__ void warp_max(u64 v, unsigned c, u64& mv,
                                         unsigned& mc) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned mhi = __reduce_max_sync(tsne::kFullMask, hi);
  const unsigned lo = hi == mhi ? static_cast<unsigned>(v) : 0u;
  const unsigned mlo = __reduce_max_sync(tsne::kFullMask, lo);
  mv = (static_cast<u64>(mhi) << 32) | mlo;
  mc = __reduce_max_sync(tsne::kFullMask, v == mv ? c : 0u);
}

template <int KREG>
__device__ __forceinline__ void lane_max(const u64 (&reg)[KREG],
                                         const unsigned (&col)[KREG], u64& lm,
                                         unsigned& lc, int& ls) {
  lm = 0;
  lc = 0;
  ls = 0;
#pragma unroll
  for (int s = 0; s < KREG; ++s)
    if (less(lm, lc, reg[s], col[s])) {
      lm = reg[s];
      lc = col[s];
      ls = s;
    }
}

template <int KREG>
__device__ __forceinline__ void reg_set(u64 (&reg)[KREG],
                                        unsigned (&col)[KREG], int slot, u64 v,
                                        unsigned c) {
#pragma unroll
  for (int s = 0; s < KREG; ++s)
    if (s == slot) {
      reg[s] = v;
      col[s] = c;
    }
}

// the two operands of a float64 sweep, as Sweep (norms: [n + 1] doubles)
struct Sweep64 {
  const double* xr;
  const double* nr_norms;
  int nr, r_off;
  const double* xc;
  const double* nc_norms;
  int nc, c_off, n_global;
};

// PENDING: the pending class (pend_k / pend_c [nr, PEND], the wrapper's
// scratch); otherwise KREG k-list slots a merge lane holds
template <int KREG, bool PENDING>
__global__ void __launch_bounds__(THREADS, 1)
knn_f64_kernel(const Sweep64 sw, int f, int k, int cosine, double* out_d,
               int* out_i, u64* pend_k, unsigned* pend_c) {
  extern __shared__ __align__(16) double smem64[];
  double* ring = smem64;                               // [STAGES][STAGE_D]
  double* dt = ring + STAGES * STAGE_D;                // [DTB][TR][DSD]
  u64* wkey = reinterpret_cast<u64*>(dt + DTB * DT_D);  // [TR] worst key
  volatile double* thr = reinterpret_cast<double*>(wkey + TR);  // [TR]
  unsigned* wcol = reinterpret_cast<unsigned*>(
      const_cast<double*>(thr) + TR);                  // [TR] worst column
  int* fill = reinterpret_cast<int*>(wcol + TR);       // [TR]
  unsigned* rowmask = reinterpret_cast<unsigned*>(fill + TR);
  // the pending class: pending counts [TR], histograms [MERGE_WARPS][BINS]
  int* pcount = reinterpret_cast<int*>(rowmask + DTB * MERGE_WARPS);
  unsigned* hist = reinterpret_cast<unsigned*>(pcount + TR);
  // the k-lists: out_d's words hold the key bits until the last pass
  u64* lists = reinterpret_cast<u64*>(out_d);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * TR;
  const int ks_per_tile = (f + BKD - 1) / BKD;
  const int tiles = (sw.nc + TC - 1) / TC;
  const int total = tiles * ks_per_tile;

  for (int r = tid; r < TR; r += THREADS) {
    wkey[r] = ~0ull;
    wcol[r] = ~0u;
    fill[r] = 0;
    thr[r] = INFINITY;
    if constexpr (PENDING) pcount[r] = 0;
  }
  for (int e = tid; e < DTB * MERGE_WARPS; e += THREADS) rowmask[e] = 0;
  __syncthreads();

  if (tid < COMPUTE) {
    const int warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, tq = lane & 3;

    auto load_stage = [&](int s, int buf) {
      const int col0 = (s / ks_per_tile) * TC;
      const int kk = s % ks_per_tile;
      const int k0 = kk * BKD;
      double* st = ring + buf * STAGE_D;
      for (int c = tid; c < (TR + TC) * (BKD / 2); c += COMPUTE) {
        const int row = c / (BKD / 2), q = c % (BKD / 2);
        const bool is_row = row < TR;
        const int gr = is_row ? row0 + row : col0 + row - TR;
        const double* src = is_row ? sw.xr : sw.xc;
        const int fk = k0 + 2 * q;
        const bool valid = gr < (is_row ? sw.nr : sw.nc) && fk < f;
        cp_async16d(st + row * LDD + 2 * q,
                    src + (valid ? (size_t)gr * f + fk : 0), valid);
      }
      // the tile's last stage also brings its columns' norms (two a
      // copy; the norms have a zero past nc)
      if (kk == ks_per_tile - 1 && !cosine && tid < TC / 2) {
        const bool valid = col0 + 2 * tid < sw.nc;
        cp_async16d(st + OPER_D + 2 * tid,
                    sw.nc_norms + (valid ? (size_t)col0 + 2 * tid : 0), valid);
      }
    };

    double na[MI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wm * 16 * MI + i * 16 + g + 8 * h;
        na[i][h] = gr < sw.nr && !cosine ? sw.nr_norms[gr] : 0.0;
      }

    double acc[MI][4][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load_stage(s, s);
      cp_async_commit();
    }

    for (int s = 0; s < total; ++s) {
      cp_async_wait<STAGES - 2>();
      bar_sync(BAR_COMPUTE, COMPUTE);
      {
        const int nx = s + STAGES - 1;
        if (nx < total) load_stage(nx, nx % STAGES);
        cp_async_commit();
      }
      const double* as = ring + (s % STAGES) * STAGE_D;
      const double* bs = as + TR * LDD;
#pragma unroll
      for (int kb = 0; kb < BKD; kb += 8) {
        double a[MI][4], b[4][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int o0 = (wm * 16 * MI + i * 16 + g) * LDD + kb + tq;
          const int o1 = o0 + 8 * LDD;
          a[i][0] = as[o0];
          a[i][1] = as[o1];
          a[i][2] = as[o0 + 4];
          a[i][3] = as[o1 + 4];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (wn * 32 + j * 8 + g) * LDD + kb + tq;
          b[j][0] = bs[o];
          b[j][1] = bs[o + 4];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_f64(acc[i][j], a[i], b[j]);
      }
      if (s % ks_per_tile != ks_per_tile - 1) continue;

      // ---- epilogue of column tile t: filter into Dt, hand it over
      const int t = s / ks_per_tile;
      const int col0 = t * TC;
      const int buf = t % DTB;
      if (t >= DTB) bar_sync(BAR_EMPTY + buf, THREADS);
      double* d_tile = dt + buf * DT_D;
      const double* nb_tile = as + OPER_D;  // [TC], staged above
      unsigned live = 0;  // bit i*16 + g + 8h: row (i, h) kept an entry
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + 2 * tq;
        const double2 nb = cosine ? make_double2(0.0, 0.0)
                                  : *reinterpret_cast<const double2*>(nb_tile + c);
        const double nbv[2] = {nb.x, nb.y};
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm * 16 * MI + i * 16 + g + 8 * h;
            const int gr = row0 + r;
            const double bar = thr[r];
            double v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const double gv = acc[i][j][2 * h + e];
              double d = cosine ? __dsub_rn(1.0, gv)
                                : fmax(__dsub_rn(__dadd_rn(na[i][h], nbv[e]),
                                                 __dmul_rn(2.0, gv)),
                                       0.0);
              d = d + 0.0;  // -0 -> +0, so the key order is the value order
              const int gc = col0 + c + e;
              const int gid = sw.c_off + gc;
              const bool keep = gr < sw.nr && gc < sw.nc &&
                                gid != sw.r_off + gr && gid < sw.n_global &&
                                d <= bar;
              v[e] = keep ? d : INFINITY;
              if (keep) live |= 1u << (i * 16 + g + 8 * h);
            }
            *reinterpret_cast<double2*>(d_tile + r * DSD + c) =
                make_double2(v[0], v[1]);
          }
      }
      live = __reduce_or_sync(tsne::kFullMask, live);
      if (lane == 0) {
        unsigned* word = rowmask + buf * MERGE_WARPS + wm * MI;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const unsigned bits = (live >> (16 * i)) & 0xffffu;
          if (bits) atomicOr(word + i, bits);
        }
      }
      bar_arrive(BAR_FULL + buf, THREADS);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    }
  } else if constexpr (PENDING) {
    // ---------------- the pending class's merge warps (as the float32
    // form's, over (distance bits, column) pairs)
    const int mw = (tid - COMPUTE) >> 5;
    unsigned* h = hist + mw * BINS;
    auto merge = [&](int r) {
      const size_t o = (size_t)(row0 + r) * k;
      const size_t po = (size_t)(row0 + r) * PEND;
      WKey worst;
      const int cnt = pending_merge<12>(ListF64{lists + o, out_i + o},
                                        PendF64{pend_k + po, pend_c + po},
                                        fill[r], pcount[r], k, h, worst);
      if (lane == 0) {
        fill[r] = cnt;
        pcount[r] = 0;
        if (cnt == k) {
          wkey[r] = worst.hi;
          wcol[r] = worst.lo;
          thr[r] = key_dist(worst.hi);
        }
      }
      __syncwarp();
    };
    for (int t = 0; t < tiles; ++t) {
      const int buf = t % DTB;
      const int col0 = t * TC;
      bar_sync(BAR_FULL + buf, THREADS);
      const double* d_tile = dt + buf * DT_D;
      unsigned rows = rowmask[buf * MERGE_WARPS + mw];
      while (rows) {
        const int r = mw * MROWS + __ffs(rows) - 1;
        rows &= rows - 1;
        const size_t po = (size_t)(row0 + r) * PEND;
        const u64 wk = wkey[r];
        const unsigned wc = wcol[r];
        int p = pcount[r];
#pragma unroll
        for (int h0 = 0; h0 < TC; h0 += 32) {
          const double d = d_tile[r * DSD + h0 + lane];
          const u64 key = dkey(d);
          const unsigned cid = static_cast<unsigned>(sw.c_off + col0 + h0 + lane);
          const bool take = d < INFINITY && less(key, cid, wk, wc);
          const unsigned m = __ballot_sync(tsne::kFullMask, take);
          if (take) {
            const size_t at = po + p + __popc(m & ((1u << lane) - 1u));
            pend_k[at] = key;
            pend_c[at] = cid;
          }
          p += __popc(m);
        }
        __syncwarp();
        if (lane == 0) pcount[r] = p;
        __syncwarp();
        if (p > PEND - TC) merge(r);
      }
      __syncwarp();
      if (lane == 0) rowmask[buf * MERGE_WARPS + mw] = 0;
      if (t + DTB < tiles) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
    for (int r = mw * MROWS; r < (mw + 1) * MROWS; ++r)
      if (pcount[r] > 0) merge(r);
  } else {
    // ---------------- merge warps: fold each filtered tile into the k-lists
    const int mw = (tid - COMPUTE) >> 5;
    for (int t = 0; t < tiles; ++t) {
      const int buf = t % DTB;
      const int col0 = t * TC;
      bar_sync(BAR_FULL + buf, THREADS);
      const double* d_tile = dt + buf * DT_D;
      unsigned rows = rowmask[buf * MERGE_WARPS + mw];
      while (rows) {
        const int r = mw * MROWS + __ffs(rows) - 1;
        rows &= rows - 1;
        const size_t base = (size_t)(row0 + r) * k;
        u64 wk = wkey[r];
        unsigned wc = wcol[r];
        int cnt = fill[r];
        u64 reg[KREG];
        unsigned col[KREG];
#pragma unroll
        for (int s = 0; s < KREG; ++s) {
          const int slot = s * 32 + lane;
          const bool held = slot < cnt;
          reg[s] = held ? lists[base + slot] : 0ull;
          col[s] = held ? static_cast<unsigned>(out_i[base + slot]) : 0u;
        }
        u64 lm;
        unsigned lc;
        int ls;
        lane_max(reg, col, lm, lc, ls);
#pragma unroll
        for (int h = 0; h < TC; h += 32) {
          const double d = d_tile[r * DSD + h + lane];
          const u64 key = dkey(d);
          const unsigned cid = static_cast<unsigned>(sw.c_off + col0 + h + lane);
          unsigned cand =
              __ballot_sync(tsne::kFullMask, d < INFINITY && less(key, cid, wk, wc));
          while (cand) {
            const int src = __ffs(cand) - 1;
            cand &= cand - 1;
            const u64 ck = shfl64(key, src);
            const unsigned cc = __shfl_sync(tsne::kFullMask, cid, src);
            if (!less(ck, cc, wk, wc)) continue;  // warp-uniform
            if (cnt < k) {
              if (lane == (cnt & 31)) reg_set(reg, col, cnt >> 5, ck, cc);
              if (++cnt < k) continue;
              lane_max(reg, col, lm, lc, ls);
            } else if (lm == wk && lc == wc) {  // the lane holding the worst
              reg_set(reg, col, ls, ck, cc);
              lane_max(reg, col, lm, lc, ls);
            }
            warp_max(lm, lc, wk, wc);
          }
        }
#pragma unroll
        for (int s = 0; s < KREG; ++s) {
          const int slot = s * 32 + lane;
          if (slot < cnt) {
            lists[base + slot] = reg[s];
            out_i[base + slot] = static_cast<int>(col[s]);
          }
        }
        if (lane == 0) {
          wkey[r] = wk;
          wcol[r] = wc;
          fill[r] = cnt;
          thr[r] = cnt == k ? key_dist(wk) : INFINITY;
        }
      }
      __syncwarp();
      if (lane == 0) rowmask[buf * MERGE_WARPS + mw] = 0;
      if (t + DTB < tiles) bar_arrive(BAR_EMPTY + buf, THREADS);
    }
  }
  __syncthreads();

  // the key bits become distances; (inf, -1) past a row's held slots
  for (int e = tid; e < TR * k; e += THREADS) {
    const int r = e / k, slot = e % k;
    const int g = row0 + r;
    if (g < sw.nr) {
      const size_t o = (size_t)g * k + slot;
      const bool held = slot < fill[r];
      const double d = held ? key_dist(lists[o]) : INFINITY;
      lists[o] = static_cast<u64>(__double_as_longlong(d));
      if (!held) out_i[o] = -1;
    }
  }
}

template <int KREG, bool PENDING>
int launch_f64(const Sweep64& sw, int f, int k, int cosine, double* out_d,
               int* out_i, u64* pend_k, unsigned* pend_c,
               cudaStream_t stream) {
  auto kern = knn_f64_kernel<KREG, PENDING>;
  const size_t smem = smem_bytes(PENDING);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (sw.nr + TR - 1) / TR;
  kern<<<blocks, THREADS, smem, stream>>>(sw, f, k, cosine, out_d, out_i,
                                          pend_k, pend_c);
  return tsne::launch_status();
}

// pend: the pending class's scratch, [nr, PEND] keys then [nr, PEND]
// columns (12·nr·PEND bytes, 8-byte aligned), needed past k = 1,024
int sweep(const Sweep64& sw, int f, int k, int cosine, double* out_d,
          int* out_i, void* pend, cudaStream_t s) {
  if (k <= 256)
    return launch_f64<8, false>(sw, f, k, cosine, out_d, out_i, nullptr,
                                nullptr, s);
  if (k <= K_REG_MAX)
    return launch_f64<32, false>(sw, f, k, cosine, out_d, out_i, nullptr,
                                 nullptr, s);
  if (pend == nullptr || reinterpret_cast<uintptr_t>(pend) % 8)
    return (int)cudaErrorInvalidValue;
  u64* pk = static_cast<u64*>(pend);
  unsigned* pc = reinterpret_cast<unsigned*>(pk + (size_t)sw.nr * PEND);
  return launch_f64<1, true>(sw, f, k, cosine, out_d, out_i, pk, pc, s);
}

}  // namespace f64

}  // namespace

// The float64 form of tsne_knn_f32: x [n, f] f64 (f a multiple of 16,
// 16-byte aligned rows); norms [n + 1] f64: each row's squared norm, then
// a zero, 16-byte aligned (unused for cosine); out_d [n, k] f64, out_i
// [n, k] int32: each row's k nearest columns, unordered; pend: past k =
// 1,024 the pending class's scratch ([n, 1,024] keys, then [n, 1,024]
// columns: 12 bytes a slot, 8-byte aligned), else unused.  Requires 1 <=
// k <= n - 1.
TSNE_API int tsne_knn_f64(const double* x, const double* norms, int n, int f,
                          int k, int cosine, double* out_d, int* out_i,
                          void* pend, void* stream) {
  if (k < 1 || k > n - 1 || f % 16)
    return (int)cudaErrorInvalidValue;
  const f64::Sweep64 sw{x, norms, n, 0, x, norms, n, 0, n};
  return f64::sweep(sw, f, k, cosine, out_d, out_i, pend,
                    (cudaStream_t)stream);
}

// The float64 form of tsne_knn_cross_f32 (norms as tsne_knn_f64 takes
// them; out_d f64; pend as tsne_knn_f64's, [nr, ...]).
TSNE_API int tsne_knn_cross_f64(const double* xr, const double* norms_r,
                                int nr, int r_off, const double* xc,
                                const double* norms_c, int nc, int c_off,
                                int n_global, int f, int k, int cosine,
                                double* out_d, int* out_i, void* pend,
                                void* stream) {
  if (k < 1 || nr < 1 || nc < 1 || r_off < 0 || c_off < 0 ||
      f % 16)
    return (int)cudaErrorInvalidValue;
  const f64::Sweep64 sw{xr, norms_r, nr, r_off, xc, norms_c, nc, c_off,
                        n_global};
  return f64::sweep(sw, f, k, cosine, out_d, out_i, pend,
                    (cudaStream_t)stream);
}

TSNE_API const char* tsne_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
