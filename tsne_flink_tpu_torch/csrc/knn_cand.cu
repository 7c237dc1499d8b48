// B6 — one funnel stage of a refine chunk, fused: candidate build, dedup,
// scoring, selection and (in the exact stage) the merge into the row's
// neighbour list, with every candidate kept on chip.
//
// Replaces tsne_flink_tpu/ops/knn_pallas.py::_cand_kernel (launched by
// _run_cand, driven by cand_sqdist_fused for ops/knn._cand_sqdist), and
// with it the glue of the JAX package's refine chunk around that kernel
// (tsne_flink_tpu/ops/knn.py knn_refine's one_chunk: the candidate
// concatenation and id sort, the self/duplicate masks, lax.top_k, and
// _dedup_smallest).
//
// Computes, for chunk row r (point i = row0 + r), one block each:
// 1. its candidate ids.  BUILD (a chunk's first stage): the row's 2s
//    gateways (deduped by the caller) and the first ke ids of each
//    gateway's list in the graph [n, kg], less i itself and any id at or
//    past n_valid (a mesh's padding rows: the sharded refine's base is the
//    gathered [n_padded, f] points), deduped in a shared-memory hash set.  Otherwise a list [c, w] from the previous
//    stage, in rank order, -1 where a row had fewer candidates.
// 2. their scores, d² = max((sq_i + sq_j) − 2·Σ_f base_i·base_j, 0) (the
//    TPU kernel's norm trick; sqrt for euclidean in the exact stage).
// 3. KEEP mode (a JL or cascade stage): the `keep` smallest by the 64-bit
//    key (score bits, tie), tie = the id in a BUILD stage (the plain
//    candidates are id-sorted, so a stable sort breaks ties by id) and the
//    previous stage's rank otherwise; written as ids in rank order.
//    FINAL mode (the exact stage): the k smallest by the same key (the
//    lossless pre-top-k), merged with the row's old list (old_i, old_d
//    [c, k]) keeping each id's smallest distance, ordered by (d, id) as
//    _dedup_smallest orders them; written as the row's new list.
//
// What bounds it on an H100: bytes.  The work is ~2·U·F operations a row
// (U unique candidates); what must move is the distinct rows of base the
// chunk touches (and their norms), the gateway lists, the old lists and
// the outputs: well under one operation a byte.  What sets the pace is
// the gather: each row reads its unique candidates' vectors (at the 1.3M
// x 50 shape a row's 2,416 proposals dedup to ~1,500 in the first refine
// round, ~1.2 GB a chunk of 4,096 rows), served from L2 after a shared
// row's first fetch.
// The design keeps everything else on chip: the [c, Z] candidate, score
// and mask tensors of the plain chunk never exist in device memory, and
// the id sort, masks, top-k sorts and merge sorts they fed become
// shared-memory work of the block that owns the row.
//
// Design: 256 threads a row.  The hash set has 2·Z int32 slots (linear
// probing, atomicCAS; integer atomics only); a warp appends its new ids
// with one atomicAdd.  Scoring is B6's inner loop: a group of lanes per
// candidate, each lane summing a strided part of F and a butterfly adding
// the parts — 8 lanes below F = 64 (at the 1.3M x 50 shape a row's 50
// floats in coalesced 32-byte pieces; a thread per candidate, the
// score-only kernel's mapping, took five times as long there, its loads
// scattered over 32 rows), 32 from it — two candidates a group at a time.
// Selection is a radix select of the want-th key through 256-bin
// shared-memory histograms (lanes adding to one bin add once, by
// __match_any_sync), one byte of the key a pass, stopping as soon as the
// chosen bin holds exactly the keys still wanted; the survivors are
// compacted (one atomicAdd a warp) and sorted by a bitonic sort of at
// most 8,192 keys (a keep stage's 5k at k = 1,024 rounds up to it).  The
// merge looks each new id up in the old list (in shared memory) and sorts
// old ∪ new by (d, id).  The hash set's slots
// and, after it, the sort buffer and the scores share one region.  Keys
// are unique (ids or ranks), so the result does not depend on the order
// in which threads insert or compact: every output is written once, and
// two launches give the same bits.
//
// Rounding: scores keep the score-only kernel's arithmetic — the scalar
// type's separately rounded add, subtract and multiply (tsne::Num) in the
// plain version's order (sq_i + sq_j) − 2·g, only the dot product g summed
// in another order than the plain version's, which the card's checks bound
// at rtol 2e-5 (float32) and within 1e-12 of |d| + ‖a‖² + ‖b‖² (float64).
//
// The float64 form (B6_f64, tsne_refine_chunk_f64) is the same kernel over
// the scalar type: float64 base, norms, scores and distances, every score
// rounded as the plain float64 stage rounds it and the euclidean root
// correctly rounded.  What changes with the type:
// - the key.  A float64 score has 64 order-preserving bits, so the key is
//   a (score bits, tie) pair of 16 bytes compared lexicographically, as
//   B1_f64's (distance, column) pair; −0 folds onto +0 and the bits turn
//   back into the exact double, so FINAL's distances, written from the
//   key, are the scores bit for bit.  The radix select walks 8 score bytes
//   and then up to 4 tie bytes (at most 12 passes, most rows done in 2-3);
// - the scoring lanes.  WIDE_F stays at 64 elements: below it a 32-lane
//   group would idle 14 of its lanes in a row's second and last step at
//   [large]'s F = 50, at either width, while the 8-lane group reads a row
//   in 64-byte pieces at doubles (two whole 32-byte sectors a step; one
//   at floats), so both fetch the same sectors and the narrow group keeps
//   four times the candidates in flight;
// - shared memory.  The row's vector, the scores and the keys double, so
//   the float64 layout puts the old list (the exact stage's, read only
//   after the survivors are compacted) into the candidate ids' array,
//   which is dead by then; every stage of every plan ops/knn admits (k <=
//   1,024) fits in 227 KB at both widths (tests/test_torch_f64.py).
// What bounds it is still bytes: a distinct row moves (F + 1)·8 bytes, so
// the gather, and with it the bound, doubles.
//
// The workspace route (a stage that does not fit on chip: past ~k = 1,100
// a first exact stage's 2·w·(1 + k) hash slots, or a keep stage's sort
// past 8,192 keys).  The row's vector, the histogram, the counters and
// the gateways stay in shared memory; the candidate ids, the hash set,
// the scores, the sort keys and the exact stage's old list move to a
// device-memory workspace of the chunk's rows, WsLayout bytes a row,
// allocated by the wrapper (ops/knn_cuda.refine_route states the same
// layout).  Every step is the on-chip route's, save the sort: a stable
// block-wide LSD radix sort over the key's bytes (8 passes, or 12 at
// float64; a pass whose bytes are all equal is skipped) between the keys
// and a second buffer in the workspace, of exactly the keys there are.
// The keys are unique or equal only where they are indistinguishable, so
// the result still does not depend on the order of insertion or
// compaction, and two launches give the same bits.  The workspace is read
// and written from L2 and device memory: a slower route, taken only where
// the on-chip one cannot hold the stage.
//
// The unstaged form (B6u, B6u_f64: tsne_refine_chunk_unstaged_f32/_f64),
// for rows wider than STAGED_F_MAX = 12,288 values, where the staged
// form's row vector (rvec: 48 KB at float32, 96 KB at float64 at that
// width) no longer fits beside the stage's other arrays.
// What bounds it: bytes.  At 68,579 x 32,738 raw counts (k = 90) a
// 4,096-row exact-stage chunk scores 4,096 x 270 pairs whose candidates
// are 48,140 distinct rows of 131 KB: 6.30 GB, 1.885 ms at 3.35 TB/s.  A
// design that scores a pair at a time over its whole row (as the staged
// form does) makes the chunk's resident pairs touch ~1,000 rows of 131
// KB at once, far past the 50 MB L2, so each pair reads its candidate
// from device memory: 144.8 GB a chunk, each distinct row ~23 times.
// The design: three launches a stage, each reading only what it needs.
// - The build pass (a first stage only): refine_kernel with
//   Workspace::build_only builds the rows' candidates as the staged form
//   does and writes them, and their count, to the row's Scratch.
// - The score pass (score_kernel): one wave of blocks, every block
//   resident at once, each owning a contiguous run of the chunk's rows
//   and every pair of them, walks F in slabs of SLAB_BYTES (64 floats, 32
//   doubles) in the same order: a slab of the block's rows is staged in
//   shared memory, a warp reads a candidate's slab at once (one 8-byte
//   load a lane where the rows allow it) for 8 pairs at a time, and one
//   transposing butterfly sums the 8 pairs' products over the lanes; the
//   pair's running sum, a double, is kept in the block's shared memory
//   (or, past 64 KB of them, in the Scratch).  At one time the card
//   holds a slab or two of the chunk's distinct candidates (48,140 x 256
//   B = 12.3 MB) beside the rows' slab (1 MB): all of it in L2, so each
//   candidate row's bytes come from device memory once a chunk, and every
//   later pair reads them from L2 (counted: 6.30 GB of rows + 0.54 GB of
//   the chunk rows' slabs + ~0.02 GB of scores a chunk, against 144.8
//   GB).  After the last slab the pair's score is formed as the staged
//   form forms it,
//   combine(sq_i, sq_j, g) (sqrt for euclidean in the exact stage), with
//   g the double sum rounded once to the scalar type.
// - The select pass: refine_kernel with STAGED = false reads the
//   candidates (the list, or the build pass's) and the scores from the
//   Scratch and selects and merges exactly as the staged form does, on
//   chip or on the workspace route by what its arrays need (Layout and
//   WsLayout hold no rvec).
// A pair's score is the same operations in the same order whatever chunk
// or block it lands in, so a row's outputs do not depend on the chunk,
// and two launches give the same bits.  The summation order is not the
// staged form's, so at a width both take the two forms agree to the B6
// bars and in their ids outside ties, not bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WIDE_F = 64;          // from this F on, a warp scores one candidate
constexpr int NARROW_LANES = 8;     // lanes a candidate below WIDE_F
constexpr int SORT_MAX = 8192;      // keys a row sorts: keep, or 2k in FINAL mode
constexpr int BINS = 256;           // radix-select digit: one byte
constexpr size_t SMEM_MAX = 232448; // what a block may opt in to on sm_90
constexpr int STAGED_F_MAX = 12288; // the widest row the staged form keeps
constexpr int SLAB_BYTES = 256;     // the unstaged form's score pass: a slab
constexpr int SCORE_LANES = 8;      // lanes a pair in the score pass

template <class T>
struct Params {
  const T* base;      // [n, f]
  const T* sq;        // [n] squared norms
  int n, f, row0, c;
  const int* cand;    // BUILD: gateways [c, w]; else ids [c, w], -1 = none
  int w;
  const int* graph;   // BUILD: [n, kg]
  int kg, ke;
  int keep;           // KEEP mode: survivors a row
  const int* old_i;   // FINAL mode: [c, k]
  const T* old_d;
  int k, euclid;
  int n_valid;        // BUILD: ids >= n_valid are no candidates
  int* out_i;         // KEEP: [c, keep]; FINAL: [c, k]
  T* out_d;           // FINAL: [c, k]
};

// The workspace route's device memory: ``row`` bytes for each of the c
// rows (a kernel argument of its own, after Params, which the on-chip
// route leaves unread); the unstaged form's Scratch, ``srow`` bytes a row,
// and its build pass
struct Workspace {
  unsigned char* base;
  size_t row;
  unsigned char* scratch;
  size_t srow;
  int build_only;
};

// The selection key of a score and its tie, ordered as (score, tie): one
// 64-bit word of 32 order-preserving score bits above the tie (float32),
// or a 16-byte (64 score bits, tie) pair compared lexicographically
// (float64).  Scores fold −0 onto +0 and come back from the key exactly.
template <class T>
struct KeyOps;

template <>
struct KeyOps<float> {
  using Key = unsigned long long;
  static constexpr int BYTES = 8;  // radix-select passes at most
  static __device__ __forceinline__ Key none() { return ~0ull; }
  static __device__ __forceinline__ Key make(float v, unsigned tie) {
    const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
    const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)o << 32) | tie;
  }
  static __device__ __forceinline__ float score(Key key) {
    const unsigned o = (unsigned)(key >> 32);
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  }
  static __device__ __forceinline__ unsigned tie(Key key) {
    return (unsigned)key;
  }
  static __device__ __forceinline__ bool greater(Key a, Key b) {
    return a > b;
  }
  // byte b of the key, the most significant first
  static __device__ __forceinline__ int digit(Key key, int b) {
    return (int)((key >> (56 - 8 * b)) & 0xff);
  }
  static __device__ __forceinline__ void set_digit(Key& prefix, Key& mask,
                                                   int b, int d) {
    prefix |= (Key)d << (56 - 8 * b);
    mask |= 0xffull << (56 - 8 * b);
  }
  static __device__ __forceinline__ bool masked_eq(Key key, Key mask,
                                                   Key prefix) {
    return (key & mask) == prefix;
  }
  static __device__ __forceinline__ bool masked_le(Key key, Key mask,
                                                   Key prefix) {
    return (key & mask) <= prefix;
  }
};

struct __align__(16) Key16 {
  unsigned long long s;  // the score's order-preserving bits
  unsigned t;            // the tie
  unsigned pad;
};

template <>
struct KeyOps<double> {
  using Key = Key16;
  static constexpr int BYTES = 12;
  static constexpr unsigned long long SIGN = 0x8000000000000000ull;
  static __device__ __forceinline__ Key none() { return {~0ull, ~0u, 0u}; }
  static __device__ __forceinline__ Key make(double v, unsigned tie) {
    const unsigned long long u =
        (unsigned long long)__double_as_longlong(__dadd_rn(v, 0.0));
    return {(u & SIGN) ? ~u : (u | SIGN), tie, 0u};
  }
  static __device__ __forceinline__ double score(Key key) {
    const unsigned long long o = key.s;
    return __longlong_as_double((long long)((o & SIGN) ? (o & ~SIGN) : ~o));
  }
  static __device__ __forceinline__ unsigned tie(Key key) { return key.t; }
  static __device__ __forceinline__ bool greater(Key a, Key b) {
    return a.s > b.s || (a.s == b.s && a.t > b.t);
  }
  static __device__ __forceinline__ int digit(Key key, int b) {
    return b < 8 ? (int)((key.s >> (56 - 8 * b)) & 0xff)
                 : (int)((key.t >> (24 - 8 * (b - 8))) & 0xff);
  }
  static __device__ __forceinline__ void set_digit(Key& prefix, Key& mask,
                                                   int b, int d) {
    if (b < 8) {
      prefix.s |= (unsigned long long)d << (56 - 8 * b);
      mask.s |= 0xffull << (56 - 8 * b);
    } else {
      prefix.t |= (unsigned)d << (24 - 8 * (b - 8));
      mask.t |= 0xffu << (24 - 8 * (b - 8));
    }
  }
  static __device__ __forceinline__ bool masked_eq(Key key, Key mask,
                                                   Key prefix) {
    return (key.s & mask.s) == prefix.s && (key.t & mask.t) == prefix.t;
  }
  static __device__ __forceinline__ bool masked_le(Key key, Key mask,
                                                   Key prefix) {
    const unsigned long long s = key.s & mask.s;
    return s < prefix.s || (s == prefix.s && (key.t & mask.t) <= prefix.t);
  }
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The block's dynamic shared memory, byte offsets of each array.  The
// float64 form keeps the old list (FINAL mode) in the ids' array, which
// is read for the last time before the old list is loaded.  The unstaged
// form (staged false) holds no row vector.
template <class T>
struct Layout {
  static constexpr bool OLD_IN_IDS = sizeof(T) == 8;
  int zcap, hsize, sortcap;
  size_t rvec, ids, hist, misc, gates, oi, od, region, scores, bytes;
  __host__ __device__ Layout(const Params<T>& p, bool build, bool fin,
                             bool staged) {
    zcap = build ? p.w * (1 + p.ke) : p.w;
    hsize = build ? 2 * zcap : 0;
    sortcap = pow2_at_least(fin ? 2 * p.k : p.keep);
    const size_t oi_bytes = fin ? align16(sizeof(int) * p.k) : 0;
    const size_t od_bytes = fin ? align16(sizeof(T) * p.k) : 0;
    size_t id_bytes = sizeof(int) * (size_t)zcap;
    if (OLD_IN_IDS && oi_bytes + od_bytes > id_bytes)
      id_bytes = oi_bytes + od_bytes;
    size_t at = 0;
    rvec = at;   at += staged ? align16(sizeof(T) * p.f) : 0;
    ids = at;    at += align16(id_bytes);
    hist = at;   at += align16(sizeof(int) * BINS);
    misc = at;   at += align16(sizeof(int) * 8);
    gates = at;  at += build ? align16(sizeof(int) * p.w) : 0;
    if (OLD_IN_IDS) {
      oi = ids;
      od = ids + oi_bytes;
    } else {
      oi = at;   at += oi_bytes;
      od = at;   at += od_bytes;
    }
    // the region: the hash set while the candidates are built, then the
    // sort buffer (keys) followed by the scores
    region = at;
    const size_t sort =
        sizeof(typename KeyOps<T>::Key) * (size_t)sortcap;
    scores = region + sort;
    const size_t table = sizeof(int) * (size_t)hsize;
    const size_t after = sort + sizeof(T) * (size_t)zcap;
    at += align16(table > after ? table : after);
    bytes = at;
  }
};

// The workspace route's layout: in shared memory the row's vector (the
// staged form), the histogram, the counters, the gateways (a first stage)
// and the radix sort's per-warp digit counts; in the row's workspace the
// candidate ids, the old list (the exact stage), and one region that holds
// the hash set while the candidates are built, then the sort keys, the
// sort's second buffer and the scores.
template <class T>
struct WsLayout {
  int zcap, hsize, nsort;
  size_t rvec, hist, misc, gates, wcnt, bytes;     // shared memory
  size_t ids, oi, od, region, keys2, scores, row;  // the row's workspace
  __host__ __device__ WsLayout(const Params<T>& p, bool build, bool fin,
                               bool staged) {
    using Key = typename KeyOps<T>::Key;
    zcap = build ? p.w * (1 + p.ke) : p.w;
    hsize = build ? 2 * zcap : 0;
    nsort = fin ? 2 * p.k : p.keep;
    size_t at = 0;
    rvec = at;   at += staged ? align16(sizeof(T) * p.f) : 0;
    hist = at;   at += align16(sizeof(int) * BINS);
    misc = at;   at += align16(sizeof(int) * 8);
    gates = at;  at += build ? align16(sizeof(int) * p.w) : 0;
    wcnt = at;   at += align16(sizeof(int) * (THREADS / 32) * BINS);
    bytes = at;
    at = 0;
    ids = at;    at += align16(sizeof(int) * (size_t)zcap);
    oi = at;     at += fin ? align16(sizeof(int) * p.k) : 0;
    od = at;     at += fin ? align16(sizeof(T) * p.k) : 0;
    region = at;
    const size_t sort = align16(sizeof(Key) * (size_t)nsort);
    keys2 = region + sort;
    scores = keys2 + sort;
    const size_t table = sizeof(int) * (size_t)hsize;
    const size_t after = 2 * sort + sizeof(T) * (size_t)zcap;
    at += align16(table > after ? table : after);
    row = at;
  }
};

// The unstaged form's device memory for each chunk row: the count and
// ids of a first stage's candidates (its build pass writes them), the
// score pass's running sums (double) and the finished scores.
template <class T>
struct Scratch {
  size_t cnt, ids, acc, scores, bytes;
  __host__ __device__ Scratch(int w, int ke, bool build) {
    const size_t zcap = build ? (size_t)w * (1 + ke) : (size_t)w;
    size_t at = 0;
    cnt = at;    at += build ? 16 : 0;
    ids = at;    at += build ? align16(sizeof(int) * zcap) : 0;
    acc = at;    at += align16(sizeof(double) * zcap);
    scores = at; at += align16(sizeof(T) * zcap);
    bytes = at;
  }
};

// misc[] slots
constexpr int M_COUNT = 0;  // candidates in ids[] (BUILD) / valid ones (list)
constexpr int M_NSEL = 1;   // survivors compacted
constexpr int M_DIGIT = 2, M_BELOW = 3, M_BIN = 4;  // radix-select pass
constexpr int M_SKIP = 5;   // radix-sort pass: every key has the same byte

// d² = max((sq_i + sq_j) − 2·g, 0), each operation rounded on its own
template <class T>
__device__ __forceinline__ T combine(T sq_i, T sq_j, T g) {
  using N = tsne::Num<T>;
  return N::max(N::sub(N::add(sq_i, sq_j), N::mul(T(2), g)), T(0));
}

// Ascending bitonic sort of n (a power of two) keys; every thread calls.
template <class T>
__device__ void bitonic_sort(typename KeyOps<T>::Key* buf, int n) {
  using Key = typename KeyOps<T>::Key;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const Key a = buf[lo], b = buf[hi];
        if (KeyOps<T>::greater(a, b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One pass of a stable block-wide LSD radix sort: src[0 .. n) -> dst by
// byte b of the key (most significant = 0), or nothing when every key has
// the same byte (returns false: src stays the result).  Each tile of
// THREADS keys ranks its keys within a warp (__match_any_sync) and across
// the warps (wcnt [warps][BINS], zero on entry and on return), after the
// keys of the earlier tiles (hist, the running bin starts).  Every thread
// calls.
template <class T>
__device__ bool radix_pass(const typename KeyOps<T>::Key* src,
                           typename KeyOps<T>::Key* dst, int n, int b,
                           int* hist, int* wcnt, int* misc) {
  using K = KeyOps<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = THREADS / 32;
  for (int t = threadIdx.x; t < BINS; t += THREADS) hist[t] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n; t0 += THREADS) {  // the same trips in a warp
    const int t = t0 + threadIdx.x;
    const int bin = t < n ? K::digit(src[t], b) : -1;
    const unsigned peers = __match_any_sync(tsne::kFullMask, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[bin], __popc(peers));
  }
  __syncthreads();
  if (warp == 0) {  // the bins' exclusive starts; one bin holding all: skip
    int v[BINS / 32], sum = 0;
#pragma unroll
    for (int j = 0; j < BINS / 32; ++j) {
      v[j] = hist[lane * (BINS / 32) + j];
      sum += v[j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(tsne::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    int run = incl - sum, one = 0;
#pragma unroll
    for (int j = 0; j < BINS / 32; ++j) {
      one |= v[j] == n;
      hist[lane * (BINS / 32) + j] = run;
      run += v[j];
    }
    one = __reduce_or_sync(tsne::kFullMask, one);
    if (lane == 0) misc[M_SKIP] = one;
  }
  __syncthreads();
  if (misc[M_SKIP]) return false;
  for (int t0 = 0; t0 < n; t0 += THREADS) {
    const int t = t0 + threadIdx.x;
    typename K::Key key{};
    int bin = -1;
    if (t < n) {
      key = src[t];
      bin = K::digit(key, b);
    }
    const unsigned peers = __match_any_sync(tsne::kFullMask, bin);
    const bool lead = bin >= 0 && lane == __ffs(peers) - 1;
    if (lead) wcnt[warp * BINS + bin] = __popc(peers);
    __syncthreads();
    if (bin >= 0) {
      int at = hist[bin] + __popc(peers & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) at += wcnt[w * BINS + bin];
      dst[at] = key;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < BINS; d += THREADS)
      for (int w = 0; w < WARPS; ++w) hist[d] += wcnt[w * BINS + d];
    __syncthreads();
    if (lead) wcnt[warp * BINS + bin] = 0;
    __syncwarp();
  }
  __syncthreads();
  return true;
}

// Ascending stable LSD radix sort of keys[0 .. n) over every byte of the
// key, with tmp as the second buffer; returns where the result is.
template <class T>
__device__ typename KeyOps<T>::Key* radix_sort(typename KeyOps<T>::Key* keys,
                                               typename KeyOps<T>::Key* tmp,
                                               int n, int* hist, int* wcnt,
                                               int* misc) {
  for (int b = KeyOps<T>::BYTES - 1; b >= 0; --b) {
    if (radix_pass<T>(keys, tmp, n, b, hist, wcnt, misc)) {
      typename KeyOps<T>::Key* t = keys;
      keys = tmp;
      tmp = t;
    }
  }
  return keys;
}

// One slot a warp for each lane with `mine` set: the slot of this lane's
// item (one atomicAdd a warp, not a lane).  Every lane of the warp calls.
__device__ __forceinline__ int warp_append(bool mine, int* counter) {
  const unsigned ballot = __ballot_sync(tsne::kFullMask, mine);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && ballot) base = atomicAdd(counter, __popc(ballot));
  base = __shfl_sync(tsne::kFullMask, base, 0);
  return base + __popc(ballot & ((1u << lane) - 1u));
}

// (prefix, mask) such that exactly `want` of the valid keys have
// (key & mask) <= prefix.  Needs more than `want` valid, unique keys;
// every thread calls and gets the same answer.  One byte of the key a
// pass, most significant first; lanes adding to one bin add once, by
// __match_any_sync.
template <class T, class KeyOf, class Valid>
__device__ void radix_threshold(KeyOf key_of, Valid valid, int nz, int want,
                                int* hist, int* misc,
                                typename KeyOps<T>::Key& prefix,
                                typename KeyOps<T>::Key& mask) {
  using K = KeyOps<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int need = want;
  for (int b = 0; b < K::BYTES; ++b) {
    for (int t = threadIdx.x; t < BINS; t += THREADS) hist[t] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < nz; t0 += THREADS) {  // the same trips in a warp
      const int t = t0 + threadIdx.x;
      int bin = -1;
      if (t < nz && valid(t)) {
        const typename K::Key key = key_of(t);
        if (K::masked_eq(key, mask, prefix)) bin = K::digit(key, b);
      }
      const unsigned peers = __match_any_sync(tsne::kFullMask, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      int v[BINS / 32], sum = 0;
#pragma unroll
      for (int j = 0; j < BINS / 32; ++j) {
        v[j] = hist[lane * (BINS / 32) + j];
        sum += v[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(tsne::kFullMask, incl, off);
        if (lane >= off) incl += y;
      }
      int run = incl - sum;
      if (run < need && need <= incl) {
        for (int j = 0; j < BINS / 32; ++j) {
          if (run + v[j] >= need) {
            misc[M_DIGIT] = lane * (BINS / 32) + j;
            misc[M_BELOW] = run;
            misc[M_BIN] = v[j];
            break;
          }
          run += v[j];
        }
      }
    }
    __syncthreads();
    need -= misc[M_BELOW];
    K::set_digit(prefix, mask, b, misc[M_DIGIT]);
    const bool done = misc[M_BIN] == need;
    __syncthreads();  // misc and hist are rewritten by the next pass
    if (done) break;
  }
}

// STAGED: the row's vector in shared memory (rvec) and the scores computed
// here; otherwise (the unstaged form, any F) the build pass (BUILD and
// ws.build_only: step 1 alone, into the Scratch) or the select pass, which
// reads its candidates and scores from the Scratch (the score pass's)
template <class T, bool BUILD, bool FINAL, int LANES, bool WS, bool STAGED>
__global__ void __launch_bounds__(THREADS)
refine_kernel(const Params<T> p, const Workspace ws) {
  using K = KeyOps<T>;
  using Key = typename K::Key;
  extern __shared__ __align__(16) unsigned char smem[];
  // the candidate-sized arrays: in shared memory (Layout), or in the
  // row's workspace (WsLayout, the workspace route)
  const std::conditional_t<WS, WsLayout<T>, Layout<T>> L(p, BUILD, FINAL,
                                                         STAGED);
  unsigned char* big = smem;
  if constexpr (WS) big = ws.base + (size_t)blockIdx.x * ws.row;
  T* rvec = reinterpret_cast<T*>(smem + L.rvec);
  int* ids = reinterpret_cast<int*>(big + L.ids);
  T* scores = reinterpret_cast<T*>(big + L.scores);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  Key* keys = reinterpret_cast<Key*>(big + L.region);
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int i = p.row0 + r;
  // the unstaged form's Scratch: a first stage's candidates (the build
  // pass writes them there), the scores the score pass left
  int* sc_cnt = nullptr;
  if constexpr (!STAGED) {
    const Scratch<T> SC(p.w, p.ke, BUILD);
    unsigned char* sc = ws.scratch + (size_t)r * ws.srow;
    sc_cnt = reinterpret_cast<int*>(sc + SC.cnt);
    if constexpr (BUILD) ids = reinterpret_cast<int*>(sc + SC.ids);
    scores = reinterpret_cast<T*>(sc + SC.scores);
  }

  const T* __restrict__ bi = p.base + (size_t)i * p.f;
  if constexpr (STAGED)
    for (int t = tid; t < p.f; t += THREADS) rvec[t] = bi[t];
  if (tid < 8) misc[tid] = 0;
  if constexpr (BUILD) {
    int* table = reinterpret_cast<int*>(big + L.region);
    int* gates = reinterpret_cast<int*>(smem + L.gates);
    for (int t = tid; t < L.hsize; t += THREADS) table[t] = -1;
    for (int t = tid; t < p.w; t += THREADS)
      gates[t] = p.cand[(size_t)r * p.w + t];
  }
  __syncthreads();

  // 1. the row's candidates
  int nz;
  if (!STAGED && BUILD && !ws.build_only) {
    nz = *sc_cnt;  // the build pass's
    if (tid == 0) misc[M_COUNT] = nz;
    __syncthreads();
  } else if constexpr (BUILD) {
    int* table = reinterpret_cast<int*>(big + L.region);
    const int* gates = reinterpret_cast<const int*>(smem + L.gates);
    const int total = p.w * (1 + p.ke);
    for (int t0 = 0; t0 < total; t0 += THREADS) {  // the same trips in a warp
      const int t = t0 + tid;
      int id = -1;
      if (t < p.w) {
        id = gates[t];
      } else if (t < total) {  // consecutive threads read one list
        const int e = t - p.w;
        const int g = e / p.ke;
        id = __ldg(p.graph + (size_t)gates[g] * p.kg + (e - g * p.ke));
      }
      bool fresh = false;
      if (id >= 0 && id != i && id < p.n_valid) {
        unsigned h = __umulhi((unsigned)id * 0x9E3779B1u, (unsigned)L.hsize);
        while (true) {
          const int prev = atomicCAS(&table[h], -1, id);
          if (prev == -1) {
            fresh = true;
            break;
          }
          if (prev == id) break;
          if (++h == (unsigned)L.hsize) h = 0;
        }
      }
      const int pos = warp_append(fresh, &misc[M_COUNT]);
      if (fresh) ids[pos] = id;
    }
    __syncthreads();
    nz = misc[M_COUNT];
    if constexpr (!STAGED) {  // the build pass ends here
      if (tid == 0) *sc_cnt = nz;
      return;
    }
  } else {
    int mine = 0;
    for (int t = tid; t < p.w; t += THREADS) {
      const int id = p.cand[(size_t)r * p.w + t];
      ids[t] = id;
      mine += id >= 0;
    }
    mine = __reduce_add_sync(tsne::kFullMask, mine);
    if ((tid & 31) == 0) atomicAdd(&misc[M_COUNT], mine);
    __syncthreads();  // a warp scores ids other threads loaded
    nz = p.w;
  }

  // 2. scores (the staged form; the unstaged form's are the score
  // pass's): LANES lanes a candidate, each summing a strided part of F,
  // a butterfly within the group adding the parts; two candidates a group
  // at a time, so that twice the loads are in flight
  // root, sq_i and bi stay at function scope: moved into the staged
  // form's block they change ptxas's code for its on-chip exact stages
  const bool root = FINAL && p.euclid;
  const T sq_i = p.sq[i];
  if constexpr (STAGED) {
    constexpr int GROUPS = THREADS / LANES;
    const int lane = tid % LANES;
    const int group = tid / LANES;
    for (int t0 = 0; t0 < nz; t0 += 2 * GROUPS) {  // the same trips in a warp
      const int ta = t0 + group;
      const int tb = ta + GROUPS;
      const int ja = ta < nz ? ids[ta] : -1;
      const int jb = tb < nz ? ids[tb] : -1;
      const T* __restrict__ ba = p.base + (size_t)(ja >= 0 ? ja : i) * p.f;
      const T* __restrict__ bb = p.base + (size_t)(jb >= 0 ? jb : i) * p.f;
      T ga = T(0), gb = T(0);
#pragma unroll 4
      for (int q = lane; q < p.f; q += LANES) {
        const T rq = rvec[q];
        ga = tsne::Num<T>::fma(rq, __ldg(ba + q), ga);
        gb = tsne::Num<T>::fma(rq, __ldg(bb + q), gb);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        ga += __shfl_xor_sync(tsne::kFullMask, ga, off, LANES);
        gb += __shfl_xor_sync(tsne::kFullMask, gb, off, LANES);
      }
      if (lane == 0) {
        if (ja >= 0) {
          const T d = combine(sq_i, __ldg(p.sq + ja), ga);
          scores[ta] = root ? tsne::Num<T>::sqrt(d) : d;
        }
        if (jb >= 0) {
          const T d = combine(sq_i, __ldg(p.sq + jb), gb);
          scores[tb] = root ? tsne::Num<T>::sqrt(d) : d;
        }
      }
    }
  }
  __syncthreads();
  const int nvalid = misc[M_COUNT];

  // 3. the `want` smallest by (score, tie)
  const int want = FINAL ? p.k : p.keep;
  auto valid = [&](int t) { return BUILD || ids[t] >= 0; };
  auto key_of = [&](int t) {
    return K::make(scores[t], BUILD ? (unsigned)ids[t] : (unsigned)t);
  };
  Key prefix{}, mask{};  // all of them, unless
  if (nvalid > want)
    radix_threshold<T>(key_of, valid, nz, want, hist, misc, prefix, mask);
  for (int t0 = 0; t0 < nz; t0 += THREADS) {  // the same trips in a warp
    const int t = t0 + tid;
    Key key{};
    bool take = false;
    if (t < nz && valid(t)) {
      key = key_of(t);
      take = K::masked_le(key, mask, prefix);
    }
    const int pos = warp_append(take, &misc[M_NSEL]);
    // FINAL keys by (d, id), the merge's order
    if (take) keys[pos] = FINAL ? K::make(scores[t], (unsigned)ids[t]) : key;
  }
  __syncthreads();
  const int nsel = misc[M_NSEL];

  // the workspace route's sort: a radix sort of exactly the keys there are
  int* wcnt = nullptr;
  Key* keys2 = nullptr;
  if constexpr (WS) {
    wcnt = reinterpret_cast<int*>(smem + L.wcnt);
    keys2 = reinterpret_cast<Key*>(big + L.keys2);
    for (int t = tid; t < (THREADS / 32) * BINS; t += THREADS) wcnt[t] = 0;
  }

  if constexpr (!FINAL) {
    if constexpr (WS) {
      __syncthreads();
      keys = radix_sort<T>(keys, keys2, nsel, hist, wcnt, misc);
    } else {
      for (int t = nsel + tid; t < L.sortcap; t += THREADS)
        keys[t] = K::none();
      __syncthreads();
      bitonic_sort<T>(keys, L.sortcap);
    }
    for (int t = tid; t < p.keep; t += THREADS) {
      int id = -1;
      if (t < nsel) {
        const unsigned tie = K::tie(keys[t]);
        id = BUILD ? (int)tie : ids[tie];
      }
      p.out_i[(size_t)r * p.keep + t] = id;
    }
  } else {
    // 4. merge with the old list: each id's smallest distance, by (d, id)
    int* oi = reinterpret_cast<int*>(big + L.oi);
    T* od = reinterpret_cast<T*>(big + L.od);
    for (int t = tid; t < p.k; t += THREADS) {
      oi[t] = p.old_i[(size_t)r * p.k + t];
      od[t] = p.old_d[(size_t)r * p.k + t];
    }
    __syncthreads();
    for (int e = tid; e < nsel; e += THREADS) {
      const Key key = keys[e];
      const int id = (int)K::tie(key);
      const T dn = K::score(key);
      bool old = false;
      for (int o = 0; o < p.k; ++o) {
        if (oi[o] == id) {  // new ids are unique: one thread per old slot
          od[o] = tsne::Num<T>::min(od[o], dn);
          old = true;
        }
      }
      if (old) keys[e] = K::none();
    }
    __syncthreads();
    if constexpr (WS) {
      for (int t = tid; t < p.k; t += THREADS)
        keys[nsel + t] = K::make(od[t], (unsigned)oi[t]);
      __syncthreads();
      keys = radix_sort<T>(keys, keys2, nsel + p.k, hist, wcnt, misc);
    } else {
      for (int t = tid; t < L.sortcap - nsel; t += THREADS)
        keys[nsel + t] =
            t < p.k ? K::make(od[t], (unsigned)oi[t]) : K::none();
      __syncthreads();
      bitonic_sort<T>(keys, L.sortcap);
    }
    for (int t = tid; t < p.k; t += THREADS) {
      const Key key = keys[t];
      p.out_i[(size_t)r * p.k + t] = (int)K::tie(key);
      p.out_d[(size_t)r * p.k + t] = K::score(key);
    }
  }
}

// The unstaged form's score pass: every pair (chunk row r, candidate t)
// of the stage, blocks of rpb consecutive rows, every block resident at
// once; F walked in slabs of S values in the same order by every block
// (see the header).  A group of SCORE_LANES lanes takes a pair's slab: lane
// l sums base_i[q]·base_j[q] over q = V·l + 8V·u + e (u = 0 .. PER/V − 1,
// e = 0 .. V − 1, V = 8 / sizeof(T)) in that order, reading its V values
// as one 8-byte load where the rows allow it (VEC: float32 rows of an even
// F) and one by one otherwise (the same sums either way); a butterfly
// adds the lanes, and the group's lane 0 adds the slab to the pair's
// double sum, held in shared memory for the block's pairs (acc_on_chip)
// or else in the Scratch; after the last slab it writes the pair's score.
template <class T, bool BUILD, bool VEC>
__global__ void __launch_bounds__(THREADS)
score_kernel(const Params<T> p, const Workspace ws, int rpb,
             int acc_on_chip) {
  constexpr int S = SLAB_BYTES / sizeof(T);  // values a slab
  constexpr int V = 8 / sizeof(T);           // values a lane loads at once
  constexpr int PER = S / SCORE_LANES;       // values a lane
  constexpr int GROUPS = THREADS / SCORE_LANES;
  static_assert(!VEC || V == 2, "VEC: float32 pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  const int zc = BUILD ? p.w * (1 + p.ke) : p.w;
  T* rows = reinterpret_cast<T*>(smem);                     // [rpb][S]
  int* nzs = reinterpret_cast<int*>(smem + align16(sizeof(T) * rpb * S));
  double* sacc = reinterpret_cast<double*>(
      smem + align16(sizeof(T) * rpb * S) + align16(4 * (size_t)rpb));
  const Scratch<T> SC(p.w, p.ke, BUILD);
  const int r0 = blockIdx.x * rpb;
  const int nr = min(rpb, p.c - r0);
  const int lane = threadIdx.x % SCORE_LANES;
  const int group = threadIdx.x / SCORE_LANES;
  const bool root = p.old_i != nullptr && p.euclid;  // the exact stage
  for (int t = threadIdx.x; t < nr; t += THREADS)
    nzs[t] = BUILD ? *reinterpret_cast<const int*>(
                         ws.scratch + (size_t)(r0 + t) * ws.srow + SC.cnt)
                   : p.w;
  const int nslab = (p.f + S - 1) / S;
  for (int s = 0; s < nslab; ++s) {
    const int q0 = s * S;
    const bool last = s == nslab - 1;
    __syncthreads();  // the previous slab's rows are read (and nzs set)
    for (int e = threadIdx.x; e < nr * S; e += THREADS) {
      const int rr = e / S, q = e - rr * S;
      rows[e] = q0 + q < p.f
                    ? p.base[(size_t)(p.row0 + r0 + rr) * p.f + q0 + q]
                    : T(0);
    }
    __syncthreads();
    // group g walks the block's pairs g, g + GROUPS, ... row by row (the
    // same trips in a warp: every group of a warp steps together)
    int rr = 0, t = group;
    while (rr < nr && t >= nzs[rr]) t -= nzs[rr++];
    for (;;) {
      const bool live = __any_sync(tsne::kFullMask, rr < nr);
      if (!live) break;
      const bool mine = rr < nr;
      const int row = mine ? rr : 0;
      unsigned char* sc = ws.scratch + (size_t)(r0 + row) * ws.srow;
      int j = -1;
      if (mine)
        j = BUILD ? __ldg(reinterpret_cast<const int*>(sc + SC.ids) + t)
                  : __ldg(p.cand + (size_t)(r0 + rr) * p.w + t);
      const bool pair = j >= 0;
      const T* __restrict__ bj =
          p.base + (size_t)(pair ? j : p.row0 + r0) * p.f + q0;
      const T* ri = rows + row * S;
      double* acc = acc_on_chip
                        ? sacc + (size_t)row * zc + t
                        : reinterpret_cast<double*>(sc + SC.acc) + t;
      const double before = pair && s > 0 && lane == 0 ? *acc : 0.0;
      T g = T(0);
#pragma unroll
      for (int u = 0; u < PER / V; ++u) {
        const int q = V * lane + 8 * V * u;
        T b[V];
        if constexpr (VEC) {
          if (q0 + q < p.f) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(bj + q));
            b[0] = v.x;
            b[1] = v.y;
          } else {
            b[0] = b[1] = T(0);
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            b[e] = q0 + q + e < p.f ? __ldg(bj + q + e) : T(0);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) g = tsne::Num<T>::fma(ri[q + e], b[e], g);
      }
#pragma unroll
      for (int off = SCORE_LANES / 2; off > 0; off >>= 1)
        g += __shfl_xor_sync(tsne::kFullMask, g, off, SCORE_LANES);
      if (pair && lane == 0) {
        const double sum = before + (double)g;
        if (!last) {
          *acc = sum;
        } else {
          const int i = p.row0 + r0 + rr;
          const T d = combine(__ldg(p.sq + i), __ldg(p.sq + j), (T)sum);
          reinterpret_cast<T*>(sc + SC.scores)[t] =
              root ? tsne::Num<T>::sqrt(d) : d;
        }
      }
      if (mine) {
        t += GROUPS;
        while (rr < nr && t >= nzs[rr]) t -= nzs[rr++];
      }
    }
  }
}

// Whether a stage takes the workspace route: its on-chip layout past the
// block's shared memory, or its sort past the bitonic sort's capacity.
template <class T>
bool needs_workspace(const Params<T>& p, bool build, bool fin, bool staged) {
  const Layout<T> L(p, build, fin, staged);
  return L.bytes > SMEM_MAX || L.sortcap > SORT_MAX;
}

template <class T, bool BUILD, bool FINAL, int LANES, bool WS, bool STAGED>
int launch(const Params<T>& p, const Workspace& ws, cudaStream_t stream) {
  size_t bytes;
  if constexpr (WS) {
    const WsLayout<T> L(p, BUILD, FINAL, STAGED);
    if (ws.base == nullptr || ws.row < L.row || ws.row % 16 ||
        reinterpret_cast<uintptr_t>(ws.base) % 16)
      return (int)cudaErrorInvalidValue;
    bytes = L.bytes;
  } else {
    bytes = Layout<T>(p, BUILD, FINAL, STAGED).bytes;
  }
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = refine_kernel<T, BUILD, FINAL, LANES, WS, STAGED>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<p.c, THREADS, bytes, stream>>>(p, ws);
  return tsne::launch_status();
}

// The staged form: 8 lanes a candidate below WIDE_F, a warp from it; the
// unstaged form's build and select passes score nothing (LANES 32).
template <class T, bool BUILD, bool FINAL, bool WS, bool STAGED>
int launch_width(const Params<T>& p, const Workspace& ws,
                 cudaStream_t stream) {
  if constexpr (STAGED)
    return p.f < WIDE_F
               ? launch<T, BUILD, FINAL, NARROW_LANES, WS, true>(p, ws, stream)
               : launch<T, BUILD, FINAL, 32, WS, true>(p, ws, stream);
  else
    return launch<T, BUILD, FINAL, 32, WS, false>(p, ws, stream);
}

template <class T, bool BUILD, bool FINAL, bool STAGED>
int launch_route(const Params<T>& p, const Workspace& ws,
                 cudaStream_t stream) {
  return needs_workspace(p, BUILD, FINAL, STAGED)
             ? launch_width<T, BUILD, FINAL, true, STAGED>(p, ws, stream)
             : launch_width<T, BUILD, FINAL, false, STAGED>(p, ws, stream);
}

// The unstaged form's score pass: blocks of rpb rows, rpb the least that
// puts every block of the chunk on the card at once (the occupancy the
// block's shared memory allows), so the slabs are walked in one wave; the
// block's pairs' sums in its shared memory when they take at most
// ACC_SMEM bytes there, else in the Scratch.
constexpr size_t ACC_SMEM = 64 * 1024;

template <class T, bool BUILD, bool VEC>
int launch_score_form(const Params<T>& p, const Workspace& ws,
                      cudaStream_t s) {
  constexpr int S = SLAB_BYTES / sizeof(T);
  auto kern = score_kernel<T, BUILD, VEC>;
  const size_t zc = BUILD ? (size_t)p.w * (1 + p.ke) : (size_t)p.w;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  for (int on_chip = 1; on_chip >= 0; --on_chip) {
    int rpb = 1;
    size_t bytes = 0;
    bool fits = false;
    for (int tries = 0; tries < 8; ++tries) {
      const size_t acc = on_chip ? align16(8 * zc * rpb) : 0;
      bytes = align16(sizeof(T) * (size_t)rpb * S) +
              align16(4 * (size_t)rpb) + acc;
      if (bytes > SMEM_MAX || acc > ACC_SMEM) break;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          THREADS, bytes);
      if (err != cudaSuccess) return (int)err;
      if (per_sm < 1) break;
      const long long wave = (long long)sms * per_sm;
      if (wave * rpb >= p.c) {
        fits = true;
        break;
      }
      rpb = (int)((p.c + wave - 1) / wave);
    }
    if (!fits) continue;
    const int grid = (p.c + rpb - 1) / rpb;
    kern<<<grid, THREADS, bytes, s>>>(p, ws, rpb, on_chip);
    return tsne::launch_status();
  }
  return (int)cudaErrorInvalidValue;
}

// float32 rows of an even F (and a base 8-byte aligned) load their
// values in pairs
template <class T, bool BUILD>
int launch_score(const Params<T>& p, const Workspace& ws, cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) {
    if (p.f % 2 == 0 && reinterpret_cast<uintptr_t>(p.base) % 8 == 0)
      return launch_score_form<T, BUILD, true>(p, ws, s);
  }
  return launch_score_form<T, BUILD, false>(p, ws, s);
}

// One funnel stage on the caller's stream.  The unstaged form first runs
// its build pass (a first stage) and its score pass, which fill scratch
// (scratch_row bytes, at least Scratch's, for each of the c rows); then
// either form's stage (the unstaged form's select pass) on its route.
template <class T, bool STAGED>
int refine_chunk(const T* base, const T* sq, int n, int f, int row0, int c,
                 const int* cand, int w, const int* graph, int kg, int ke,
                 int keep, const int* old_i, const T* old_d, int k,
                 int euclid, int n_valid, int* out_i, T* out_d, void* ws,
                 size_t ws_row, void* scratch, size_t scratch_row,
                 void* stream) {
  const bool build = graph != nullptr;
  const bool fin = old_i != nullptr;
  if (c < 1 || w < 1 || f < 1 || row0 < 0 || row0 + c > n ||
      n_valid < 1 || n_valid > n ||
      (STAGED ? f > STAGED_F_MAX : f < WIDE_F) ||
      (build && (ke < 1 || ke > kg)) ||
      (fin ? k < 1 : keep < 1))
    return (int)cudaErrorInvalidValue;
  if (!STAGED && (scratch == nullptr || scratch_row % 16 ||
                  reinterpret_cast<uintptr_t>(scratch) % 16 ||
                  scratch_row < Scratch<T>(w, build ? ke : 0, build).bytes))
    return (int)cudaErrorInvalidValue;
  const Params<T> p{base, sq, n, f, row0, c, cand, w, graph, kg, ke, keep,
                    old_i, old_d, k, euclid, n_valid, out_i, out_d};
  Workspace wsp{static_cast<unsigned char*>(ws), ws_row,
                static_cast<unsigned char*>(scratch), scratch_row, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (!STAGED) {
    int rc;
    if (build) {
      wsp.build_only = 1;
      rc = fin ? launch_route<T, true, true, false>(p, wsp, s)
               : launch_route<T, true, false, false>(p, wsp, s);
      wsp.build_only = 0;
      if (rc == 0) rc = launch_score<T, true>(p, wsp, s);
    } else {
      rc = launch_score<T, false>(p, wsp, s);
    }
    if (rc) return rc;
  }
  if (build) return fin ? launch_route<T, true, true, STAGED>(p, wsp, s)
                        : launch_route<T, true, false, STAGED>(p, wsp, s);
  return fin ? launch_route<T, false, true, STAGED>(p, wsp, s)
             : launch_route<T, false, false, STAGED>(p, wsp, s);
}

// The route of one funnel stage (arguments as tsne_refine_chunk_f32's;
// itemsize 4 or 8; staged: the staged form's layouts, else the unstaged
// form's): returns the workspace bytes a row (0: the stage runs on chip)
// and writes the block's dynamic shared memory.
template <class T>
size_t route_bytes(int f, int w, int ke, int keep, int k, int build,
                   int fin, bool staged, size_t* smem) {
  Params<T> p{};
  p.f = f;
  p.w = w;
  p.ke = ke;
  p.keep = keep;
  p.k = k;
  if (!needs_workspace(p, build, fin, staged)) {
    *smem = Layout<T>(p, build, fin, staged).bytes;
    return 0;
  }
  const WsLayout<T> L(p, build, fin, staged);
  *smem = L.bytes;
  return L.row;
}

}  // namespace

// One funnel stage of rows row0 .. row0 + c − 1 (every id in [0, n); a
// BUILD stage drops ids >= n_valid, n_valid <= n), by the staged form:
// 1 <= f <= 12,288 (STAGED_F_MAX).
// base [n, f], sq [n] in the entry's value type (f32 or f64), as are
// old_d and out_d.  BUILD when graph is non-null: cand holds
// the gateways [c, w] and graph [n, kg] the lists, of which the first ke
// ids are proposed.  Otherwise cand [c, w] is a list, -1 for none.
// KEEP mode when old_i is null: out_i [c, keep].  FINAL mode otherwise:
// old_i/old_d [c, k] the rows' lists, out_i/out_d [c, k] the new ones,
// euclid != 0 for euclidean distances.  Needs c, w >= 1 and keep >= 1
// (KEEP) or k >= 1 (FINAL).  A stage whose block (a few words a
// candidate, 2·w·(1 + ke) hash slots, a key of 8 bytes (f32) or 16 (f64)
// a sorted entry) fits 227 KB of shared memory, with at most 8,192 keys
// to sort, runs on chip; any other takes the workspace route, whose
// workspace ws holds ws_row bytes (a multiple of 16, at least
// tsne_refine_route's) for each of the c rows.  ops/knn_cuda.refine_route
// states both layouts.  Returns cudaErrorInvalidValue for what it does
// not take.
TSNE_API int tsne_refine_chunk_f32(const float* base, const float* sq, int n,
                                   int f, int row0, int c, const int* cand,
                                   int w, const int* graph, int kg, int ke,
                                   int keep, const int* old_i,
                                   const float* old_d, int k, int euclid,
                                   int n_valid, int* out_i, float* out_d,
                                   void* ws, size_t ws_row, void* stream) {
  return refine_chunk<float, true>(base, sq, n, f, row0, c, cand, w, graph,
                                   kg, ke, keep, old_i, old_d, k, euclid,
                                   n_valid, out_i, out_d, ws, ws_row, nullptr,
                                   0, stream);
}

TSNE_API int tsne_refine_chunk_f64(const double* base, const double* sq,
                                   int n, int f, int row0, int c,
                                   const int* cand, int w, const int* graph,
                                   int kg, int ke, int keep,
                                   const int* old_i, const double* old_d,
                                   int k, int euclid, int n_valid,
                                   int* out_i, double* out_d, void* ws,
                                   size_t ws_row, void* stream) {
  return refine_chunk<double, true>(base, sq, n, f, row0, c, cand, w, graph,
                                    kg, ke, keep, old_i, old_d, k, euclid,
                                    n_valid, out_i, out_d, ws, ws_row,
                                    nullptr, 0, stream);
}

// The unstaged form (B6u, B6u_f64): the same stage and outputs, scored
// over F in slabs (see the header); any f >= 64 (WIDE_F).  The wrapper
// launches it past STAGED_F_MAX.  The arguments of tsne_refine_chunk_f32,
// and scratch [c, scratch_row] bytes (scratch_row a multiple of 16, at
// least tsne_refine_scratch's) that the three passes share.
TSNE_API int tsne_refine_chunk_unstaged_f32(
    const float* base, const float* sq, int n, int f, int row0, int c,
    const int* cand, int w, const int* graph, int kg, int ke, int keep,
    const int* old_i, const float* old_d, int k, int euclid, int n_valid,
    int* out_i, float* out_d, void* ws, size_t ws_row, void* scratch,
    size_t scratch_row, void* stream) {
  return refine_chunk<float, false>(base, sq, n, f, row0, c, cand, w, graph,
                                    kg, ke, keep, old_i, old_d, k, euclid,
                                    n_valid, out_i, out_d, ws, ws_row,
                                    scratch, scratch_row, stream);
}

TSNE_API int tsne_refine_chunk_unstaged_f64(
    const double* base, const double* sq, int n, int f, int row0, int c,
    const int* cand, int w, const int* graph, int kg, int ke, int keep,
    const int* old_i, const double* old_d, int k, int euclid, int n_valid,
    int* out_i, double* out_d, void* ws, size_t ws_row, void* scratch,
    size_t scratch_row, void* stream) {
  return refine_chunk<double, false>(base, sq, n, f, row0, c, cand, w,
                                     graph, kg, ke, keep, old_i, old_d, k,
                                     euclid, n_valid, out_i, out_d, ws,
                                     ws_row, scratch, scratch_row, stream);
}

// The unstaged form's scratch bytes a chunk row (w, ke as the entry points
// take them, build != 0 for a first stage, itemsize 4 or 8): Scratch's.
TSNE_API size_t tsne_refine_scratch(int w, int ke, int build, int itemsize) {
  return itemsize == 8 ? Scratch<double>(w, build ? ke : 0, build).bytes
                       : Scratch<float>(w, build ? ke : 0, build).bytes;
}

// A stage's route as the kernel takes it (f, w, ke, keep, k as the entry
// points take them, build / fin for a first stage / the exact stage,
// itemsize 4 or 8, staged != 0 for the staged form, 0 for the unstaged
// one): returns the workspace bytes a row, 0 on chip, and writes the
// block's dynamic shared memory.
TSNE_API size_t tsne_refine_route(int f, int w, int ke, int keep, int k,
                                  int build, int fin, int itemsize,
                                  int staged, size_t* smem) {
  return itemsize == 8
             ? route_bytes<double>(f, w, ke, keep, k, build, fin, staged,
                                   smem)
             : route_bytes<float>(f, w, ke, keep, k, build, fin, staged,
                                  smem);
}
