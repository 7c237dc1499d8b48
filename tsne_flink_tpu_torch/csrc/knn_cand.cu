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
// Rounding: scores keep the score-only kernel's arithmetic — __fadd_rn /
// __fmul_rn in the plain version's order (sq_i + sq_j) − 2·g, only the dot
// product g summed in another order than the plain version's, which the
// card's checks bound at rtol 2e-5.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WIDE_F = 64;          // from this F on, a warp scores one candidate
constexpr int NARROW_LANES = 8;     // lanes a candidate below WIDE_F
constexpr int SORT_MAX = 8192;      // keys a row sorts: keep, or 2k in FINAL mode
constexpr int BINS = 256;           // radix-select digit: one byte
constexpr unsigned long long KEY_NONE = ~0ull;
constexpr size_t SMEM_MAX = 232448; // what a block may opt in to on sm_90

struct Params {
  const float* base;  // [n, f]
  const float* sq;    // [n] squared norms
  int n, f, row0, c;
  const int* cand;    // BUILD: gateways [c, w]; else ids [c, w], -1 = none
  int w;
  const int* graph;   // BUILD: [n, kg]
  int kg, ke;
  int keep;           // KEEP mode: survivors a row
  const int* old_i;   // FINAL mode: [c, k]
  const float* old_d;
  int k, euclid;
  int n_valid;        // BUILD: ids >= n_valid are no candidates
  int* out_i;         // KEEP: [c, keep]; FINAL: [c, k]
  float* out_d;       // FINAL: [c, k]
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The block's dynamic shared memory, byte offsets of each array.
struct Layout {
  int zcap, hsize, sortcap;
  size_t rvec, ids, hist, misc, gates, oi, od, region, scores, bytes;
  __host__ __device__ Layout(const Params& p, bool build, bool fin) {
    zcap = build ? p.w * (1 + p.ke) : p.w;
    hsize = build ? 2 * zcap : 0;
    sortcap = pow2_at_least(fin ? 2 * p.k : p.keep);
    size_t at = 0;
    rvec = at;   at += align16(sizeof(float) * p.f);
    ids = at;    at += align16(sizeof(int) * zcap);
    hist = at;   at += align16(sizeof(int) * BINS);
    misc = at;   at += align16(sizeof(int) * 8);
    gates = at;  at += build ? align16(sizeof(int) * p.w) : 0;
    oi = at;     at += fin ? align16(sizeof(int) * p.k) : 0;
    od = at;     at += fin ? align16(sizeof(float) * p.k) : 0;
    // the region: the hash set while the candidates are built, then the
    // sort buffer (keys) followed by the scores
    region = at;
    const size_t sort = sizeof(unsigned long long) * (size_t)sortcap;
    scores = region + sort;
    const size_t table = sizeof(int) * (size_t)hsize;
    const size_t after = sort + sizeof(float) * (size_t)zcap;
    at += align16(table > after ? table : after);
    bytes = at;
  }
};

// misc[] slots
constexpr int M_COUNT = 0;  // candidates in ids[] (BUILD) / valid ones (list)
constexpr int M_NSEL = 1;   // survivors compacted
constexpr int M_DIGIT = 2, M_BELOW = 3, M_BIN = 4;  // radix-select pass

__device__ __forceinline__ float combine(float sq_i, float sq_j, float g) {
  return fmaxf(__fsub_rn(__fadd_rn(sq_i, sq_j), __fmul_rn(2.f, g)), 0.f);
}

// float -> uint32 in the float's order (−0 folded onto +0), and back
__device__ __forceinline__ unsigned ord_bits(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ord(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ unsigned long long make_key(float d, unsigned tie) {
  return ((unsigned long long)ord_bits(d) << 32) | tie;
}

// Ascending bitonic sort of n (a power of two) keys; every thread calls.
__device__ void bitonic_sort(unsigned long long* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
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
// every thread calls and gets the same answer.  Lanes adding to one bin
// add once, by __match_any_sync.
template <class KeyOf, class Valid>
__device__ void radix_threshold(KeyOf key_of, Valid valid, int nz, int want,
                                int* hist, int* misc,
                                unsigned long long& prefix,
                                unsigned long long& mask) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int need = want;
  prefix = 0;
  mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < BINS; b += THREADS) hist[b] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < nz; t0 += THREADS) {  // the same trips in a warp
      const int t = t0 + threadIdx.x;
      int bin = -1;
      if (t < nz && valid(t)) {
        const unsigned long long key = key_of(t);
        if ((key & mask) == prefix) bin = (int)((key >> shift) & 0xff);
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
    prefix |= (unsigned long long)misc[M_DIGIT] << shift;
    mask |= 0xffull << shift;
    const bool done = misc[M_BIN] == need;
    __syncthreads();  // misc and hist are rewritten by the next pass
    if (done) break;
  }
}

template <bool BUILD, bool FINAL, int LANES>
__global__ void __launch_bounds__(THREADS) refine_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(p, BUILD, FINAL);
  float* rvec = reinterpret_cast<float*>(smem + L.rvec);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  float* scores = reinterpret_cast<float*>(smem + L.scores);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(smem + L.region);
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int i = p.row0 + r;

  const float* __restrict__ bi = p.base + (size_t)i * p.f;
  for (int t = tid; t < p.f; t += THREADS) rvec[t] = bi[t];
  if (tid < 8) misc[tid] = 0;
  if constexpr (BUILD) {
    int* table = reinterpret_cast<int*>(smem + L.region);
    int* gates = reinterpret_cast<int*>(smem + L.gates);
    for (int t = tid; t < L.hsize; t += THREADS) table[t] = -1;
    for (int t = tid; t < p.w; t += THREADS)
      gates[t] = p.cand[(size_t)r * p.w + t];
  }
  __syncthreads();

  // 1. the row's candidates
  int nz;
  if constexpr (BUILD) {
    int* table = reinterpret_cast<int*>(smem + L.region);
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

  // 2. scores: LANES lanes a candidate, each summing a strided part of F,
  // a butterfly within the group adding the parts; two candidates a group
  // at a time, so that twice the loads are in flight
  const bool root = FINAL && p.euclid;
  const float sq_i = p.sq[i];
  {
    constexpr int GROUPS = THREADS / LANES;
    const int lane = tid % LANES;
    const int group = tid / LANES;
    for (int t0 = 0; t0 < nz; t0 += 2 * GROUPS) {  // the same trips in a warp
      const int ta = t0 + group;
      const int tb = ta + GROUPS;
      const int ja = ta < nz ? ids[ta] : -1;
      const int jb = tb < nz ? ids[tb] : -1;
      const float* __restrict__ ba = p.base + (size_t)(ja >= 0 ? ja : i) * p.f;
      const float* __restrict__ bb = p.base + (size_t)(jb >= 0 ? jb : i) * p.f;
      float ga = 0.f, gb = 0.f;
#pragma unroll 4
      for (int q = lane; q < p.f; q += LANES) {
        const float rq = rvec[q];
        ga = fmaf(rq, __ldg(ba + q), ga);
        gb = fmaf(rq, __ldg(bb + q), gb);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        ga += __shfl_xor_sync(tsne::kFullMask, ga, off, LANES);
        gb += __shfl_xor_sync(tsne::kFullMask, gb, off, LANES);
      }
      if (lane == 0) {
        if (ja >= 0) {
          const float d = combine(sq_i, __ldg(p.sq + ja), ga);
          scores[ta] = root ? sqrtf(d) : d;
        }
        if (jb >= 0) {
          const float d = combine(sq_i, __ldg(p.sq + jb), gb);
          scores[tb] = root ? sqrtf(d) : d;
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
    return make_key(scores[t], BUILD ? (unsigned)ids[t] : (unsigned)t);
  };
  unsigned long long prefix = 0, mask = 0;  // all of them, unless
  if (nvalid > want)
    radix_threshold(key_of, valid, nz, want, hist, misc, prefix, mask);
  for (int t0 = 0; t0 < nz; t0 += THREADS) {  // the same trips in a warp
    const int t = t0 + tid;
    unsigned long long key = 0;
    bool take = false;
    if (t < nz && valid(t)) {
      key = key_of(t);
      take = (key & mask) <= prefix;
    }
    const int pos = warp_append(take, &misc[M_NSEL]);
    // FINAL keys by (d, id), the merge's order
    if (take) keys[pos] = FINAL ? make_key(scores[t], (unsigned)ids[t]) : key;
  }
  __syncthreads();
  const int nsel = misc[M_NSEL];

  if constexpr (!FINAL) {
    for (int t = nsel + tid; t < L.sortcap; t += THREADS) keys[t] = KEY_NONE;
    __syncthreads();
    bitonic_sort(keys, L.sortcap);
    for (int t = tid; t < p.keep; t += THREADS) {
      int id = -1;
      if (t < nsel) {
        const unsigned tie = (unsigned)keys[t];
        id = BUILD ? (int)tie : ids[tie];
      }
      p.out_i[(size_t)r * p.keep + t] = id;
    }
  } else {
    // 4. merge with the old list: each id's smallest distance, by (d, id)
    int* oi = reinterpret_cast<int*>(smem + L.oi);
    float* od = reinterpret_cast<float*>(smem + L.od);
    for (int t = tid; t < p.k; t += THREADS) {
      oi[t] = p.old_i[(size_t)r * p.k + t];
      od[t] = p.old_d[(size_t)r * p.k + t];
    }
    __syncthreads();
    for (int e = tid; e < nsel; e += THREADS) {
      const unsigned long long key = keys[e];
      const int id = (int)(unsigned)key;
      const float dn = from_ord((unsigned)(key >> 32));
      bool old = false;
      for (int o = 0; o < p.k; ++o) {
        if (oi[o] == id) {  // new ids are unique: one thread per old slot
          od[o] = fminf(od[o], dn);
          old = true;
        }
      }
      if (old) keys[e] = KEY_NONE;
    }
    __syncthreads();
    for (int t = tid; t < L.sortcap - nsel; t += THREADS)
      keys[nsel + t] = t < p.k ? make_key(od[t], (unsigned)oi[t]) : KEY_NONE;
    __syncthreads();
    bitonic_sort(keys, L.sortcap);
    for (int t = tid; t < p.k; t += THREADS) {
      const unsigned long long key = keys[t];
      p.out_i[(size_t)r * p.k + t] = (int)(unsigned)key;
      p.out_d[(size_t)r * p.k + t] = from_ord((unsigned)(key >> 32));
    }
  }
}

template <bool BUILD, bool FINAL, int LANES>
int launch(const Params& p, cudaStream_t stream) {
  const Layout L(p, BUILD, FINAL);
  if (L.bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = refine_kernel<BUILD, FINAL, LANES>;
  if (L.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<p.c, THREADS, L.bytes, stream>>>(p);
  return tsne::launch_status();
}

template <bool BUILD, bool FINAL>
int launch_width(const Params& p, cudaStream_t stream) {
  return p.f < WIDE_F ? launch<BUILD, FINAL, NARROW_LANES>(p, stream)
                      : launch<BUILD, FINAL, 32>(p, stream);
}

}  // namespace

// One funnel stage of rows row0 .. row0 + c − 1 (every id in [0, n); a
// BUILD stage drops ids >= n_valid, n_valid <= n).
// base [n, f] f32, sq [n] f32.  BUILD when graph is non-null: cand holds
// the gateways [c, w] and graph [n, kg] the lists, of which the first ke
// ids are proposed.  Otherwise cand [c, w] is a list, -1 for none.
// KEEP mode when old_i is null: out_i [c, keep].  FINAL mode otherwise:
// old_i/old_d [c, k] the rows' lists, out_i/out_d [c, k] the new ones,
// euclid != 0 for euclidean distances.  Needs c, w >= 1, keep <= 8,192
// (KEEP) or 2k <= 8,192 (FINAL), and the block's shared memory (a few
// words a candidate, 2·w·(1 + ke) hash slots, 8 bytes a sorted key) within
// 227 KB: ops/knn_cuda.refine_smem_bytes states the same layout.
TSNE_API int tsne_refine_chunk_f32(const float* base, const float* sq, int n,
                                   int f, int row0, int c, const int* cand,
                                   int w, const int* graph, int kg, int ke,
                                   int keep, const int* old_i,
                                   const float* old_d, int k, int euclid,
                                   int n_valid, int* out_i, float* out_d,
                                   void* stream) {
  const bool build = graph != nullptr;
  const bool fin = old_i != nullptr;
  if (c < 1 || w < 1 || f < 1 || row0 < 0 || row0 + c > n ||
      n_valid < 1 || n_valid > n ||
      (build && (ke < 1 || ke > kg)) ||
      (fin ? (k < 1 || 2 * k > SORT_MAX) : (keep < 1 || keep > SORT_MAX)))
    return (int)cudaErrorInvalidValue;
  const Params p{base, sq, n, f, row0, c, cand, w, graph, kg, ke, keep,
                 old_i, old_d, k, euclid, n_valid, out_i, out_d};
  const cudaStream_t s = (cudaStream_t)stream;
  if (build) return fin ? launch_width<true, true>(p, s)
                        : launch_width<true, false>(p, s);
  return fin ? launch_width<false, true>(p, s) : launch_width<false, false>(p, s);
}
