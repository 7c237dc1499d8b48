"""k-nearest-neighbour strategies (port of ``tsne_flink_tpu/ops/knn.py``).

* ``bruteforce`` and ``partition`` — the exact graph, both through kernel
  B1 (``ops/knn_cuda.fused_knn``), which never materialises a [c, N]
  distance block: the partition schedule's memory bound is the kernel's
  own (as under the JAX package's Pallas policy).
* ``project`` — the hybrid plan for large N: random-shift Z-order rounds
  with an exact banded re-rank (:func:`knn_project`), then cycles of fresh
  Z-order rounds + one NN-descent refine round (:func:`knn_refine`), whose
  refine chunks run their funnel stages through kernel B6
  (``ops/knn_cuda.refine_keep`` / ``refine_final``).
* ``auto`` — :func:`pick_knn_method`'s cost model over the FLOP counts of
  ``utils/flops.knn_flops``.

Every method returns ``(neighbor_idx int32 [N, k], neighbor_dist [N, k])``
with rows ascending by distance.  ``matmul_dtype`` (None, or
``torch.bfloat16`` under ``--dtype bfloat16``) is the operand dtype of
every distance and projection product the JAX package routes through
``matmul_operands``: B1's sweep, the Z-order projections and banded
re-rank, the refine funnel's projections (not its scores: B6 keeps its
float32 bits, ``ops/knn_cuda``) and the query sweep.  Entries a project round could not fill
carry ``dist == +inf``.

Randomness: every draw of the hybrid plan is made by :func:`draw_project`
or :func:`draw_refine` from an explicit ``torch.Generator``; the functions
below them take the drawn tensors (``draws=``), so a caller can inject any
draws — the parity tests inject the JAX package's.  ``lax.top_k`` and
``jnp.argsort`` break ties by the lowest index; here every selection is a
stable sort (``torch.topk`` fixes no order among ties).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.ops.knn_cuda import (fused_knn, refine_final,
                                               refine_keep)
from tsne_flink_tpu_torch.ops.metrics import matmul_operands, pairwise
from tsne_flink_tpu_torch.ops.zorder import zorder_permutation
from tsne_flink_tpu_torch.utils.device import timed_stage

KNN_METHODS = ("bruteforce", "partition", "project", "auto")

#: rows per pass of the per-row dedup merge (bounds its sort transients:
#: the merges of the 1.3M-point plan sort [N, 3k] planes otherwise)
DEDUP_ROW_CHUNK = 1 << 16


def backend_of(x: torch.Tensor) -> str:
    """The policy backend of a tensor: ``cuda`` or ``cpu``."""
    return "cuda" if x.is_cuda else "cpu"


def _topk_smallest(d: torch.Tensor, k: int):
    """Smallest-k along the last axis -> (dist ascending, idx), ties by
    the lowest index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _resolve_tiles(tiles, n: int, d: int, k: int, backend: str,
                   metric: str = "sqeuclidean"):
    if tiles is not None:
        return tiles
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    return pick_knn_tiles(n, d, k, backend, metric=metric)


def _clamp_k(k: int, n: int) -> int:
    # the reference's first(k) yields shorter groups when k > n-1; the
    # arrays stay regular by clamping
    return int(min(k, n - 1))


def cosine_zbase(x: torch.Tensor) -> torch.Tensor:
    """L2-normalised rows: the cosine metric's Z-order coordinates and B1's
    cosine operand."""
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


# ---- policies (copied from the JAX package; the backend comes from the
# tensor's device) ----------------------------------------------------------

# graftlint: disable=policy-recorded -- a pure function of n; the
# port has no bench record, and the run's PlanConfig resolves the
# same value (resolved_knn), which --auditPlan prints
def pick_knn_rounds(n: int) -> int:
    """Auto project-kNN Z-order SEED rounds: 6 in the 4k-8k band, where
    plain rounds beat refine cycles, else the reference's 3."""
    if 4000 < n <= 8000:
        return 6
    return 3


#: values of x's elementwise square that a refine round's squared norms
#: hold at once (1 GiB at float32): made a row block at a time, the square
#: never exists whole (8.4 GiB at 68,579 x 32,738)
NORM_BLOCK_VALUES = 1 << 28


def norm_rows(d: int) -> int:
    """Rows a block of the refine round's squared norms takes at width
    ``d`` (:data:`NORM_BLOCK_VALUES`)."""
    return max(1, NORM_BLOCK_VALUES // max(d, 1))


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Each row's squared norm, summed a row block of :func:`norm_rows`
    at a time; x of fewer rows is one block, the one-call sum."""
    return torch.cat([torch.sum(b * b, dim=1)
                      for b in x.split(norm_rows(x.shape[1]))])


#: refine-funnel constants, shared with the FLOP model (utils/flops)
FILTER_KEEP = 5       # exact survivors (x k) of the single-stage filter
FILTER_KEEP_WIDE = 8  # stage-1 survivors (x k) when the cascade engages
CASCADE_KEEP = 3      # exact survivors (x k) after the cascade mid stage
CASCADE_DIMS = 128    # mid-stage projection width


# graftlint: disable=policy-recorded -- a pure function of the input
# width d (as in the JAX package)
def pick_knn_filter(d: int) -> int | None:
    """Auto JL-filter width of the refine funnel: 32 when the full width
    dwarfs it, else no filter."""
    return 32 if d > 128 else None


# graftlint: disable=policy-recorded -- a pure function of the input
# width d (as in the JAX package)
def pick_knn_cascade(d: int) -> int | None:
    """Auto mid-stage width of the cascaded re-rank: engages when the full
    width dwarfs :data:`CASCADE_DIMS`."""
    return CASCADE_DIMS if d > 2 * CASCADE_DIMS else None


# graftlint: disable=policy-recorded -- a pure function of (n, d); the
# run's PlanConfig resolves the same value, which --auditPlan prints
def pick_knn_refine(n: int, d: int | None = None) -> int:
    """Auto hybrid refine cycles after the seed: none while the band
    covers a large fraction of N, growing gently with N beyond; two more
    when the staged funnel engages at large N (the JAX package's measured
    recall frontier)."""
    if n <= 8000:
        return 0
    cycles = max(2, min(5, math.ceil(math.log2(n / 4000))))
    if d is not None and n > 32000 and pick_knn_filter(d) is not None:
        cycles = min(cycles + 2, 7)
    return cycles


#: effective kNN-stage throughputs (FLOP/s) :func:`pick_knn_method` weighs
#: the two plans with: ``knn_flops`` over measured wall-clock seconds,
#: deliberately coarse (the decision only has to be right about a ~3x
#: gap).  ``cpu``/``tpu``: the JAX package's (a 1-core CPU host; a v5e).
#: ``cuda``: NVIDIA H100 80GB HBM3 at its 700 W limit, the ``[large]``
#: phase of ``chip_smoke.py`` (1,306,127 x 50, k = 150): B1's exact graph
#: (the 3xTF32 tensor-core sweep) in 9.03 s -> 1.95e13, the hybrid plan (3
#: seed rounds + 5 cycles, each refine chunk's stages in the fused kernel
#: B6) 7.68 s -> 6.49e11, each timed to the end of the device's work.
#: With them the card's crossover at k = 90 sits near 832k points at
#: d = 50 and 768k at d = 784 (``chip_smoke.auto_crossover``).  Checked
#: near it on the same card (``scripts/exact_fft_crossover_cuda.py``,
#: ``make_cells`` cut to 800,000 x 50, k = 90): B1 3.396 and 3.395 s, the
#: hybrid plan (3 + 5 cycles, recall@90 0.9998) 3.324 and 3.330 s,
#: against the model's 3.469 and 3.490 s: a 2% gap that the model calls
#: the other way, as close to the crossover as its coarseness allows.
KNN_EXACT_EFF = {"cpu": 55e9, "tpu": 2.0e13, "cuda": 1.9e13}
KNN_HYBRID_EFF = {"cpu": 7e9, "tpu": 1.0e12, "cuda": 6.5e11}

#: the plain exact sweep materialises a [row_chunk, N] distance block;
#: past this transient the CPU policy prefers the partition schedule.
#: Kernel B1 never builds the block, so on the card the cap does not apply.
EXACT_TILE_BYTES_MAX = 1 << 30


# graftlint: disable=policy-recorded -- a pure function of (n, d, k,
# backend); the run's PlanConfig resolves the same method, which
# --auditPlan prints
def pick_knn_method(n: int, d: int, k: int, backend: str = "cuda") -> str:
    """Auto kNN method: the exact sweep when its predicted wall clock
    beats the hybrid Z-order + NN-descent plan, else ``project``."""
    from tsne_flink_tpu_torch.utils.flops import knn_flops
    rounds = pick_knn_rounds(n)
    refine = pick_knn_refine(n, d)
    exact_s = (knn_flops(n, d, k, "bruteforce")
               / KNN_EXACT_EFF.get(backend, KNN_EXACT_EFF["cpu"]))
    hybrid_s = (knn_flops(n, d, k, "project", rounds=rounds,
                          refine_rounds=refine)
                / KNN_HYBRID_EFF.get(backend, KNN_HYBRID_EFF["cpu"]))
    if exact_s > hybrid_s:
        return "project"
    if backend not in ("tpu", "cuda"):
        from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
        c = pick_knn_tiles(n, d, k, backend).row_chunk
        if c * n * 4 > EXACT_TILE_BYTES_MAX:
            return "partition"
    return "bruteforce"


def resolve_knn_plan(n: int, d: int, method: str, rounds, refine, k=None,
                     backend: str = "cuda"):
    """The RESOLVED ``(method, rounds, refine)`` of a kNN request: ``auto``
    through :func:`pick_knn_method` (``k`` None = 90), and for
    ``project`` the None seed rounds / refine cycles through
    :func:`pick_knn_rounds` / :func:`pick_knn_refine`."""
    if method == "auto":
        method = pick_knn_method(n, d, int(k if k is not None else 90),
                                 backend)
    if method == "project":
        if rounds is None:
            rounds = pick_knn_rounds(n)
        if refine is None:
            refine = pick_knn_refine(n, d)
    return method, rounds, refine


# ---- exact methods ----------------------------------------------------------

def knn_bruteforce(x: torch.Tensor, k: int, metric: str = "sqeuclidean",
                   matmul_dtype=None):
    """Exact kNN by the full N x N sweep of kernel B1 (its plain version
    on a CPU tensor; B1's bf16 form under bf16 operands)."""
    return fused_knn(x, _clamp_k(k, x.shape[0]), metric, matmul_dtype)


def knn_partition(x: torch.Tensor, k: int, metric: str = "sqeuclidean",
                  blocks: int = 8, matmul_dtype=None):
    """Exact kNN under the reference's block-cross schedule
    (``TsneHelpers.scala:61-91``).  ``blocks`` bounded the working-set
    width there; B1 streams column tiles through shared memory and never
    builds a [c, N] block, so its sweep IS the memory-bounded form and the
    result is :func:`knn_bruteforce`'s exact graph."""
    del blocks  # the kernel's tiling bounds the working set
    return knn_bruteforce(x, k, metric, matmul_dtype)


def knn_queries(q: torch.Tensor, x: torch.Tensor, k: int,
                metric: str = "sqeuclidean", matmul_dtype=None):
    """Exact cross-set kNN: each QUERY row's k nearest BASE rows, the
    serving path's sweep (``serve/transform.py``).  Queries are not base
    points, so no self-pair is masked and ``k`` clamps to ``n_base``.
    Row chunks of ``‖a‖² + ‖b‖² − 2abᵀ`` distance tiles (one FP32 matmul
    each; TF32 is switched off for it on the card) and a stable sort per
    row, so ties go to the lowest base index as ``lax.top_k``'s do; the
    chunk comes from the tile plan (:func:`pick_knn_tiles`), which bounds
    the [c, n_base] tile.  Plain tensor code: the JAX package runs this
    sweep outside any Pallas kernel.  ``matmul_dtype``: the products'
    operand dtype (:func:`~.metrics.pairwise`).  Returns ``(idx int32 [B,
    k], dist [B, k])``, rows ascending by distance."""
    nb, dim = x.shape
    nq = q.shape[0]
    k = int(min(k, nb))
    row_chunk = _resolve_tiles(None, max(nq, 1), dim, k,
                               backend_of(x)).row_chunk
    idx, dist = [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, nq, row_chunk):
            d, i = _topk_smallest(pairwise(metric, q[s:s + row_chunk], x,
                                           matmul_dtype), k)
            dist.append(d)
            idx.append(i.to(torch.int32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not idx:
        return (torch.zeros((0, k), dtype=torch.int32, device=x.device),
                x.new_zeros((0, k)))
    return torch.cat(idx), torch.cat(dist)


# ---- merging ----------------------------------------------------------------

def _dedup_smallest(cat_i: torch.Tensor, cat_d: torch.Tensor, k: int):
    """Per row: drop duplicate neighbour ids (keeping each id's SMALLEST
    distance) and return the k nearest survivors.  Two-pass stable sort —
    by distance, then by id — so within an id group the best copy comes
    first.  Rows are independent; large inputs go in row passes."""
    n = cat_i.shape[0]
    if n > DEDUP_ROW_CHUNK:
        parts = [_dedup_smallest(cat_i[s:s + DEDUP_ROW_CHUNK],
                                 cat_d[s:s + DEDUP_ROW_CHUNK], k)
                 for s in range(0, n, DEDUP_ROW_CHUNK)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    o1 = torch.argsort(cat_d, dim=1, stable=True)
    ci = torch.gather(cat_i, 1, o1)
    cd = torch.gather(cat_d, 1, o1)
    o2 = torch.argsort(ci, dim=1, stable=True)
    ci = torch.gather(ci, 1, o2)
    cd = torch.gather(cd, 1, o2)
    dup = torch.zeros_like(ci, dtype=torch.bool)
    dup[:, 1:] = ci[:, 1:] == ci[:, :-1]
    cd = cd.masked_fill(dup, math.inf)
    dd, sel = _topk_smallest(cd, k)
    return torch.gather(ci, 1, sel), dd


def merge_rounds(dists: list, idxs: list, k: int):
    """Merge per-round (dist, idx) candidate sets: per-row dedup by
    neighbour id, keep the smallest k (``TsneHelpers.scala:113-133``)."""
    if len(dists) == 1:
        return idxs[0], dists[0]
    return _dedup_smallest(torch.cat(idxs, dim=1), torch.cat(dists, dim=1),
                           k)


def _reverse_sample(idx: torch.Tensor, r: int,
                    perm: torch.Tensor | None = None) -> torch.Tensor:
    """``r`` IN-neighbours of every point of the directed graph ``idx``
    [N, k]: one stable sort of the edges by (dst, score) and a run-rank
    scatter.  ``perm`` (a permutation of the N·k edges, from
    :func:`draw_refine`) is the score, so points whose in-degree exceeds
    ``r`` get a random subset; without it the smallest src ids win.
    Missing slots carry -1."""
    n, k = idx.shape
    dev = idx.device
    e = n * k
    src = torch.arange(n, device=dev).repeat_interleave(k)
    dst = idx.reshape(-1).long()
    score = src if perm is None else perm.long()
    # lax.sort((dst, score, src), num_keys=2) as one sort on a composite
    # int64 key: score < N·k, so dst·N·k + score orders by (dst, score)
    order = torch.argsort(dst * e + score, stable=True)
    ds = dst[order]
    ss = src[order]
    del order
    first = torch.ones(e, dtype=torch.bool, device=dev)
    first[1:] = ds[1:] != ds[:-1]
    eidx = torch.arange(e, device=dev)
    run_start = torch.cummax(torch.where(first, eidx, 0), dim=0).values
    col = eidx - run_start
    keep = col < r
    out = torch.full((n + 1, r), -1, dtype=torch.int32, device=dev)
    # the dropped edges land in the extra row n, sliced off below
    out[torch.where(keep, ds, n), torch.where(keep, col, 0)] = torch.where(
        keep, ss, -1).to(torch.int32)
    return out[:n]


# ---- the hybrid plan's draws ------------------------------------------------

@dataclass(frozen=True)
class ProjectDraw:
    """One Z-order round's draws: the Gaussian projection [dim, m] (scaled
    by 1/sqrt(dim); None when dim <= m) and the shift fractions [m] in
    [0, 1) (None on the unshifted first round)."""

    proj: torch.Tensor | None
    shift: torch.Tensor | None


@dataclass(frozen=True)
class RefineDraw:
    """One refine round's draws: the gateway scores [nloc, k] in [0, 1)
    (None when the sample covers every out-neighbour), a permutation of
    the N·k edges ordering the reverse sample, and the JL / cascade
    projections [dim, width] scaled by 1/sqrt(dim) (None for a stage that
    does not run)."""

    gate: torch.Tensor | None
    rev: torch.Tensor
    filt: torch.Tensor | None
    casc: torch.Tensor | None


def _gaussian(gen, dim: int, width: int, dtype, device) -> torch.Tensor:
    return torch.randn((dim, width), generator=gen, dtype=dtype,
                       device=device) / math.sqrt(dim)


def draw_project(gen: torch.Generator, dim: int, m: int, shifted: bool,
                 dtype, device) -> ProjectDraw:
    """Draw one Z-order round's projection and shift from ``gen``."""
    proj = _gaussian(gen, dim, m, dtype, device) if dim > m else None
    shift = (torch.rand((m,), generator=gen, dtype=dtype, device=device)
             if shifted else None)
    return ProjectDraw(proj=proj, shift=shift)


@dataclass(frozen=True)
class RefinePlan:
    """The funnel widths of one :func:`knn_refine` call."""

    s: int            # gateway sample per half
    ke: int           # out-neighbours proposed per gateway
    n_cand: int       # candidates per row, 2s(1+ke)
    filter_dims: int | None  # JL stage width, None when it does not run
    keep: int         # JL stage survivors
    cascade_dims: int | None  # cascade width, None when it does not run
    keep2: int        # cascade survivors


def _refine_plan(dim: int, k: int, *, sample: int = 8,
                 expand_k: int | None = None,
                 filter_dims: int | None = None,
                 filter_keep: int | None = None,
                 cascade_dims: int | str | None = "auto",
                 cascade_keep: int = CASCADE_KEEP) -> RefinePlan:
    """The JAX function's funnel rules: cascade eligibility first (it
    decides the stage-1 keep), then the 95% rule that skips a JL stage
    which would keep nearly every candidate."""
    s = min(sample, k)
    ke = min(expand_k, k) if expand_k else k
    n_cand = 2 * s * (1 + ke)
    if cascade_dims == "auto":
        cascade_dims = pick_knn_cascade(dim)
    cascade_ok = (filter_dims is not None and cascade_dims is not None
                  and filter_dims < cascade_dims < dim)
    if filter_keep is None:
        filter_keep = FILTER_KEEP_WIDE if cascade_ok else FILTER_KEEP
    keep = min(filter_keep * k, n_cand)
    do_filter = (filter_dims is not None and 0 < filter_dims < dim
                 and keep < n_cand)
    keep2 = min(cascade_keep * k, keep)
    do_cascade = do_filter and cascade_ok and keep2 < keep
    if do_cascade and keep >= int(0.95 * n_cand):
        do_filter = False
        keep2 = min(cascade_keep * k, n_cand)
        do_cascade = keep2 < n_cand
    return RefinePlan(s=s, ke=ke, n_cand=n_cand,
                      filter_dims=filter_dims if do_filter else None,
                      keep=keep,
                      cascade_dims=cascade_dims if do_cascade else None,
                      keep2=keep2)


def refine_stages(dim: int, k: int, *, sample: int = 8) -> list:
    """The B6 launches of one refine chunk under the auto funnel
    (:func:`knn_project_refined`'s filter and expand policy) at (dim, k),
    in order, as :func:`knn_refine` makes them: ``(f, w, ke, keep, build,
    final)`` — the stage's width, the candidates a row it takes (the 2s
    gateways of the first stage), the ids proposed a gateway (first
    stage), the survivors it keeps (a keep stage) and whether it is the
    first and the exact stage."""
    fd = pick_knn_filter(dim)
    plan = _refine_plan(dim, k, sample=sample, filter_dims=fd,
                        expand_k=(k + 1) // 2 if fd else None)
    widths = [(plan.filter_dims, plan.keep)] if plan.filter_dims else []
    widths += [(plan.cascade_dims, plan.keep2)] if plan.cascade_dims else []
    out, w = [], 2 * plan.s
    for i, (f, keep) in enumerate(widths + [(dim, 0)]):
        build, final = i == 0, i == len(widths)
        if not final:
            keep = min(keep, w * (1 + plan.ke) if build else w)
        out.append((f, w, plan.ke if build else 0, keep, build, final))
        w = keep
    return out


def draw_refine(gen: torch.Generator, plan: RefinePlan, n: int, k: int,
                dim: int, dtype, device, n_graph: int | None = None
                ) -> RefineDraw:
    """Draw one refine round's gateway scores ([n, k]: the refined rows),
    reverse-sample order (of the ``n_graph`` x k edges of the graph the
    sample is drawn from, default ``n``; the sharded refine's is the
    gathered global graph) and projections from ``gen``."""
    gate = (torch.rand((n, k), generator=gen, dtype=dtype, device=device)
            if plan.s < k else None)
    rev = torch.randperm((n if n_graph is None else n_graph) * k,
                         generator=gen, device=device)
    filt = (_gaussian(gen, dim, plan.filter_dims, dtype, device)
            if plan.filter_dims else None)
    casc = (_gaussian(gen, dim, plan.cascade_dims, dtype, device)
            if plan.cascade_dims else None)
    return RefineDraw(gate=gate, rev=rev, filt=filt, casc=casc)


def _generator(gen, device, seed: int) -> torch.Generator:
    if gen is not None:
        return gen
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


# ---- hybrid kNN -------------------------------------------------------------

def knn_refine(x: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor,
               metric: str = "sqeuclidean", rounds: int = 1, *,
               sample: int = 8, row_chunk: int | None = None,
               generator: torch.Generator | None = None,
               draws: list | None = None,
               x_full=None, idx_full=None, row_offset: int = 0,
               n_valid: int | None = None,
               filter_dims: int | None = None,
               filter_keep: int | None = None,
               cascade_dims: int | str | None = "auto",
               cascade_keep: int = CASCADE_KEEP,
               expand_k: int | None = None,
               dedup_gather: bool | str = "auto", tiles=None,
               matmul_dtype=None):
    """Neighbour-of-neighbour refinement of an approximate kNN graph (the
    fixed-shape form of NN-descent's local join), ``rounds`` rounds.

    Each round builds every row's UNDIRECTED gateway set — ``sample``
    out-neighbours (the nearest half always, the rest drawn at random) and
    ``sample`` drawn in-neighbours (:func:`_reverse_sample`), id-deduped —
    proposes the gateways and the first ``expand_k`` out-neighbours of
    each as candidates, id-dedups them per row, ranks them through the
    staged funnel (a JL stage of ``filter_dims``, a ``cascade_dims``
    cascade, each over a projection), scores the survivors exactly in the
    CLI metric, pre-top-ks to k and merges them into the row's list.
    Rows are processed in chunks of ``row_chunk`` (the tile plan's
    ``refine_chunk``), one call of ``ops/knn_cuda.refine_keep`` or
    ``refine_final`` per funnel stage per chunk: kernel B6 on the card
    (the exact stage of cosine excepted), the plain chunk body on the CPU.
    Every operation is per row, so the chunk size never changes the
    result.

    ``draws`` (one :class:`RefineDraw` per round) replaces the draws from
    ``generator`` (default: a generator seeded 7).  ``dedup_gather``
    (True | False | "auto" = False) routes the plain scorers' vector
    gathers through ``ops/knn_cuda._compact_gather``; on the card B6
    gathers in the kernel and the option is moot.  ``matmul_dtype``
    rounds the operands of the JL and cascade projections and of the
    cosine exact stage's product on the card (the JAX package's
    ``knn.py:723-736``, ``:539-544``); the funnel's squared-distance
    scores keep the array's dtype, as the TPU route's Pallas scorer does.

    The sharded form (``parallel/knn.project_knn_sharded``): ``x``,
    ``idx``/``dist`` are the LOCAL row shard (global ids ``row_offset``
    ..), ``x_full``/``idx_full`` the gathered global points and graph,
    which the gathers, the candidate lists and the reverse sample read;
    candidates at or past ``n_valid`` (mesh padding rows) are dropped.
    The draws then take the local shape (the gateway scores [nloc, k],
    drawn alike on every shard as the JAX function draws them) and the
    reverse order the global graph's."""
    xf = (x if x_full is None else x_full).contiguous()
    idx, dist = idx.contiguous(), dist.contiguous()
    gidx = idx if idx_full is None else idx_full.contiguous()
    nloc, k = idx.shape
    dim = xf.shape[1]
    dev = xf.device
    plan = _refine_plan(dim, k, sample=sample, expand_k=expand_k,
                        filter_dims=filter_dims, filter_keep=filter_keep,
                        cascade_dims=cascade_dims, cascade_keep=cascade_keep)
    s, ke = plan.s, plan.ke
    if row_chunk is None:
        row_chunk = _resolve_tiles(tiles, nloc, dim, k, backend_of(xf),
                                   metric).refine_chunk
    compact = False if dedup_gather == "auto" else bool(dedup_gather)
    c = min(row_chunk, nloc)
    if draws is None:
        generator = _generator(generator, dev, 7)
    rows_g = row_offset + torch.arange(nloc, device=dev)
    staged = plan.filter_dims or plan.cascade_dims
    if staged and metric == "cosine":
        fbase = xf / torch.clamp(torch.linalg.norm(xf, dim=1, keepdim=True),
                                 min=1e-12)
    else:
        fbase = xf
    if metric == "cosine":
        xcache = torch.clamp(torch.linalg.norm(xf, dim=1), min=1e-12)
    else:
        xcache = _sq_norms(xf)

    for rnd in range(max(0, rounds)):
        dr = (draws[rnd] if draws is not None else
              draw_refine(generator, plan, nloc, k, dim, xf.dtype, dev,
                          n_graph=gidx.shape[0]))
        if plan.filter_dims:
            fm, rm = matmul_operands(fbase, dr.filt, matmul_dtype)
            proj = (fm @ rm).contiguous()
            del fm, rm
            psq = torch.sum(proj * proj, dim=1)
        if plan.cascade_dims:
            fm, rm = matmul_operands(fbase, dr.casc, matmul_dtype)
            proj2 = (fm @ rm).contiguous()
            del fm, rm
            p2sq = torch.sum(proj2 * proj2, dim=1)
        gidx_loc = gidx[rows_g].long()
        if s < k:
            score = dr.gate.clone()
            score[:, :max(1, s // 2)] = -math.inf  # the nearest half
            _, gsel = _topk_smallest(score, s)
            gate = torch.gather(gidx_loc, 1, gsel)
        else:
            gate = gidx_loc[:, :s]
        # the edge sort is global (in-neighbours of local rows come from
        # anywhere); only the rows are sliced
        rev = _reverse_sample(gidx, s, perm=dr.rev)[rows_g].long()
        rev = torch.where(rev < 0, rows_g[:, None], rev)
        # gateway dedup: a duplicate becomes the row's own id (self-masked
        # at ranking; its expansion re-proposes the row's own neighbours)
        us = torch.sort(torch.cat([gate, rev], dim=1), dim=1).values
        dupu = torch.zeros_like(us, dtype=torch.bool)
        dupu[:, 1:] = us[:, 1:] == us[:, :-1]
        u_loc = torch.where(dupu, rows_g[:, None], us)
        del gate, rev, us, dupu, gidx_loc

        graph = gidx
        if xf.is_cuda:
            u_loc = u_loc.to(torch.int32)  # kernel B6's gateway operand
            graph = graph.to(torch.int32)

        new_i = torch.empty_like(idx)
        new_d = torch.empty_like(dist)
        for c0 in range(0, nloc, c):
            # the chunk's first stage builds its candidates: the gateways
            # and the first ke ids of each gateway's list; its rows are
            # global ids row0 .. of the (gathered) base
            row0 = row_offset + c0
            cand, bad = u_loc[c0:c0 + c], None
            first = dict(graph=graph, ke=ke, n_valid=n_valid)
            if plan.filter_dims:
                cand, bad = refine_keep(proj, psq, row0, cand, plan.keep,
                                        bad=bad, compact=compact, **first)
                first = {}
            if plan.cascade_dims:
                cand, bad = refine_keep(proj2, p2sq, row0, cand, plan.keep2,
                                        bad=bad, compact=compact, **first)
                first = {}
            ni, nd = refine_final(metric, xf, xcache, row0, cand,
                                  idx[c0:c0 + c], dist[c0:c0 + c], bad=bad,
                                  compact=compact, matmul_dtype=matmul_dtype,
                                  **first)
            new_i[c0:c0 + c] = ni
            new_d[c0:c0 + c] = nd
        idx, dist = new_i, new_d
        if idx_full is None:
            gidx = idx  # one device: the next round sees the refined graph
    return idx, dist


def _project_round(x, zbase, k: int, metric: str, dr: ProjectDraw, b: int,
                   group: int, matmul_dtype=None):
    """One Z-order round: project, shift, sort along the curve, and
    exact-rank each sorted block of ``b`` rows against its contiguous band
    of b + 2k columns, ``group`` blocks per batched product; both
    products over operands rounded to ``matmul_dtype``."""
    n = x.shape[0]
    dev = x.device
    if dr.proj is not None:
        zb, rm = matmul_operands(zbase, dr.proj, matmul_dtype)
        z = zb @ rm
        del zb, rm
    else:
        z = zbase
    if dr.shift is not None:  # every round but the unshifted first
        span = torch.amax(z, dim=0) - torch.amin(z, dim=0)
        z = z + dr.shift * span
    perm = zorder_permutation(z).long()
    nb = math.ceil(n / b)
    npad = nb * b
    band = b + 2 * k
    # index-space padding: pad the PERMUTATION and gather each block
    # straight from x (pad values never matter: the position mask kills
    # every out-of-range column)
    perm_pad = perm[torch.clamp(torch.arange(npad + 2 * k, device=dev) - k,
                                0, n - 1)]
    dist_s = torch.empty((npad, k), dtype=x.dtype, device=dev)
    idx_s = torch.empty((npad, k), dtype=torch.long, device=dev)
    r_off = torch.arange(b, device=dev)
    c_off = torch.arange(band, device=dev)
    for g0 in range(0, nb, group):
        starts = torch.arange(g0, min(g0 + group, nb), device=dev) * b
        rpos = starts[:, None] + r_off                    # [G, b] sorted pos
        cpos = starts[:, None] - k + c_off                # [G, band]
        d = pairwise(metric, x[perm_pad[rpos + k]], x[perm_pad[cpos + k]],
                     matmul_dtype)
        bad = (((cpos < 0) | (cpos >= n))[:, None, :]
               | (rpos[:, :, None] == cpos[:, None, :])
               | (rpos >= n)[:, :, None])
        dd, sel = _topk_smallest(d.masked_fill(bad, math.inf), k)
        del d, bad
        gpos = torch.gather(cpos[:, None, :].expand(-1, b, -1), 2, sel)
        lo, hi = g0 * b, g0 * b + rpos.numel()
        dist_s[lo:hi] = dd.reshape(-1, k)
        idx_s[lo:hi] = perm[torch.clamp(gpos, 0, n - 1)].reshape(-1, k)
    # back to point order: row p of the sorted result is point perm[p]
    dist = torch.empty((n, k), dtype=x.dtype, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    dist[perm] = dist_s[:n]
    idx[perm] = idx_s[:n].to(torch.int32)
    return dist, idx


def knn_project(x: torch.Tensor, k: int, metric: str = "sqeuclidean",
                rounds: int = 3, generator: torch.Generator | None = None,
                *, draws: list | None = None, proj_dims: int = 3,
                block: int | None = None, start_round: int = 0, tiles=None,
                matmul_dtype=None):
    """Approximate kNN via random-shift Z-order rounds + exact banded
    re-rank (reference ``projectKnn``, ``TsneHelpers.scala:93-160``).

    For dim > ``proj_dims`` the curve runs over a fresh random Gaussian
    projection each round; every round but the first (``start_round`` 0)
    shifts the coordinates by U[0,1) fractions of their span.  Points are
    ordered along the Z-curve and each sorted row block of ``block`` points
    (the tile plan's, >= 1024) computes exact distances to the contiguous
    band [start − k, end + k) — a plain product per block, ``group`` blocks
    batched (``ops/knn_tiles.project_block_group``).  Per-round results
    merge by per-row id dedup (:func:`merge_rounds`).

    ``draws`` (one :class:`ProjectDraw` per round) replaces the draws from
    ``generator`` (default: a generator seeded 0).  ``matmul_dtype``: the
    projection's and the re-rank's operand dtype."""
    x = x.contiguous()
    n, dim = x.shape
    k = _clamp_k(k, n)
    backend = backend_of(x)
    if block is None:
        block = _resolve_tiles(tiles, n, dim, k, backend).block
    m = min(dim, proj_dims)
    zbase = cosine_zbase(x) if metric == "cosine" else x
    if draws is None:
        gen = _generator(generator, x.device, 0)
        draws = [draw_project(gen, dim, m, it > 0, x.dtype, x.device)
                 for it in range(start_round, start_round + max(1, rounds))]
    from tsne_flink_tpu_torch.ops.knn_tiles import project_block_group
    b = int(min(block, n))
    group = project_block_group(b, dim, k, backend)
    dists, idxs = [], []
    for dr in draws:
        d, i = _project_round(x, zbase, k, metric, dr, b, group,
                              matmul_dtype)
        dists.append(d)
        idxs.append(i)
    return merge_rounds(dists, idxs, k)


#: fresh Z-order rounds merged in before each refine round of the hybrid
#: plan: they inject independent global candidates that break
#: NN-descent's local optimum
ZORDER_PER_CYCLE = 2


def knn_project_refined(x: torch.Tensor, k: int, metric: str = "sqeuclidean",
                        seed_rounds: int = 3, cycles: int = 2,
                        generator: torch.Generator | None = None, *,
                        filter_dims: int | str | None = "auto",
                        expand_k: int | str | None = "auto",
                        z_per_cycle: int | None = None, tiles=None,
                        on_substage=None, matmul_dtype=None,
                        **refine_kwargs):
    """The hybrid high-recall plan: a Z-order seed graph, then ``cycles``
    of (``z_per_cycle`` fresh Z-order rounds merged in + 1 refine round).

    Every draw comes from ``generator`` (default: seeded 0), in one fixed
    order.  With ``on_substage`` (a callable taking ``{name: seconds}``)
    each stage is timed to the end of the device's work — ``zorder_seed``,
    ``zorder_cycles``, ``merge``, ``refine`` — which synchronises the
    device between stages; the graph is the same either way."""
    gen = _generator(generator, x.device, 0)
    n, dim = x.shape
    if filter_dims == "auto":
        filter_dims = pick_knn_filter(dim)
    if expand_k == "auto":
        # the gateways' nearest k/2 out-neighbours only when the filtered
        # funnel runs (the JAX package measured higher recall at less cost)
        expand_k = (k + 1) // 2 if filter_dims else None
    zpc = ZORDER_PER_CYCLE if z_per_cycle is None else z_per_cycle
    tiles = _resolve_tiles(tiles, n, dim, k, backend_of(x), metric)
    subs: dict = {}

    def run(name, fn):
        # the span ends after the substage's sync when one is timed, and
        # measures host time (no sync of its own) otherwise
        with obtrace.span(f"knn.{name}", cat="knn") as sp:
            out = fn()
            if on_substage is not None:
                # graftlint: disable=host-sync -- deliberate: substage timing
                # ends at the device's end of work (on_substage asks for it)
                secs = timed_stage(x.device, sp)
                subs[name] = subs.get(name, 0.0) + secs
        return out

    idx, dist = run("zorder_seed", lambda: knn_project(
        x, k, metric, seed_rounds, gen, tiles=tiles,
        matmul_dtype=matmul_dtype))
    for cyc in range(max(0, cycles)):
        iz, dz = run("zorder_cycles", lambda: knn_project(
            x, k, metric, zpc, gen, start_round=seed_rounds + cyc * zpc,
            tiles=tiles, matmul_dtype=matmul_dtype))
        idx, dist = run("merge", lambda: merge_rounds([dist, dz], [idx, iz],
                                                      k))
        idx, dist = run("refine", lambda: knn_refine(
            x, idx, dist, metric, rounds=1, generator=gen,
            filter_dims=filter_dims, expand_k=expand_k, tiles=tiles,
            matmul_dtype=matmul_dtype, **refine_kwargs))
    if on_substage is not None:
        on_substage(dict(subs))
    return idx, dist


def knn(x: torch.Tensor, k: int, method: str, metric: str = "sqeuclidean",
        *, blocks: int = 8, rounds: int | None = None,
        refine: int | None = None, generator: torch.Generator | None = None,
        tiles=None, on_substage=None, matmul_dtype=None):
    """Dispatch on the kNN method (``Tsne.scala:74-79``), resolved by
    :func:`resolve_knn_plan` for the tensor's device.  ``on_substage``
    receives the substage seconds, each measured to the end of the
    device's work (``exact_sweep`` for the exact methods).
    ``matmul_dtype``: the products' operand dtype (module docstring)."""
    n, d = x.shape
    method, rounds, refine = resolve_knn_plan(n, d, method, rounds, refine,
                                              k=k, backend=backend_of(x))
    if method in ("bruteforce", "partition"):
        with obtrace.span("knn.exact_sweep", cat="knn",
                          method=method) as sp:
            out = (knn_bruteforce(x, k, metric, matmul_dtype)
                   if method == "bruteforce"
                   else knn_partition(x, k, metric, blocks, matmul_dtype))
            if on_substage is not None:
                # graftlint: disable=host-sync -- deliberate: substage timing
                # ends at the device's end of work (on_substage asks for it)
                on_substage({"exact_sweep": timed_stage(x.device, sp)})
        return out
    if method == "project":
        if refine > 0:
            return knn_project_refined(x, k, metric, rounds, refine,
                                       generator, tiles=tiles,
                                       on_substage=on_substage,
                                       matmul_dtype=matmul_dtype)
        with obtrace.span("knn.zorder_seed", cat="knn") as sp:
            out = knn_project(x, k, metric, rounds, generator, tiles=tiles,
                              matmul_dtype=matmul_dtype)
            if on_substage is not None:
                # graftlint: disable=host-sync -- deliberate: substage timing
                # ends at the device's end of work (on_substage asks for it)
                on_substage({"zorder_seed": timed_stage(x.device, sp)})
        return out
    raise ValueError(f"Knn method '{method}' not defined")
