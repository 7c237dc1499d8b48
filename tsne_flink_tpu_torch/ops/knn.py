"""k-nearest-neighbour strategies (port of ``tsne_flink_tpu/ops/knn.py``).

* ``bruteforce`` and ``partition`` — the exact graph, both through kernel
  B1 (``ops/knn_cuda.fused_knn``), which never materialises a [c, N]
  distance block: the partition schedule's memory bound is the kernel's
  own (as under the JAX package's Pallas policy).
* ``project`` — the hybrid plan for large N: random-shift Z-order rounds
  with an exact banded re-rank (:func:`knn_project`), then cycles of fresh
  Z-order rounds + one NN-descent refine round (:func:`knn_refine`), whose
  candidate scorer is kernel B6 (``ops/knn_cuda.cand_sqdist``).
* ``auto`` — :func:`pick_knn_method`'s cost model over the FLOP counts of
  ``utils/flops.knn_flops``.

Every method returns ``(neighbor_idx int32 [N, k], neighbor_dist [N, k])``
with rows ascending by distance.  Entries a project round could not fill
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
import time
from dataclasses import dataclass

import torch

from tsne_flink_tpu_torch.ops.knn_cuda import (_cand_vectors, cand_sqdist,
                                               fused_knn)
from tsne_flink_tpu_torch.ops.metrics import metric_fn, pairwise
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


def _resolve_tiles(tiles, n: int, d: int, k: int, backend: str):
    if tiles is not None:
        return tiles
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    return pick_knn_tiles(n, d, k, backend)


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

def pick_knn_rounds(n: int) -> int:
    """Auto project-kNN Z-order SEED rounds: 6 in the 4k-8k band, where
    plain rounds beat refine cycles, else the reference's 3."""
    if 4000 < n <= 8000:
        return 6
    return 3


#: refine-funnel constants, shared with the FLOP model (utils/flops)
FILTER_KEEP = 5       # exact survivors (x k) of the single-stage filter
FILTER_KEEP_WIDE = 8  # stage-1 survivors (x k) when the cascade engages
CASCADE_KEEP = 3      # exact survivors (x k) after the cascade mid stage
CASCADE_DIMS = 128    # mid-stage projection width


def pick_knn_filter(d: int) -> int | None:
    """Auto JL-filter width of the refine funnel: 32 when the full width
    dwarfs it, else no filter."""
    return 32 if d > 128 else None


def pick_knn_cascade(d: int) -> int | None:
    """Auto mid-stage width of the cascaded re-rank: engages when the full
    width dwarfs :data:`CASCADE_DIMS`."""
    return CASCADE_DIMS if d > 2 * CASCADE_DIMS else None


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
#: phase of ``chip_smoke.py`` (1,306,127 x 50, k = 150): B1's exact sweep
#: 14.36 s -> 1.22e13, the hybrid plan (3 seed rounds + 5 cycles) 11.01 s
#: -> 4.53e11, each timed to the end of the device's work.  With them the
#: card's crossover sits near 1M points at d = 50.
KNN_EXACT_EFF = {"cpu": 55e9, "tpu": 2.0e13, "cuda": 1.2e13}
KNN_HYBRID_EFF = {"cpu": 7e9, "tpu": 1.0e12, "cuda": 4.5e11}

#: the plain exact sweep materialises a [row_chunk, N] distance block;
#: past this transient the CPU policy prefers the partition schedule.
#: Kernel B1 never builds the block, so on the card the cap does not apply.
EXACT_TILE_BYTES_MAX = 1 << 30


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

def knn_bruteforce(x: torch.Tensor, k: int, metric: str = "sqeuclidean"):
    """Exact kNN by the full N x N sweep of kernel B1 (its plain version
    on a CPU tensor)."""
    return fused_knn(x, _clamp_k(k, x.shape[0]), metric)


def knn_partition(x: torch.Tensor, k: int, metric: str = "sqeuclidean",
                  blocks: int = 8):
    """Exact kNN under the reference's block-cross schedule
    (``TsneHelpers.scala:61-91``).  ``blocks`` bounded the working-set
    width there; B1 streams column tiles through shared memory and never
    builds a [c, N] block, so its sweep IS the memory-bounded form and the
    result is :func:`knn_bruteforce`'s exact graph."""
    del blocks  # the kernel's tiling bounds the working set
    return knn_bruteforce(x, k, metric)


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


def draw_refine(gen: torch.Generator, plan: RefinePlan, n: int, k: int,
                dim: int, dtype, device) -> RefineDraw:
    """Draw one refine round's gateway scores, reverse-sample order and
    projections from ``gen``."""
    gate = (torch.rand((n, k), generator=gen, dtype=dtype, device=device)
            if plan.s < k else None)
    rev = torch.randperm(n * k, generator=gen, device=device)
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


# ---- the refine funnel's scorers ------------------------------------------

def _cand_sqdist(base: torch.Tensor, sq: torch.Tensor, rows: torch.Tensor,
                 cand: torch.Tensor, compact: bool = False) -> torch.Tensor:
    """Squared euclidean distances row -> candidates, [c] x [c, Z] ->
    [c, Z], with ``sq`` the cached squared norms of ``base``: kernel B6 on
    the card, its plain version on the CPU."""
    return cand_sqdist(base, sq, rows.to(torch.int32),
                       cand.to(torch.int32).contiguous(), compact)


def _cand_exact(metric: str, xf: torch.Tensor, cache: torch.Tensor,
                rows: torch.Tensor, cand: torch.Tensor,
                compact: bool = False) -> torch.Tensor:
    """Exact CLI-metric distances row -> candidates.  ``cache`` holds the
    squared norms (sqeuclidean/euclidean) or the norms (cosine).  Cosine
    is a plain batched product on the card and the elementwise metric on
    the CPU, as the JAX package's accelerator and CPU forms."""
    if metric == "cosine":
        pr = xf[rows.long()]
        pc = _cand_vectors(xf, cand, compact)
        if xf.is_cuda:
            g = torch.einsum("cf,czf->cz", pr, pc)
            return 1.0 - g / (cache[rows.long()][:, None]
                              * cache[cand.long()])
        return metric_fn("cosine")(pr[:, None, :], pc)
    d2 = _cand_sqdist(xf, cache, rows, cand, compact)
    return torch.sqrt(d2) if metric == "euclidean" else d2


def _keep_smallest(score, cand, bad, keep: int):
    """The ``keep`` best-scored candidates of each row, ascending, ties by
    the lowest slot (``lax.top_k(-score, keep)``)."""
    _, sel = _topk_smallest(score, keep)
    return torch.gather(cand, 1, sel), torch.gather(bad, 1, sel)


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
               dedup_gather: bool | str = "auto", tiles=None):
    """Neighbour-of-neighbour refinement of an approximate kNN graph (the
    fixed-shape form of NN-descent's local join), ``rounds`` rounds.

    Each round builds every row's UNDIRECTED gateway set — ``sample``
    out-neighbours (the nearest half always, the rest drawn at random) and
    ``sample`` drawn in-neighbours (:func:`_reverse_sample`), id-deduped —
    proposes the gateways and the first ``expand_k`` out-neighbours of
    each as candidates, id-dedups them per row, ranks them through the
    staged funnel (a JL stage of ``filter_dims``, a ``cascade_dims``
    cascade, each a projection scored by kernel B6), scores the survivors
    exactly in the CLI metric (B6 for sqeuclidean/euclidean), pre-top-ks
    to k and merges them into the row's list.  Rows are processed in
    chunks of ``row_chunk`` (the tile plan's ``refine_chunk``); every
    operation is per row, so the chunk size never changes the result.

    ``draws`` (one :class:`RefineDraw` per round) replaces the draws from
    ``generator`` (default: a generator seeded 7).  ``dedup_gather``
    (True | False | "auto" = False) routes the plain scorers' vector
    gathers through ``ops/knn_cuda._compact_gather``; on the card B6
    gathers in the kernel and the option is moot.  The sharded form (``x_full``,
    ``idx_full``, ``row_offset``, ``n_valid``) is ROADMAP queue A14."""
    if (x_full is not None or idx_full is not None or row_offset
            or n_valid is not None):
        raise NotImplementedError(
            "the sharded refine (x_full, idx_full, row_offset, n_valid) is "
            "not ported yet (ROADMAP queue A14)")
    x = x.contiguous()
    nloc, k = idx.shape
    dim = x.shape[1]
    dev = x.device
    plan = _refine_plan(dim, k, sample=sample, expand_k=expand_k,
                        filter_dims=filter_dims, filter_keep=filter_keep,
                        cascade_dims=cascade_dims, cascade_keep=cascade_keep)
    s, ke = plan.s, plan.ke
    if row_chunk is None:
        row_chunk = _resolve_tiles(tiles, nloc, dim, k,
                                   backend_of(x)).refine_chunk
    compact = False if dedup_gather == "auto" else bool(dedup_gather)
    c = min(row_chunk, nloc)
    if draws is None:
        generator = _generator(generator, dev, 7)
    rows_g = torch.arange(nloc, device=dev)
    staged = plan.filter_dims or plan.cascade_dims
    if staged and metric == "cosine":
        fbase = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                                min=1e-12)
    else:
        fbase = x
    if metric == "cosine":
        xcache = torch.clamp(torch.linalg.norm(x, dim=1), min=1e-12)
    else:
        xcache = torch.sum(x * x, dim=1)

    for rnd in range(max(0, rounds)):
        dr = (draws[rnd] if draws is not None else
              draw_refine(generator, plan, nloc, k, dim, x.dtype, dev))
        if plan.filter_dims:
            proj = (fbase @ dr.filt).contiguous()
            psq = torch.sum(proj * proj, dim=1)
        if plan.cascade_dims:
            proj2 = (fbase @ dr.casc).contiguous()
            p2sq = torch.sum(proj2 * proj2, dim=1)
        gidx = idx.long()
        if s < k:
            score = dr.gate.clone()
            score[:, :max(1, s // 2)] = -math.inf  # the nearest half
            _, gsel = _topk_smallest(score, s)
            gate = torch.gather(gidx, 1, gsel)
        else:
            gate = gidx[:, :s]
        rev = _reverse_sample(idx, s, perm=dr.rev).long()
        rev = torch.where(rev < 0, rows_g[:, None], rev)
        # gateway dedup: a duplicate becomes the row's own id (self-masked
        # at ranking; its expansion re-proposes the row's own neighbours)
        us = torch.sort(torch.cat([gate, rev], dim=1), dim=1).values
        dupu = torch.zeros_like(us, dtype=torch.bool)
        dupu[:, 1:] = us[:, 1:] == us[:, :-1]
        u_loc = torch.where(dupu, rows_g[:, None], us)
        del gate, rev, us, dupu

        new_i = torch.empty_like(idx)
        new_d = torch.empty_like(dist)
        for c0 in range(0, nloc, c):
            rc = rows_g[c0:c0 + c]
            cc = rc.shape[0]
            mine = u_loc[c0:c0 + c]                       # [cc, 2s]
            cand = torch.cat([mine, gidx[mine][..., :ke].reshape(cc, -1)],
                             dim=1)                       # [cc, 2s(1+ke)]
            cand = torch.sort(cand, dim=1).values
            bad = cand == rc[:, None]                     # self
            bad[:, 1:] |= cand[:, 1:] == cand[:, :-1]     # in-row duplicates
            if plan.filter_dims:
                ad = _cand_sqdist(proj, psq, rc, cand, compact)
                cand, bad = _keep_smallest(ad.masked_fill(bad, math.inf),
                                           cand, bad, plan.keep)
            if plan.cascade_dims:
                ad = _cand_sqdist(proj2, p2sq, rc, cand, compact)
                cand, bad = _keep_smallest(ad.masked_fill(bad, math.inf),
                                           cand, bad, plan.keep2)
            dd = _cand_exact(metric, x, xcache, rc, cand,
                             compact).masked_fill(bad, math.inf)
            if dd.shape[1] > k:
                # lossless pre-top-k: candidates are per-row unique, so
                # any id of the final smallest-k of old ∪ new is among the
                # k smallest new ones
                dd, selk = _topk_smallest(dd, k)
                cand = torch.gather(cand, 1, selk)
            ni, nd = _dedup_smallest(
                torch.cat([idx[c0:c0 + c], cand.to(idx.dtype)], dim=1),
                torch.cat([dist[c0:c0 + c], dd], dim=1), k)
            new_i[c0:c0 + c] = ni
            new_d[c0:c0 + c] = nd
        idx, dist = new_i, new_d
    return idx, dist


def _project_round(x, zbase, k: int, metric: str, dr: ProjectDraw, b: int,
                   group: int):
    """One Z-order round: project, shift, sort along the curve, and
    exact-rank each sorted block of ``b`` rows against its contiguous band
    of b + 2k columns, ``group`` blocks per batched product."""
    n = x.shape[0]
    dev = x.device
    z = zbase @ dr.proj if dr.proj is not None else zbase
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
        d = pairwise(metric, x[perm_pad[rpos + k]], x[perm_pad[cpos + k]])
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
                block: int | None = None, start_round: int = 0, tiles=None):
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
    ``generator`` (default: a generator seeded 0)."""
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
        d, i = _project_round(x, zbase, k, metric, dr, b, group)
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
                        on_substage=None, **refine_kwargs):
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
    tiles = _resolve_tiles(tiles, n, dim, k, backend_of(x))
    subs: dict = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if on_substage is not None:
            subs[name] = subs.get(name, 0.0) + timed_stage(x.device, t0)
        return out

    idx, dist = run("zorder_seed", lambda: knn_project(
        x, k, metric, seed_rounds, gen, tiles=tiles))
    for cyc in range(max(0, cycles)):
        iz, dz = run("zorder_cycles", lambda: knn_project(
            x, k, metric, zpc, gen, start_round=seed_rounds + cyc * zpc,
            tiles=tiles))
        idx, dist = run("merge", lambda: merge_rounds([dist, dz], [idx, iz],
                                                      k))
        idx, dist = run("refine", lambda: knn_refine(
            x, idx, dist, metric, rounds=1, generator=gen,
            filter_dims=filter_dims, expand_k=expand_k, tiles=tiles,
            **refine_kwargs))
    if on_substage is not None:
        on_substage(dict(subs))
    return idx, dist


def knn(x: torch.Tensor, k: int, method: str, metric: str = "sqeuclidean",
        *, blocks: int = 8, rounds: int | None = None,
        refine: int | None = None, generator: torch.Generator | None = None,
        tiles=None, on_substage=None):
    """Dispatch on the kNN method (``Tsne.scala:74-79``), resolved by
    :func:`resolve_knn_plan` for the tensor's device.  ``on_substage``
    receives the substage seconds, each measured to the end of the
    device's work (``exact_sweep`` for the exact methods)."""
    n, d = x.shape
    method, rounds, refine = resolve_knn_plan(n, d, method, rounds, refine,
                                              k=k, backend=backend_of(x))
    if method in ("bruteforce", "partition"):
        t0 = time.perf_counter()
        out = (knn_bruteforce(x, k, metric) if method == "bruteforce"
               else knn_partition(x, k, metric, blocks))
        if on_substage is not None:
            on_substage({"exact_sweep": timed_stage(x.device, t0)})
        return out
    if method == "project":
        if refine > 0:
            return knn_project_refined(x, k, metric, rounds, refine,
                                       generator, tiles=tiles,
                                       on_substage=on_substage)
        t0 = time.perf_counter()
        out = knn_project(x, k, metric, rounds, generator, tiles=tiles)
        if on_substage is not None:
            on_substage({"zorder_seed": timed_stage(x.device, t0)})
        return out
    raise ValueError(f"Knn method '{method}' not defined")
