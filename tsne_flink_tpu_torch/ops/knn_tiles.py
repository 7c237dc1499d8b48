"""Tile planning for the kNN stage (port of ``tsne_flink_tpu/ops/knn_tiles.py``).

:func:`pick_knn_tiles` sizes every tile of the kNN stage from a
working-set budget instead of constants: the exact tiles' row chunk and
column block, the banded re-rank's row block (pinned at the recall basis
:data:`MIN_BLOCK`) and the refine funnel's row chunk.  The refine row
chunk never changes the graph (every refine operation is per row), so it
is free to grow on the card, where fewer and fatter chunks mean fewer
launches; the band block is a recall-bearing width and stays at the floor.

:func:`autotune_knn_tiles` (the CLI's ``--knnAutotune``, the estimator's
``knn_autotune=True``) times a few refine chunk widths around the
model's on a row slice of the real input and keeps the fastest.  Tile
sizes are not part of the prepare-artifact fingerprint
(``utils/artifacts.knn_fingerprint``): the refine chunk never changes the
graph, and the band block is pinned.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace

#: usable working-set budget per backend when the caller passes no
#: ``hbm_bytes``.  ``cuda``: the H100's 80 GB less what the large-N kNN
#: stage holds beside its tiles — the input (261 MB at 1.3M x 50), three
#: to five [N, k] graphs (1.57 GB each at k = 150), the merge's [N, 3k]
#: sort transients (~15 GB) and the caching allocator's slack — leaves
#: 48 GiB; it replaces the JAX package's 12 GiB sized for a 16 GB v5e.
#: ``cpu``: a locality target, not a RAM limit (tiles past ~2 GiB stream
#: through every cache level for no gain).
DEFAULT_BUDGET_BYTES = {"cuda": 48 << 30, "cpu": 2 << 30}
_FALLBACK_BUDGET = 2 << 30

#: fraction of the budget any ONE launched tile (plus its operands) may
#: claim: several tiles and their transients are live at once.
TILE_BUDGET_FRACTION = 1 / 16

#: the committed recall sweeps of the JAX package are all measured at
#: block=1024; the planner never goes below it.
MIN_BLOCK = 1024
MAX_BLOCK = 8192

#: refine row-chunk bounds: the CPU's measured optimum, and the JAX
#: package's ceiling for accelerators.  On the card kernel B6 runs each
#: funnel stage of a chunk in shared memory, so a chunk's transients are
#: its [c, keep] / [c, k] outputs, not the [c, Z, d] gather the budget
#: model counts; the cap rises so the 1.3M refine runs a few hundred
#: chunks a round instead of ~1,300.
MIN_REFINE_CHUNK = 64
MAX_REFINE_CHUNK = 1024
MAX_REFINE_CHUNK_CUDA = 8192

#: rows of the slice :func:`autotune_knn_tiles` probes (the JAX package's)
AUTOTUNE_ROWS = 8192

#: the banded re-rank's stable sort holds the [b, band] f32 tile, its
#: sorted copy and int64 positions: ~4x the tile that
#: :func:`project_block_bytes` counts.
SORT_TRANSIENT_FACTOR = 4


@dataclass(frozen=True)
class KnnTilePlan:
    """Resolved tile shapes for one kNN stage invocation."""

    row_chunk: int      # exact-tile row chunk (the plain sweep's)
    block: int          # project banded re-rank row block (band = block + 2k)
    refine_chunk: int   # NN-descent local-join row chunk (knn_refine)
    #: the route of the candidate scorer and the exact sweep: "cuda"
    #: (kernels B1/B6) or "plain" (their plain PyTorch versions, CPU)
    kernel: str = "plain"
    #: how the plan was made: "model" (:func:`pick_knn_tiles`) or
    #: "autotune" (:func:`autotune_knn_tiles`)
    source: str = "model"

    def as_record(self) -> dict:
        """The plan as a JSON-safe dict."""
        return asdict(self)


def _pow2_at_most(v: float, lo: int, hi: int) -> int:
    """Largest power of two <= v, clamped to [lo, hi]."""
    if v < lo:
        return lo
    return int(min(hi, 2 ** math.floor(math.log2(max(v, 1)))))


def refine_workspace_bytes(d: int, k: int, *, sample: int = 8,
                           itemsize: int = 4) -> int:
    """Device memory a chunk row of ``knn_refine`` takes on the card
    beyond the JAX model's count: the largest of the auto funnel's B6
    stages' workspace (``ops/knn_cuda.refine_route``; 0 when every stage
    runs on chip, as at every k <= 1,024) and, for a stage of the
    unstaged form (past ``STAGED_F_MAX`` features), its scratch beside it
    (``ops/knn_cuda.refine_scratch_bytes``: ~3.3 KB a row at k = 90)."""
    from tsne_flink_tpu_torch.ops.knn import refine_stages
    from tsne_flink_tpu_torch.ops.knn_cuda import (refine_route,
                                                   refine_scratch_bytes,
                                                   refine_staged)
    return max(refine_route(f, w, ke, keep, k, build, final,
                            itemsize).workspace
               + (0 if refine_staged(f) else
                  refine_scratch_bytes(w, ke, build, itemsize))
               for f, w, ke, keep, build, final in refine_stages(
                   d, k, sample=sample))


def _funnel(d: int, k: int, sample: int):
    """(candidates a row, the JL and cascade widths, the keeps after each:
    the JL stage's and the exact stage's rows a row) of the auto funnel."""
    from tsne_flink_tpu_torch.ops.knn import (CASCADE_KEEP, FILTER_KEEP,
                                              FILTER_KEEP_WIDE,
                                              pick_knn_cascade,
                                              pick_knn_filter)
    s = min(sample, k)
    fd = pick_knn_filter(d)
    cd = pick_knn_cascade(d)
    ke = (k + 1) // 2 if fd else k
    cand = 2 * s * (1 + ke)
    keep = exact = cand
    if fd:
        keep = exact = min((FILTER_KEEP_WIDE if cd else FILTER_KEEP) * k,
                           cand)
        if cd:
            exact = min(CASCADE_KEEP * k, keep)
    return s, cand, fd, cd, keep, exact


def exact_gather_bytes(c: int, d: int, k: int, *, sample: int = 8,
                       itemsize: int = 4) -> float:
    """The JAX count's full-width exact gather of a chunk (the cascade's
    survivors, the JL stage's, or every candidate, [c, exact, d]): made by
    the plain exact stage (the CPU's, and cosine's on the card), never by
    kernel B6."""
    return float(c * _funnel(d, k, sample)[5] * d * itemsize)


def refine_chunk_bytes(c: int, d: int, k: int, *, sample: int = 8,
                       itemsize: int = 4, workspace: bool = False,
                       metric: str = "sqeuclidean") -> float:
    """Working-set bytes of one ``knn_refine`` row chunk under the auto
    funnel policy, as the JAX model counts it: the candidate id tensors
    ``[c, 2s(1+ke)]``, the staged-projection gathers and the full-width
    exact gather of the cascade survivors.  With ``workspace`` (the card)
    also the chunk's B6 workspace (:func:`refine_workspace_bytes`), and
    past B6's staged width (``ops/knn_cuda.STAGED_F_MAX``) the exact
    gather (:func:`exact_gather_bytes`) only where the exact stage makes
    one: in ``metric`` cosine, whose exact stage is the plain version on
    the card too (``ops/knn_cuda.final_in_kernel``).  B6 never makes it;
    counted, it alone would hold the chunk to 64 rows, one block a row on
    half the card's SMs (at 20,000 x 32,738, k = 90, NVIDIA H100 80GB
    HBM3: 36.7 us a row in a 64-row chunk against 11.2-13.4 in chunks of
    256-4,096, ``scripts/wide_features_phase_cuda.py --chunks``).  Up to
    the staged width the card keeps the JAX count, as its chunks were
    measured."""
    from tsne_flink_tpu_torch.ops.knn_cuda import (final_in_kernel,
                                                   refine_staged)
    s, cand, fd, cd, keep, _ = _funnel(d, k, sample)
    total = 3.0 * c * cand * itemsize          # ids + ranks + bad masks
    if fd:
        total += c * cand * fd * itemsize      # JL-stage gather [c, cand, fd]
        if cd:
            total += c * keep * cd * itemsize  # cascade gather [c, keep, cd]
    if not (workspace and final_in_kernel(metric) and not refine_staged(d)):
        total += exact_gather_bytes(c, d, k, sample=sample,
                                    itemsize=itemsize)
    total += c * 2 * s * k * itemsize          # gateway out-list gather
    if workspace:
        total += c * refine_workspace_bytes(d, k, sample=sample,
                                            itemsize=itemsize)
    return total


def project_block_bytes(b: int, d: int, k: int, *, itemsize: int = 4) -> float:
    """Working-set bytes of one banded re-rank block in ``knn_project``:
    the gathered row/column operands plus the [b, band] distance tile."""
    band = b + 2 * k
    return float((b * d + band * d + b * band) * itemsize)


def _tile_budget(backend: str, hbm_bytes: int | None) -> float:
    if hbm_bytes is None:
        hbm_bytes = DEFAULT_BUDGET_BYTES.get(backend, _FALLBACK_BUDGET)
    return max(hbm_bytes * TILE_BUDGET_FRACTION, 1 << 20)


def project_block_group(b: int, d: int, k: int, backend: str,
                        hbm_bytes: int | None = None) -> int:
    """How many banded re-rank blocks ``knn_project`` batches into one
    product + sort: as many as fit the tile budget with the sort's
    transients (at 1.3M x 50 on the card ~136 of its 1,276 blocks a
    round; a Python loop of single blocks would be launch-bound)."""
    per = project_block_bytes(b, d, k) * SORT_TRANSIENT_FACTOR
    return max(1, int(_tile_budget(backend, hbm_bytes) // per))


# graftlint: disable=policy-recorded -- the resolved plan is printed by
# the CLI ('# knn tiles:') and returned by prepare (knn_tiles)
def pick_knn_tiles(n: int, d: int, k: int, backend: str = "cuda",
                   hbm_bytes: int | None = None,
                   metric: str = "sqeuclidean") -> KnnTilePlan:
    """Analytic tile plan for the kNN stage on ``backend`` (``cuda`` or
    ``cpu``; any other name gets the fallback budget), as the JAX
    function: ``block`` pinned at :data:`MIN_BLOCK`; ``refine_chunk`` the
    CPU's measured 64, grown toward the tile budget elsewhere (on the card
    counting B6's workspace, so a chunk at large k shrinks, and the exact
    gather of ``metric``'s exact stage where it makes one:
    :func:`refine_chunk_bytes`); the exact
    tiles' ``row_chunk`` sized by the budget (the JAX plan's column block
    has no user here: B1 streams its own column tiles).  A larger budget
    never shrinks a tile."""
    tile_budget = _tile_budget(backend, hbm_bytes)
    block = MIN_BLOCK
    refine_chunk = MIN_REFINE_CHUNK
    if backend != "cpu":
        cap = MAX_REFINE_CHUNK_CUDA if backend == "cuda" else MAX_REFINE_CHUNK
        ws = backend == "cuda"  # B6's workspace route, where a stage takes it
        while (refine_chunk * 2 <= cap
               and refine_chunk_bytes(refine_chunk * 2, d, k,
                                      workspace=ws, metric=metric)
               <= tile_budget):
            refine_chunk *= 2
    row_chunk = _pow2_at_most(tile_budget / (max(d, 1) * 4 * 2), 128, 1024)
    return KnnTilePlan(row_chunk=row_chunk, block=block,
                       refine_chunk=refine_chunk,
                       kernel="cuda" if backend == "cuda" else "plain")


def autotune_knn_tiles(x, k: int, metric: str = "sqeuclidean", *,
                       plan: KnnTilePlan | None = None) -> KnnTilePlan:
    """The model's plan with its refine chunk replaced by the fastest of
    2-3 widths (half, the model's, double) measured on a row slice of
    ``x``: one refine round over a one-round Z-order seed graph of the
    first :data:`AUTOTUNE_ROWS` rows, each width run once to warm up and
    once timed to the end of the device's work (host clock;
    ``torch.cuda.synchronize`` on the card).  Labelled
    ``source="autotune"``.  Every refine operation is per row, so the
    chunk never changes the graph; the band block, which does, is never
    probed.  The probe draws from its own generators, so the run's kNN
    stage draws what it would without it.  A slice too small to probe
    (fewer than 2 x MIN_BLOCK rows), or one that fits a single width,
    returns ``plan``."""
    import torch

    from tsne_flink_tpu_torch.obs import trace as obtrace
    from tsne_flink_tpu_torch.ops.knn import (backend_of, knn_project,
                                              knn_refine, pick_knn_filter)
    from tsne_flink_tpu_torch.utils.device import timed_stage

    n, d = int(x.shape[0]), int(x.shape[1])
    backend = backend_of(x)
    if plan is None:
        plan = pick_knn_tiles(n, d, k, backend, metric=metric)
    ns = int(min(n, AUTOTUNE_ROWS))
    if ns < 2 * MIN_BLOCK or ns <= k + 1:
        return plan
    xs = x[:ns].contiguous()

    def gen():
        return torch.Generator(device=x.device).manual_seed(0)

    seed_i, seed_d = knn_project(xs, k, metric, rounds=1, generator=gen(),
                                 block=plan.block)
    fd = pick_knn_filter(d)  # the funnel knn_project_refined runs
    funnel = dict(filter_dims=fd, expand_k=(k + 1) // 2 if fd else None)
    cap = MAX_REFINE_CHUNK_CUDA if backend == "cuda" else MAX_REFINE_CHUNK
    cands = sorted({plan.refine_chunk,
                    max(MIN_REFINE_CHUNK, plan.refine_chunk // 2),
                    min(cap, plan.refine_chunk * 2)})
    cands = [c for c in cands if c <= ns]
    if len(cands) < 2:
        return plan
    seconds = {}
    for c in cands:
        def probe(c=c):
            return knn_refine(xs, seed_i, seed_d, metric, rounds=1,
                              generator=gen(), row_chunk=c, **funnel)
        probe()
        with obtrace.span("knn.autotune_probe", cat="knn",
                          refine_chunk=c) as sp:
            probe()
            # graftlint: disable=host-sync -- deliberate: the autotuner IS a
            # timing probe (off by default: --knnAutotune)
            seconds[c] = timed_stage(x.device, sp)
    return replace(plan, refine_chunk=min(seconds, key=seconds.get),
                   source="autotune")
