"""Tile planning for the kNN stage (port of ``tsne_flink_tpu/ops/knn_tiles.py``).

:func:`pick_knn_tiles` sizes every tile of the kNN stage from a
working-set budget instead of constants: the exact tiles' row chunk and
column block, the banded re-rank's row block (pinned at the recall basis
:data:`MIN_BLOCK`) and the refine funnel's row chunk.  The refine row
chunk never changes the graph (every refine operation is per row), so it
is free to grow on the card, where fewer and fatter chunks mean fewer
launches; the band block is a recall-bearing width and stays at the floor.

The JAX package's empirical ``autotune_knn_tiles`` (a CLI/estimator flag)
is ROADMAP queue A9, with the rest of the prepare stage's extras.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
#: package's ceiling for accelerators.  On the card the candidate scorer
#: (kernel B6) gathers candidate vectors inside the kernel, so a chunk's
#: transients are its [c, Z] id/score planes and sort buffers, not the
#: [c, Z, d] gather the budget model counts; the cap rises so the 1.3M
#: refine runs a few hundred chunks a round instead of ~1,300.
MIN_REFINE_CHUNK = 64
MAX_REFINE_CHUNK = 1024
MAX_REFINE_CHUNK_CUDA = 8192

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


def _pow2_at_most(v: float, lo: int, hi: int) -> int:
    """Largest power of two <= v, clamped to [lo, hi]."""
    if v < lo:
        return lo
    return int(min(hi, 2 ** math.floor(math.log2(max(v, 1)))))


def refine_chunk_bytes(c: int, d: int, k: int, *, sample: int = 8,
                       itemsize: int = 4) -> float:
    """Working-set bytes of one ``knn_refine`` row chunk under the auto
    funnel policy, as the JAX model counts it: the candidate id tensors
    ``[c, 2s(1+ke)]``, the staged-projection gathers and the full-width
    exact gather of the cascade survivors."""
    from tsne_flink_tpu_torch.ops.knn import (CASCADE_KEEP, FILTER_KEEP,
                                              FILTER_KEEP_WIDE,
                                              pick_knn_cascade,
                                              pick_knn_filter)
    s = min(sample, k)
    fd = pick_knn_filter(d)
    cd = pick_knn_cascade(d)
    ke = (k + 1) // 2 if fd else k
    cand = 2 * s * (1 + ke)
    total = 3.0 * c * cand * itemsize          # ids + ranks + bad masks
    if fd:
        keep = min((FILTER_KEEP_WIDE if cd else FILTER_KEEP) * k, cand)
        total += c * cand * fd * itemsize      # JL-stage gather [c, cand, fd]
        if cd:
            total += c * keep * cd * itemsize  # cascade gather [c, keep, cd]
            keep = min(CASCADE_KEEP * k, keep)
        total += c * keep * d * itemsize       # exact gather
    else:
        total += c * cand * d * itemsize       # single-stage exact gather
    total += c * 2 * s * k * itemsize          # gateway out-list gather
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


def pick_knn_tiles(n: int, d: int, k: int, backend: str = "cuda",
                   hbm_bytes: int | None = None) -> KnnTilePlan:
    """Analytic tile plan for the kNN stage on ``backend`` (``cuda`` or
    ``cpu``; any other name gets the fallback budget), as the JAX
    function: ``block`` pinned at :data:`MIN_BLOCK`; ``refine_chunk`` the
    CPU's measured 64, grown toward the tile budget elsewhere; the exact
    tiles' ``row_chunk`` sized by the budget (the JAX plan's column block
    has no user here: B1 streams its own column tiles).  A larger budget
    never shrinks a tile."""
    tile_budget = _tile_budget(backend, hbm_bytes)
    block = MIN_BLOCK
    refine_chunk = MIN_REFINE_CHUNK
    if backend != "cpu":
        cap = MAX_REFINE_CHUNK_CUDA if backend == "cuda" else MAX_REFINE_CHUNK
        while (refine_chunk * 2 <= cap
               and refine_chunk_bytes(refine_chunk * 2, d, k) <= tile_budget):
            refine_chunk *= 2
    row_chunk = _pow2_at_most(tile_budget / (max(d, 1) * 4 * 2), 128, 1024)
    return KnnTilePlan(row_chunk=row_chunk, block=block,
                       refine_chunk=refine_chunk,
                       kernel="cuda" if backend == "cuda" else "plain")
