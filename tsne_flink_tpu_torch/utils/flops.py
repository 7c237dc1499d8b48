"""Analytic FLOP model of the kNN stage (port of part of
``tsne_flink_tpu/utils/flops.py``).

Only what the kNN method policy (``ops/knn.pick_knn_method``) needs: the
exact sweep's N x N distance tiles and the hybrid plan's per-substage
FLOPs.  The model counts the dense work of the shapes launched (2·R·C·D
per distance tile, band padding included), with the refine funnel's
stage widths taken from ``ops/knn`` itself so the two cannot drift.
"""

from __future__ import annotations

import math


def distance_tile_flops(rows: float, cols: float, d: float) -> float:
    """One ``|a|^2+|b|^2-2ab^T`` tile: 2·R·C·D for the product, +3 ops per
    output element for the norm broadcast/add."""
    return rows * cols * (2.0 * d + 3.0)


def _funnel_widths(d: int, k: int, sample: int):
    """The auto staged-funnel widths of ``ops/knn.knn_refine`` (its own
    ``_refine_plan`` under the auto filter/expand policy):
    ``(cand, fd, cd, keep, keep2, ke)`` — ``fd``/``cd`` None for a stage
    that does not run, ``keep`` the candidates the cascade ranks, and
    ``keep2`` those the exact stage scores."""
    from tsne_flink_tpu_torch.ops.knn import _refine_plan, pick_knn_filter
    fd = pick_knn_filter(d)
    plan = _refine_plan(d, k, sample=sample, filter_dims=fd,
                        expand_k=(k + 1) // 2 if fd else None)
    cand = plan.n_cand
    keep = plan.keep if plan.filter_dims else cand
    keep2 = plan.keep2 if plan.cascade_dims else keep
    return cand, plan.filter_dims, plan.cascade_dims, keep, keep2, plan.ke


def knn_substage_flops(n: int, d: int, k: int, *, rounds: int = 3,
                       proj_dims: int = 3, block: int | None = None,
                       refine_rounds: int = 0,
                       refine_sample: int = 8) -> dict:
    """Per-substage FLOPs of the hybrid project-kNN plan: ``zorder_proj``
    (the per-round Gaussian projections), ``zorder_sort`` (0 by
    convention), ``band_rerank`` (the banded [b, b+2k] x d tiles),
    ``gateway`` (the reverse-sample edge sort), ``jl_filter`` /
    ``cascade`` / ``full_rerank`` (the staged funnel) and ``merge``."""
    if block is None:
        from tsne_flink_tpu_torch.ops.knn_tiles import MIN_BLOCK
        block = MIN_BLOCK
    from tsne_flink_tpu_torch.ops.knn import ZORDER_PER_CYCLE
    m = min(d, proj_dims)
    band = min(block, n) + 2 * k
    zrounds = rounds + refine_rounds * ZORDER_PER_CYCLE
    sub = {name: 0.0 for name in
           ("zorder_proj", "zorder_sort", "band_rerank", "gateway",
            "jl_filter", "cascade", "full_rerank", "merge")}
    if d > m:
        sub["zorder_proj"] = zrounds * 2.0 * n * d * m
    sub["band_rerank"] = zrounds * distance_tile_flops(n, band, d)
    if refine_rounds > 0:
        cand, fd, cd, keep, keep2, _ke = _funnel_widths(d, k, refine_sample)
        r = refine_rounds
        sub["gateway"] = r * 2.0 * n * k * math.log2(max(2 * n * k, 2))
        if fd:
            sub["jl_filter"] = r * (2.0 * n * d * fd + n * cand * 3.0 * fd)
        if cd:
            width = keep if fd else cand
            sub["cascade"] = r * (2.0 * n * d * cd + n * width * 3.0 * cd)
        sub["full_rerank"] = r * n * keep2 * 3.0 * d
        sub["merge"] = r * n * (
            cand * math.log2(max(cand, 2))
            + 8.0 * k * math.log2(max(2 * k, 2)))
    return sub


def knn_flops(n: int, d: int, k: int, method: str, *, rounds: int = 3,
              proj_dims: int = 3, block: int | None = None,
              refine_rounds: int = 0, refine_sample: int = 8) -> float:
    """kNN stage FLOPs: the full N x N distance computation for the exact
    methods (``bruteforce``/``partition``), the sum of
    :func:`knn_substage_flops` for ``project``."""
    if method in ("bruteforce", "partition"):
        return distance_tile_flops(n, n, d)
    if method == "project":
        return float(sum(knn_substage_flops(
            n, d, k, rounds=rounds, proj_dims=proj_dims, block=block,
            refine_rounds=refine_rounds,
            refine_sample=refine_sample).values()))
    raise ValueError(f"Knn method '{method}' not defined")
