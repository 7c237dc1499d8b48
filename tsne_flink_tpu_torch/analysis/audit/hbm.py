"""The memory model: per-stage peak device bytes of a plan (port of the
arithmetic of ``tsne_flink_tpu/analysis/audit/hbm.py``).

Walks prepare → optimize (→ transform for a serving plan) for a
:class:`~tsne_flink_tpu_torch.analysis.audit.plan.PlanConfig` and
accounts the LIVE SET of each stage: the persistent arrays (input, kNN
graph, assembled P, optimizer state) plus the stage's dominant transients,
per stage and per term, so an over-budget verdict names the line that
blew it.  The OOM ladder (``runtime/ladder.py``), the fleet's admission
(``runtime/admission.py``) and the serve daemon's residency gate
(``serve/model.FrozenModel.transform_peak``) all charge it; a batch run's
charge (:func:`charged_peak_bytes`) takes the widest rows its data may
give it, since the hub-widened width is known only once the kNN graph
is.

Every JAX term keeps the JAX arithmetic.  The port's own working set
adds NEW terms, reckoned from the port's code (:func:`_port_knn`,
:func:`_port_affinity`, :func:`_port_optimize`, :func:`_query_sort_bytes`;
PERF.md lists each with the lines it counts): the tensor code's
transients, on the CPU as on the card (the same code runs on both), and
on the card what a kernel or the card's sort holds instead of a JAX tile
(B1 and B2 stream their columns through shared memory; a stable sort's
scratch), the port's callers holding x and the graph through optimize,
and per stage the caching allocator's reserve and the process's CUDA
context, which other processes on the card see and
``torch.cuda.max_memory_allocated`` does not.  A stage's peak is the
larger of the JAX live set and the port's.

An ESTIMATE, not a simulation: it counts what the algorithm must hold,
which is what a plan author controls; the card's measured peak is held
against it by ``chip_smoke.py``'s ``[runtime]`` phase.
"""

from __future__ import annotations

import math

from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.analysis.core import Finding

RULE = "hbm-footprint"

#: the factor the JAX model charges a pipelined transient tile
PIPELINE_FACTOR = 2

#: bytes a CUDA process holds on the card outside the caching allocator:
#: the context, the loaded modules (the kernel library, cuBLAS, cuFFT)
#: and their handles' workspaces — 691.6 MiB measured on an NVIDIA H100
#: 80GB HBM3 (700 W) by chip_smoke.runtime_context (``torch.cuda
#: .mem_get_info`` used bytes less ``torch.cuda.memory_reserved`` in a
#: fresh process after B1, a matmul and an FFT), rounded up to a MiB.
CUDA_CONTEXT_BYTES = 692 << 20

#: bytes a process's libraries keep allocated through the caching
#: allocator once used — cuBLAS's workspace, cuFFT's plan cache — which
#: ``torch.cuda.max_memory_allocated`` counts in the stage of a process
#: that first calls them: 32.0 MiB measured on an NVIDIA H100 80GB HBM3
#: (700 W) by chip_smoke.runtime_context (``torch.cuda.memory_allocated``
#: of a fresh process after B1, a matmul and an FFT, every tensor of its
#: own dropped; PyTorch 2.11, CUDA 12.8).
LIBRARY_WORKSPACE_BYTES = 32 << 20

#: the caching allocator's rounding of the live tensors: it hands a
#: request a whole cached block when the rest would be under 1 MiB
#: (``kSmallSize``: a block is split only when more remains), so every
#: live tensor over 1 MiB may count up to 1 MiB more than its bytes; the
#: port's largest live sets hold at most 16 such tensors (the band
#: group's: x, the two gathers, ``pairwise``'s four tiles, six held
#: graph arrays, the round's two outputs)
ALLOCATOR_ROUNDING_BYTES = 16 << 20

#: the caching allocator's reserve above its allocated peak, as a fraction
#: of the allocated peak (``max_memory_reserved / max_memory_allocated -
#: 1``): the pipeline never empties the cache, so the blocks one stage
#: frees stay reserved while the next allocates other sizes, and other
#: processes see more than the tensors hold.  0.373-0.559 over the
#: smoke's five full-size runs on an NVIDIA H100 80GB HBM3 (700 W;
#: scripts/memory_model_cuda.py), the largest rounded up to a percent.
ALLOCATOR_RESERVE_FRACTION = 0.56

#: streaming multiprocessors of the card the model is written for (an
#: NVIDIA H100 SXM: B2's column splits are a function of it)
CARD_SMS = 132

#: torch.sort's dispatch on the card (ATen ``sort_stable`` / cub): rows of
#: at most this many keys sort in place in shared memory
SMALL_SORT_KEYS = 4096
#: segments at least this long (or a single segment) sort one at a time
#: with O(segment) scratch (``segmented_sort_large_segments``)
LARGE_SEGMENT_KEYS = 1_000_000


def _gib(b: float) -> float:
    return round(b / (1 << 30), 3)


def sort_scratch_bytes(rows: int, cols: int, itemsize: int,
                       backend: str) -> float:
    """Scratch of one stable ``torch.sort(dim=-1)`` of a [rows, cols]
    tensor with int64 indices, beyond its values and indices outputs, as
    the sort's code allocates it: on the card in-place below
    :data:`SMALL_SORT_KEYS` keys a row; one segment at a time (an int64
    iota and cub's alternate key/value buffers of one row) for a single
    row or rows of at least :data:`LARGE_SEGMENT_KEYS` keys; else a full
    sort of all keys with two int2 (index, segment) arrays, a keys-out
    buffer and cub's alternate keys and int2 values.  The CPU sorts rows
    in place (a row's merge buffer, not counted)."""
    if backend != "cuda" or cols <= SMALL_SORT_KEYS:
        return 0.0
    if rows == 1 or cols >= LARGE_SEGMENT_KEYS:
        return float(cols * (8 + itemsize + 8))
    return float(rows * cols * (2 * 8 + itemsize + itemsize + 8))


def _query_sort_bytes(c: int, n: int, isz: int, backend: str) -> float:
    """The query kNN's live bytes beyond the JAX model's two [c, N] tiles
    (``ops/knn.knn_queries``): while ``pairwise`` runs, four [c, N]
    tensors (the product, ‖a‖² + ‖b‖², 2·product and their difference
    before the clamp); while the stable sort runs, the distance tile, the
    sorted values, the int64 indices and the sort's scratch."""
    pairwise = 4.0 * c * n * isz
    sort = c * n * (isz + isz + 8.0) + sort_scratch_bytes(c, n, isz, backend)
    return max(pairwise, sort) - PIPELINE_FACTOR * c * n * isz


def _knn_stage(plan: PlanConfig) -> dict:
    """Live-set candidates of the kNN stage; the stage peak is their max."""
    from tsne_flink_tpu_torch.ops.knn_tiles import (pick_knn_tiles,
                                                    refine_chunk_bytes)
    n, d, k, isz = plan.n, plan.d, plan.k, plan.itemsize
    method = plan.resolved_method()
    x = float(n * d * isz) if method != "precomputed" else 0.0
    graph = float(n * k * (4 + isz))          # idx int32 + dist
    terms: dict = {"input": x, "graph": graph}
    if method in ("bruteforce", "partition"):
        tiles = pick_knn_tiles(n, d, k, plan.backend)
        terms["kernel"] = tiles.kernel
        # one [row_chunk, n] distance tile (+ top-k scratch), pipelined
        terms["exact_tile"] = PIPELINE_FACTOR * tiles.row_chunk * n * isz
        terms["peak"] = x + graph + terms["exact_tile"]
        return terms
    if method == "precomputed":
        terms["peak"] = graph
        return terms

    rounds, refine = plan.resolved_knn()
    tiles = pick_knn_tiles(n, d, k, plan.backend, metric=plan.metric)
    b = min(tiles.block, n)
    npad = math.ceil(n / b) * b

    # --- band sweep (per Z-order round) ---
    from tsne_flink_tpu_torch.ops.knn_tiles import project_block_bytes
    band_tile = PIPELINE_FACTOR * project_block_bytes(b, d, k, itemsize=isz)
    zorder = n * (3 * isz + 2 * 4)            # projected coords, keys, perm
    if plan.knn_padding == "materialized":
        pad_extra = 2.0 * x
    else:
        pad_extra = (npad + 2 * k) * 4.0      # padded PERMUTATION only
    round_out = 2.0 * npad * k * (4 + isz)
    held = max(0, rounds - 1) * n * k * (4 + isz)
    band = x + zorder + pad_extra + band_tile + round_out + held
    terms["band_sweep"] = band

    # --- cross-round merge: concat + 2-pass sort of the [n, rounds*k]
    # candidate set (ids + dists, operands and scratch ~3 copies) ---
    merge_w = max(rounds, 2) * k
    merge = x + 3.0 * n * merge_w * (4 + isz)
    terms["round_merge"] = merge

    peak = max(band, merge)
    if refine > 0:
        from tsne_flink_tpu_torch.ops.knn import (pick_knn_cascade,
                                                  pick_knn_filter)
        fd = pick_knn_filter(d) or 0
        cd = pick_knn_cascade(d) or 0
        proj = n * (fd + cd) * isz
        rev_sort = 3.0 * 2.0 * n * k * 4     # (dst, score, src) 2-pass sort
        chunk = PIPELINE_FACTOR * refine_chunk_bytes(
            tiles.refine_chunk, d, k, itemsize=isz)
        terms["refine"] = x + graph + proj + rev_sort + n * 16 * 4 + chunk
        terms["cycle_merge"] = x + graph + 3.0 * n * 2 * k * (4 + isz)
        peak = max(peak, terms["refine"], terms["cycle_merge"])
    terms["peak"] = peak
    return terms


def _affinity_stage(plan: PlanConfig) -> dict:
    """β search + symmetrized assembly; the input stays live."""
    n, k, isz = plan.n, plan.k, plan.itemsize
    x = float(n * plan.d * isz) if plan.knn_method != "precomputed" else 0.0
    graph = float(n * k * (4 + isz))
    p_cond = float(n * k * isz)
    s = plan.sym_width_est()
    label = plan.resolved_assembly()
    terms: dict = {"input": x, "graph": graph, "p_cond": p_cond,
                   "assembly": label}
    if label == "sorted":
        terms["edge_sort"] = 2.0 * 2.0 * n * k * (8 + isz)
        terms["rows"] = float(n * s * (4 + isz))
    else:
        kk_chunk = min(n * k * k, 2 ** 27)   # reverse_merge row_chunk cap
        terms["reverse_merge"] = 2.0 * kk_chunk * isz + n * k * isz
        terms["edge_sort"] = 2.0 * n * k * (8 + isz)
        if label == "blocks":
            terms["rows"] = n * k * isz + n * k * (8.0 + isz)
        else:
            terms["rows"] = float(n * s * (4 + isz))
    terms["peak"] = (x + graph + p_cond + terms.get("reverse_merge", 0.0)
                     + terms["edge_sort"] + terms["rows"])
    return terms


def _fft_bytes(g: int, m: int, n: int, isz: int) -> float:
    big = float((2 * g) ** m)                 # circulant volume (cells)
    half = big / (2 * g) * (g + 1)            # rfft half-spectrum (cells)
    nch = 1 + m
    taps = 3 ** m                             # interp-order stencil
    return (big * isz + 2.0 * big * isz + 2.0 * half * 2 * isz
            + float(g ** m) * nch * isz + taps * n * (nch + 1.0) * isz
            + big * nch * isz + half * nch * 2 * isz + big * nch * isz)


def _optimize_stage(plan: PlanConfig) -> dict:
    """The loop's resident set and its dominant per-iteration transients
    (the JAX model's terms; on the CPU the caller-held input and kNN
    graph join the live set as ``resident``)."""
    n, k, m, isz = plan.n, plan.k, plan.n_components, plan.itemsize
    mesh = max(1, int(plan.mesh))
    cpu = plan.backend == "cpu"
    nl = n if cpu else -(-n // mesh)
    s = plan.sym_width_est()
    label = plan.resolved_assembly()
    rep = plan.resolved_repulsion()
    terms: dict = {"repulsion": rep, "assembly": label, "mesh": str(mesh)}
    resident = float(n * plan.d * isz + n * k * (4 + isz)) if cpu else 0.0
    terms["resident"] = resident
    state = 2.0 * 3.0 * nl * m * isz
    y_full = float(n * m * isz)
    terms["state"] = state + y_full
    c = min(plan.row_chunk, nl)
    e_est = 2.0 * n * k
    from tsne_flink_tpu_torch.ops.affinities import edges_beneficial
    if label == "blocks":
        p_arrays = nl * k * (4.0 + isz) + nl * k * (8.0 + isz)
        attr = (PIPELINE_FACTOR * c * k * (m * isz + 3.0 * isz)
                + nl * k * (2.0 * m * isz + 4.0 * isz))
    elif plan.attraction == "edges":
        p_arrays = float(nl * s * (4 + isz)) + (e_est / mesh) * (8.0 + isz)
        attr = (e_est / mesh) * (2.0 * m * isz + 4.0 * isz)
    elif plan.attraction in ("auto", "csr") and (
            plan.attraction == "csr" or edges_beneficial(e_est, n, s)):
        from tsne_flink_tpu_torch.ops.attraction_cuda import pick_csr_width
        w = pick_csr_width(int(e_est), n, s)
        tail = max(0.0, e_est - 0.85 * n * min(w, 2 * k)) / mesh
        p_arrays = (float(nl * s * (4 + isz)) + nl * w * (4.0 + isz)
                    + tail * (8.0 + isz))
        # the fused step (the port's default) keeps the attraction output
        # and gradient per row: no [nl, m] round-trip buffers
        attr = (PIPELINE_FACTOR * c * w * (m * isz + 4.0 * isz)
                + tail * (2.0 * m * isz + 4.0 * isz))
    else:
        p_arrays = float(nl * s * (4 + isz))
        attr = PIPELINE_FACTOR * c * s * (m * isz + 4.0 * isz)
    terms["p_arrays"] = p_arrays
    terms["attraction"] = attr
    if rep == "exact":
        terms["repulsion_tile"] = PIPELINE_FACTOR * c * n * isz
    elif rep == "bh":
        from tsne_flink_tpu_torch.ops.repulsion_bh import (default_frontier,
                                                           default_levels)
        lv = default_levels(n, m)
        fr = default_frontier(n, m, lv, plan.theta)
        terms["repulsion_tile"] = c * fr * 3.0 * isz + n * lv * 4.0
    else:
        from tsne_flink_tpu_torch.ops.repulsion_fft import DEFAULT_GRID
        g = plan.fft_grid or DEFAULT_GRID.get(m, 1024)
        terms["repulsion_tile"] = _fft_bytes(g, m, n, isz)
        if plan.autopilot:
            terms["repulsion_tile"] += _fft_bytes(max(32, g // 2), m, n, isz)
    slots = max(1, plan.iterations // 10)
    terms["carries"] = float(slots * 6 * isz + nl * m * isz)
    if plan.autopilot:
        terms["carries"] += float(nl * m * isz + isz + 3 * isz
                                  + slots * 4 * isz)
    terms["peak"] = (resident + terms["state"] + p_arrays + attr
                     + terms["repulsion_tile"] + terms["carries"])
    return terms


def _transform_stage(plan: PlanConfig) -> dict:
    """The serving process's steady state: the frozen model resident (base
    X and Y, the [N, k] graph of a fat checkpoint, the FFT potentials when
    fft serves) plus one bucket of ``serve_queries`` rows' transients (the
    [c, N] query sweep and its sort, the query working set, the
    attraction and repulsion tiles)."""
    n, d, k, m, isz = (plan.n, plan.d, plan.k, plan.n_components,
                       plan.itemsize)
    b = int(plan.serve_queries)
    rep = plan.resolved_repulsion()
    terms: dict = {"repulsion": rep}
    model = float(n * d * isz + n * m * isz + n * k * (4 + isz))
    if rep == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import DEFAULT_GRID
        g = plan.fft_grid or DEFAULT_GRID.get(m, 1024)
        model += float((2 + m) * g ** m * isz)
    terms["model"] = model
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    tiles = pick_knn_tiles(max(b, 1), d, k, plan.backend)
    c = min(tiles.row_chunk, max(b, 1))
    terms["knn_tile"] = PIPELINE_FACTOR * c * n * isz
    terms["query_sort"] = _query_sort_bytes(c, n, isz, plan.backend)
    terms["queries"] = float(b * d * isz + 3.0 * b * m * isz
                             + b * k * (4 + 2.0 * isz))
    rows = min(plan.row_chunk, max(b, 1))
    attr = PIPELINE_FACTOR * rows * k * (m * isz + 4.0 * isz)
    rep_tile = 0.0 if rep == "fft" else PIPELINE_FACTOR * rows * n * isz
    terms["attraction"] = attr
    terms["repulsion_tile"] = rep_tile
    terms["peak"] = (model + terms["knn_tile"] + terms["query_sort"]
                     + terms["queries"] + attr + rep_tile)
    return terms


# ---- the port's own working set ------------------------------------------
#
# Each port term is a NEW key of its stage, reckoned from the port's code
# (PERF.md lists every one with the lines it counts); the JAX keys keep the
# JAX arithmetic, save where a kernel on the card holds nothing of a JAX
# tile (``exact_tile``, ``repulsion_tile`` set to what the kernel holds).
# A stage's ``peak`` is the larger of the JAX live set and the port's.


def _port_knn(plan: PlanConfig, terms: dict) -> None:
    """B1's wrapper sums each row's squared norm in float64
    (``ops/knn_cuda.norm_pairs``: a float64 copy of x and its square; at
    float64 ``norms_f64``'s one product, no (hi, lo) pairs and no copy),
    and B1 streams column tiles through shared memory (no [c, N] tile;
    its float64 form keeps the k-lists in its [N, k] outputs).
    A Z-order round (``ops/knn._project_round``) batches ``g`` band
    blocks (``ops/knn_tiles.project_block_group``) into one product: the
    gathered rows and band columns beside ``pairwise``'s four [g, b, band]
    tiles, or the tile, its mask, the masked copy and the stable sort's
    values and int64 indices (21 B an element); the round's sorted-order
    results hold int64 ids.  The hybrid plan's refine round peaks at the tail of
    ``ops/knn._reverse_sample``: beside x, the graph and the projections,
    the round holds ``idx.long()``, the gateway scores and their clone,
    the int64 reverse permutation, and the caller's last Z-order cycle
    graph (40 B an edge), and the sample itself holds src, dst, the sorted
    dst and src, the run flags, the edge index, the run starts, the
    column ranks, the keep mask and the scatter's three index tensors and
    its int32 values (94 B an edge) — more than its argsort (64 B with the
    card's sort scratch).  On the card B6 runs a refine chunk's funnel in
    shared memory (``refine_chunk`` replaces the JAX chunk's gathers),
    save a stage on its workspace route, whose chunk workspace
    (``b6_workspace``, ``ops/knn_tiles.refine_workspace_bytes``) the term
    adds, and cosine's exact stage, the plain version on the card too,
    its gather of the candidates' vectors (``exact_gather``); a round's
    squared norms hold a row block of x's elementwise square
    (``refine_norms``, at most ``ops/knn.NORM_BLOCK_VALUES`` values);
    B1's float64 form past k = 1,024 holds its pending pairs in device
    memory (``b1_pending``, 12 bytes a pair, 1,024 a row).

    Under bf16 operands (``plan.matmul_dtype``) B1's bf16 form rounds x
    into a bf16 copy it streams (``b1_operands``: 2 bytes a feature, F
    padded to 16), and a band group's product takes rounded float32
    copies of its gathered rows and columns (``ops/metrics
    .matmul_operands``), held while its distance tiles form."""
    n, d, k, isz = plan.n, plan.d, plan.k, plan.itemsize
    x, graph = terms["input"], terms["graph"]
    bf16 = plan.matmul_dtype == "bfloat16"
    if "exact_tile" in terms and plan.backend == "cuda":
        from tsne_flink_tpu_torch.ops.knn_cuda import b1_pending_bytes
        terms["b1_norms"] = (1.0 if plan.dtype == "float64" else 2.0) * (
            n * d * 8)
        terms["exact_tile"] = 0.0
        # the float64 form's pending pairs past k = 1,024 (the float32
        # form keeps its pending keys in shared memory)
        terms["b1_pending"] = float(b1_pending_bytes(
            n, min(k, n - 1), plan.dtype == "float64"))
        terms["peak"] = x + graph + terms["b1_norms"] + terms["b1_pending"]
        if bf16:
            terms["b1_operands"] = 2.0 * n * (d + (-d % 16))
            terms["peak"] = max(terms["peak"],
                                x + graph + terms["b1_operands"])
        return
    if "refine" in terms:
        from tsne_flink_tpu_torch.ops.knn import (pick_knn_cascade,
                                                  pick_knn_filter)
        if plan.backend == "cuda":
            # B6 runs a chunk's funnel in shared memory: the chunk holds
            # its gateways and its new [c, k] lists (ids and distances at
            # the run's itemsize: B6_f64's are float64), not the JAX
            # model's [c, Z, d] gathers
            from tsne_flink_tpu_torch.ops.knn import norm_rows
            from tsne_flink_tpu_torch.ops.knn_cuda import final_in_kernel
            from tsne_flink_tpu_torch.ops.knn_tiles import (
                exact_gather_bytes, pick_knn_tiles, refine_chunk_bytes,
                refine_workspace_bytes)
            c = pick_knn_tiles(n, d, k, plan.backend,
                               metric=plan.metric).refine_chunk
            jax_chunk = PIPELINE_FACTOR * refine_chunk_bytes(c, d, k,
                                                             itemsize=isz)
            # a stage on B6's workspace route (past ~k = 1,100) adds its
            # chunk's workspace, and a stage of its unstaged form (past
            # 12,288 features) the scratch its passes share, one stage's
            # at a time
            terms["b6_workspace"] = float(
                min(c, n) * refine_workspace_bytes(d, k, itemsize=isz))
            terms["exact_gather"] = (
                0.0 if final_in_kernel(plan.metric) else
                PIPELINE_FACTOR * exact_gather_bytes(min(c, n), d, k,
                                                     itemsize=isz))
            terms["refine_chunk"] = PIPELINE_FACTOR * c * (
                16 * 8.0 + k * (4.0 + isz)) + terms["b6_workspace"] + \
                terms["exact_gather"]
            terms["refine"] += terms["refine_chunk"] - jax_chunk
            # the round's squared norms (ops/knn._sq_norms) hold a row
            # block of x's elementwise square beside x and the graph
            terms["refine_norms"] = float(min(n, norm_rows(d)) * d * isz)
            terms["peak"] = max(terms["band_sweep"], terms["round_merge"],
                                terms["refine"], terms["cycle_merge"],
                                x + graph + terms["refine_norms"])
        e = float(n * k)
        proj = n * ((pick_knn_filter(d) or 0) + (pick_knn_cascade(d) or 0)
                    + 2) * isz
        terms["reverse_sample"] = e * (40.0 + 94.0)
        live = x + graph + proj + terms["reverse_sample"]
        terms["peak"] = max(terms["peak"], live)
    if "band_sweep" in terms:
        from tsne_flink_tpu_torch.ops.knn import ZORDER_PER_CYCLE
        from tsne_flink_tpu_torch.ops.knn_tiles import (pick_knn_tiles,
                                                        project_block_group)
        rounds, refine = plan.resolved_knn()
        b = min(pick_knn_tiles(n, d, k, plan.backend).block, n)
        nb = math.ceil(n / b)
        band = b + 2 * k
        g = min(project_block_group(b, d, k, plan.backend), nb)
        tile = float(g * b * band)
        gathers = g * (b + band) * d * isz
        terms["band_group"] = max(gathers + 4.0 * tile * isz,
                                  tile * (3.0 * isz + 1.0 + 8.0))
        if bf16:
            # pairwise holds the rounded copies while its tiles form
            terms["band_group"] = max(terms["band_group"],
                                      2.0 * gathers + 4.0 * tile * isz)
        # the seed's earlier rounds; in a refine cycle, the graph, the
        # last cycle's merged rounds (bound until the new ones return) and
        # the cycle's earlier rounds.  A merge's distances are a view of
        # its sorted [n, rounds·k] candidates (``_topk_smallest``), which
        # the view keeps whole: the seed graph's in the first cycle, the
        # last cycle's rounds' in the later ones
        g1 = n * k * (4 + isz)

        def merged(r):
            return n * k * 4 + n * (r if r > 1 else 1) * k * isz
        held = max(rounds - 1, 0) * g1
        if refine:
            held = max(held, merged(rounds)
                       + (ZORDER_PER_CYCLE - 1) * g1)
        if refine > 1:
            held = max(held, g1 + merged(ZORDER_PER_CYCLE)
                       + (ZORDER_PER_CYCLE - 1) * g1)
        live = (x + n * (3 * isz + 2 * 4) + (nb * b + 2 * k) * 8.0 + held
                + nb * b * k * (isz + 8.0) + terms["band_group"])
        terms["peak"] = max(terms["peak"], live)


def _port_affinity(plan: PlanConfig, terms: dict) -> None:
    """The split builders' phases (``ops/affinities``): ``reverse_merge``
    holds ``idx.long()`` (8 B an edge) and, per row chunk, the gathered
    ids, the hit mask, the gathered p and the select (9 B per [chunk, k,
    k] element); ``_split_edge_parts`` sorts the forward edges holding the
    present/emit masks, the merged values, the int64 targets, the int32
    sources, the values, the sorted targets and the int64 order (30 B an
    edge and two values: 38 B at float32; plus the card's sort scratch);
    the split rows build [N, S] planes from the parts (21 B an edge):
    int64 positions and their clamp, the valid mask, the two gathered
    planes, the concatenated jidx and jval, the validity mask, and the
    normalization's clamp and select (26 B a slot and four values: 42 B
    at float32)."""
    n, k, isz = plan.n, plan.k, plan.itemsize
    e = float(n * k)
    base = terms["input"] + terms["graph"] + terms["p_cond"]
    kk_chunk = min(n * k * k, 2 ** 27)
    terms["reverse_merge_gather"] = kk_chunk * 9.0 + e * (8.0 + isz)
    terms["edge_parts"] = e * (30.0 + 2.0 * isz) + sort_scratch_bytes(
        1, n * k, 8, plan.backend)
    live = max(terms["reverse_merge_gather"],
               e * isz + terms["edge_parts"])
    if terms["assembly"] in ("split-rows", "split"):
        terms["row_planes"] = e * 21.0 + n * plan.sym_width_est() * (
            26.0 + 4.0 * isz)
        live = max(live, e * isz + terms["row_planes"])
    terms["peak"] = max(terms["peak"], base + live)


def _port_optimize(plan: PlanConfig, terms: dict) -> None:
    """The port's callers hold x and the kNN graph through optimize
    (``resident``, as the JAX model counts on the CPU).  The layout's plan
    (``ops/affinities.plan_attraction``) counts the row layout's entries
    through an [N, S] bool mask widened to int64 (9 B a slot) while the
    rows are held.  On the card B2 streams its columns: no [chunk, N]
    tile, only its column splits' partial rep and Z: the slab
    ``ops/repulsion_cuda.partials_bytes`` allocates on :data:`CARD_SMS`
    (the wide form's splits past m = 8, the rows rounded to 4)."""
    n, d, k, m, isz = (plan.n, plan.d, plan.k, plan.n_components,
                       plan.itemsize)
    if plan.backend == "cuda":
        resident = float(n * d * isz + n * k * (4 + isz))
        terms["peak"] += resident - terms["resident"]
        terms["resident"] = resident
        if terms["repulsion"] == "exact":
            from tsne_flink_tpu_torch.ops.repulsion_cuda import (
                partials_bytes)
            tile = float(partials_bytes(n, n, m, isz, CARD_SMS))
            terms["peak"] += tile - terms["repulsion_tile"]
            terms["repulsion_tile"] = tile
    if terms["assembly"] != "blocks" and plan.attraction != "rows":
        s = plan.sym_width_est()
        terms["plan_count"] = n * s * 9.0
        live = terms["resident"] + n * s * (4.0 + isz) + terms["plan_count"]
        terms["peak"] = max(terms["peak"], live)


def _cuda_process(terms: dict) -> None:
    """What the card holds for the stage beyond the stage's tensors: the
    libraries' workspaces and the allocator's rounding (both allocated),
    the caching allocator's reserve and the process's CUDA context."""
    terms["library_workspaces"] = float(LIBRARY_WORKSPACE_BYTES)
    terms["allocator_rounding"] = float(ALLOCATOR_ROUNDING_BYTES)
    terms["peak"] += LIBRARY_WORKSPACE_BYTES + ALLOCATOR_ROUNDING_BYTES
    reserve = ALLOCATOR_RESERVE_FRACTION * terms["peak"]
    terms["allocator_reserve"] = reserve
    terms["cuda_context"] = float(CUDA_CONTEXT_BYTES)
    terms["peak"] += reserve + CUDA_CONTEXT_BYTES


def _cuda_transform(plan: PlanConfig, terms: dict) -> None:
    """The port's frozen model holds the base features, the embedding and
    the FFT potentials, not the [N, k] graph (``serve/model.from_arrays``);
    B2 streams the frozen base's columns: no [rows, N] tile.  A model's
    peak is its allocated bytes; the daemon process's reserve and CUDA
    context are charged once, by :func:`residency_report`."""
    n, k, isz = plan.n, plan.k, plan.itemsize
    graph = float(n * k * (4 + isz))
    terms["model"] -= graph
    terms["peak"] -= graph + terms["repulsion_tile"]
    terms["repulsion_tile"] = 0.0


def allocated_peak(terms: dict) -> float:
    """A stage's peak without the allocator's reserve and the CUDA
    context: what ``torch.cuda.max_memory_allocated`` counts (the
    libraries' workspaces and the allocator's rounding included)."""
    return (terms["peak"] - terms.get("allocator_reserve", 0.0)
            - terms.get("cuda_context", 0.0))


def stage_terms(plan: PlanConfig) -> dict:
    """Every stage's terms in bytes (unrounded), with the port's terms."""
    stages = {"knn": _knn_stage(plan), "affinities": _affinity_stage(plan),
              "optimize": _optimize_stage(plan)}
    _port_knn(plan, stages["knn"])
    _port_affinity(plan, stages["affinities"])
    _port_optimize(plan, stages["optimize"])
    if plan.backend == "cuda":
        for terms in stages.values():
            _cuda_process(terms)
    if int(plan.serve_queries) > 0:
        stages["transform"] = transform_terms(plan)
    return stages


def transform_terms(plan: PlanConfig) -> dict:
    """The transform stage's terms, the port's card terms applied for
    ``backend="cuda"``."""
    terms = _transform_stage(plan)
    if plan.backend == "cuda":
        _cuda_transform(plan, terms)
    return terms


def transform_peak_bytes(plan: PlanConfig) -> int:
    """One model's serving peak in BYTES (the daemon's admission unit):
    the model resident and one bucket's transients."""
    return int(transform_terms(plan)["peak"])


def residency_report(plans) -> dict:
    """Several resident models: their arrays all at once, plus at most two
    buckets' transients (the double-buffered tick), beside the
    conservative sum the admission gate charges.  On the card the peak
    and the sum also carry the daemon process's allocator reserve and CUDA
    context, once."""
    plans = list(plans)
    stages = [transform_terms(p) for p in plans]
    card = any(p.backend == "cuda" for p in plans)
    context = float(CUDA_CONTEXT_BYTES) if card else 0.0
    grow = 1.0 + (ALLOCATOR_RESERVE_FRACTION if card else 0.0)
    resident = float(sum(s["model"] for s in stages))
    transient = max((float(s["peak"]) - float(s["model"]) for s in stages),
                    default=0.0)
    return {"models": len(stages),
            "resident_bytes": int(resident),
            "transient_bytes": int(transient),
            "peak_bytes": int(context + grow * (resident + 2.0 * transient)),
            "conservative_sum_bytes": int(
                context + grow * sum(float(s["peak"]) for s in stages))}


def serving_charge(peak: int, backend: str) -> int:
    """One resident model's charge at the serve daemon's gate: its
    transform peak (:func:`transform_peak_bytes`), on the card grown by
    the caching allocator's reserve.  The CPU charges the peak alone, the
    JAX gate."""
    if backend == "cuda":
        return int((1.0 + ALLOCATOR_RESERVE_FRACTION) * int(peak))
    return int(peak)


def serving_process_bytes(backend: str) -> int:
    """What a serving process adds to its models' charges, once: on the
    card its CUDA context, which a replica, a process of its own, pays
    beside every other; nothing on the CPU.  The gate's total is
    :func:`residency_report`'s ``conservative_sum_bytes``."""
    return int(CUDA_CONTEXT_BYTES) if backend == "cuda" else 0


def charged_plans(plan: PlanConfig) -> list:
    """The plans a run of ``plan`` may turn out to be, whatever its data.
    The run learns its rows' width from the kNN graph, and the model's
    terms grow with the width, so the charge takes the widest rows the run
    may build: a plan without ``sym_width`` (the graph not built yet)
    stands for every width its assembly allows, a plan with one (pinned,
    or ``ops/affinities.width_bound`` of the graph) for every width up to
    it.  ``auto`` builds rows only while they fit the byte gate that picks
    them (``ops/affinities.ROWS_BYTES_MAX``), else the blocks layout: its
    widest rows are capped there, and the blocks layout joins them when
    the width may pass the gate.  ``sorted`` / ``split`` without a width
    may reach a row of every point (``row_width_bound(k, n)``)."""
    if plan.assembly == "blocks":
        return [plan]
    from dataclasses import replace

    from tsne_flink_tpu_torch.ops.affinities import (ROWS_BYTES_MAX,
                                                     row_width_bound)
    s = (row_width_bound(plan.k, plan.n) if plan.sym_width is None
         else int(plan.sym_width))
    if plan.assembly != "auto":
        return [replace(plan, sym_width=s)]
    cap = ROWS_BYTES_MAX // (plan.n * (4 + plan.itemsize))
    plans = [replace(plan, sym_width=min(s, cap))] if cap >= plan.k else []
    if s > cap:
        plans.append(replace(plan, assembly="blocks", sym_width=None))
    return plans


def charged_peak_bytes(plan: PlanConfig) -> int:
    """What a run of ``plan`` is charged — by the fleet's admission and
    the OOM ladder's records: the largest ``peak_hbm_est`` of
    :func:`charged_plans`."""
    return max(int(plan_hbm_report(p)["peak_hbm_est"])
               for p in charged_plans(plan))


def plan_hbm_report(plan: PlanConfig) -> dict:
    """Per-stage peak estimates (GiB, rounded for people) and the
    plan-level verdict (``peak_hbm_est`` in bytes: what admission and the
    ladder charge)."""
    stages = stage_terms(plan)
    peak_stage = max(stages, key=lambda st: stages[st]["peak"])
    peak = stages[peak_stage]["peak"]
    budget = plan.hbm_budget()
    return {
        "plan": plan.name,
        "stages": {st: {t: (v if isinstance(v, str) else _gib(v))
                        for t, v in terms.items()}
                   for st, terms in stages.items()},
        "mesh": max(1, int(plan.mesh)),
        "peak_hbm_est": int(peak),
        "peak_hbm_est_gib": _gib(peak),
        "peak_stage": peak_stage,
        "hbm_budget": budget,
        "ok": budget is None or peak <= budget,
    }


def audit_hbm(plans) -> tuple[list[Finding], dict]:
    """Run the memory model over ``plans``; an over-budget plan is a
    finding (the OOM gate ``--auditPlan`` enforces), with the JAX
    package's message."""
    findings, reports = [], {}
    for plan in plans:
        rep = plan_hbm_report(plan)
        reports[plan.name] = rep
        if not rep["ok"]:
            findings.append(Finding(
                RULE, f"plan:{plan.name}", 1, 0,
                f"predicted peak HBM {rep['peak_hbm_est_gib']} GiB in the "
                f"'{rep['peak_stage']}' stage exceeds the "
                f"{_gib(rep['hbm_budget'])} GiB {plan.backend} budget — "
                "this plan is predicted to OOM (shrink the footprint: "
                "assembly=blocks, a narrower sym_width, or shard the point "
                "axis)"))
    return findings, reports
