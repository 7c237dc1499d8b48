"""High-dimensional affinities (port of ``tsne_flink_tpu/ops/affinities.py``).

* :func:`pairwise_affinities` — per-row β bisection so each row's entropy
  is log(perplexity): 50 fixed steps for all rows at once, tolerance
  1e-5, the 1e-7 zero-sum guard (``TsneHelpers.scala:443-504``).
* the sorted assembly of the symmetrized joint P — :func:`assemble_rows`,
  :func:`symmetrized_width`, :func:`joint_distribution` — rows sorted by
  neighbour id, the golden-comparable form.
* the split assembly — :func:`reverse_merge`, :func:`split_width`,
  :func:`joint_distribution_split` — and :func:`affinity_pipeline`, which
  runs either builder.
* the blocks layout — :func:`symmetrize_split_blocks`,
  :func:`affinity_blocks` — the width-k forward rows plus the
  reverse-only entries as an edge list, never the [N, S] rows; and the
  width-aware :func:`affinity_auto` that picks split rows or blocks.
* the attraction-layout plan: :func:`edge_count`, :func:`assemble_edges`,
  :func:`edges_beneficial`, :func:`plan_edges`, :func:`plan_attraction`.
* the landmark schedule's layouts: :func:`subsample_affinities` (the
  landmarks' own joint P) and :func:`landmark_placement_rows` (each row's
  conditional affinities onto the landmarks), tensor code on P's device.

Data-dependent widths and counts are read on the host (preprocessing
only), so widths and drop counts come back as Python ints.
"""

from __future__ import annotations

import math
import sys

import torch

MAX_BISECT_STEPS = 50
H_TOL = 1e-5
ZERO_SUM_GUARD = 1e-7
P_FLOOR = 1e-12
ATTRACTION_MODES = ("auto", "rows", "edges", "csr")
#: affinity_auto keeps the row layout while jidx + jval fit in this many
#: bytes, else it takes the blocks layout.  The JAX package's default,
#: kept for parity; it was sized for a TPU's memory and is still to be
#: re-derived for the H100 (ROADMAP "Speed").  The port reads no override.
ROWS_BYTES_MAX = 4 << 30


def _row_entropy(d, valid, beta):
    p = torch.where(valid, torch.exp(-d * beta[:, None]), 0.0)
    sum_p = torch.sum(p, dim=1)
    sum_p = torch.where(sum_p == 0.0, ZERO_SUM_GUARD, sum_p)
    h = torch.log(sum_p) + beta * torch.sum(d * p, dim=1) / sum_p
    return h, p, sum_p


def pairwise_affinities(dist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Row-calibrated conditional affinities p_j|i, [N, k]; non-finite
    distances get p = 0 and each valid row sums to 1."""
    target = math.log(perplexity)
    valid = torch.isfinite(dist)
    d = torch.where(valid, dist, 0.0)
    n = d.shape[0]
    beta = torch.ones(n, dtype=d.dtype, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    for _ in range(MAX_BISECT_STEPS):
        h, _, _ = _row_entropy(d, valid, beta)
        done = done | (torch.abs(h - target) < H_TOL)
        pos = h - target > 0  # entropy too high -> raise beta
        n_lo = torch.where(pos, beta, lo)
        n_hi = torch.where(pos, hi, beta)
        n_beta = torch.where(
            pos,
            torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0))
        beta = torch.where(done, beta, n_beta)
        lo = torch.where(done, lo, n_lo)
        hi = torch.where(done, hi, n_hi)
    _, p, sum_p = _row_entropy(d, valid, beta)
    return p / sum_p[:, None]


def reverse_merge(idx: torch.Tensor, p: torch.Tensor,
                  row_chunk: int | None = None) -> torch.Tensor:
    """``rev[i, a]`` = p_{i|j} for j = idx[i, a] (0 when j does not list
    i): a gather + compare + reduce over [chunk, k, k].  Neighbour ids
    must be distinct within each row (every kNN here guarantees it)."""
    n, k = idx.shape
    if row_chunk is None:
        row_chunk = int(max(256, min(n, 2 ** 27 // max(1, k * k))))
    il = idx.long()
    out = []
    for s in range(0, n, row_chunk):
        ic = il[s:s + row_chunk]
        own = torch.arange(s, s + ic.shape[0], device=idx.device)
        hit = idx[ic] == own[:, None, None]
        out.append(torch.sum(torch.where(hit, p[ic], 0.0), dim=-1))
    return torch.cat(out)


def _split_edge_parts(idx, p, rev=None):
    """Merged forward values plus the reverse-only edge list (target row,
    neighbour, value) sorted stably by target, dump entries (key n) last.
    Returns ``(present, vf, t_sorted, src_sorted, val_sorted)``."""
    n, k = idx.shape
    present = p > 0
    if rev is None:
        rev = reverse_merge(idx, p)
    vf = torch.where(present, p + rev, 0.0)
    emit = present & (rev == 0)
    t = torch.where(emit, idx.long(), n).reshape(-1)
    src = torch.arange(n, dtype=torch.int32,
                       device=idx.device).repeat_interleave(k)
    val = torch.where(emit, p, 0.0).reshape(-1)
    t_s, order = torch.sort(t, stable=True)
    return present, vf, t_s, src[order], val[order]


def split_width(idx: torch.Tensor, p: torch.Tensor, return_rev: bool = False):
    """Exact row width of the split layout: k forward slots + the max
    per-row count of reverse-only entries, rounded up to a multiple of 8
    (a host int).  ``return_rev`` also returns the reverse_merge values."""
    n, k = idx.shape
    rev = reverse_merge(idx, p)
    emit = (p > 0) & (rev == 0)
    rev_deg = torch.bincount(torch.where(emit, idx.long(), n).reshape(-1),
                             minlength=n + 1)[:n]
    # graftlint: disable=host-sync -- a data-dependent width: the host
    # sizes the allocation from it (prepare, once a run)
    c = int(torch.max(rev_deg))
    w = k + (c + 7) // 8 * 8
    return (w, rev) if return_rev else w


def joint_distribution_split(idx: torch.Tensor, p: torch.Tensor,
                             sym_width: int | None = None,
                             return_dropped: bool = False,
                             return_needed: bool = False,
                             return_row_deg: bool = False,
                             rev: torch.Tensor | None = None):
    """Symmetrize + globally normalize into the [N, S] row layout: slots
    [0, k) hold the forward kNN edges with merged values p_j|i + p_i|j,
    slots [k, S) the reverse-only entries in ascending source order.
    Padding is (idx=0, val=0); valid entries carry val >= 1e-12, so
    ``jval > 0`` is the validity mask.  Returns (jidx int32, jval), then
    optionally ``dropped`` (distinct entries lost to an explicit
    ``sym_width``), ``needed`` (the lossless width) and ``row_deg`` (each
    row's true distinct degree), as :func:`joint_distribution` does."""
    n, k = idx.shape
    present, vf, t_s, src_s, val_s = _split_edge_parts(idx, p, rev)
    bounds = torch.searchsorted(
        t_s, torch.arange(n + 1, device=idx.device, dtype=t_s.dtype))
    starts, ends = bounds[:n], bounds[1:]
    rev_deg = ends - starts
    # graftlint: disable=host-sync -- a data-dependent width: the host
    # sizes the allocation from it (prepare, once a run)
    needed = k + (int(torch.max(rev_deg)) + 7) // 8 * 8
    s = needed if sym_width is None else int(sym_width)
    c = max(0, s - k)
    pos = starts[:, None] + torch.arange(c, device=idx.device)
    valid_r = pos < ends[:, None]
    pos_c = torch.clamp(pos, 0, t_s.shape[0] - 1)
    jidx2 = torch.where(valid_r, src_s[pos_c], 0)
    jval2 = torch.where(valid_r, val_s[pos_c], 0.0)
    jidx1 = torch.where(present, idx, 0).to(torch.int32)
    jidx = torch.cat([jidx1, jidx2.to(torch.int32)], dim=1)[:, :s]
    jval = torch.cat([vf, jval2], dim=1)[:, :s]
    sum_p = torch.sum(jval)
    valid = jval > 0
    jval = torch.where(valid, torch.clamp(jval / sum_p, min=P_FLOOR), 0.0)
    jidx = torch.where(valid, jidx, 0)
    out = [jidx, jval]
    if return_dropped:
        # graftlint: disable=host-sync -- the dropped-edge count the caller
        # reports (prepare, once a run)
        dropped = int(torch.sum(torch.clamp(rev_deg - c, min=0)))
        if s < k:  # forward slots past S are sliced off above
            # graftlint: disable=host-sync -- the same count, its overflow part
            dropped += int(torch.sum(present[:, s:]))
        out.append(dropped)
    if return_needed:
        out.append(needed)
    if return_row_deg:
        out.append((torch.sum(present, dim=1) + rev_deg).to(torch.int32))
    return tuple(out)


def symmetrized_width(idx: torch.Tensor, p: torch.Tensor) -> int:
    """Upper bound of any row's distinct degree after symmetrization
    (out-degree + in-degree; mutual pairs count twice), rounded up to a
    multiple of 8, at least 8 — the sorted builder's default width."""
    n = idx.shape[0]
    present = p > 0
    in_deg = torch.bincount(idx[present].long(), minlength=n)
    # graftlint: disable=host-sync -- a data-dependent width: the host
    # sizes the allocation from it (prepare, once a run)
    max_deg = int(torch.max(torch.sum(present, dim=1) + in_deg))
    return max(8, (max_deg + 7) // 8 * 8)


def row_width_bound(k: int, in_degree: int) -> int:
    """The widest symmetrized row a point with k out-neighbours and
    ``in_degree`` in-neighbours can have, rounded as :func:`split_width`
    (k + a multiple of 8) and :func:`symmetrized_width` (a multiple of 8,
    at least 8) round."""
    c = int(in_degree)
    return max(8, k + (c + 7) // 8 * 8, (k + c + 7) // 8 * 8)


def width_bound(idx: torch.Tensor) -> int:
    """An upper bound, from the kNN graph alone, of the symmetrized row
    width every assembly builds from it: :func:`row_width_bound` at the
    largest in-degree.  One bincount over the N·k ids and one host read:
    what the memory model charges for a run's rows before the affinity
    stage builds them.  Ids outside [0, N) are not edges."""
    n, k = idx.shape
    ids = idx.reshape(-1)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    return row_width_bound(
        # graftlint: disable=host-sync -- a data-dependent width: the host
        # sizes the allocation from it (prepare, once a run)
        k, int(torch.max(torch.bincount(ids, minlength=n + 1)[:n])))


def assemble_rows(ii: torch.Tensor, jj: torch.Tensor, vv: torch.Tensor,
                  n_rows: int, sym_width: int | None = None,
                  return_dropped: bool = False, return_needed: bool = False,
                  return_row_deg: bool = False):
    """COO entries -> padded rows ``(jidx [n_rows, S] int32, jval)``,
    merging duplicate (i, j) by summing, rows sorted by neighbour id,
    padded with (0, 0.0), UN-normalized.  ``ii == n_rows`` marks an
    invalid entry.

    The JAX function's two-key ``lax.sort`` is one stable sort of the
    int64 key ``ii·(max jj + 1) + jj``: the same order, ties kept in input
    order.  A run of equal (i, j) is summed by a sorted segment sum.

    With ``sym_width=None`` S is the true max row degree (rounded up to a
    multiple of 8, at least 8).  An explicit width drops the largest-id
    entries of a row that overflows it.  Optional outputs: ``dropped``
    (runs lost to the width), ``needed`` (the lossless width) and
    ``row_deg`` (each row's true distinct degree, int32 [n_rows])."""
    dev = vv.device
    ii, jj = ii.long(), jj.long()
    e = ii.shape[0]
    # graftlint: disable=host-sync -- a data-dependent width: the host
    # sizes the allocation from it (prepare, once a run)
    span = int(torch.max(jj)) + 1 if e else 1
    _, order = torch.sort(ii * span + jj, stable=True)
    ii, jj, vv = ii[order], jj[order], vv[order]

    # run-length merge of duplicate (i, j)
    new_row = torch.ones(e, dtype=torch.bool, device=dev)
    new_row[1:] = ii[1:] != ii[:-1]
    first = new_row.clone()
    first[1:] |= jj[1:] != jj[:-1]
    run = torch.cumsum(first, 0) - 1
    run_sum = torch.segment_reduce(vv, "sum", lengths=torch.bincount(run))
    run_val = run_sum[run]

    # column slot of each run within its row
    row_start_run = torch.cummax(torch.where(new_row, run, 0), 0).values
    col = run - row_start_run

    valid = ii < n_rows
    # graftlint: disable=host-sync -- a data-dependent width: the host
    # sizes the allocation from it (prepare, once a run)
    max_deg = int(torch.max(torch.where(first & valid, col, -1))) + 1 \
        if e else 0
    needed = max(8, (max_deg + 7) // 8 * 8)
    s = needed if sym_width is None else int(sym_width)

    keep = first & (col < s) & valid
    jidx = torch.zeros((n_rows, s), dtype=torch.int32, device=dev)
    jval = torch.zeros((n_rows, s), dtype=vv.dtype, device=dev)
    jidx[ii[keep], col[keep]] = jj[keep].to(torch.int32)
    jval[ii[keep], col[keep]] = run_val[keep]
    out = [jidx, jval]
    if return_dropped:
        # graftlint: disable=host-sync -- the per-band widths of the blocks
        # layout: each sizes one block's allocation (prepare)
        out.append(int(torch.sum(first & (col >= s) & valid)))
    if return_needed:
        out.append(needed)
    if return_row_deg:
        out.append(torch.bincount(ii[first & valid],
                                  minlength=n_rows).to(torch.int32))
    return tuple(out)


def joint_distribution(idx: torch.Tensor, p: torch.Tensor,
                       sym_width: int | None = None,
                       return_dropped: bool = False,
                       return_needed: bool = False,
                       return_row_deg: bool = False):
    """Symmetrize + globally normalize, P_ij = (p_j|i + p_i|j) / ΣP, by
    the sorted builder: the forward and transposed kNN entries through
    :func:`assemble_rows`.  ``(jidx, jval)`` [N, S], rows sorted by
    neighbour id, padded with (0, 0.0); valid entries carry val >= 1e-12.
    Optional outputs as :func:`assemble_rows` gives them."""
    n, k = idx.shape
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1).long()
    present = (p > 0).reshape(-1)
    # absent entries get row id n: they sort last and are dropped
    ii = torch.cat([torch.where(present, rows, n),
                    torch.where(present, cols, n)])
    jj = torch.cat([cols, rows])
    vv = torch.cat([p.reshape(-1), p.reshape(-1)])
    jidx, jval, dropped, needed, row_deg = assemble_rows(
        ii, jj, vv, n, sym_width, return_dropped=True, return_needed=True,
        return_row_deg=True)
    sum_p = torch.sum(jval)
    valid = jval > 0
    jval = torch.where(valid, torch.clamp(jval / sum_p, min=P_FLOOR), 0.0)
    jidx = torch.where(valid, jidx, 0)
    out = [jidx, jval]
    if return_dropped:
        out.append(dropped)
    if return_needed:
        out.append(needed)
    if return_row_deg:
        out.append(row_deg)
    return tuple(out)


def affinity_pipeline(idx: torch.Tensor, dist: torch.Tensor,
                      perplexity: float, sym_width: int | None = None,
                      assembly: str | None = None):
    """kNN distances -> symmetrized normalized P rows ``(jidx, jval)``.

    ``assembly`` is ``"sorted"`` (:func:`joint_distribution`, the default
    for ``None``, as at the JAX call site) or ``"split"``
    (:func:`joint_distribution_split`).  The sorted builder's default
    width is :func:`symmetrized_width`, the split builder's its exact
    lossless width.  An explicit ``sym_width`` may have been sized for
    the other layout: when it would drop entries of the split layout, the
    split builder reruns at its exact width instead of altering P."""
    assembly = "sorted" if assembly is None else assembly
    if assembly not in ("sorted", "split"):
        raise ValueError(
            f"assembly '{assembly}' not in ('sorted', 'split'); for the "
            "edge-direct blocks layout call affinity_blocks, which returns "
            "(jidx, jval, extra_edges)")
    p_cond = pairwise_affinities(dist, perplexity)
    if assembly == "sorted":
        if sym_width is None:
            sym_width = symmetrized_width(idx, p_cond)
        return joint_distribution(idx, p_cond, sym_width=sym_width)
    if sym_width is None:
        w, rev = split_width(idx, p_cond, return_rev=True)
        return joint_distribution_split(idx, p_cond, sym_width=w, rev=rev)
    rev = reverse_merge(idx, p_cond)
    jidx, jval, dropped, needed = joint_distribution_split(
        idx, p_cond, sym_width=sym_width, return_dropped=True,
        return_needed=True, rev=rev)
    if dropped > 0:
        print(f"# sym_width {sym_width} lossless for the sorted layout "
              f"drops {dropped} entries in the split layout; rerunning at "
              f"its exact width {needed}", file=sys.stderr)
        jidx, jval = joint_distribution_split(idx, p_cond, sym_width=needed,
                                              rev=rev)
    return jidx, jval


def symmetrize_split_blocks(idx: torch.Tensor, p: torch.Tensor,
                            rev: torch.Tensor | None = None):
    """The joint P as two blocks, never the [N, S] rows:

    * the forward block ``fwd_val [N, k]``: with ``idx`` as its structure,
      the merged value p_j|i + p_i|j of each kNN entry (0 where absent);
    * the reverse block ``(rev_src, rev_dst, rev_val)`` [N·k] each: the
      reverse-only entries (j lists i, i does not list j) as an edge list
      into ``rev_src``, sorted ascending by it, padding (n-1, 0, 0) last.

    Values are normalized over both blocks and floored at ``P_FLOOR``;
    every distinct entry appears once in each endpoint's view, so forces
    and the KL match the [N, S] rows."""
    n = idx.shape[0]
    present, vf, t_s, dst_s, val_s = _split_edge_parts(idx, p, rev)
    rev_src = torch.clamp(t_s, max=n - 1).to(torch.int32)  # dump n -> n-1
    rev_dst = torch.where(val_s > 0, dst_s, 0).to(torch.int32)
    sum_p = torch.sum(vf) + torch.sum(val_s)
    vf = torch.where(present, torch.clamp(vf / sum_p, min=P_FLOOR), 0.0)
    rev_val = torch.where(val_s > 0, torch.clamp(val_s / sum_p, min=P_FLOOR),
                          0.0)
    return vf, rev_src, rev_dst, rev_val


def affinity_blocks(idx: torch.Tensor, dist: torch.Tensor,
                    perplexity: float):
    """kNN distances -> the blocks layout ``(jidx, jval, extra_edges)``:
    ``(idx, fwd_val)`` is the width-k forward row block and
    ``extra_edges`` the reverse block, for ``optimize(...,
    edges=extra_edges, edges_extra=True)``."""
    p_cond = pairwise_affinities(dist, perplexity)
    fwd_val, rsrc, rdst, rval = symmetrize_split_blocks(idx, p_cond)
    return idx, fwd_val, (rsrc, rdst, rval)


def affinity_auto(idx: torch.Tensor, dist: torch.Tensor, perplexity: float,
                  rows_bytes_max: int = ROWS_BYTES_MAX):
    """Calibrate, then build the split rows at their exact lossless width
    when jidx + jval fit in ``rows_bytes_max``, else the blocks layout.
    Returns ``(jidx, jval, None, 'split-rows')`` or ``(idx, fwd_val,
    (rsrc, rdst, rval), 'blocks')``, as the JAX function does."""
    p_cond = pairwise_affinities(dist, perplexity)
    w, rev = split_width(idx, p_cond, return_rev=True)
    n = int(idx.shape[0])
    rows_bytes = n * w * (4 + p_cond.element_size())
    if rows_bytes <= rows_bytes_max:
        jidx, jval = joint_distribution_split(idx, p_cond, sym_width=w,
                                              rev=rev)
        return jidx, jval, None, "split-rows"
    print(f"# affinity assembly auto: [N={n}, S={w}] rows need "
          f"{rows_bytes / 2**30:.1f} GiB (> {rows_bytes_max / 2**30:.1f}); "
          "using the O(Nk) blocks layout", file=sys.stderr)
    fwd_val, rsrc, rdst, rval = symmetrize_split_blocks(idx, p_cond, rev=rev)
    return idx, fwd_val, (rsrc, rdst, rval), "blocks"


def edge_count(jval: torch.Tensor, multiple: int = 1024) -> int:
    """Count of valid entries of a padded row layout, rounded up to
    ``multiple`` (a host sync; preprocessing only)."""
    # graftlint: disable=host-sync -- the edge count sizes the flat edge
    # list (the attraction plan, once a run)
    nnz = int(torch.sum(jval > 0))
    return max(multiple, (nnz + multiple - 1) // multiple * multiple)


def assemble_edges(jidx: torch.Tensor, jval: torch.Tensor, e_pad: int):
    """Padded rows [N, S] -> the flat edge list ``(src, dst, val)`` of
    length ``e_pad`` (from :func:`edge_count`): the valid entries in
    row-major order, then padding (src = n-1, dst = 0, val = 0), so
    ``src`` ascends end to end and a sorted segment sum may reduce it.
    Mask padding by ``val == 0``, never by src."""
    n, s = jidx.shape
    if n * s >= 2 ** 31:
        # the JAX function's slot cumsum runs in int32 and raises here;
        # the port raises alike so both packages take the same layouts
        # (plan_edges declines this size in auto mode)
        raise ValueError(
            f"edge conversion needs {n} x {s} = {n * s} int32 cumsum slots "
            ">= 2^31; shard the point axis or use attraction='rows'")
    flat_val = jval.reshape(-1)
    nz = torch.nonzero(flat_val > 0).reshape(-1)[:e_pad]
    e = nz.shape[0]
    dev = jidx.device
    src = torch.full((e_pad,), n - 1, dtype=torch.int32, device=dev)
    dst = torch.zeros((e_pad,), dtype=torch.int32, device=dev)
    val = torch.zeros((e_pad,), dtype=jval.dtype, device=dev)
    src[:e] = (nz // s).to(torch.int32)
    dst[:e] = jidx.reshape(-1)[nz].to(torch.int32)
    val[:e] = flat_val[nz]
    return src, dst, val


def edges_beneficial(e_pad: int, n_rows: int, s: int) -> bool:
    """The edge/CSR layout wins when its padded edge count is at most
    half the row layout's rows x S launched pairs."""
    return e_pad <= (n_rows * s) // 2


def plan_edges(jidx: torch.Tensor, jval: torch.Tensor, mode: str = "auto",
               multiple: int = 1024):
    """``(use_edges, e_pad)`` for a row block: True for ``"edges"``, or
    ``"auto"`` when :func:`edges_beneficial`; auto declines a layout whose
    conversion :func:`assemble_edges` would refuse."""
    if mode not in ATTRACTION_MODES:
        raise ValueError(f"attraction mode '{mode}' not defined "
                         f"({' | '.join(ATTRACTION_MODES)})")
    if mode == "rows":
        return False, 0
    n_rows, s = jidx.shape
    if mode == "auto" and n_rows * s >= 2 ** 31:
        return False, 0
    e_pad = edge_count(jval, multiple)
    return (mode == "edges" or edges_beneficial(e_pad, n_rows, s)), e_pad


def plan_attraction(jidx: torch.Tensor, jval: torch.Tensor,
                    mode: str = "auto"):
    """The attraction-layout decision: ``("rows", 0)``, ``("edges",
    e_pad)`` or ``("csr", width)`` (see the JAX function)."""
    if mode not in ATTRACTION_MODES:
        raise ValueError(f"attraction mode '{mode}' not defined "
                         f"({' | '.join(ATTRACTION_MODES)})")
    if mode == "rows":
        return "rows", 0
    n_rows, s = jidx.shape
    if mode == "edges":
        return "edges", edge_count(jval)
    e_pad = edge_count(jval)
    if mode == "csr" or edges_beneficial(e_pad, n_rows, s):
        from tsne_flink_tpu_torch.ops.attraction_cuda import pick_csr_width
        return "csr", pick_csr_width(e_pad, n_rows, s)
    return "rows", 0


def _compact_kept_rows(nbr, vals, keep):
    """Stable left-compaction of the kept entries of a row layout into a
    fresh ``[N, W]`` block, W the kept degree's maximum rounded up to a
    multiple of 8 (at least 8; one host read).  Each kept entry lands at
    its own slot, so the scatter is deterministic."""
    n = keep.shape[0]
    # graftlint: disable=host-sync -- a data-dependent width: the host
    # sizes the allocation from it (prepare, once a run)
    w = int(torch.max(torch.sum(keep, dim=1))) if n else 0
    w = max(8, -(-w // 8) * 8)
    pos = torch.cumsum(keep, dim=1) - 1
    rr, cc = torch.nonzero(keep, as_tuple=True)
    out_idx = torch.zeros((n, w), dtype=nbr.dtype, device=nbr.device)
    out_val = torch.zeros((n, w), dtype=vals.dtype, device=vals.device)
    out_idx[rr, pos[rr, cc]] = nbr[rr, cc]
    out_val[rr, pos[rr, cc]] = vals[rr, cc]
    return out_idx, out_val


def _remap(n: int, landmarks, device):
    """Row id -> landmark-local id (-1 off the landmark set), and the
    landmark ids as a tensor."""
    lm = torch.as_tensor(landmarks, dtype=torch.int64, device=device)
    remap = torch.full((n,), -1, dtype=torch.int64, device=device)
    remap[lm] = torch.arange(lm.shape[0], device=device)
    return remap, lm


def subsample_affinities(jidx: torch.Tensor, jval: torch.Tensor, landmarks):
    """A symmetrized row layout restricted to the landmark set (sorted row
    ids): the edges with both ends landmarks, ids remapped to [0, L),
    each row left-compacted to the subset's own width, renormalized as
    its own joint distribution (ΣP = 1, :data:`P_FLOOR` floor).  Returns
    ``(sub_idx [L, W'] int32, sub_val [L, W'])``."""
    remap, lm = _remap(jidx.shape[0], landmarks, jidx.device)
    rows = remap[jidx[lm].long()]
    vals = jval[lm]
    keep = (vals > 0) & (rows >= 0)
    sub_idx, sub_val = _compact_kept_rows(rows, vals, keep)
    # graftlint: disable=host-sync -- the landmark subsample's mass, read
    # once to renormalize (the landmark schedule's set-up)
    total = float(torch.sum(sub_val))
    if total <= 0.0:
        total = 1.0  # degenerate subset: all-zero rows stay all-zero
    sub_val = torch.where(sub_val > 0,
                          torch.clamp(sub_val / total, min=P_FLOOR), 0.0)
    return sub_idx.to(torch.int32), sub_val.to(jval.dtype)


def landmark_placement_rows(jidx: torch.Tensor, jval: torch.Tensor,
                            landmarks):
    """Each row's conditional affinities onto the landmarks, for the
    interpolation init (``serve/transform.interpolation_init``): entries
    whose neighbour is a landmark, ids remapped to [0, L), left-compacted,
    each row normalized to sum 1 (a row with no landmark neighbour stays
    zero).  Returns ``(ridx [N, W] int32, rval [N, W])``."""
    remap, _ = _remap(jidx.shape[0], landmarks, jidx.device)
    nbr = remap[jidx.long()]
    keep = (jval > 0) & (nbr >= 0)
    ridx, rval = _compact_kept_rows(nbr, jval, keep)
    row_sum = torch.sum(rval, dim=1, keepdim=True)
    rval = torch.where(row_sum > 0,
                       rval / torch.clamp(row_sum, min=1e-300), 0.0)
    return ridx.to(torch.int32), rval.to(jval.dtype)
