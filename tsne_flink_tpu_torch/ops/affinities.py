"""High-dimensional affinities (port of ``tsne_flink_tpu/ops/affinities.py``).

* :func:`pairwise_affinities` — per-row β bisection so each row's entropy
  is log(perplexity): 50 fixed steps for all rows at once, tolerance
  1e-5, the 1e-7 zero-sum guard (``TsneHelpers.scala:443-504``).
* the split assembly of the symmetrized joint P — :func:`reverse_merge`,
  :func:`split_width`, :func:`joint_distribution_split` — and the
  width-aware :func:`affinity_auto` that chooses it.
* the attraction-layout plan: :func:`edge_count`,
  :func:`edges_beneficial`, :func:`plan_attraction`.

Not ported yet (ROADMAP queue A6): the sorted ``joint_distribution``
builder, ``affinity_pipeline``, and the blocks layout that
``affinity_auto`` picks when the [N, S] rows would not fit.
"""

from __future__ import annotations

import math

import torch

MAX_BISECT_STEPS = 50
H_TOL = 1e-5
ZERO_SUM_GUARD = 1e-7
P_FLOOR = 1e-12
ATTRACTION_MODES = ("auto", "rows", "edges", "csr")
#: affinity_auto keeps the row layout while jidx + jval fit in this many
#: bytes (the JAX package's default; the port reads no override)
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
    c = int(torch.max(rev_deg))
    w = k + (c + 7) // 8 * 8
    return (w, rev) if return_rev else w


def joint_distribution_split(idx: torch.Tensor, p: torch.Tensor,
                             sym_width: int | None = None,
                             rev: torch.Tensor | None = None):
    """Symmetrize + globally normalize into the [N, S] row layout: slots
    [0, k) hold the forward kNN edges with merged values p_j|i + p_i|j,
    slots [k, S) the reverse-only entries in ascending source order.
    Padding is (idx=0, val=0); valid entries carry val >= 1e-12, so
    ``jval > 0`` is the validity mask.  Returns (jidx int32, jval)."""
    n, k = idx.shape
    present, vf, t_s, src_s, val_s = _split_edge_parts(idx, p, rev)
    bounds = torch.searchsorted(
        t_s, torch.arange(n + 1, device=idx.device, dtype=t_s.dtype))
    starts, ends = bounds[:n], bounds[1:]
    if sym_width is None:
        sym_width = k + (int(torch.max(ends - starts)) + 7) // 8 * 8
    s = int(sym_width)
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
    return jidx, jval


def affinity_auto(idx: torch.Tensor, dist: torch.Tensor, perplexity: float,
                  rows_bytes_max: int = ROWS_BYTES_MAX):
    """Calibrate, then build the split rows at their exact lossless width
    when jidx + jval fit in ``rows_bytes_max``.  Returns ``(jidx, jval,
    None, 'split-rows')`` like the JAX function's row branch; its blocks
    branch (hub-pathological graphs) is ROADMAP queue A6 and raises."""
    p_cond = pairwise_affinities(dist, perplexity)
    w, rev = split_width(idx, p_cond, return_rev=True)
    n = int(idx.shape[0])
    rows_bytes = n * w * (4 + p_cond.element_size())
    if rows_bytes > rows_bytes_max:
        raise NotImplementedError(
            f"[N={n}, S={w}] rows need {rows_bytes / 2**30:.1f} GiB (> "
            f"{rows_bytes_max / 2**30:.1f}); the O(Nk) blocks layout that "
            "takes over there is not ported yet (ROADMAP queue A6)")
    jidx, jval = joint_distribution_split(idx, p_cond, sym_width=w, rev=rev)
    return jidx, jval, None, "split-rows"


def edge_count(jval: torch.Tensor, multiple: int = 1024) -> int:
    """Count of valid entries of a padded row layout, rounded up to
    ``multiple`` (a host sync; preprocessing only)."""
    nnz = int(torch.sum(jval > 0))
    return max(multiple, (nnz + multiple - 1) // multiple * multiple)


def edges_beneficial(e_pad: int, n_rows: int, s: int) -> bool:
    """The edge/CSR layout wins when its padded edge count is at most
    half the row layout's rows x S launched pairs."""
    return e_pad <= (n_rows * s) // 2


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
