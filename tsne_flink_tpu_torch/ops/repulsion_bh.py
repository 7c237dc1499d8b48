"""Barnes-Hut repulsion (port of ``tsne_flink_tpu/ops/repulsion_bh.py``).

An implicit complete quadtree (octree at m = 3) in dense per-level
arrays, evaluated breadth-first with a bounded frontier, as in the JAX
function:

* level l is the dense array of ``2^(m·l)`` Morton-ordered cells over the
  embedding's bounding square; a cell's children are the contiguous ids
  ``c·2^m .. c·2^m + 2^m − 1``.  Each level is one ``[cells, 1 + m]``
  table (point count, coordinate sum), so one gather brings a child's
  whole aggregate;
* every row carries a frontier of at most ``frontier`` cells a level; a
  child is accepted (one body at its centre of mass) when the θ gate
  passes and it is not on the row's own ancestor chain, descended
  otherwise; when more than ``frontier`` children want to descend, the
  closest descend and the rest are accepted early; the deepest level
  accumulates everything left, the row's own leaf shedding the row.

The JAX function ``vmap``s one row's walk over 8,192-row chunks; here a
chunk's rows walk together as batched tensors (frontier ``[c, F]``,
children ``[c, F·2^m]``), the chunk sized by a byte budget
(:data:`CHUNK_BYTES`), so a 1.3M-row call is a few dozen chunks and not
hundreds.  The JAX package computes this in XLA (no Pallas kernel), and
so does the port: plain tensor code, on the card for CUDA tensors.

Determinism, on the card as on the CPU:

* the leaf aggregates are a sorted segment sum — the rows ordered by leaf
  id with a stable sort, each leaf summed in that order by
  ``torch.segment_reduce`` — not a scatter-add, whose atomics would move
  the tree's bits from call to call; the upper levels pool 2^m children
  with ``reshape(-1, 2^m).sum``, as the JAX function does;
* the frontier is the JAX's ``lax.top_k`` set, the lowest index first
  among equal keys: a stable descending sort of the keys (``torch.topk``
  leaves the tie order unspecified on CUDA);
* Z is the per-row partials summed once, in one fixed order.
"""

from __future__ import annotations

import math

import torch

#: Morton bit budget per dimension that keeps cell ids in int32
MAX_LEVELS = {2: 15, 3: 10}
#: dense per-level arrays cost (2^m)^L cells: 2-D at 11 levels 4.2M cells,
#: 3-D at 9 levels 134M (~2.1 GB of f32 count + sums at the leaf level);
#: 3-D below 9 levels leaves clustered embeddings with ~1e-1 force error
#: even at θ = 0 (the JAX package's measurement)
MEM_LEVELS = {2: 11, 3: 9}
#: bytes of chunk intermediates one batched walk may hold at once
CHUNK_BYTES = 1 << 30
#: bytes a child slot of one row costs in a level's intermediates
#: (ids, masks, the gathered aggregate, centre of mass, differences,
#: distances, weights and the sort's keys and indices)
BYTES_PER_CHILD = 160


def default_levels(n: int, m: int) -> int:
    """``ceil(log4 n) + 3`` for both m, capped by :data:`MEM_LEVELS` and
    :data:`MAX_LEVELS` (the JAX package's measured depth policy)."""
    want = math.ceil(math.log(max(n, 2), 4)) + 3
    return max(2, min(MEM_LEVELS[m], MAX_LEVELS[m], want))


def default_frontier(n: int, m: int, levels: int | None = None,
                     theta: float = 0.25) -> int:
    """``16/θ`` in 2-D, ``8/θ²`` in 3-D, rounded up to a multiple of 8 and
    clamped to [16, 256] (the JAX package's measured plateaus); ``n`` and
    ``levels`` are unused, as there."""
    del n, levels
    t = max(theta, 0.05)
    f = int(16.0 / t) if m == 2 else int(8.0 / t ** 2)
    return max(16, min(256, 8 * ((f + 7) // 8)))


def _interleave(q: torch.Tensor, m: int, levels: int) -> torch.Tensor:
    """Bit-interleave quantized [N, m] coords (int64) into Morton cell ids
    at the deepest level."""
    out = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for bit in range(levels - 1, -1, -1):
        for d in range(m - 1, -1, -1):
            out = (out << 1) | ((q[:, d] >> bit) & 1)
    return out


def build_tree(y_full: torch.Tensor, levels: int,
               col_valid: torch.Tensor | None = None):
    """Aggregate (counts, sums) per level, plus the quantization frame.

    Returns ``(counts: list[l -> [B^l]], sums: list[l -> [B^l, m]], lo,
    side, leaf [N] int64)``, as the JAX function does; the level lists
    are views of one ``[B^l, 1 + m]`` table a level (:func:`_tables`)."""
    tables, lo, side, leaf = _tables(y_full, levels, col_valid)
    return ([t[:, 0] for t in tables], [t[:, 1:] for t in tables], lo, side,
            leaf)


def _tables(y_full, levels, col_valid=None):
    """Per level, the ``[B^l, 1 + m]`` table of (count, coordinate sums);
    the frame ``lo``, ``side``; each row's leaf id."""
    n, m = y_full.shape
    b = 2 ** m
    lo = torch.amin(y_full, dim=0)
    hi = torch.amax(y_full, dim=0)
    side = torch.clamp(torch.amax(hi - lo),
                       min=torch.finfo(y_full.dtype).tiny)
    cells = 1 << levels
    qf = torch.clamp(torch.floor((y_full - lo[None, :]) / side * cells),
                     0, cells - 1)
    # clamped again as integers: a non-finite coordinate (a diverging run)
    # must still give an id inside the table
    q = qf.to(torch.int64).clamp_(0, cells - 1)
    leaf = _interleave(q, m, levels)
    w = (torch.ones(n, dtype=y_full.dtype, device=y_full.device)
         if col_valid is None else col_valid.to(y_full.dtype))
    data = torch.cat([w[:, None], y_full * w[:, None]], dim=1)  # [N, 1+m]
    order = torch.argsort(leaf, stable=True)
    lengths = torch.bincount(leaf, minlength=b ** levels)
    tables = [None] * (levels + 1)
    tables[levels] = torch.segment_reduce(data[order], "sum",
                                          lengths=lengths, axis=0)
    for l in range(levels - 1, -1, -1):
        tables[l] = tables[l + 1].reshape(-1, b, 1 + m).sum(dim=1)
    return tables, lo, side, leaf


def _walk(yc, own, tables, side, levels, frontier, theta, gate):
    """One chunk's rows walk the tree together: ``(rep [c, m], sumq [c])``
    — the JAX function's ``point_rep`` over a batch."""
    c, m = yc.shape
    b = 2 ** m
    dev, dt = yc.device, yc.dtype
    rep = torch.zeros((c, m), dtype=dt, device=dev)
    sumq = torch.zeros(c, dtype=dt, device=dev)
    fr = torch.full((c, frontier), -1, dtype=torch.int64, device=dev)
    fr[:, 0] = 0
    branch = torch.arange(b, dtype=torch.int64, device=dev)
    yi = yc[:, None, :]
    theta_ = torch.tensor(theta, dtype=dt, device=dev)

    for l in range(1, levels + 1):
        kids = (fr[:, :, None] * b + branch).reshape(c, -1)   # [c, F·b]
        alive = (fr >= 0)[:, :, None].expand(c, frontier, b).reshape(c, -1)
        kids_safe = torch.where(alive, kids, 0)
        agg = tables[l][kids_safe]                            # [c, K, 1+m]
        cnt = agg[..., 0] * alive
        sm = agg[..., 1:] * alive[..., None]
        occupied = cnt > 0
        if l < levels:
            com = sm / torch.clamp(cnt, min=1)[..., None]
            diff = yi - com
            d2 = torch.sum(diff * diff, dim=2)
            half = side / (2 ** (l + 1))  # half-width of a level-l cell
            on_chain = kids_safe == (own >> (m * (levels - l)))[:, None]
            if gate == "vdm":
                # bhtsne: side / sqrt(D) < θ  <=>  side² < θ²·D
                passed = (2 * half) ** 2 < theta_ * theta_ * d2
            else:
                # reference, QuadTree.scala:134: max(h, w) / D < θ, D = |.|²
                passed = half < theta_ * d2
            accept = occupied & ~on_chain & passed
            q = 1.0 / (1.0 + d2)
            contrib = (cnt * q) * accept
            sumq = sumq + torch.sum(contrib, dim=1)
            rep = rep + torch.sum((contrib * q)[..., None] * diff, dim=1)
            # descend the rest, the closest first; past ``frontier`` the
            # farthest are accepted instead (lax.top_k's set and order)
            want = occupied & ~accept
            key = torch.where(want, -d2, -math.inf)
            sel = torch.sort(key, dim=1, descending=True,
                             stable=True).indices[:, :frontier]
            sel_want = torch.gather(want, 1, sel)
            fr = torch.where(sel_want, torch.gather(kids_safe, 1, sel), -1)
            chosen = torch.zeros_like(want).scatter_(1, sel, sel_want)
            overflow = want & ~chosen
            contrib_o = (cnt * q) * overflow
            sumq = sumq + torch.sum(contrib_o, dim=1)
            rep = rep + torch.sum((contrib_o * q)[..., None] * diff, dim=1)
        else:
            # deepest level: everything left is accumulated; the row's own
            # leaf sheds the row from its aggregates
            mine = kids_safe == own[:, None]
            cnt_adj = torch.where(mine & occupied, cnt - 1, cnt)
            sm_adj = torch.where(mine[..., None], sm - yi, sm)
            occ = occupied & (cnt_adj > 0)
            com_adj = sm_adj / torch.clamp(cnt_adj, min=1)[..., None]
            diff_adj = yi - com_adj
            d2_adj = torch.sum(diff_adj * diff_adj, dim=2)
            q = 1.0 / (1.0 + d2_adj)
            contrib = (cnt_adj * q) * occ
            sumq = sumq + torch.sum(contrib, dim=1)
            rep = rep + torch.sum((contrib * q)[..., None] * diff_adj, dim=1)
    return rep, sumq


def chunk_rows(frontier: int, m: int, budget: int = CHUNK_BYTES) -> int:
    """Rows a batched walk takes at once: ``budget`` over the bytes one
    row's ``frontier · 2^m`` children cost in a level's intermediates."""
    return max(1, budget // (frontier * 2 ** m * BYTES_PER_CHILD))


def bh_repulsion(y: torch.Tensor, y_full: torch.Tensor | None = None, *,
                 theta: float = 0.25, levels: int | None = None,
                 frontier: int | None = None, gate: str = "vdm",
                 row_offset: int = 0,
                 col_valid: torch.Tensor | None = None,
                 row_chunk: int | None = None, row_z: bool = False,
                 row_block: int | None = None):
    """θ-gated repulsive forces, ``exact_repulsion``'s contract: ``(rep
    [len(y), m] unnormalized, Z)`` — Z a 0-d tensor, or the per-row
    partials ``[len(y)]`` with ``row_z``.  ``y`` are rows [row_offset,
    row_offset + len(y)) of ``y_full``; ``col_valid`` masks padded points
    out of the tree and the output.  ``levels``/``frontier`` None resolve
    through :func:`default_levels`/:func:`default_frontier`.
    ``row_chunk`` caps the rows a batched walk takes (None: the byte
    budget's :func:`chunk_rows`).  ``row_block`` restarts the chunks at
    every multiple of it (a sharded optimizer passes its quantum-wide
    local size, so that every mesh width walks chunks of the same shapes:
    a reduction's order on the card may follow its row count)."""
    if gate not in ("vdm", "flink"):
        raise ValueError(f"unknown bh gate '{gate}'")
    if y_full is None:
        y_full = y
    nloc, m = y.shape
    nfull = y_full.shape[0]
    if m not in MAX_LEVELS:
        raise ValueError(f"bh repulsion supports 2 or 3 components, got {m}")
    levels = levels if levels is not None else default_levels(nfull, m)
    frontier = (frontier if frontier is not None
                else default_frontier(nfull, m, levels, theta))
    tables, _, side, leaf_full = _tables(y_full, levels, col_valid)
    rows = row_offset + torch.arange(nloc, device=y.device)
    own_leaves = leaf_full[rows]
    row_ok = (None if col_valid is None else col_valid[rows].to(y.dtype))
    c = chunk_rows(frontier, m)
    if row_chunk is not None:
        c = min(c, row_chunk)
    block = nloc if row_block is None else max(1, int(row_block))
    reps, sqs = [], []
    for b0 in range(0, nloc, block):
        b1 = min(b0 + block, nloc)
        for s in range(b0, b1, c):
            e = min(s + c, b1)
            r, q = _walk(y[s:e], own_leaves[s:e], tables, side, levels,
                         frontier, theta, gate)
            reps.append(r)
            sqs.append(q)
    rep = torch.cat(reps) if reps else y.new_zeros((0, m))
    sq = torch.cat(sqs) if sqs else y.new_zeros((0,))
    if row_ok is not None:
        rep = rep * row_ok[:, None]
        sq = sq * row_ok
    return rep, (sq if row_z else torch.sum(sq))
