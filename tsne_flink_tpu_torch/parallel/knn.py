"""Sharded kNN (port of ``tsne_flink_tpu/parallel/knn.py``): the exact ring
and the sharded Z-order project kNN of the multi-controller job.

Both run on one shard of a 1-D point mesh, inside a rank's program: the
collectives are the shard's axis (``parallel/mesh.MeshAxis`` on a thread
mesh, ``ProcessAxis`` in a multi-process job).  Every shard holds
``n_local`` rows, global ids ``index * n_local + r``; ids at or past
``n_global`` are mesh padding and are never reported as neighbours.

* :func:`ring_knn` keeps the local shard where it is while one block
  travels the ring (``ppermute``, with its norm pairs), and each hop folds
  one n_local x n_local tile into the running top-k.  The hop is kernel
  B1's cross sweep (``ops/knn_cuda.knn_cross``): padding columns and the
  row's own id masked, the hop's k nearest by (distance, global id),
  merged into the carried list by (distance, id).  On the card each pair
  gets the single sweep's bits, so the ring gives ``fused_knn``'s graph at
  every width; the JAX fold breaks distance ties by hop order, the port by
  the lowest id, as the single sweep does.
* :func:`project_knn_sharded` gathers x once, computes the replicated
  Morton permutation of every round (padding rows sort last), splits the
  band blocks by sorted block range, gathers the bands and keeps its own
  rows; then ``merge_rounds`` and the refine cycles, the refine sharded
  (``ops/knn.knn_refine`` with ``x_full``/``idx_full``/``n_valid``, kernel
  B6 on the card).  Its draws come in one fixed order from a generator
  seeded alike on every shard, or are injected (``draws=``): the refine's
  gateway scores take the local shape, as the JAX function draws them, so
  a project graph depends on the mesh width, as the reference's does.

Both take ``matmul_dtype`` (None, or ``torch.bfloat16`` under ``--dtype
bfloat16``): the ring's hop then runs B1's bf16 form, and the sharded
project rounds the operands of its Z-order projection, banded re-rank
and refine projections (``ops/metrics.matmul_operands``).  The JAX
sharded Z-order round multiplies its projection in the array's dtype
(``parallel/knn.py:203``); the port rounds it as the single-device round
(``ops/knn.py:907-911``) does, so every full-width feature product of a
bf16 run takes one operand policy.
"""

from __future__ import annotations

import math

import torch

from tsne_flink_tpu_torch.ops.knn import (ZORDER_PER_CYCLE, ProjectDraw,
                                          _clamp_k, _generator,
                                          _refine_plan, _resolve_tiles,
                                          _topk_smallest, backend_of,
                                          cosine_zbase, draw_project,
                                          draw_refine, knn_refine,
                                          merge_rounds, pick_knn_filter)
from tsne_flink_tpu_torch.ops.knn_cuda import (FEATURE_MULTIPLE, knn_cross,
                                               sweep_norms)
from tsne_flink_tpu_torch.ops.metrics import matmul_operands, pairwise
from tsne_flink_tpu_torch.ops.zorder import BITS_FOR_DIMS, morton_keys


def _merge_by_dist_id(d1, i1, d2, i2, k: int):
    """The k smallest of two per-row lists by (distance, id), ascending
    (the lists' ids are disjoint)."""
    d = torch.cat([d1, d2], dim=1)
    i = torch.cat([i1, i2], dim=1)
    by_id = torch.argsort(i, dim=1, stable=True)
    d, i = torch.gather(d, 1, by_id), torch.gather(i, 1, by_id)
    by_d = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, by_d), torch.gather(i, 1, by_d)


def ring_knn(x_local: torch.Tensor, k: int, n_global: int,
             metric: str = "sqeuclidean", *, axis, matmul_dtype=None):
    """Exact kNN of the local row shard against the global point set.

    ``axis`` is the shard's collectives handle (its ``index`` and
    ``size``; every shard padded to the same ``n_local``).  Returns
    ``(idx [n_local, k] int32 global ids, dist [n_local, k])``, rows
    ascending by (distance, id).  B1 launches once a hop on the card:
    ``axis.size`` times a shard (its bf16 form under ``matmul_dtype``)."""
    n_local = x_local.shape[0]
    k = _clamp_k(k, n_global)
    cosine = metric == "cosine"
    base = cosine_zbase(x_local) if cosine else x_local
    norms = None
    if base.is_cuda:
        pad = -base.shape[1] % FEATURE_MULTIPLE
        if pad:
            base = torch.nn.functional.pad(base, (0, pad))
        base = base.contiguous()
        # the block's norm pairs travel with it: each pair's norms are its
        # points' own, as in the single sweep
        norms = None if cosine else sweep_norms(base)
    me, d_ = axis.index, axis.size
    row_off = me * n_local
    blk, blk_norms = base, norms
    best_d = best_i = None
    for t in range(d_):
        owner = (me + t) % d_
        hi, hd = knn_cross(base, blk, k, cosine, row_off, owner * n_local,
                           n_global, norms, blk_norms, matmul_dtype)
        if best_d is None:
            best_d, best_i = hd, hi
        else:
            best_d, best_i = _merge_by_dist_id(best_d, best_i, hd, hi, k)
        if t < d_ - 1:
            blk = axis.ppermute(blk)
            if blk_norms is not None:
                blk_norms = axis.ppermute(blk_norms)
    if metric == "euclidean":
        best_d = torch.sqrt(best_d)
    return best_i.to(torch.int32), best_d


def project_draws(gen: torch.Generator, dim: int, k: int, rounds: int,
                  refine_rounds: int, n_local: int, n_padded: int, dtype,
                  device, proj_dims: int = 3) -> list:
    """Every draw of one :func:`project_knn_sharded` call, in the order it
    consumes them: a :class:`ProjectDraw` a seed round, then for each
    refine cycle ``ZORDER_PER_CYCLE`` shifted rounds and one
    :class:`RefineDraw` (gateway scores [n_local, k], the reverse order
    of the n_padded x k global edges)."""
    m = min(dim, proj_dims)
    out = [draw_project(gen, dim, m, it > 0, dtype, device)
           for it in range(max(1, rounds))]
    fd = pick_knn_filter(dim)
    plan = _refine_plan(dim, k, filter_dims=fd,
                        expand_k=(k + 1) // 2 if fd else None)
    for _ in range(max(0, refine_rounds)):
        out += [draw_project(gen, dim, m, True, dtype, device)
                for _ in range(ZORDER_PER_CYCLE)]
        out.append(draw_refine(gen, plan, n_local, k, dim, dtype, device,
                               n_graph=n_padded))
    return out


def project_knn_sharded(x_local: torch.Tensor, k: int, n_global: int,
                        metric: str = "sqeuclidean", rounds: int = 3,
                        generator: torch.Generator | None = None, *, axis,
                        draws: list | None = None, proj_dims: int = 3,
                        block: int | None = None, refine_rounds: int = 0,
                        refine_sample: int = 8, tiles=None,
                        matmul_dtype=None):
    """Sharded approximate kNN: random-shift Morton rounds + banded
    re-rank, the band work split across the mesh by sorted block range,
    then ``refine_rounds`` hybrid cycles (2 fresh sharded Z-order rounds
    merged in, one sharded NN-descent round).  ``draws`` (the list
    :func:`project_draws` makes) replaces the draws from ``generator``
    (default: seeded 0).  ``matmul_dtype``: the products' operand dtype
    (the module docstring).  Returns ``(idx [n_local, k] int32, dist)``."""
    n_local, dim = x_local.shape
    k = _clamp_k(k, n_global)
    dev, dtype = x_local.device, x_local.dtype
    if block is None:
        tiles = _resolve_tiles(tiles, n_global, dim, k, backend_of(x_local),
                               metric)
        block = tiles.block
    me, d_ = axis.index, axis.size
    x_full = axis.all_gather(x_local.contiguous())   # [npts, dim]
    npts = x_full.shape[0]  # n_local * shards (>= n_global; tail: padding)
    m = min(dim, proj_dims)
    if draws is None:
        draws = project_draws(_generator(generator, dev, 0), dim, k, rounds,
                              refine_rounds, n_local, npts, dtype, dev,
                              proj_dims)
    draws = iter(draws)

    # bands over the padded sorted order; each shard sweeps nb_local blocks
    b = int(min(block, npts))
    nb = math.ceil(npts / b)
    nb_local = math.ceil(nb / d_)
    band = b + 2 * k
    gids = torch.arange(npts, device=dev)
    valid_col = (gids < n_global)[:, None]
    zbase = cosine_zbase(x_full) if metric == "cosine" else x_full
    from tsne_flink_tpu_torch.ops.knn_tiles import project_block_group
    group = project_block_group(b, dim, k, backend_of(x_local))
    mine = me * n_local + torch.arange(n_local, device=dev)

    def round_perm(it, dr: ProjectDraw):
        """The replicated Z-order permutation of the padded global points;
        padding rows sort last."""
        if dr.proj is not None:
            zb, rm = matmul_operands(zbase, dr.proj, matmul_dtype)
            z = zb @ rm
            del zb, rm
        else:
            z = zbase
        # masked min-max quantize; the shift moves the quantization grid
        lo = torch.amin(torch.where(valid_col, z, math.inf), dim=0,
                        keepdim=True)
        hi = torch.amax(torch.where(valid_col, z, -math.inf), dim=0,
                        keepdim=True)
        span = torch.clamp(hi - lo, min=torch.finfo(dtype).tiny)
        if it > 0:  # the first round is unshifted
            lo = lo - dr.shift[None, :] * span
            span = span * 2.0
        bits = BITS_FOR_DIMS[m]
        q = torch.clamp(torch.floor((z - lo) * ((2 ** bits - 1) / span)),
                        0, 2 ** bits - 1).to(torch.int32)
        keys = torch.where(gids < n_global, morton_keys(q),
                           torch.iinfo(torch.int32).max)
        return torch.argsort(keys, stable=True)

    def one_round(it, dr):
        perm = round_perm(it, dr)
        dist_b = torch.full((nb_local * b, k), math.inf, dtype=dtype,
                            device=dev)
        idx_b = torch.zeros((nb_local * b, k), dtype=torch.long, device=dev)
        r_off = torch.arange(b, device=dev)
        c_off = torch.arange(band, device=dev)
        first = me * nb_local
        last = min(nb, first + nb_local)
        for g0 in range(first, last, group):
            starts = torch.arange(g0, min(g0 + group, last), device=dev) * b
            rpos = starts[:, None] + r_off                    # [G, b]
            cpos = starts[:, None] - k + c_off                # [G, band]
            rows = x_full[perm[torch.clamp(rpos, 0, npts - 1)]]
            cols = x_full[perm[torch.clamp(cpos, 0, npts - 1)]]
            d = pairwise(metric, rows, cols, matmul_dtype)
            csrc = perm[torch.clamp(cpos, 0, npts - 1)]
            bad = (((cpos < 0) | (cpos >= npts) | (csrc >= n_global))
                   [:, None, :] | (rpos[:, :, None] == cpos[:, None, :]))
            dd, sel = _topk_smallest(d.masked_fill(bad, math.inf), k)
            ii = torch.gather(csrc[:, None, :].expand(-1, b, -1), 2, sel)
            lo_ = (g0 - first) * b
            hi_ = lo_ + rpos.numel()
            dist_b[lo_:hi_] = dd.reshape(-1, k)
            idx_b[lo_:hi_] = ii.reshape(-1, k)
        # every shard's band slice -> the sorted-order results; keep mine
        dist_s = axis.all_gather(dist_b)[:npts]
        idx_s = axis.all_gather(idx_b)[:npts]
        inv = torch.empty_like(perm)
        inv[perm] = gids
        pos = inv[mine]
        return dist_s[pos], idx_s[pos].to(torch.int32)

    dists, idxs = [], []
    for it in range(max(1, rounds)):
        d, i = one_round(it, next(draws))
        dists.append(d)
        idxs.append(i)
    idx, dist = merge_rounds(dists, idxs, k)

    row_offset = me * n_local
    it = max(1, rounds)
    fd = pick_knn_filter(dim)
    for _ in range(max(0, refine_rounds)):
        # fresh sharded Z-order rounds: independent global candidates
        for _z in range(ZORDER_PER_CYCLE):
            d2, i2 = one_round(it, next(draws))
            it += 1
            idx, dist = merge_rounds([dist, d2], [idx, i2], k)
        idx_full = axis.all_gather(idx.contiguous())        # [npts, k]
        # mesh padding rows must not inject reverse edges: self-loops
        idx_full = torch.where(gids[:, None] < n_global, idx_full,
                               gids[:, None].to(idx_full.dtype))
        idx, dist = knn_refine(x_local, idx, dist, metric, rounds=1,
                               sample=refine_sample, draws=[next(draws)],
                               x_full=x_full, idx_full=idx_full,
                               row_offset=row_offset, n_valid=n_global,
                               filter_dims=fd, tiles=tiles,
                               expand_k=(k + 1) // 2 if fd else None,
                               matmul_dtype=matmul_dtype)
    return idx.to(torch.int32), dist
