"""Distributed symmetrization (port of ``tsne_flink_tpu/parallel/
symmetrize.py``): route the transpose edges to their owner shard with
``all_to_all``.

The replicated form (``parallel/pipeline``) gathers the [N, k] graph and
sorts 2·N·k edges on every shard; this is the form whose footprint
shrinks with the mesh:

1. forward contributions (i local) stay local;
2. each transpose contribution (j, i, v) travels to owner(j) = j // n_local
   in fixed-capacity [D, cap] buffers: one ``all_to_all`` for the int
   payloads (j's local row, i's global id) and one for the values (equal
   splits, which NCCL and gloo both take);
3. every shard merges its forward and received edges with the sorted
   builder (``ops/affinities.assemble_rows``) and the global normaliser is
   one ``psum``.

Capacity: per-destination sends are capped at ``cap = max(8, slack·ceil(
n_local·k / D))`` edges; edges past a destination's cap are dropped in
source-row-major order and counted.  Edges to the shard's own rows bypass
the collective.
"""

from __future__ import annotations

import torch

from tsne_flink_tpu_torch.ops.affinities import P_FLOOR, assemble_rows


def symmetrize_alltoall(idx: torch.Tensor, p: torch.Tensor, sym_width: int,
                        *, slack: int = 4, axis):
    """Sharded P + Pᵀ with routed transpose edges, on one shard.

    ``idx`` [n_local, k] holds GLOBAL neighbour ids, ``p`` [n_local, k] the
    conditional affinities (0 = absent).  Returns ``(jidx, jval, dropped,
    needed, nnz)``: ``jidx/jval`` [n_local, sym_width] normalised so the
    global ΣP = 1 (valid entries floored at 1e-12); ``dropped`` the psum'd
    int64 [2] (transpose edges lost to the capacity cap, merged (i, j)
    runs lost to ``sym_width``); ``needed`` the pmax'd true max row degree
    (a multiple of 8, at least 8); ``nnz`` the pmax'd per-shard true edge
    count.  Every counter is the same tensor on every shard."""
    n_local, k = idx.shape
    e = n_local * k
    d_, me = axis.size, axis.index
    dev = p.device
    row_l = torch.arange(n_local, device=dev).repeat_interleave(k)
    row_g = me * n_local + row_l
    cols = idx.reshape(-1).long()
    vv = p.reshape(-1)
    present = vv > 0

    # forward edges (stay local): (i_local, j_global, v)
    ii_f = torch.where(present, row_l, n_local)
    jj_f = cols

    # transpose edges: (owner(j), j's local row there, i_global, v)
    dest = torch.div(cols, n_local, rounding_mode="floor")
    j_loc = cols - dest * n_local
    is_mine = present & (dest == me)
    to_route = present & (dest != me)
    ii_self = torch.where(is_mine, j_loc, n_local)  # bypass the collective

    # routed edges sorted by destination (stable: (j, i) order kept), each
    # edge's position within its destination's run
    key = torch.where(to_route, dest, d_)
    order = torch.argsort(key, stable=True)
    dest_s = key[order]
    pos = (torch.arange(e, device=dev)
           - torch.searchsorted(dest_s, dest_s, side="left"))
    cap = max(8, slack * (-(-e // max(d_, 1))))
    valid_send = (dest_s < d_) & (pos < cap)
    dropped = torch.sum((dest_s < d_) & (pos >= cap))
    drow = torch.where(valid_send, dest_s, d_)  # the dump row
    slot = pos % cap

    send_jloc = torch.full((d_ + 1, cap), n_local, dtype=torch.long,
                           device=dev)
    send_jloc[drow, slot] = torch.where(valid_send, j_loc[order], n_local)
    send_i = torch.zeros((d_ + 1, cap), dtype=torch.long, device=dev)
    send_i[drow, slot] = row_g[order]
    send_v = torch.zeros((d_ + 1, cap), dtype=p.dtype, device=dev)
    send_v[drow, slot] = torch.where(valid_send, vv[order], 0.0)
    # both int payloads ride one collective: [D, 2·cap]
    send_ints = torch.cat([send_jloc[:d_], send_i[:d_]], dim=1)
    recv_ints = axis.all_to_all(send_ints.contiguous())
    recv_v = axis.all_to_all(send_v[:d_].contiguous())
    recv_jloc, recv_i = recv_ints[:, :cap], recv_ints[:, cap:]

    ii = torch.cat([ii_f, ii_self, recv_jloc.reshape(-1)])
    jj = torch.cat([jj_f, row_g, recv_i.reshape(-1)])
    vv_all = torch.cat([vv, vv, recv_v.reshape(-1)])
    # received padding has value 0: the dump row, so that it makes no
    # phantom (row, 0) run
    ii = torch.where(vv_all > 0, ii, n_local)

    jidx, jval, width_dropped, needed, row_deg = assemble_rows(
        ii, jj, vv_all, n_local, sym_width, return_dropped=True,
        return_needed=True, return_row_deg=True)
    total = axis.psum(torch.sum(jval))
    valid = jval > 0
    jval = torch.where(valid, torch.clamp(jval / total, min=P_FLOOR), 0.0)
    jidx = torch.where(valid, jidx, 0)
    counts = torch.stack([dropped.to(torch.int64),
                          torch.as_tensor(width_dropped, device=dev)])
    return (jidx, jval, axis.psum(counts),
            axis.pmax(torch.as_tensor(needed, device=dev)),
            axis.pmax(torch.sum(row_deg.to(torch.int64))))
