"""Exact (theta = 0) Student-t repulsion — the plain version of kernel B2.

Port of ``tsne_flink_tpu/ops/repulsion_exact.py`` with the same contract:
for rows ``y`` (rows [row_offset, row_offset + len(y)) of ``y_full``)
returns the unnormalized force F_rep_i = Σ_j q_ij² (y_i − y_j) and the
partition sum Σ_{i≠j} q_ij, with q_ij = 1 / (1 + |y_i − y_j|²);
``col_valid`` masks padded points out of both; ``row_z`` returns the
per-row partials instead of their sum.

Unlike the JAX twin it forms d² and the force directly from the
differences y_i − y_j rather than by the norm trick — the same arithmetic
as the CUDA kernel (``csrc/repulsion.cu``), and free of the cancellation
the norm trick suffers once the embedding has spread out.
"""

from __future__ import annotations

import torch


def exact_repulsion(y: torch.Tensor, y_full: torch.Tensor | None = None, *,
                    row_offset: int = 0,
                    col_valid: torch.Tensor | None = None,
                    row_chunk: int = 2048, row_z: bool = False):
    """Returns ``(rep [len(y), m], Z)`` — Z a 0-d tensor, or the per-row
    partials ``[len(y)]`` with ``row_z=True``."""
    if y_full is None:
        y_full = y
    nloc, m = y.shape
    nfull = y_full.shape[0]
    col_ids = torch.arange(nfull, device=y.device)
    reps, zs = [], []
    for s in range(0, nloc, row_chunk):
        yc = y[s:s + row_chunk]
        row_ids = row_offset + s + torch.arange(yc.shape[0], device=y.device)
        diffs = [yc[:, d, None] - y_full[None, :, d] for d in range(m)]
        d2 = sum(df * df for df in diffs)
        q = 1.0 / (1.0 + d2)
        dead = row_ids[:, None] == col_ids[None, :]
        if col_valid is not None:
            dead = dead | ~col_valid[None, :] | ~col_valid[row_ids][:, None]
        q = torch.where(dead, 0.0, q)
        q2 = q * q
        reps.append(torch.stack([torch.sum(q2 * df, dim=1) for df in diffs],
                                dim=1))
        zs.append(torch.sum(q, dim=1))
    rep = torch.cat(reps) if reps else y.new_zeros((0, m))
    z = torch.cat(zs) if zs else y.new_zeros((0,))
    return rep, (z if row_z else torch.sum(z))
