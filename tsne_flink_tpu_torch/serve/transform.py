"""The out-of-sample query path (port of
``tsne_flink_tpu/serve/transform.py``), so far only its interpolation
init, which the landmark schedule shares (``models/tsne
.landmark_optimize``).  The bucketed query stages are ROADMAP queue A13.
"""

from __future__ import annotations

import torch


def interpolation_init(p: torch.Tensor, idx: torch.Tensor,
                       yb: torch.Tensor) -> torch.Tensor:
    """Each row starts at the affinity-weighted mean of its neighbours'
    frozen coordinates, ``y0_i = Σ_a p[i, a] · yb[idx[i, a]]``; a row of
    zero affinities lands at the origin.  ``[B, m]`` in ``yb``'s dtype."""
    dt = torch.promote_types(p.dtype, yb.dtype)
    return torch.einsum("bk,bkm->bm", p.to(dt),
                        yb[idx.long()].to(dt)).to(yb.dtype)
