"""The prepare stage (port of ``tsne_flink_tpu/utils/artifacts.prepare``).

kNN graph -> β search -> assembled joint-P rows, with the seconds of each
stage measured to the end of the device's work.  The JAX function's
artifact cache, AOT executables, trace spans and fault hooks are not
ported yet (ROADMAP queue A9), nor are the sorted/split/blocks assembly
choices (A6): the port always takes ``affinity_auto``'s split rows.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from tsne_flink_tpu_torch.utils.device import resolve_device, timed_stage


@dataclass
class PrepareResult:
    """Everything the optimize loop needs, plus the stage times."""

    idx: torch.Tensor | None   # [N, k] kNN structure
    dist: torch.Tensor | None  # [N, k] kNN distances
    jidx: torch.Tensor         # [N, S] joint-P rows
    jval: torch.Tensor
    extra_edges: None          # the blocks layout's edges (not ported)
    label: str                 # resolved assembly: split-rows
    knn_seconds: float
    affinity_seconds: float


def prepare(x=None, *, knn=None, neighbors: int,
            knn_method: str = "bruteforce", metric: str = "sqeuclidean",
            perplexity: float, assembly: str = "auto",
            device=None) -> PrepareResult:
    """kNN (or the given ``knn=(idx, dist)``), then ``affinity_auto``."""
    from tsne_flink_tpu_torch.ops.affinities import affinity_auto
    from tsne_flink_tpu_torch.ops.knn import knn as knn_dispatch

    if assembly != "auto":
        raise NotImplementedError(f"assembly '{assembly}' is not ported yet "
                                  "(ROADMAP queue A6); the port builds "
                                  "affinity_auto's split rows")
    device = resolve_device(device)
    t0 = time.perf_counter()
    if knn is not None:
        idx, dist = (torch.as_tensor(a, device=device) for a in knn)
    else:
        idx, dist = knn_dispatch(torch.as_tensor(x, device=device),
                                 int(neighbors), knn_method, metric)
    t_knn = timed_stage(device, t0)
    t0 = time.perf_counter()
    jidx, jval, extra, label = affinity_auto(idx, dist, perplexity)
    t_aff = timed_stage(device, t0)
    return PrepareResult(idx=idx, dist=dist, jidx=jidx, jval=jval,
                         extra_edges=extra, label=label, knn_seconds=t_knn,
                         affinity_seconds=t_aff)
