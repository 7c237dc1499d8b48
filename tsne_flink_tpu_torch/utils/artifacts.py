"""The prepare stage (port of ``tsne_flink_tpu/utils/artifacts.prepare``).

kNN graph -> β search -> assembled joint P, with the seconds of each
stage measured to the end of the device's work.  The JAX function's
artifact cache, AOT executables, trace spans and fault hooks are not
ported yet (ROADMAP queue A9).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

# resolve_knn_plan lives with the policies it applies; it is importable
# from here as from the JAX package's utils/artifacts
from tsne_flink_tpu_torch.ops.knn import resolve_knn_plan  # noqa: F401
from tsne_flink_tpu_torch.utils.device import resolve_device, timed_stage


@dataclass
class PrepareResult:
    """Everything the optimize loop needs, plus the stage times."""

    idx: torch.Tensor | None   # [N, k] kNN structure
    dist: torch.Tensor | None  # [N, k] kNN distances
    jidx: torch.Tensor         # [N, S] joint-P rows (blocks: [N, k])
    jval: torch.Tensor
    extra_edges: tuple | None  # blocks: the reverse (src, dst, val)
    label: str                 # resolved assembly: split-rows | sorted |
    # split | blocks
    knn_seconds: float
    affinity_seconds: float
    knn_substages: dict | None = None  # kNN substage seconds (None when
    # the graph was given)


def prepare(x=None, *, knn=None, neighbors: int,
            knn_method: str = "bruteforce", metric: str = "sqeuclidean",
            knn_rounds: int | None = None, knn_refine: int | None = None,
            knn_blocks: int = 8, generator: torch.Generator | None = None,
            perplexity: float, assembly: str = "auto",
            sym_width: int | None = None, device=None) -> PrepareResult:
    """kNN (or the given ``knn=(idx, dist)``), then the symmetrized P by
    ``assembly``: ``auto`` (``affinity_auto``: split rows, or blocks when
    the rows would not fit), ``blocks`` (``affinity_blocks``), or
    ``sorted`` / ``split`` (``affinity_pipeline`` at ``sym_width``).

    The kNN plan resolves through ``ops/knn.resolve_knn_plan``
    (``knn_rounds``/``knn_refine`` None = the auto policies); the hybrid
    plan draws from ``generator`` (None: the kNN functions' seeded
    defaults)."""
    from tsne_flink_tpu_torch.ops import affinities as aff
    from tsne_flink_tpu_torch.ops.knn import knn as knn_dispatch

    if assembly not in ("auto", "sorted", "split", "blocks"):
        raise ValueError(f"assembly '{assembly}' not defined "
                         "(auto | sorted | split | blocks)")
    device = resolve_device(device)
    t0 = time.perf_counter()
    subs = None
    if knn is not None:
        idx, dist = (torch.as_tensor(a, device=device) for a in knn)
    else:
        subs = {}
        idx, dist = knn_dispatch(torch.as_tensor(x, device=device),
                                 int(neighbors), knn_method, metric,
                                 blocks=knn_blocks, rounds=knn_rounds,
                                 refine=knn_refine, generator=generator,
                                 on_substage=subs.update)
    t_knn = timed_stage(device, t0)
    t0 = time.perf_counter()
    if assembly == "auto":
        jidx, jval, extra, label = aff.affinity_auto(idx, dist, perplexity)
    elif assembly == "blocks":
        jidx, jval, extra = aff.affinity_blocks(idx, dist, perplexity)
        label = "blocks"
    else:
        jidx, jval = aff.affinity_pipeline(idx, dist, perplexity, sym_width,
                                           assembly=assembly)
        extra, label = None, assembly
    t_aff = timed_stage(device, t0)
    return PrepareResult(idx=idx, dist=dist, jidx=jidx, jval=jval,
                         extra_edges=extra, label=label, knn_seconds=t_knn,
                         affinity_seconds=t_aff, knn_substages=subs)
