"""k-nearest-neighbour strategies (port of ``tsne_flink_tpu/ops/knn.py``).

Ported: the exact ``bruteforce`` method, which runs the fused kernel B1
(``ops/knn_cuda.fused_knn``).  The other methods of the JAX package —
``partition``, the hybrid ``project`` (Z-order rounds + NN-descent refine,
with the candidate-scorer kernel B6) and the ``auto`` policy that picks
between them — are ROADMAP queue A11 and raise here.

Every method returns ``(neighbor_idx int32 [N, k], neighbor_dist [N, k])``
with rows ascending by distance.
"""

from __future__ import annotations

import torch

from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn

KNN_METHODS = ("bruteforce", "partition", "project", "auto")


def _clamp_k(k: int, n: int) -> int:
    # the reference's first(k) yields shorter groups when k > n-1; the
    # arrays stay regular by clamping
    return int(min(k, n - 1))


def cosine_zbase(x: torch.Tensor) -> torch.Tensor:
    """L2-normalised rows (the cosine kernel's operand)."""
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-12)


def knn_bruteforce(x: torch.Tensor, k: int, metric: str = "sqeuclidean"):
    """Exact kNN by the full N x N sweep of kernel B1 (its plain version
    on a CPU tensor)."""
    return fused_knn(x, _clamp_k(k, x.shape[0]), metric)


def knn(x: torch.Tensor, k: int, method: str, metric: str = "sqeuclidean"):
    """Dispatch on the kNN method (``Tsne.scala:74-79``)."""
    if method == "bruteforce":
        return knn_bruteforce(x, k, metric)
    if method in KNN_METHODS:
        raise NotImplementedError(
            f"knn method '{method}' is not ported yet (ROADMAP queue A11: "
            "partition, hybrid project kNN with kernel B6, auto policy)")
    raise ValueError(f"Knn method '{method}' not defined")
