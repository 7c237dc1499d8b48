"""Distance metrics (port of ``tsne_flink_tpu/ops/metrics.py``).

* :func:`metric_fn` — an elementwise pair metric over the trailing axis;
  always ``"sqeuclidean"`` for the embedding-space Student-t q_ij.
* :func:`pairwise` — a distance matrix ``[Na, d] x [Nb, d] -> [Na, Nb]``
  around one matmul (``‖a‖² + ‖b‖² − 2 a·bᵀ``), batched over leading
  dimensions.

Operands stay in their own dtype: this slice has no bf16 operand policy,
and float32 products run in full float32 (callers on the card keep
``torch.backends.cuda.matmul.allow_tf32`` False, its default).
"""

from __future__ import annotations

import torch

METRICS = ("sqeuclidean", "euclidean", "cosine")


def _check(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"Metric '{metric}' not defined")


def metric_fn(metric: str):
    """Elementwise pair metric over the trailing axis."""
    _check(metric)

    if metric == "sqeuclidean":

        def f(a, b):
            d = a - b
            return torch.sum(d * d, dim=-1)

    elif metric == "euclidean":

        def f(a, b):
            d = a - b
            return torch.sqrt(torch.sum(d * d, dim=-1))

    else:  # cosine: 1 - <a,b> / (|a||b|), clamped like the JAX package

        def f(a, b):
            num = torch.sum(a * b, dim=-1)
            den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
            return 1.0 - num / torch.clamp(den, min=1e-12)

    return f


def pairwise(metric: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance matrix [..., Na, Nb] via one (batched) matmul; leading
    dimensions of ``a`` [..., Na, d] and ``b`` [..., Nb, d] are a batch."""
    _check(metric)
    g = a @ b.transpose(-1, -2)
    if metric == "cosine":
        na = torch.linalg.norm(a, dim=-1)
        nb = torch.linalg.norm(b, dim=-1)
        return 1.0 - g / (na[..., :, None] * nb[..., None, :])
    ra = torch.sum(a * a, dim=-1)
    rb = torch.sum(b * b, dim=-1)
    d2 = torch.clamp(ra[..., :, None] + rb[..., None, :] - 2.0 * g, min=0.0)
    if metric == "euclidean":
        return torch.sqrt(d2)
    return d2
