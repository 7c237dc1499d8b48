"""Distance metrics and the matmul operand policy (port of
``tsne_flink_tpu/ops/metrics.py``).

* :func:`metric_fn` — an elementwise pair metric over the trailing axis;
  always ``"sqeuclidean"`` for the embedding-space Student-t q_ij.
* :func:`pairwise` — a distance matrix ``[Na, d] x [Nb, d] -> [Na, Nb]``
  around one matmul (``‖a‖² + ‖b‖² − 2 a·bᵀ``), batched over leading
  dimensions.

Mixed precision (``--dtype bfloat16``, ``TSNE(dtype="bfloat16")``): the
distance and projection products take bf16 operands while every norm,
accumulation, affinity and optimizer value stays float32 — the JAX
package's ``set_matmul_dtype`` contract.  The port threads the setting
as an argument (``matmul_dtype``: None or ``torch.bfloat16``) from the
entry points down instead of a process-wide setting: the thread mesh
runs one Python thread a shard, and a global would leak across
concurrent estimators.

:func:`matmul_operands` rounds both operands to bf16 (round to nearest,
ties to even, as ``astype(jnp.bfloat16)`` and ``cvt.rn.bf16.f32`` do)
and hands them back in their own dtype.  The product of two bf16 values
is exact in float32, so the plain product of the rounded operands (TF32
off) is a bf16-operand, float32-accumulate product up to summation
order, and no product returns a bf16 tensor.  Kernel B1's bf16 form
(``ops/knn_cuda``) rounds its operands the same way on the card.
Float64 operands round through float32, as both frameworks do.
"""

from __future__ import annotations

import torch

METRICS = ("sqeuclidean", "euclidean", "cosine")

#: the operand dtypes a mixed-precision run may feed the products
MATMUL_DTYPES = (torch.bfloat16,)


def check_matmul_dtype(dtype) -> None:
    """Raise on an operand dtype the products do not take (None: the
    operands' own dtype)."""
    if dtype is not None and dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul operand dtype {dtype} not supported "
                         f"(None or one of {MATMUL_DTYPES})")


def kernel_float64(x) -> bool:
    """Whether ``x`` — a tensor or a dtype — is float64: the one test a
    kernel wrapper dispatches its float64 form on (its float32 form
    otherwise).  Any other dtype raises: the kernels take these two.
    graftlint's dtype-drift blesses this function's float64 name."""
    dtype = x.dtype if torch.is_tensor(x) else x
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 or float64 values, got "
                        f"{dtype}")
    return dtype == torch.float64


def resolve_matmul_dtype(dtype: str | None):
    """A run's ``--dtype`` / ``TSNE(dtype=)`` -> ``(compute dtype name,
    matmul operand dtype)``: ``bfloat16`` is mixed precision (float32
    state, bf16 operands), any other value its own compute dtype with
    operands in it."""
    if dtype == "bfloat16":
        return "float32", torch.bfloat16
    return dtype, None


def matmul_dtype_name(dtype) -> str | None:
    """``torch.bfloat16`` -> ``"bfloat16"`` (None stays None): the name a
    plan or a record carries."""
    return None if dtype is None else str(dtype).removeprefix("torch.")


def default_matmul_dtype(backend: str, compute_dtype=None):
    """The operand default of a run that names no dtype: the JAX package
    feeds bf16 operands by default on a TPU only.  On ``cuda`` and
    ``cpu`` it is None: the card's default stays B1's 3xTF32 (whether
    bf16 operands should become the card's default is ROADMAP §D's
    decision, from the bench)."""
    if backend != "tpu":
        return None
    if compute_dtype is not None and compute_dtype != torch.float32:
        return None
    return torch.bfloat16


def matmul_operands(a: torch.Tensor, b: torch.Tensor, dtype=None):
    """The two operands of a distance or projection product under the
    operand dtype ``dtype``: rounded to it and back to their own dtype
    (None: unchanged)."""
    check_matmul_dtype(dtype)
    if dtype is None:
        return a, b
    return a.to(dtype).to(a.dtype), b.to(dtype).to(b.dtype)


def acc_dtype(a: torch.Tensor):
    """Accumulation dtype: the ORIGINAL array dtype, never the operand
    cast."""
    return a.dtype


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


def pairwise(metric: str, a: torch.Tensor, b: torch.Tensor,
             matmul_dtype=None) -> torch.Tensor:
    """Distance matrix [..., Na, Nb] via one (batched) matmul; leading
    dimensions of ``a`` [..., Na, d] and ``b`` [..., Nb, d] are a batch.
    The product takes :func:`matmul_operands`; the norms come from the
    unrounded operands."""
    _check(metric)
    am, bm = matmul_operands(a, b, matmul_dtype)
    g = am @ bm.transpose(-1, -2)
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
