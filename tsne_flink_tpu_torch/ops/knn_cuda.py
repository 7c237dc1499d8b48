"""B1: exact self-kNN through the fused distance + top-k kernel, and
B6: the refine funnel's candidate scorer.

B1 replaces ``tsne_flink_tpu/ops/knn_pallas.py::_fused_kernel`` (with its
``_fused_prep`` staging and ``_fused_final`` ordering).  The kernel is
``csrc/knn.cu``; its header says what bounds it on an H100 (the 2·N²·F
FP32 multiply-adds) and how its design keeps every distance tile and
each row's running k-list on chip.

:func:`fused_knn` is the wrapper.  On a CPU tensor it runs
:func:`knn_sweep_plain` — chunked :func:`~.metrics.pairwise` distances and
a stable sort, which breaks ties by the lowest column exactly as the
kernel's lexicographic (distance, column) order does (``torch.topk``
fixes no order among ties).  On a CUDA tensor it launches the kernel or
raises.  Both sweeps return each row's k nearest squared (or cosine)
distances; :func:`_fused_final` orders them and takes the sqrt for
``euclidean``.

B6 replaces ``tsne_flink_tpu/ops/knn_pallas.py::_cand_kernel`` (driven
by ``cand_sqdist_fused``).  The kernel is ``csrc/knn_cand.cu``: it
gathers the candidate rows by index itself, so the [c, Z, F] candidate
operand the JAX form gathers first never exists in device memory, and a
candidate row shared by many chunk rows is served from L2 — the JAX
package's dedup-then-gather (:func:`_compact_gather`) is moot on the
card.  :func:`cand_sqdist` is the wrapper: :func:`cand_sqdist_plain` on a
CPU tensor (which keeps the compact gather as an option, bit-identical to
the direct one), the kernel on a CUDA tensor, or it raises.
"""

from __future__ import annotations

import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.ops.metrics import pairwise

#: feature axis padded (with zeros) to this multiple for the kernel's
#: 16-wide shared-memory slices and 16-byte row loads
FEATURE_MULTIPLE = 16
#: the kernel keeps each row's k-list in shared memory: 64·k·8 bytes
K_MAX = 256
#: rows per distance block of the plain sweep
PLAIN_ROW_CHUNK = 1024


def _base(x: torch.Tensor, metric: str) -> torch.Tensor:
    """The kernel's operand: L2-normalised rows for cosine (the
    ``_fused_prep`` staging), the points themselves otherwise."""
    if metric == "cosine":
        from tsne_flink_tpu_torch.ops.knn import cosine_zbase
        return cosine_zbase(x)
    return x


def knn_sweep_plain(base: torch.Tensor, k: int, cosine: bool,
                    row_chunk: int = PLAIN_ROW_CHUNK):
    """Plain version of the kernel: (dist [N, k], idx [N, k] int32), each
    row's k smallest by (distance, column), ascending.  Distances are
    squared euclidean (norm trick, clamped at 0) or 1 − â·b̂."""
    n = base.shape[0]
    cols = torch.arange(n, device=base.device)
    ds, ids = [], []
    for s in range(0, n, row_chunk):
        rows = base[s:s + row_chunk]
        if cosine:
            d = 1.0 - rows @ base.T
        else:
            d = pairwise("sqeuclidean", rows, base)
        rid = torch.arange(s, s + rows.shape[0], device=base.device)
        d = d.masked_fill(rid[:, None] == cols[None, :], float("inf"))
        # columns arrive in ascending order, so a stable sort by distance
        # is the lexicographic (distance, column) order
        dv, order = torch.sort(d, dim=1, stable=True)
        ds.append(dv[:, :k])
        ids.append(order[:, :k].to(torch.int32))
    return torch.cat(ds), torch.cat(ids)


def _check_cuda(base: torch.Tensor, k: int) -> None:
    if not base.is_cuda:
        raise ValueError(f"B1 kernel takes a CUDA tensor, got {base.device}")
    if base.dtype != torch.float32:
        raise TypeError(f"B1 kernel takes float32 points, got {base.dtype}")
    if base.dim() != 2 or not base.is_contiguous():
        raise ValueError("B1 kernel takes a contiguous [N, F] tensor")
    if base.shape[1] % FEATURE_MULTIPLE or base.data_ptr() % 16:
        raise ValueError("B1 kernel needs F % 16 == 0 and 16-byte rows")
    n = base.shape[0]
    if not 1 <= k <= min(K_MAX, n - 1):
        raise ValueError(f"B1 kernel needs 1 <= k <= min({K_MAX}, N - 1); "
                         f"got k={k}, N={n}")


def knn_sweep_cuda(base: torch.Tensor, k: int, cosine: bool):
    """Launch B1: (dist [N, k], idx [N, k] int32), each row's k nearest
    in no particular order."""
    pad = -base.shape[1] % FEATURE_MULTIPLE
    if pad:
        base = torch.nn.functional.pad(base, (0, pad))
    base = base.contiguous()
    _check_cuda(base, k)
    n, f = base.shape
    norms = (torch.zeros(1, device=base.device) if cosine
             else torch.sum(base * base, dim=1))
    dist = torch.empty((n, k), device=base.device, dtype=torch.float32)
    idx = torch.empty((n, k), device=base.device, dtype=torch.int32)
    KERNELS["B1"](base.data_ptr(), norms.data_ptr(), n, f, k, int(cosine),
                  dist.data_ptr(), idx.data_ptr())
    return dist, idx


def _fused_final(dist: torch.Tensor, idx: torch.Tensor, metric: str):
    """Order each row ascending by (distance, column); sqrt for
    euclidean.  Returns (idx int32 [N, k], dist [N, k])."""
    by_col = torch.argsort(idx, dim=1, stable=True)
    dist = torch.gather(dist, 1, by_col)
    idx = torch.gather(idx, 1, by_col)
    by_dist = torch.argsort(dist, dim=1, stable=True)
    dist = torch.gather(dist, 1, by_dist)
    idx = torch.gather(idx, 1, by_dist)
    if metric == "euclidean":
        dist = torch.sqrt(dist)
    return idx.to(torch.int32), dist


def fused_knn(x: torch.Tensor, k: int, metric: str = "sqeuclidean"):
    """Exact kNN of ``x`` against itself: (idx int32 [N, k], dist [N, k]),
    rows ascending.  ``k`` must already be clamped to N − 1."""
    cosine = metric == "cosine"
    base = _base(x, metric)
    if base.device.type == "cpu":
        dist, idx = knn_sweep_plain(base, k, cosine)
    else:
        dist, idx = knn_sweep_cuda(base, k, cosine)
    return _fused_final(dist, idx, metric)


# ---- B6: the refine funnel's candidate scorer ---------------------------

#: the kernel keeps a chunk row's vector in shared memory (F·4 bytes of
#: the 48 KB a launch gets without opting in)
CAND_F_MAX = 12_288


def _compact_gather(base: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Dedup-then-gather: fetch each UNIQUE candidate row of the chunk
    once into a compact [U, d] buffer, then rebuild the [c, Z, d] operand
    from it.  Values are bit-identical to the direct gather (the same
    vectors land in the same slots)."""
    c, z = cand.shape
    cz = c * z
    flat = cand.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    fs = flat[order]
    first = torch.ones(cz, dtype=torch.bool, device=cand.device)
    first[1:] = fs[1:] != fs[:-1]
    uslot = torch.cumsum(first.long(), dim=0) - 1       # [cz] unique slot
    uniq = torch.zeros(cz, dtype=torch.long, device=cand.device)
    uniq[uslot] = fs
    inv = torch.empty(cz, dtype=torch.long, device=cand.device)
    inv[order] = uslot
    gu = base[uniq]                                     # [<=U once, d]
    return gu[inv].reshape(c, z, base.shape[1])


def _cand_vectors(base: torch.Tensor, cand: torch.Tensor,
                  compact: bool) -> torch.Tensor:
    """The candidate-vector operand [c, Z, f] of the plain scorers: direct
    gather, or the dedup-then-gather form (:func:`_compact_gather`)."""
    return _compact_gather(base, cand) if compact else base[cand.long()]


def cand_sqdist_plain(base: torch.Tensor, sq: torch.Tensor,
                      rows: torch.Tensor, cand: torch.Tensor,
                      compact: bool = False) -> torch.Tensor:
    """Plain version of B6, the TPU kernel's own formula: ``(sq[rows] +
    sq[cand]) − 2·Σ_f r·c`` clamped at 0, [c, Z].  ``compact`` gathers
    the candidate vectors through the dedup-then-gather form (identical
    values)."""
    rows = rows.long()
    pr = base[rows]                                 # [c, F]
    pc = _cand_vectors(base, cand, compact)         # [c, Z, F]
    g = torch.sum(pr[:, None, :] * pc, dim=-1)      # [c, Z]
    return torch.clamp(sq[rows][:, None] + sq[cand.long()] - 2.0 * g,
                       min=0.0)


def _check_cand(base, sq, rows, cand) -> None:
    for name, t, dtype, dim in (("base", base, torch.float32, 2),
                                ("sq", sq, torch.float32, 1),
                                ("rows", rows, torch.int32, 1),
                                ("cand", cand, torch.int32, 2)):
        if not t.is_cuda or t.device != base.device:
            raise ValueError(f"B6 kernel takes CUDA tensors on one device; "
                             f"{name} is on {t.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"B6 kernel takes a contiguous {dim}-D {dtype} "
                             f"{name}; got {t.dtype} {tuple(t.shape)}")
    n, f = base.shape
    if sq.shape[0] != n or cand.shape[0] != rows.shape[0]:
        raise ValueError(f"B6 kernel: sq {tuple(sq.shape)} must be [{n}] and "
                         f"cand {tuple(cand.shape)} [{rows.shape[0]}, Z]")
    if not 1 <= f <= CAND_F_MAX:
        raise ValueError(f"B6 kernel takes 1 <= F <= {CAND_F_MAX}; got {f}")


def cand_sqdist(base: torch.Tensor, sq: torch.Tensor, rows: torch.Tensor,
                cand: torch.Tensor, compact: bool = False) -> torch.Tensor:
    """Squared euclidean distances from each of ``base[rows]`` [c] to its
    candidates ``base[cand]`` [c, Z] -> [c, Z], with ``sq`` the cached
    squared norms of ``base``.  Kernel B6 on a CUDA tensor (ids int32,
    every one in range); the plain version on a CPU tensor."""
    if base.device.type == "cpu":
        return cand_sqdist_plain(base, sq, rows, cand, compact)
    _check_cand(base, sq, rows, cand)
    c, z = cand.shape
    out = torch.empty((c, z), device=base.device, dtype=torch.float32)
    if c and z:
        KERNELS["B6"](base.data_ptr(), sq.data_ptr(), rows.data_ptr(),
                      cand.data_ptr(), c, z, base.shape[1], out.data_ptr())
    return out
