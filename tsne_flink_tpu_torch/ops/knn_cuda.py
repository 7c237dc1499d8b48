"""B1: exact self-kNN through the fused distance + top-k kernel, and
B6: one funnel stage of a refine chunk, fused.

B1 replaces ``tsne_flink_tpu/ops/knn_pallas.py::_fused_kernel`` (with its
``_fused_prep`` staging and ``_fused_final`` ordering).  The kernel is
``csrc/knn.cu``; its header says what bounds it on an H100 (the N²·F
multiply-adds, as three TF32 tensor-core passes) and how its design keeps
every distance tile and each row's running k-list on chip.

:func:`fused_knn` is the wrapper.  On a CPU tensor it runs
:func:`knn_sweep_plain` — chunked :func:`~.metrics.pairwise` distances and
a stable sort, which breaks ties by the lowest column exactly as the
kernel's lexicographic (distance, column) order does (``torch.topk``
fixes no order among ties).  On a CUDA tensor it launches the kernel or
raises: :func:`knn_sweep_cuda` passes each row's squared norm as a (hi,
lo) pair of its float64 value (:func:`norm_pairs`), and the kernel splits
each value into TF32 parts as :func:`tf32_split` states in PyTorch.  Both
sweeps return each row's k nearest squared (or cosine) distances;
:func:`_fused_final` orders them and takes the sqrt for ``euclidean``.

Under bf16 operands (``matmul_dtype=torch.bfloat16``, the mixed
precision of ``--dtype bfloat16``) both sweeps take B1's bf16 form, the
TPU kernel's ``cast_dtype`` path (``knn_pallas.py:81-84``): counted as
``KERNELS["B1_bf16"]``, the kernel rounds x into a bf16 scratch the
wrapper allocates and runs one bf16 tensor-core pass a step, with the
norm pairs of the unrounded x.  Its plain version is the plain sweep with
:func:`~.metrics.matmul_operands` (the rounded operands, products exact
in float32 or float64).

At float64 both sweeps take B1's float64 form (``KERNELS["B1_f64"]``,
``csrc/knn.cu``'s ``knn_f64_kernel``): FP64 tensor-core products over
plain float64 norms (:func:`norms_f64`), float64 distances out.  The
wrappers take float32 or float64 points and cast nothing;
:func:`sweep_norms` is the norms each form takes.

Every k runs: past :data:`K_REG_MAX` = 1,024 each form takes B1's
pending class (:func:`b1_class`), which keeps the k-lists in the outputs
and merges a pending area of :data:`B1_PENDING` keys a row into them by
a radix select (``csrc/knn.cu``); the float64 form's pending pairs live
in a scratch the wrapper allocates (:func:`b1_pending_bytes`).

B1's cross sweep (:func:`knn_cross`) is the same kernel over a row block
and a column block, each with the global id of its first point, masking
columns past ``n_global`` and each row's own id: the hop of the
multi-controller ring (``parallel/knn.ring_knn``), as the TPU kernel's
``_fused_sweep(rows, cols, nv)`` is.  Its plain version
(:func:`knn_cross_plain`) sums each pair's products in one order whatever
the blocks' shapes, so a ring on the CPU gives the same graph at every
mesh width; on the card the kernel gives each pair the single sweep's
bits.

B6 replaces ``tsne_flink_tpu/ops/knn_pallas.py::_cand_kernel`` (driven
by ``cand_sqdist_fused``) together with the glue of the JAX package's
refine chunk around it.  The kernel is ``csrc/knn_cand.cu``: one launch
per funnel stage per chunk builds each row's candidates from its gateways
(first stage), dedups them in shared memory, scores them (gathering the
candidate rows by index itself), selects the best and, in the exact
stage, merges them into the row's list; the [c, Z] candidate, score and
mask tensors of the plain chunk never exist in device memory, and the
JAX package's dedup-then-gather (:func:`_compact_gather`) is moot on the
card.  :func:`refine_keep` and :func:`refine_final` are the wrappers:
their plain versions (:func:`refine_keep_plain`,
:func:`refine_final_plain`, today's chunk body of ``knn_refine``) on a
CPU tensor, the kernel on a CUDA tensor, or they raise.
:func:`cand_sqdist_plain` is the TPU kernel's formula, which the plain
stages score with.

At float64 the stages take B6's float64 form (``KERNELS["B6_f64"]``,
``csrc/knn_cand.cu``'s ``tsne_refine_chunk_f64``), as the TPU kernel
writes its scores in the operands' dtype (``knn_pallas.py:300``): float64
scores, keys of (64 score bits, tie) and distances out, the ids int32.
The wrappers take float32 or float64 values, one dtype for ``base``,
``sq`` and ``old_d``, and cast nothing; :func:`refine_smem_bytes` states
each form's shared memory.  A stage that does not fit it (or sorts more
than 8,192 keys) takes B6's workspace route, its candidate-sized arrays
in device memory the wrapper allocates (:func:`refine_route`,
:func:`refine_ws_layout`).  :data:`ROUTE_LAUNCHES` counts the launches of
each B1 class and B6 route.

Every F runs.  Up to :data:`STAGED_F_MAX` = 12,288 features B6 stages the
chunk row's vector in shared memory; past it a stage launches B6's
unstaged form (``KERNELS["B6u"]``, ``["B6u_f64"]``: a build pass for a
first stage, a score pass that walks F in slabs shared by the whole
chunk, so each candidate row comes from device memory once a chunk, and
the staged form's selection and merge over the scores), whose select
pass takes whichever route its other arrays need (:func:`refine_route`
with ``staged=False``) and whose passes share a scratch of
:func:`refine_scratch_bytes` a row.  Its sums run in another order than
the staged form's: the two agree to the B6 bars, not bit for bit.

B6 under bf16 operands: on its accelerator the JAX package scores the
refine funnel through the tile plan's ``kernel``, ``pallas`` on a TPU
(``ops/knn_tiles.pick_knn_tiles`` via ``knn_pallas.pick_knn_kernel``,
read by ``ops/knn._kernel_of``, ``knn.py:150-156``), so ``_cand_sqdist``
(``knn.py:513-517``) takes the Pallas ``_cand_kernel``
(``knn_pallas.py:264-272``), which casts nothing: every keep stage and
the sqeuclidean / euclidean exact stage score in the array's dtype.  B6
therefore keeps its float32 bits in a bf16 run and takes no operand
flag.  The one cast of that route is the cosine exact stage
(``_cand_exact``, ``knn.py:539-544``: its product takes
``matmul_operands``), which the port runs as plain tensor code on the
card (:func:`cand_exact_plain`), rounding its operands there too; on the
CPU both packages take the elementwise metric, which casts nothing.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple

import torch

from tsne_flink_tpu_torch.kernels.build import B6_STAGED_F_MAX, KERNELS
from tsne_flink_tpu_torch.ops.metrics import (check_matmul_dtype,
                                              kernel_float64,
                                              matmul_operands, metric_fn,
                                              pairwise)

#: feature axis padded (with zeros) to this multiple for the kernel's
#: 16-wide shared-memory slices and 16-byte row loads
FEATURE_MULTIPLE = 16
#: the mantissa bits a float32 has beyond TF32's 10
TF32_DROPPED_BITS = 13
#: the largest k whose list a merge lane of B1 holds in registers (64·k·8
#: bytes a block of lists in shared memory up to k = 256, 16·k·8 in the
#: deep class up to this k; the float64 form keeps them in its outputs).
#: Past it B1 takes its pending class: the k-lists in the outputs, merged
#: through a pending area of :data:`B1_PENDING` keys a row (``csrc/knn.cu``)
K_REG_MAX = 1024
#: pending keys a row of B1's pending class: in shared memory at float32
#: and bf16 operands, in device memory the wrapper allocates at float64
#: (12 bytes a pair, :func:`b1_pending_bytes`)
B1_PENDING = 1024
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
                    row_chunk: int = PLAIN_ROW_CHUNK, matmul_dtype=None,
                    rows: torch.Tensor | None = None):
    """Plain version of the kernel: (dist [N, k], idx [N, k] int32), each
    row's k smallest by (distance, column), ascending.  Distances are
    squared euclidean (norm trick, clamped at 0) or 1 − â·b̂, the product
    over :func:`~.metrics.matmul_operands` of ``matmul_dtype``.  ``rows``
    (int64 ids) restricts the sweep to those rows, in that order (every
    column still swept)."""
    n = base.shape[0]
    cols = torch.arange(n, device=base.device)
    if rows is None:
        rows = cols
    ds, ids = [], []
    for s in range(0, rows.shape[0], row_chunk):
        rid = rows[s:s + row_chunk]
        part = base[rid]
        if cosine:
            pm, bm = matmul_operands(part, base, matmul_dtype)
            d = 1.0 - pm @ bm.T
        else:
            d = pairwise("sqeuclidean", part, base, matmul_dtype)
        d = d.masked_fill(rid[:, None] == cols[None, :], float("inf"))
        # columns arrive in ascending order, so a stable sort by distance
        # is the lexicographic (distance, column) order
        dv, order = torch.sort(d, dim=1, stable=True)
        ds.append(dv[:, :k])
        ids.append(order[:, :k].to(torch.int32))
    return torch.cat(ds), torch.cat(ids)


def tf32_split(x: torch.Tensor):
    """(hi, lo): ``hi`` is ``x`` rounded to the nearest TF32 value (ties
    away from zero) through an int32 view, ``lo`` the TF32 rounding of the
    exact remainder ``x − hi``.  Both are float32 tensors holding exact
    TF32 values (their low 13 mantissa bits are zero); hi + lo carries
    ~22 of float32's 24 significant bits.  Kernel B1 applies this split to
    each value on its way into the tensor cores (``cvt.rna.tf32.f32``);
    here it states the arithmetic for the tests."""
    def rnd(t):
        half = 1 << (TF32_DROPPED_BITS - 1)
        mask = -(1 << TF32_DROPPED_BITS)
        return ((t.contiguous().view(torch.int32) + half) & mask).view(
            torch.float32)
    hi = rnd(x)
    return hi, rnd(x - hi)


def norm_pairs(base: torch.Tensor) -> torch.Tensor:
    """[N + 1, 2] float32: each row's squared norm, summed in float64, as a
    (hi, lo) pair with hi + lo = the float64 value to ~2^-48, then a zero
    row (the kernel copies the pairs two columns at a time)."""
    # graftlint: disable=dtype-drift -- deliberate: the norms are summed
    # in float64 and split into an exact (hi, lo) float32 pair (B1's
    # 3xTF32 contract); nothing float64 leaves this function
    n64 = torch.sum(base.double() ** 2, dim=1)
    hi = n64.float()
    # graftlint: disable=dtype-drift -- the lo half of the same pair
    pairs = torch.stack([hi, (n64 - hi.double()).float()], dim=1)
    return torch.nn.functional.pad(pairs, (0, 0, 0, 1)).contiguous()


def norms_f64(base: torch.Tensor) -> torch.Tensor:
    """[N + 1] float64: each row's squared norm, then a zero (B1's float64
    form copies the norms two columns at a time)."""
    return torch.nn.functional.pad(torch.sum(base * base, dim=1),
                                   (0, 1)).contiguous()


def sweep_norms(base: torch.Tensor) -> torch.Tensor:
    """The norms B1 takes for ``base``'s dtype: :func:`norm_pairs` at
    float32, :func:`norms_f64` at float64."""
    return norms_f64(base) if kernel_float64(base) else norm_pairs(base)


def knn_config(k: int) -> tuple[int, int, int, int, int]:
    """B1's configuration for ``k`` as the kernel chooses it: (rows a
    block, ring stages, distance-tile buffers, dynamic shared memory
    bytes, pending keys a row: 0 in the k-list classes)."""
    import ctypes
    from tsne_flink_tpu_torch.kernels.build import library
    rows, stages, bufs, pend = (ctypes.c_int(), ctypes.c_int(),
                                ctypes.c_int(), ctypes.c_int())
    smem = library().tsne_knn_config(k, ctypes.byref(rows),
                                     ctypes.byref(stages), ctypes.byref(bufs),
                                     ctypes.byref(pend))
    return rows.value, stages.value, bufs.value, smem, pend.value


def b1_class(k: int) -> str:
    """B1's class for ``k`` (at every form): ``wide`` (k <= 256, 64 rows a
    block), ``deep`` (k <= :data:`K_REG_MAX`; the float64 form keeps the
    wide shape) or ``pending`` (any larger k)."""
    if k > K_REG_MAX:
        return "pending"
    return "deep" if k > 256 else "wide"


def b1_pending_bytes(nr: int, k: int, f64: bool) -> int:
    """Device memory B1's wrapper allocates for ``nr`` rows at ``k``: the
    float64 form's pending pairs past :data:`K_REG_MAX` (12 bytes a
    slot), nothing otherwise."""
    return 12 * nr * B1_PENDING if f64 and k > K_REG_MAX else 0


#: launches of each B1 class and B6 route ("B1 pending", "B6 workspace",
#: ...), counted beside ``KERNELS``'s counts where the wrappers launch
ROUTE_LAUNCHES: dict = {}
_ROUTE_LOCK = threading.Lock()


def _count_route(name: str) -> None:
    with _ROUTE_LOCK:
        ROUTE_LAUNCHES[name] = ROUTE_LAUNCHES.get(name, 0) + 1


def reset_route_launches() -> None:
    with _ROUTE_LOCK:
        ROUTE_LAUNCHES.clear()


def _b1_scratch(nr: int, k: int, f64: bool, device):
    """B1's pending scratch for one launch (float64 past
    :data:`K_REG_MAX`; allocated here, written by the kernel), or None.
    Freed after the launch: the allocator reuses it only for work queued
    after the kernel on the same stream."""
    nbytes = b1_pending_bytes(nr, k, f64)
    if not nbytes:
        return None
    return torch.empty(nbytes // 8, dtype=torch.int64, device=device)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_points(t: torch.Tensor, matmul_dtype) -> None:
    """B1 takes float32 points (bf16 operands an option) or float64
    points (no operand rounding)."""
    if kernel_float64(t) and matmul_dtype is not None:
        raise TypeError("B1's float64 form rounds no operand: matmul_dtype "
                        "must be None for float64 points")


def _check_cuda(base: torch.Tensor, k: int, matmul_dtype=None) -> None:
    if not base.is_cuda:
        raise ValueError(f"B1 kernel takes a CUDA tensor, got {base.device}")
    _check_points(base, matmul_dtype)
    if base.dim() != 2 or not base.is_contiguous():
        raise ValueError("B1 kernel takes a contiguous [N, F] tensor")
    if base.shape[1] % FEATURE_MULTIPLE or base.data_ptr() % 16:
        raise ValueError("B1 kernel needs F % 16 == 0 and 16-byte rows")
    n = base.shape[0]
    if not 1 <= k <= n - 1:
        raise ValueError(f"B1 kernel needs 1 <= k <= N - 1; got k={k}, "
                         f"N={n}")


def _operand_scratch(t: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """The bf16 copy of ``t`` that B1's bf16 form rounds into and streams
    (allocated here, written by the kernel)."""
    return torch.empty(t.shape, dtype=matmul_dtype, device=t.device)


def knn_sweep_cuda(base: torch.Tensor, k: int, cosine: bool,
                   matmul_dtype=None):
    """Launch B1 (3xTF32), its bf16 form under ``matmul_dtype``, or its
    float64 form on float64 points: (dist [N, k] in the points' dtype,
    idx [N, k] int32), each row's k nearest in no particular order."""
    check_matmul_dtype(matmul_dtype)
    pad = -base.shape[1] % FEATURE_MULTIPLE
    if pad:
        base = torch.nn.functional.pad(base, (0, pad))
    base = base.contiguous()
    _check_cuda(base, k, matmul_dtype)
    n, f = base.shape
    norms = (torch.zeros((1, 2), device=base.device) if cosine
             else sweep_norms(base))
    dist = torch.empty((n, k), device=base.device, dtype=base.dtype)
    idx = torch.empty((n, k), device=base.device, dtype=torch.int32)
    if kernel_float64(base):
        pend = _b1_scratch(n, k, True, base.device)
        KERNELS["B1_f64"](base.data_ptr(), norms.data_ptr(), n, f, k,
                          int(cosine), dist.data_ptr(), idx.data_ptr(),
                          _ptr(pend))
    elif matmul_dtype is None:
        KERNELS["B1"](base.data_ptr(), norms.data_ptr(), n, f, k,
                      int(cosine), dist.data_ptr(), idx.data_ptr(), None)
    else:
        xb = _operand_scratch(base, matmul_dtype)
        KERNELS["B1_bf16"](base.data_ptr(), norms.data_ptr(), xb.data_ptr(),
                           n, f, k, int(cosine), dist.data_ptr(),
                           idx.data_ptr())
    _count_route(f"B1 {b1_class(k)}")
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


#: elements of the [rows, cols, F] product block of the plain cross sweep
#: (the chunking changes no bit): on the CPU, and on the card
CROSS_PLAIN_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 28}


def knn_cross_plain(rows: torch.Tensor, cols: torch.Tensor, k: int,
                    cosine: bool, row_off: int, col_off: int,
                    n_global: int, matmul_dtype=None):
    """Plain version of B1's cross sweep: (dist [nr, k], idx [nr, k]
    int32 global column ids), each row's k nearest unmasked columns by
    (distance, global id), ascending; (inf, -1) past a row's unmasked
    columns.  Masked: columns with global id >= ``n_global`` and the row's
    own id (``row_off + r``).  Each pair's dot product is one sum over F
    of elementwise products, whatever the blocks' sizes (a matmul's
    blocking would follow the shapes), so every mesh width gives one
    graph.  Distances are squared euclidean (|a|² + |b|² − 2g, clamped at
    0) or 1 − g on normalised rows; g over the operands rounded to
    ``matmul_dtype`` (:func:`~.metrics.matmul_operands`), the norms the
    unrounded rows'."""
    nr, f = rows.shape
    nc = cols.shape[0]
    dev = rows.device
    cid = col_off + torch.arange(nc, device=dev)
    rb = torch.sum(cols * cols, dim=1)
    rows_m, cols_m = matmul_operands(rows, cols, matmul_dtype)
    step = max(1, CROSS_PLAIN_ELEMS[dev.type] // max(1, nc * f))
    kk = min(k, nc)
    ds, ids = [], []
    for s0 in range(0, nr, step):
        a = rows[s0:s0 + step]
        g = torch.sum(rows_m[s0:s0 + step, None, :] * cols_m[None, :, :],
                      dim=-1)
        if cosine:
            d = 1.0 - g
        else:
            ra = torch.sum(a * a, dim=1)
            d = torch.clamp(ra[:, None] + rb[None, :] - 2.0 * g, min=0.0)
        rid = row_off + s0 + torch.arange(a.shape[0], device=dev)
        bad = (rid[:, None] == cid[None, :]) | (cid >= n_global)[None, :]
        # columns arrive in ascending global id: a stable sort by distance
        # is the (distance, id) order
        dv, order = torch.sort(d.masked_fill(bad, math.inf), dim=1,
                               stable=True)
        dv, order = dv[:, :kk], order[:, :kk]
        held = ~torch.gather(bad, 1, order)
        ds.append(torch.where(held, dv, math.inf))
        ids.append(torch.where(held, cid[order], -1).to(torch.int32))
    dist, idx = torch.cat(ds), torch.cat(ids)
    if kk < k:
        dist = torch.nn.functional.pad(dist, (0, k - kk), value=math.inf)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return dist, idx


def _padded_operand(base: torch.Tensor) -> torch.Tensor:
    pad = -base.shape[1] % FEATURE_MULTIPLE
    if pad:
        base = torch.nn.functional.pad(base, (0, pad))
    return base.contiguous()


def knn_cross_cuda(rows: torch.Tensor, cols: torch.Tensor, k: int,
                   cosine: bool, row_off: int, col_off: int, n_global: int,
                   norms_r=None, norms_c=None, matmul_dtype=None):
    """Launch B1's cross sweep (3xTF32, its bf16 form under
    ``matmul_dtype``, or its float64 form on float64 blocks): (dist [nr,
    k] in the blocks' dtype, idx [nr, k] int32), each row's k nearest in
    no particular order.  ``norms_r``/``norms_c`` are the blocks'
    :func:`sweep_norms` (of the feature-padded, unrounded operands),
    computed here when None."""
    check_matmul_dtype(matmul_dtype)
    rows, cols = _padded_operand(rows), _padded_operand(cols)
    for name, t in (("rows", rows), ("cols", cols)):
        if t.device != rows.device:
            raise ValueError(f"B1 cross sweep takes one device; {name} is "
                             f"on {t.device}")
        _check_points(t, matmul_dtype)
        if t.dtype != rows.dtype:
            raise TypeError(f"B1 cross sweep takes one dtype; {name} is "
                            f"{t.dtype}, rows {rows.dtype}")
        if not t.is_cuda or t.data_ptr() % 16:
            raise ValueError("B1 kernel takes 16-byte aligned CUDA rows")
    nr, f = rows.shape
    nc = cols.shape[0]
    if cols.shape[1] != f or nr < 1 or nc < 1 or k < 1:
        raise ValueError(f"B1 cross sweep needs rows [nr, F], cols [nc, F] "
                         f"and k >= 1; got {tuple(rows.shape)}, "
                         f"{tuple(cols.shape)}, k={k}")
    if not (0 <= row_off and 0 <= col_off and row_off + nr < 2 ** 31
            and col_off + nc < 2 ** 31):
        raise ValueError("B1 cross sweep: global ids must fit int32")
    f64 = kernel_float64(rows)
    if cosine:
        norms_r = norms_c = torch.zeros((1, 2), device=rows.device)
    else:
        norms_r = sweep_norms(rows) if norms_r is None else norms_r
        norms_c = sweep_norms(cols) if norms_c is None else norms_c
        for t, m in ((norms_r, nr), (norms_c, nc)):
            want = (m + 1,) if f64 else (m + 1, 2)
            if (t.shape != want or t.dtype != rows.dtype
                    or not t.is_contiguous()):
                raise ValueError("B1 cross sweep: norms must be "
                                 "sweep_norms(block)")
    dist = torch.empty((nr, k), device=rows.device, dtype=rows.dtype)
    idx = torch.empty((nr, k), device=rows.device, dtype=torch.int32)
    if f64:
        pend = _b1_scratch(nr, k, True, rows.device)
        KERNELS["B1_f64"].entry("tsne_knn_cross_f64", rows.data_ptr(),
                                norms_r.data_ptr(), nr, int(row_off),
                                cols.data_ptr(), norms_c.data_ptr(), nc,
                                int(col_off), int(n_global), f, k,
                                int(cosine), dist.data_ptr(), idx.data_ptr(),
                                _ptr(pend))
    elif matmul_dtype is None:
        KERNELS["B1"].entry("tsne_knn_cross_f32", rows.data_ptr(),
                            norms_r.data_ptr(), nr, int(row_off),
                            cols.data_ptr(), norms_c.data_ptr(), nc,
                            int(col_off), int(n_global), f, k, int(cosine),
                            dist.data_ptr(), idx.data_ptr(), None)
    else:
        xbr = _operand_scratch(rows, matmul_dtype)
        xbc = _operand_scratch(cols, matmul_dtype)
        KERNELS["B1_bf16"].entry(
            "tsne_knn_cross_bf16", rows.data_ptr(), norms_r.data_ptr(),
            xbr.data_ptr(), nr, int(row_off), cols.data_ptr(),
            norms_c.data_ptr(), xbc.data_ptr(), nc, int(col_off),
            int(n_global), f, k, int(cosine), dist.data_ptr(),
            idx.data_ptr())
    _count_route(f"B1 {b1_class(k)}")
    return dist, idx


def knn_cross(rows: torch.Tensor, cols: torch.Tensor, k: int, cosine: bool,
              row_off: int, col_off: int, n_global: int, norms_r=None,
              norms_c=None, matmul_dtype=None):
    """One hop of the ring: each of ``rows``' (global ids ``row_off`` ..)
    k nearest among ``cols`` (global ids ``col_off`` ..), masking columns
    at or past ``n_global`` and the row's own id -> (idx int32 [nr, k],
    dist [nr, k]) ascending by (distance, id), squared euclidean or 1 −
    â·b̂ on the (normalised, for cosine) operands given; (inf, -1) in
    slots past a row's unmasked columns; the products over operands
    rounded to ``matmul_dtype``.  Kernel B1 on CUDA tensors (``norms_*``
    its norm pairs, :func:`knn_cross_cuda`), its plain version on CPU
    tensors."""
    if rows.device.type == "cpu":
        dist, idx = knn_cross_plain(rows, cols, k, cosine, row_off, col_off,
                                    n_global, matmul_dtype)
    else:
        dist, idx = knn_cross_cuda(rows, cols, k, cosine, row_off, col_off,
                                   n_global, norms_r, norms_c, matmul_dtype)
    return _fused_final(dist, idx, "sqeuclidean")


def fused_knn(x: torch.Tensor, k: int, metric: str = "sqeuclidean",
              matmul_dtype=None):
    """Exact kNN of ``x`` against itself: (idx int32 [N, k], dist [N, k]),
    rows ascending.  ``k`` must already be clamped to N − 1.  Under
    ``matmul_dtype`` (bf16 operands) the products take the rounded
    operands: B1's bf16 form on the card."""
    cosine = metric == "cosine"
    base = _base(x, metric)
    if base.device.type == "cpu":
        dist, idx = knn_sweep_plain(base, k, cosine,
                                    matmul_dtype=matmul_dtype)
    else:
        dist, idx = knn_sweep_cuda(base, k, cosine, matmul_dtype)
    return _fused_final(dist, idx, metric)


# ---- B6: one funnel stage of a refine chunk -----------------------------

#: the widest row (F values) B6 stages in shared memory; a wider stage
#: launches its unstaged form, which no F limits
STAGED_F_MAX = B6_STAGED_F_MAX
#: the narrowest F the unstaged form takes (WIDE_F in csrc/knn_cand.cu:
#: its groups are warps)
UNSTAGED_F_MIN = 64
#: keys the on-chip route's bitonic sort takes a row (a keep stage's
#: survivors, or the exact stage's old + new lists, 2k, rounded up to a
#: power of two); a stage past it takes the workspace route
REFINE_SORT_MAX = 8192
#: the dynamic shared memory a block may opt in to on sm_90 (SMEM_MAX in
#: csrc/knn_cand.cu)
REFINE_SMEM_MAX = 232_448


def _a16(b: int) -> int:
    return (b + 15) // 16 * 16


def final_in_kernel(metric: str) -> bool:
    """Whether the card's exact stage in ``metric`` runs in kernel B6,
    which gathers no candidate vectors, rather than in the plain version,
    which gathers them [c, Z, F] (cosine: :func:`refine_final`)."""
    return metric != "cosine"


def refine_staged(f: int) -> bool:
    """Whether a B6 stage at width ``f`` takes the staged form (its row
    in shared memory) rather than the unstaged one."""
    return f <= STAGED_F_MAX


def refine_smem_bytes(f: int, w: int, ke: int, keep: int, k: int,
                      build: bool, final: bool, itemsize: int = 4,
                      staged: bool | None = None) -> int:
    """The dynamic shared memory of one B6 block on the on-chip route at
    values of ``itemsize`` bytes (4: float32, 8: B6_f64), as ``Layout``
    in ``csrc/knn_cand.cu`` lays it out: the row's vector (F values; the
    staged form only), the candidate ids, a histogram, the gateways (a
    first stage), the old list (the exact stage; the float64 form keeps
    it in the ids' array, dead by then), and one region that holds the
    hash set (2 slots a candidate) and then the sort keys (a power of
    two, 8 bytes each, or 16 at float64) with the scores.  ``staged``
    (None: :func:`refine_staged` of ``f``) picks the form."""
    staged = refine_staged(f) if staged is None else staged
    a16 = _a16
    zcap = w * (1 + ke) if build else w
    sortcap = 1 << ((2 * k if final else keep) - 1).bit_length()
    old = a16(4 * k) + a16(itemsize * k) if final else 0
    ids = 4 * zcap
    if itemsize == 8:
        ids, old = max(ids, old), 0
    at = ((a16(itemsize * f) if staged else 0) + a16(ids) + a16(4 * 256)
          + a16(4 * 8) + old)
    at += a16(4 * w) if build else 0
    table = 4 * 2 * zcap if build else 0
    key = 8 if itemsize == 4 else 16
    return at + a16(max(table, key * sortcap + itemsize * zcap))


def refine_ws_layout(f: int, w: int, ke: int, keep: int, k: int,
                     build: bool, final: bool, itemsize: int = 4,
                     staged: bool | None = None) -> tuple[int, int]:
    """(shared memory, workspace bytes a row) of one B6 block on the
    workspace route, as ``WsLayout`` in ``csrc/knn_cand.cu`` lays it out.
    Shared memory: the row's vector (the staged form only), the
    histogram, the counters, the gateways (a first stage) and the radix
    sort's per-warp digit counts (8 x 256).  The row's workspace: the
    candidate ids, the old list (the exact stage) and one region holding
    the hash set (2 slots a candidate), then the sort keys (exactly 2k,
    or ``keep``), the sort's second buffer and the scores.  ``staged``
    as :func:`refine_smem_bytes`'s."""
    staged = refine_staged(f) if staged is None else staged
    zcap = w * (1 + ke) if build else w
    nsort = 2 * k if final else keep
    smem = ((_a16(itemsize * f) if staged else 0) + _a16(4 * 256)
            + _a16(4 * 8) + (_a16(4 * w) if build else 0)
            + _a16(4 * 8 * 256))
    row = _a16(4 * zcap)
    if final:
        row += _a16(4 * k) + _a16(itemsize * k)
    sort = _a16((8 if itemsize == 4 else 16) * nsort)
    table = 4 * 2 * zcap if build else 0
    return smem, row + _a16(max(table, 2 * sort + itemsize * zcap))


class RefineRoute(NamedTuple):
    """Where one B6 stage runs: ``workspace`` bytes a chunk row of device
    memory (0: on chip) and the block's dynamic shared memory."""

    workspace: int
    smem: int


def refine_route(f: int, w: int, ke: int, keep: int, k: int, build: bool,
                 final: bool, itemsize: int = 4,
                 staged: bool | None = None) -> RefineRoute:
    """The route of one B6 stage, as ``tsne_refine_route`` in
    ``csrc/knn_cand.cu`` decides it: on chip when its block fits
    :data:`REFINE_SMEM_MAX` (:func:`refine_smem_bytes`) and sorts at most
    :data:`REFINE_SORT_MAX` keys, else through a workspace of
    :func:`refine_ws_layout`'s bytes a row (any k: past ~k = 1,100 a
    first exact stage's hash set, or a keep stage's 5k sort past 8,192).
    ``staged`` (None: :func:`refine_staged` of ``f``) picks the staged
    form's layouts or the unstaged form's, which hold no row vector."""
    staged = refine_staged(f) if staged is None else staged
    sort = (2 * k if final else keep)
    sortcap = 1 << max(sort - 1, 0).bit_length()
    smem = refine_smem_bytes(f, w, ke, keep, k, build, final, itemsize,
                             staged)
    if smem <= REFINE_SMEM_MAX and sortcap <= REFINE_SORT_MAX:
        return RefineRoute(0, smem)
    smem, row = refine_ws_layout(f, w, ke, keep, k, build, final, itemsize,
                                 staged)
    return RefineRoute(row, smem)


def refine_route_kernel(f: int, w: int, ke: int, keep: int, k: int,
                        build: bool, final: bool, itemsize: int = 4,
                        staged: bool | None = None) -> RefineRoute:
    """:func:`refine_route` as the kernel library itself decides it
    (``tsne_refine_route``; builds the library): the card's checks hold
    the mirror to it."""
    import ctypes
    from tsne_flink_tpu_torch.kernels.build import library
    staged = refine_staged(f) if staged is None else staged
    smem = ctypes.c_size_t()
    ws = library().tsne_refine_route(f, w, ke, keep, k, int(build),
                                     int(final), itemsize, int(staged),
                                     ctypes.byref(smem))
    return RefineRoute(int(ws), int(smem.value))


def refine_scratch_bytes(w: int, ke: int, build: bool,
                         itemsize: int = 4) -> int:
    """The unstaged form's device memory a chunk row beside its route's
    workspace, as ``Scratch`` in ``csrc/knn_cand.cu`` lays it out: a first
    stage's candidate count and ids (2s(1 + ke) of them), the score pass's
    double sums and the scores, one a candidate."""
    zcap = w * (1 + ke) if build else w
    return ((16 + _a16(4 * zcap) if build else 0) + _a16(8 * zcap)
            + _a16(itemsize * zcap))


def refine_scratch_kernel(w: int, ke: int, build: bool,
                          itemsize: int = 4) -> int:
    """:func:`refine_scratch_bytes` as the kernel library states it
    (``tsne_refine_scratch``; builds the library)."""
    from tsne_flink_tpu_torch.kernels.build import library
    return int(library().tsne_refine_scratch(w, ke, int(build), itemsize))


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
    """The TPU kernel's formula, B6's scores: ``(sq[rows] + sq[cand]) −
    2·Σ_f r·c`` clamped at 0, [c, Z].  ``compact`` gathers the candidate
    vectors through the dedup-then-gather form (identical values)."""
    rows = rows.long()
    pr = base[rows]                                 # [c, F]
    pc = _cand_vectors(base, cand, compact)         # [c, Z, F]
    g = torch.sum(pr[:, None, :] * pc, dim=-1)      # [c, Z]
    return torch.clamp(sq[rows][:, None] + sq[cand.long()] - 2.0 * g,
                       min=0.0)


def cand_sqdist(base: torch.Tensor, sq: torch.Tensor, rows: torch.Tensor,
                cand: torch.Tensor, compact: bool = False) -> torch.Tensor:
    """Squared euclidean distances from each of ``base[rows]`` [c] to its
    candidates ``base[cand]`` [c, Z] -> [c, Z], on a CPU tensor.  On the
    card B6 scores inside the fused stage (:func:`refine_keep`,
    :func:`refine_final`), which never builds this [c, Z] tensor: a CUDA
    tensor raises."""
    if base.device.type != "cpu":
        raise ValueError("B6 scores candidates inside the fused refine "
                         "stage on the card (refine_keep / refine_final); "
                         "cand_sqdist takes CPU tensors")
    return cand_sqdist_plain(base, sq, rows, cand, compact)


def cand_exact_plain(metric: str, xf: torch.Tensor, cache: torch.Tensor,
                     rows: torch.Tensor, cand: torch.Tensor,
                     compact: bool = False,
                     matmul_dtype=None) -> torch.Tensor:
    """Exact CLI-metric distances row -> candidates.  ``cache`` holds the
    squared norms (sqeuclidean/euclidean) or the norms (cosine).  Cosine
    is a plain batched product on the card (over operands rounded to
    ``matmul_dtype``) and the elementwise metric on the CPU, as the JAX
    package's accelerator and CPU forms."""
    if metric == "cosine":
        pr = xf[rows.long()]
        pc = _cand_vectors(xf, cand, compact)
        if xf.is_cuda:
            pr, pc = matmul_operands(pr, pc, matmul_dtype)
            g = torch.einsum("cf,czf->cz", pr, pc)
            return 1.0 - g / (cache[rows.long()][:, None]
                              * cache[cand.long()])
        return metric_fn("cosine")(pr[:, None, :], pc)
    d2 = cand_sqdist_plain(xf, cache, rows, cand, compact)
    return torch.sqrt(d2) if metric == "euclidean" else d2


def _chunk_rows(row0: int, cand: torch.Tensor) -> torch.Tensor:
    return torch.arange(row0, row0 + cand.shape[0], device=cand.device)


def refine_candidates_plain(row0: int, gates: torch.Tensor,
                            graph: torch.Tensor, ke: int,
                            n_valid: int | None = None):
    """A chunk's candidates: its rows' gateways [c, 2s] and the first
    ``ke`` ids of each gateway's list in ``graph``, sorted by id ->
    (cand [c, 2s(1 + ke)] int64, bad: self, an in-row duplicate, or an
    id at or past ``n_valid``, a mesh's padding row)."""
    cc = gates.shape[0]
    rc = _chunk_rows(row0, gates)
    mine = gates.long()
    cand = torch.cat([mine, graph[mine][..., :ke].reshape(cc, -1).long()],
                     dim=1)
    cand = torch.sort(cand, dim=1).values
    bad = cand == rc[:, None]                     # self
    bad[:, 1:] |= cand[:, 1:] == cand[:, :-1]     # in-row duplicates
    if n_valid is not None:
        bad |= cand >= n_valid                    # mesh padding rows
    return cand, bad


def _stage_input(row0, cand, bad, graph, ke, n_valid=None):
    """(cand, bad) of a plain stage: built from the gateways (``graph``
    given), a kernel stage's list (``bad`` None: -1 marks no candidate),
    or a plain stage's output as it is."""
    if graph is not None:
        return refine_candidates_plain(row0, cand, graph, ke, n_valid)
    if bad is None:
        bad = cand < 0
        cand = torch.where(bad, _chunk_rows(row0, cand)[:, None],
                           cand.long())
    return cand, bad


def refine_keep_plain(base, sq, row0: int, cand, keep: int, *, bad=None,
                      graph=None, ke: int = 0, compact: bool = False,
                      n_valid: int | None = None):
    """Plain version of a keep stage (the JL filter or the cascade): the
    ``keep`` best-scored candidates of each row, ascending, ties by the
    lowest slot (``lax.top_k(-score, keep)``) -> (cand, bad)."""
    from tsne_flink_tpu_torch.ops.knn import _topk_smallest
    cand, bad = _stage_input(row0, cand, bad, graph, ke, n_valid)
    ad = cand_sqdist_plain(base, sq, _chunk_rows(row0, cand), cand, compact)
    _, sel = _topk_smallest(ad.masked_fill(bad, math.inf), keep)
    return torch.gather(cand, 1, sel), torch.gather(bad, 1, sel)


def refine_final_plain(metric: str, base, cache, row0: int, cand, old_i,
                       old_d, *, bad=None, graph=None, ke: int = 0,
                       compact: bool = False, n_valid: int | None = None,
                       matmul_dtype=None):
    """Plain version of the exact stage: exact CLI-metric distances, the
    lossless pre-top-k to k, and the merge into the rows' lists
    ``old_i``/``old_d`` [c, k] (each id's smallest distance, ordered by
    (distance, id)) -> (new_i, new_d)."""
    from tsne_flink_tpu_torch.ops.knn import _dedup_smallest, _topk_smallest
    cand, bad = _stage_input(row0, cand, bad, graph, ke, n_valid)
    dd = cand_exact_plain(metric, base, cache, _chunk_rows(row0, cand), cand,
                          compact, matmul_dtype).masked_fill(bad, math.inf)
    k = old_i.shape[1]
    if dd.shape[1] > k:
        # lossless pre-top-k: candidates are per-row unique, so any id of
        # the final smallest-k of old ∪ new is among the k smallest new ones
        dd, selk = _topk_smallest(dd, k)
        cand = torch.gather(cand, 1, selk)
    return _dedup_smallest(torch.cat([old_i, cand.to(old_i.dtype)], dim=1),
                           torch.cat([old_d, dd], dim=1), k)


def _check_refine(base, sq, row0, cand, graph, ke, old, keep,
                  n_valid) -> None:
    kernel_float64(base)  # float32 or float64; sq and old_d alike
    vt = base.dtype
    named = [("base", base, vt, 2), ("sq", sq, vt, 1),
             ("cand", cand, torch.int32, 2)]
    if graph is not None:
        named.append(("graph", graph, torch.int32, 2))
    if old is not None:
        named += [("old_i", old[0], torch.int32, 2),
                  ("old_d", old[1], vt, 2)]
    for name, t, dtype, dim in named:
        if not t.is_cuda or t.device != base.device:
            raise ValueError(f"B6 kernel takes CUDA tensors on one device; "
                             f"{name} is on {t.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"B6 kernel takes a contiguous {dim}-D {dtype} "
                             f"{name} (base's value dtype); got {t.dtype} "
                             f"{tuple(t.shape)}")
    n, f = base.shape
    c = cand.shape[0]
    if sq.shape[0] != n or not 0 <= row0 <= n - c or c < 1:
        raise ValueError(f"B6 kernel: sq {tuple(sq.shape)} must be [{n}] and "
                         f"rows {row0}..{row0 + c - 1} within it")
    if graph is not None and (graph.shape[0] != n
                              or not 1 <= ke <= graph.shape[1]):
        raise ValueError(f"B6 kernel: graph {tuple(graph.shape)} must be "
                         f"[{n}, >= ke = {ke}]")
    if old is not None and (old[0].shape != old[1].shape
                            or old[0].shape[0] != c or old[0].shape[1] < 1):
        raise ValueError(f"B6 kernel: old lists {tuple(old[0].shape)} must "
                         f"be [{c}, k], k >= 1")
    if not 1 <= n_valid <= n:
        raise ValueError(f"B6 kernel: n_valid {n_valid} must be in 1..{n}")


def _refine_launch(base, sq, row0, cand, graph, ke, *, keep=0, old=None,
                   euclid=False, n_valid=None, staged=None):
    """Launch B6 (B6_f64 on float64 values; past :data:`STAGED_F_MAX`
    features their unstaged forms B6u / B6u_f64) on one stage of rows
    row0 .. row0 + c − 1; allocates its outputs, ids [c, keep] (keep
    mode) or the new lists [c, k] in base's dtype, for a stage on the
    workspace route (:func:`refine_route`) the chunk's workspace, and for
    the unstaged form its scratch (:func:`refine_scratch_bytes`).
    ``staged`` (None: :func:`refine_staged` of F) picks the form: the
    unstaged form takes any F >= :data:`UNSTAGED_F_MIN`."""
    (n, f), (c, w) = base.shape, cand.shape
    staged = refine_staged(f) if staged is None else bool(staged)
    if f < 1 or (f > STAGED_F_MAX if staged else f < UNSTAGED_F_MIN):
        raise ValueError(f"B6's {'staged' if staged else 'unstaged'} form "
                         f"does not take F = {f}")
    if old is None:
        keep = min(keep, w * (1 + ke) if graph is not None else w)
        if keep < 1:
            raise ValueError(f"B6 kernel keeps at least 1 a row; got {keep}")
    n_valid = n if n_valid is None else int(n_valid)
    _check_refine(base, sq, row0, cand, graph, ke, old, keep, n_valid)
    dev = base.device
    if old is None:
        out_i = torch.empty((c, keep), dtype=torch.int32, device=dev)
        out_d, k = None, 0
    else:
        k = old[0].shape[1]
        out_i = torch.empty((c, k), dtype=torch.int32, device=dev)
        out_d = torch.empty((c, k), dtype=base.dtype, device=dev)
    route = refine_route(f, w, ke if graph is not None else 0, keep, k,
                         graph is not None, old is not None,
                         base.element_size(), staged)
    # the workspace, freed after the launch (reused only by work queued
    # after it on the stream)
    ws = (torch.empty((c, route.workspace), dtype=torch.uint8, device=dev)
          if route.workspace else None)
    kid = "B6" + ("" if staged else "u") + (
        "_f64" if kernel_float64(base) else "")
    args = [base.data_ptr(), sq.data_ptr(), n, f, row0, c, cand.data_ptr(),
            w, None if graph is None else graph.data_ptr(),
            0 if graph is None else graph.shape[1], ke, keep,
            None if old is None else old[0].data_ptr(),
            None if old is None else old[1].data_ptr(), k, int(euclid),
            n_valid, out_i.data_ptr(),
            None if out_d is None else out_d.data_ptr(), _ptr(ws),
            route.workspace]
    if not staged:
        srow = refine_scratch_bytes(w, ke if graph is not None else 0,
                                    graph is not None, base.element_size())
        scratch = torch.empty((c, srow), dtype=torch.uint8, device=dev)
        args += [scratch.data_ptr(), srow]
    KERNELS[kid](*args)
    _count_route(f"{kid} {'workspace' if route.workspace else 'chip'}")
    return out_i if old is None else (out_i, out_d)


def refine_keep(base: torch.Tensor, sq: torch.Tensor, row0: int,
                cand: torch.Tensor, keep: int, *, bad=None, graph=None,
                ke: int = 0, compact: bool = False,
                n_valid: int | None = None):
    """One keep stage of the refine funnel over chunk rows row0 .. row0 +
    c − 1, scored by squared distances in ``base`` (a projection; ``sq``
    its squared norms): each row's ``keep`` best candidates in rank order.

    With ``graph`` [N, k] (a chunk's first stage) ``cand`` holds the rows'
    gateways [c, 2s] and the stage builds the candidates from them and the
    first ``ke`` ids of each gateway's list; otherwise ``cand`` is the
    previous stage's output.  A first stage drops candidates at or past
    ``n_valid`` (the sharded refine's mesh padding rows).  Returns (cand,
    bad): on a CPU tensor the plain version's (ids, self/duplicate/padding
    mask); on a CUDA tensor kernel B6's int32 ids (B6_f64's on float64
    values; B6u's / B6u_f64's past :data:`STAGED_F_MAX` features), -1
    where a row had fewer candidates, and None."""
    if base.device.type == "cpu":
        return refine_keep_plain(base, sq, row0, cand, keep, bad=bad,
                                 graph=graph, ke=ke, compact=compact,
                                 n_valid=n_valid)
    return _refine_launch(base, sq, row0, cand, graph, ke, keep=keep,
                          n_valid=n_valid), None


def refine_final(metric: str, base: torch.Tensor, cache: torch.Tensor,
                 row0: int, cand: torch.Tensor, old_i: torch.Tensor,
                 old_d: torch.Tensor, *, bad=None, graph=None, ke: int = 0,
                 compact: bool = False, n_valid: int | None = None,
                 matmul_dtype=None):
    """The exact stage of the refine funnel over chunk rows row0 .. row0 +
    c − 1: exact ``metric`` distances in ``base`` (``cache`` its squared
    norms, or its norms for cosine), the k nearest candidates merged into
    the rows' lists ``old_i``/``old_d`` [c, k] -> (new_i, new_d), each id
    at its smallest distance, rows ordered by (distance, id).  ``cand``,
    ``bad``, ``graph``, ``ke`` and ``n_valid`` as :func:`refine_keep`'s.

    Kernel B6 (B6_f64 on float64 values, its distances float64; their
    unstaged forms past :data:`STAGED_F_MAX` features) on a CUDA
    tensor for sqeuclidean and euclidean; the plain version on a CPU
    tensor, and for cosine, whose exact stage is plain
    PyTorch on the card too (the JAX package has no kernel for it); its
    product alone takes ``matmul_dtype`` (the module docstring: B6 keeps
    its float32 bits under bf16 operands)."""
    if base.device.type == "cpu" or not final_in_kernel(metric):
        return refine_final_plain(metric, base, cache, row0, cand, old_i,
                                  old_d, bad=bad, graph=graph, ke=ke,
                                  compact=compact, n_valid=n_valid,
                                  matmul_dtype=matmul_dtype)
    if metric not in ("sqeuclidean", "euclidean"):
        raise ValueError(f"Metric '{metric}' not defined")
    return _refine_launch(base, cache, row0, cand, graph, ke,
                          old=(old_i, old_d), euclid=metric == "euclidean",
                          n_valid=n_valid)
