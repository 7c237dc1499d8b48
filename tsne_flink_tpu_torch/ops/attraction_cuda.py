"""B3, B4 and B5: the CSR step, the KL pass and the forces alone, plus the
CSR layout.

Port of ``tsne_flink_tpu/ops/attraction_pallas.py``:

* :func:`pick_csr_width`, :func:`csr_tail_pad` and :func:`build_csr` —
  the capped-width CSR head ``[N, W]`` + the flat overflow tail, built once
  per run as tensor code on its input's device (the JAX package builds it
  on the host in numpy; the two give the same arrays).
* :func:`fused_step_update` (B3, replaces ``::_fused_kernel``): the CSR
  step of a row in one pass — head and tail forces, rep/Z, vdM gains,
  momentum and the y update, plus per-row ‖grad‖²; optionally visiting
  the rows in a given order (:func:`visit_order`: the hubs first), which
  moves no bit.
* :func:`attraction_loss` (B4, replaces ``::_loss_kernel``): per-row KL
  partials Σ pe·log(pe·Z/q) over a row block and a ragged edge part.
* :func:`attraction_forces` (B5, replaces ``::_forces_kernel``): the
  forces of a row's whole attraction pass — over a row block of any width
  (the [N, S] rows, the blocks layout's forward block, a CSR head; W may
  be 0) and a ragged part (:class:`Ragged`: the blocks layout's reverse
  edges, the edges layout's list, a CSR tail), y_i·Σw − Σw·y_j and
  Σ w·(y_i − y_j), added as forward + ragged.

The kernels are ``csrc/attraction.cu``; its header says what bounds them
on an H100 (bytes) and how one warp walks a row's slots of both parts,
gathering ``y_full[j]`` inside the kernel instead of materialising it.
On CPU tensors the wrappers run :func:`fused_step_plain` /
:func:`attraction_loss_plain` / :func:`attraction_forces_plain`, which
mirror the JAX package's XLA twins (``_xla_fused`` / ``_xla_loss`` /
``_xla_forces``) operation for operation, the fused one through the same
head math as the forces, and its segment sums over an edge list
(:func:`edge_forces_plain`, :func:`edge_loss_plain`); on CUDA tensors
they launch the kernels or raise.  The register-held instances take m
= 1 .. :data:`M_NARROW`; a wider embedding launches the kernels' wide
forms (``KERNELS["B3w"]``, ``["B4w"]``, ``["B5w"]``), which take any m:
B3w and B5w give a slot to a group of lanes, each lane a 32-byte piece
of the point, a force chunk of :func:`wide_dims` dims a grid row; B4w's
lanes split the row's dimensions.  On a mesh shard (``parallel/mesh``) they take the
shard's rows — ``y_local``, its head or row block, its ragged part with
local sources and global destinations — against the gathered
``y_full``; one warp walks one row, so a row's bits do not depend on the
launch's row count (held on the card by ``chip_smoke.py``'s ``[mesh]``).

Each kernel takes float32 or float64 values with every value operand of
one dtype (ids int32, the row pointer int64) and launches the matching
form — ``KERNELS["B3_f64"]`` etc. at float64, the same templates over
the scalar type — casting nothing on the way in.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS, M_NARROW, form_id
from tsne_flink_tpu_torch.ops.metrics import kernel_float64, metric_fn

#: padding multiple of the CSR tail edge list
TAIL_MULTIPLE = 1024


def wide_dims(float64: bool) -> int:
    """The dims of one force chunk of B3w / B5w: 32 lanes x a 32-byte
    piece each (csrc/attraction.cu ``slot_chunk_dims``), 256 at float32,
    128 at float64; :func:`kernel_wide_config` reads the kernel's own."""
    return 128 if float64 else 256


def wide_chunks(m: int, float64: bool) -> int:
    """The force chunks of a B3w / B5w launch at width ``m``, as the
    memory model counts them on any device."""
    return -(-m // wide_dims(float64))


@functools.cache
def kernel_wide_config(m: int, float64: bool) -> tuple[int, int, int]:
    """``(M_NARROW, dims a force chunk, chunks)`` of B3w / B5w at width
    ``m`` and the dtype as the kernel library states them
    (``tsne_attraction_wide_config``; builds the library).  B3w's
    ‖grad‖² partials are sized from it, so the buffer always holds what
    the kernel writes."""
    import ctypes
    from tsne_flink_tpu_torch.kernels.build import library
    dims, chunks = ctypes.c_int(), ctypes.c_int()
    narrow = library().tsne_attraction_wide_config(
        m, int(float64), ctypes.byref(dims), ctypes.byref(chunks))
    return narrow, dims.value, chunks.value


class Ragged(NamedTuple):
    """A src-sorted edge list as B4 and B5 take it: row i's edges are
    ``dst``/``val`` [rowptr[i], rowptr[i + 1]).  ``src`` [E] is kept for
    the plain versions' segment sums."""

    rowptr: torch.Tensor  # int64 [nloc + 1]
    src: torch.Tensor
    dst: torch.Tensor
    val: torch.Tensor


def ragged_edges(src, dst, val, nloc: int) -> Ragged:
    """The :class:`Ragged` form of a src-sorted edge list over ``nloc``
    rows (built once per run)."""
    rowptr = torch.zeros(nloc + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(src.long(), minlength=nloc), 0,
                 out=rowptr[1:])
    return Ragged(rowptr, src, dst, val)


# ---- CSR cap policy + one-time build ---------------------------------------

# graftlint: disable=policy-recorded -- a pure function of the graph's
# edge count and width; the port has no bench record, and the run
# reports the layout it feeds (stats['layout'])
def pick_csr_width(n_edges: int, n_rows: int, s: int) -> int:
    """Head width: ~1.3x the mean symmetrized degree, rounded up to a
    multiple of 64 (64 <= W <= S)."""
    mean = n_edges / max(1, n_rows)
    w = math.ceil(1.3 * mean / 64) * 64
    return int(min(s, max(64, w)))


def csr_tail_pad(n_tail: int) -> int:
    return max(TAIL_MULTIPLE,
               math.ceil(n_tail / TAIL_MULTIPLE) * TAIL_MULTIPLE)


def build_csr(jidx, jval, width: int):
    """Padded rows ``[N, S]`` -> (head ``[N, W]`` idx/val, tail COO), on
    ``jidx``'s device.

    Each row's set entries (val > 0) keep their order: the first ``W``
    fill the head (missing slots carry idx = val = 0), the rest become a
    (src, dst, val) tail sorted by src, padded with (n-1, 0, 0) to
    :func:`csr_tail_pad`.  Tensor code: a global rank plane of the set
    slots (int32 cumulative sums, the one [N, S] temporary that lives
    through the build), then each head slot and tail entry finds its
    source slot by a binary search of that plane, and the values are
    gathered — so they are copies, the same bits as the JAX package's
    numpy build.  One host sync, for the tail's length."""
    n, s = jidx.shape
    w = int(min(width, s))
    dev = jidx.device
    # rank[r, c] = the number of set slots up to and including (r, c), in
    # row-major order: row r's j-th set slot is where rank first reaches
    # row_start[r] + j + 1.  The per-row counts are summed in blocks of
    # rows, so no [N, S] mask or cast copy (a bool sum widens to int64)
    # lives beside the plane.
    rank = torch.empty((n, s), dtype=torch.int32, device=dev)
    rows = max(1, (1 << 24) // max(s, 1))
    for r0 in range(0, n, rows):
        torch.cumsum(jval[r0:r0 + rows] > 0, 1, dtype=torch.int32,
                     out=rank[r0:r0 + rows])
    deg = rank[:, -1].long()
    row_start = torch.cumsum(deg, 0) - deg
    rank += row_start[:, None].to(torch.int32)
    want = (row_start[:, None]
            + torch.arange(1, w + 1, device=dev)).to(torch.int32)
    col = torch.searchsorted(rank, want).clamp_(max=max(s - 1, 0))
    has = torch.arange(w, device=dev)[None, :] < deg[:, None]
    hidx = torch.where(has, torch.gather(jidx, 1, col), 0).to(torch.int32)
    hval = torch.where(has, torch.gather(jval, 1, col), 0)
    n_over = torch.clamp(deg - w, min=0)
    over_end = torch.cumsum(n_over, 0)
    # graftlint: disable=host-sync -- the CSR build's one host read: the
    # tail length sizes the tail arrays (the plan stage, once a run)
    n_tail = int(over_end[-1]) if n else 0  # the one host sync
    e_pad = csr_tail_pad(n_tail)
    e = torch.arange(n_tail, device=dev)
    src = torch.searchsorted(over_end, e, right=True)
    # entry e is its row's (w + e − first)-th set slot, 0-based
    want = (row_start[src] + w + (e - (over_end[src] - n_over[src]))
            + 1).to(torch.int32)
    at = torch.searchsorted(rank.view(-1), want)
    tsrc = torch.full((e_pad,), n - 1, dtype=torch.int32, device=dev)
    tdst = torch.zeros((e_pad,), dtype=torch.int32, device=dev)
    tval = torch.zeros((e_pad,), dtype=jval.dtype, device=dev)
    tsrc[:n_tail] = src.to(torch.int32)
    tdst[:n_tail] = jidx.reshape(-1)[at].to(torch.int32)
    tval[:n_tail] = jval.reshape(-1)[at]
    return (hidx.contiguous(), hval.contiguous()), (tsrc, tdst, tval)


def visit_order(ragged: Ragged) -> torch.Tensor:
    """B3's visit order over the rows of a ``ragged`` tail: the int32
    permutation that puts the rows with the longest tails first (index
    order among equals).  A hub's tail is walked by one warp, the
    launch's longest; started first, it runs beside the other rows
    instead of after them.  Built once per run: the tail is fixed."""
    return torch.argsort(torch.diff(ragged.rowptr), descending=True,
                         stable=True).to(torch.int32)


# ---- plain versions (the JAX package's XLA twins) ---------------------------

def _head_q(yc, yj):
    """Norm-trick squared distances and Student-t q of a [c, W] tile."""
    d2 = (torch.sum(yc * yc, dim=1)[:, None] + torch.sum(yj * yj, dim=2)
          - 2.0 * torch.sum(yc[:, None, :] * yj, dim=2))
    return 1.0 / (1.0 + torch.clamp(d2, min=0.0))


def _plain_forces(yc, yj, val, exag):
    """Head forces of a [c, W] tile: y_i·Σw − Σw·y_j, w = val·exag·q."""
    w = val * exag * _head_q(yc, yj)
    return (yc * torch.sum(w, dim=1)[:, None]
            - torch.sum(w[:, :, None] * yj, dim=1))


def _plain_fused(yc, yj, val, tail, repz, maskc, upd, gains, exag, momentum,
                 eta, min_gain):
    att = (_plain_forces(yc, yj, val, exag) + tail).to(yc.dtype)
    grad = (att - repz) * maskc[:, None]
    same_sign = (grad > 0.0) == (upd > 0.0)
    gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                        min=min_gain)
    upd = momentum * upd - eta * gains * grad
    return yc + upd, upd, gains, torch.sum(grad * grad, dim=1)


def _plain_loss(yc, yj, val, exag, z):
    q = _head_q(yc, yj)
    pe = val * exag
    mask = val > 0
    pe_safe = torch.where(mask, pe, 1.0)
    q_safe = torch.where(mask, q, 1.0)
    terms = torch.where(mask, pe * torch.log(pe_safe * z / q_safe), 0.0)
    return torch.sum(terms, dim=1)


def _mask_of(valid, y_local):
    return (torch.ones(y_local.shape[0], dtype=y_local.dtype,
                       device=y_local.device)
            if valid is None else valid.to(y_local.dtype))


def fused_step_plain(y_local, y_full, jidx, jval, exag, rep, z, valid,
                     update, gains, momentum, *, eta, min_gain,
                     ragged: Ragged | None = None, order=None,
                     row_chunk: int = 4096):
    """Plain version of B3: ``(y, update, gains, gsq)``.  The tail's forces
    are the ragged part's sorted segment sum (:func:`edge_forces_plain`),
    then per row chunk the head forces, ``(head + tail) − rep / z``, the
    mask and the vdM update (the JAX package's ``_xla_fused``).  Per-row
    math only, so any chunking gives the same bits; ``order`` cannot
    change a result and is not read."""
    del order
    maskv = _mask_of(valid, y_local)
    if not torch.is_tensor(z):
        z = torch.tensor(z, dtype=rep.dtype)
    repz = rep / z
    tail = (torch.zeros_like(y_local) if ragged is None else
            edge_forces_plain(y_local, y_full, ragged.src, ragged.dst,
                              ragged.val, exag, torch.diff(ragged.rowptr)))
    if jidx is None:  # no head block: zero head forces
        jidx = torch.zeros((y_local.shape[0], 0), dtype=torch.int32,
                           device=y_local.device)
        jval = torch.zeros((y_local.shape[0], 0), dtype=y_local.dtype,
                           device=y_local.device)
    outs = []
    for s in range(0, y_local.shape[0], row_chunk):
        sl = slice(s, s + row_chunk)
        yj = y_full[jidx[sl].long()]
        outs.append(_plain_fused(y_local[sl], yj, jval[sl], tail[sl],
                                 repz[sl], maskv[sl], update[sl], gains[sl],
                                 exag, momentum, eta, min_gain))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _segment_sum(data, lengths):
    """Sorted segment sum: segment i owns the next ``lengths[i]`` rows of
    ``data``.  Each segment is reduced by one thread in order — no atomic
    scatter, so the result is the same on every run."""
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)


def edge_forces_plain(y_local, y_full, src, dst, val, exag, lengths=None):
    """Attraction forces of a flat edge list sorted by ``src``:
    Σ_e val·exag·q (y_src − y_dst) per source row."""
    if lengths is None:
        lengths = torch.bincount(src.long(), minlength=y_local.shape[0])
    f = metric_fn("sqeuclidean")
    yi = y_local[src.long()]
    yj = y_full[dst.long()]
    q = 1.0 / (1.0 + f(yi, yj))
    w = val * exag * q
    return _segment_sum(w[:, None] * (yi - yj), lengths)


def edge_loss_plain(y_local, y_full, src, dst, val, exag, z, lengths=None):
    """Per-row partial KL of a sorted edge list (zero-valued padding
    edges add exactly 0)."""
    if lengths is None:
        lengths = torch.bincount(src.long(), minlength=y_local.shape[0])
    f = metric_fn("sqeuclidean")
    yi = y_local[src.long()]
    yj = y_full[dst.long()]
    q = 1.0 / (1.0 + f(yi, yj))
    pe = val * exag
    mask = val > 0
    pe_safe = torch.where(mask, pe, 1.0)
    q_safe = torch.where(mask, q, 1.0)
    terms = torch.where(mask, pe * torch.log(pe_safe * z / q_safe), 0.0)
    return _segment_sum(terms, lengths)


def _has_block(jidx, ragged) -> bool:
    """Whether a call has a row-block part: W > 0, or no ragged part (the
    kernels' rule, csrc/attraction.cu)."""
    return ragged is None or (jidx is not None and jidx.shape[1] > 0)


def attraction_forces_plain(y_local, y_full, jidx, jval, exag, *,
                            ragged: Ragged | None = None,
                            row_chunk: int = 4096):
    """Plain version of B5: forces [nloc, m] — the row block's, chunked
    over rows, + the ragged part's sorted segment sum."""
    att = None
    if _has_block(jidx, ragged):
        att = torch.cat([
            _plain_forces(y_local[s:s + row_chunk],
                          y_full[jidx[s:s + row_chunk].long()],
                          jval[s:s + row_chunk], exag)
            for s in range(0, y_local.shape[0], row_chunk)])
    if ragged is None:
        return att
    rag = edge_forces_plain(y_local, y_full, ragged.src, ragged.dst,
                            ragged.val, exag, torch.diff(ragged.rowptr))
    return rag if att is None else att + rag


def attraction_loss_plain(y_local, y_full, jidx, jval, exag, z, *,
                          ragged: Ragged | None = None,
                          row_chunk: int = 4096):
    """Plain version of B4: per-row partial KL [nloc] — the row block's +
    the ragged part's."""
    loss = None
    if _has_block(jidx, ragged):
        loss = torch.cat([
            _plain_loss(y_local[s:s + row_chunk],
                        y_full[jidx[s:s + row_chunk].long()],
                        jval[s:s + row_chunk], exag, z)
            for s in range(0, y_local.shape[0], row_chunk)])
    if ragged is None:
        return loss
    rag = edge_loss_plain(y_local, y_full, ragged.src, ragged.dst,
                          ragged.val, exag, z, torch.diff(ragged.rowptr))
    return rag if loss is None else loss + rag


# ---- wrappers ---------------------------------------------------------------

def _check_cuda(name, y_local, y_full, jidx, jval, planes=(), ragged=None):
    """Device, dtype, shape and contiguity of a head kernel's operands;
    ``planes`` are [nloc, m] state planes of the value dtype, ``ragged`` a
    :class:`Ragged` part.  Returns the block's width W (0 without one)."""
    dev = y_local.device
    if not y_local.is_cuda:
        raise ValueError(f"{name} kernel takes CUDA tensors, got {dev}")
    kernel_float64(y_local)  # float32 or float64, every value alike
    vt = y_local.dtype
    nloc, m = y_local.shape
    if m < 1 or y_full.dim() != 2 or y_full.shape[1] != m:
        raise ValueError(f"{name} kernel takes [N, m] embeddings of one "
                         f"width m >= 1; got {tuple(y_local.shape)} and "
                         f"{tuple(y_full.shape)}")
    if m <= M_NARROW and y_full.data_ptr() % 16:
        raise ValueError(f"{name} kernel gathers y_full's rows as vectors: "
                         "it needs a 16-byte aligned base")
    want = [(y_local, vt, (nloc, m)), (y_full, vt, tuple(y_full.shape))]
    w = 0 if jidx is None else jidx.shape[1]
    if jidx is not None:
        want += [(jidx, torch.int32, (nloc, w)), (jval, vt, (nloc, w))]
    want += [(p, vt, (nloc, m)) for p in planes]
    if ragged is not None:
        e = ragged.dst.shape[0]
        want += [(ragged.rowptr, torch.int64, (nloc + 1,)),
                 (ragged.dst, torch.int32, (e,)),
                 (ragged.val, vt, (e,))]
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} kernel: expected {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
    return w


def _launch_rows(kernel, y_local, y_full, jidx, jval, w, ragged, *args):
    """Launch B3, B4 or B5 over ``y_local``'s rows: the row block (null
    pointers when W = 0), the ragged part (null without one), then
    ``args``."""
    if y_local.shape[0] == 0:
        return
    blk = (None, None) if w == 0 else (jidx.data_ptr(), jval.data_ptr())
    rag = ((None, None, None) if ragged is None else
           (ragged.rowptr.data_ptr(), ragged.dst.data_ptr(),
            ragged.val.data_ptr()))
    kernel(y_local.data_ptr(), y_full.data_ptr(), *blk, y_local.shape[0], w,
           *rag, y_local.shape[1], *args)


def fused_step_update(y_local, y_full, jidx, jval, exag, rep, z, valid,
                      update, gains, momentum, *, eta, min_gain,
                      ragged: Ragged | None = None, order=None,
                      row_chunk: int = 4096):
    """THE CSR step, one launch of B3: over a head block ``(jidx, jval)``
    [nloc, W] (None or W = 0: none) and a ``ragged`` tail
    (:class:`Ragged`, None: none), grad = ((head + tail) − rep / z)·valid,
    then the vdM gains, momentum and y update.  Returns ``(y, update,
    gains, gsq)`` — new tensors, the inputs are left untouched.  ``z`` is
    the global Z, a 0-d tensor (read on the device by the kernel, no host
    sync) or a float; ``valid`` the padded-row mask or None; ``order`` an
    int32 permutation of the rows to visit them in (:func:`visit_order`)
    or None — it moves no bit.  ``exag``/``momentum``/``eta``/``min_gain``
    are host floats."""
    if y_local.device.type == "cpu":
        return fused_step_plain(y_local, y_full, jidx, jval, exag, rep, z,
                                valid, update, gains, momentum, eta=eta,
                                min_gain=min_gain, ragged=ragged,
                                order=order, row_chunk=row_chunk)
    nloc = y_local.shape[0]
    w = _check_cuda("B3", y_local, y_full, jidx, jval,
                    (rep, update, gains), ragged=ragged)
    dev = y_local.device
    mask = None
    if valid is not None:
        if valid.shape != (nloc,) or valid.device != dev:
            raise ValueError(f"B3 kernel: valid must be [{nloc}] on {dev}")
        mask = valid.to(y_local.dtype).contiguous()
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (nloc,)
                              or order.device != dev
                              or not order.is_contiguous()):
        raise ValueError(f"B3 kernel: order must be a contiguous int32 "
                         f"[{nloc}] permutation on {dev}")
    z = torch.as_tensor(z, dtype=y_local.dtype,
                        device=dev).reshape(1).contiguous()
    y2, u2, g2 = (torch.empty_like(y_local) for _ in range(3))
    m = y_local.shape[1]
    # the wide form writes a ‖grad‖² partial a force chunk
    chunks = (kernel_wide_config(m, kernel_float64(y_local))[2]
              if m > M_NARROW else 1)
    gsq = torch.empty((chunks, nloc) if chunks > 1 else nloc, device=dev,
                      dtype=y_local.dtype)
    _launch_rows(KERNELS[form_id("B3", kernel_float64(y_local), m)],
                 y_local, y_full, jidx, jval, w, ragged,
                 None if order is None else order.data_ptr(),
                 rep.data_ptr(), z.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 update.data_ptr(), gains.data_ptr(), float(exag),
                 float(momentum), float(eta), float(min_gain), y2.data_ptr(),
                 u2.data_ptr(), g2.data_ptr(), gsq.data_ptr())
    return y2, u2, g2, gsq if chunks == 1 else torch.sum(gsq, dim=0)


def attraction_loss(y_local, y_full, jidx, jval, exag, z, *,
                    ragged: Ragged | None = None, row_chunk: int = 4096):
    """Per-row partial KL [nloc] (sum it for the scalar) over a row block
    ``(jidx, jval)`` [nloc, W] (None or W = 0: none) and a ``ragged``
    part: forward + ragged.  ``z`` is the global Z — a 0-d tensor (read on
    the device by the kernel, no host sync) or a float."""
    if y_local.device.type == "cpu":
        return attraction_loss_plain(y_local, y_full, jidx, jval, exag, z,
                                     ragged=ragged, row_chunk=row_chunk)
    w = _check_cuda("B4", y_local, y_full, jidx, jval, ragged=ragged)
    z = torch.as_tensor(z, dtype=y_local.dtype,
                        device=y_local.device).reshape(1).contiguous()
    loss = torch.empty(y_local.shape[0], device=y_local.device,
                       dtype=y_local.dtype)
    _launch_rows(KERNELS[form_id("B4", kernel_float64(y_local),
                                 y_local.shape[1])],
                 y_local, y_full, jidx, jval, w, ragged,
                 float(exag), z.data_ptr(), loss.data_ptr())
    return loss


def attraction_forces(y_local, y_full, jidx, jval, exag, *,
                      ragged: Ragged | None = None, row_chunk: int = 4096):
    """Attraction forces [nloc, m], a new tensor, over a row block
    ``(jidx, jval)`` [nloc, W] of any width (None or W = 0: none) and a
    ``ragged`` part (:class:`Ragged`, None: none): forward + ragged.
    ``exag`` is a host float."""
    if y_local.device.type == "cpu":
        return attraction_forces_plain(y_local, y_full, jidx, jval, exag,
                                       ragged=ragged, row_chunk=row_chunk)
    w = _check_cuda("B5", y_local, y_full, jidx, jval, ragged=ragged)
    att = torch.empty_like(y_local)
    _launch_rows(KERNELS[form_id("B5", kernel_float64(y_local),
                                 y_local.shape[1])],
                 y_local, y_full, jidx, jval, w, ragged,
                 float(exag), att.data_ptr())
    return att
