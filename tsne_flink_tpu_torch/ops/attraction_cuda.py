"""B3 and B4: the fused CSR-head step and its KL pass, plus the CSR layout.

Port of ``tsne_flink_tpu/ops/attraction_pallas.py``:

* :func:`pick_csr_width`, :func:`csr_tail_pad` and :func:`build_csr` —
  the capped-width CSR head ``[N, W]`` + the flat overflow tail, built once
  per run on the host in numpy (a copy of the JAX package's code; the
  port imports nothing from it).
* :func:`fused_step_update` (B3, replaces ``::_fused_kernel``): head
  forces, the tail/repulsion combine, vdM gains, momentum and the y
  update in one pass per row, plus per-row ‖grad‖².
* :func:`attraction_loss` (B4, replaces ``::_loss_kernel``): per-row KL
  partials Σ pe·log(pe·Z/q) over the head.

The kernels are ``csrc/attraction.cu``; its header says what bounds them
on an H100 (bytes) and how they gather ``y_full[hidx]`` inside the kernel
instead of materialising it.  On CPU tensors the wrappers run
:func:`fused_step_plain` / :func:`attraction_loss_plain`, which mirror the
JAX package's XLA twins (``_xla_fused`` / ``_xla_loss``) operation for
operation; on CUDA tensors they launch the kernels or raise.  The
forces-only kernel B5 (rows layout, unfused step, serving) is ROADMAP
queue A6.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS

#: padding multiple of the CSR tail edge list
TAIL_MULTIPLE = 1024


# ---- CSR cap policy + one-time build ---------------------------------------

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
    """Padded rows ``[N, S]`` -> (head ``[N, W]`` idx/val, tail COO).

    One host-side numpy pass.  Each row's valid entries keep their order:
    the first ``W`` fill the head (missing slots carry val = 0), the rest
    become a (src, dst, val) tail sorted by src, padded with (n-1, 0, 0).
    Tensors come back on ``jidx``'s device."""
    device = jidx.device
    ji = jidx.cpu().numpy()
    jv = jval.cpu().numpy()
    n, s = ji.shape
    w = int(min(width, s))
    flat = np.flatnonzero((jv > 0).ravel())
    rows = (flat // s).astype(np.int64)
    deg = np.bincount(rows, minlength=n)
    row_start = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_start[1:])
    rank = np.arange(len(flat), dtype=np.int64) - row_start[rows]
    jif = ji.ravel()[flat]
    jvf = jv.ravel()[flat]
    head = rank < w
    hidx = np.zeros((n, w), np.int32)
    hval = np.zeros((n, w), jv.dtype)
    pos = rows[head] * w + rank[head]
    hidx.ravel()[pos] = jif[head]
    hval.ravel()[pos] = jvf[head]
    tail = ~head
    n_tail = int(tail.sum())
    e_pad = csr_tail_pad(n_tail)
    tsrc = np.full((e_pad,), n - 1, np.int32)
    tdst = np.zeros((e_pad,), np.int32)
    tval = np.zeros((e_pad,), jv.dtype)
    tsrc[:n_tail] = rows[tail]
    tdst[:n_tail] = jif[tail]
    tval[:n_tail] = jvf[tail]
    return (tuple(torch.from_numpy(a).to(device) for a in (hidx, hval)),
            tuple(torch.from_numpy(a).to(device) for a in (tsrc, tdst, tval)))


# ---- plain versions (the JAX package's XLA twins) ---------------------------

def _head_q(yc, yj):
    """Norm-trick squared distances and Student-t q of a [c, W] tile."""
    d2 = (torch.sum(yc * yc, dim=1)[:, None] + torch.sum(yj * yj, dim=2)
          - 2.0 * torch.sum(yc[:, None, :] * yj, dim=2))
    return 1.0 / (1.0 + torch.clamp(d2, min=0.0))


def _plain_fused(yc, yj, val, tail, repz, maskc, upd, gains, exag, momentum,
                 eta, min_gain):
    w = val * exag * _head_q(yc, yj)
    att = yc * torch.sum(w, dim=1)[:, None] - torch.sum(w[:, :, None] * yj,
                                                         dim=1)
    att = (att + tail).to(yc.dtype)
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


def fused_step_plain(y_local, y_full, jidx, jval, exag, tail_att, repz,
                     valid, update, gains, momentum, *, eta, min_gain,
                     row_chunk: int = 4096):
    """Plain version of B3, chunked over rows: ``(y, update, gains,
    gsq)``.  Per-row math only, so any chunking gives the same bits."""
    maskv = _mask_of(valid, y_local)
    outs = []
    for s in range(0, y_local.shape[0], row_chunk):
        sl = slice(s, s + row_chunk)
        yj = y_full[jidx[sl].long()]
        outs.append(_plain_fused(y_local[sl], yj, jval[sl], tail_att[sl],
                                 repz[sl], maskv[sl], update[sl], gains[sl],
                                 exag, momentum, eta, min_gain))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def attraction_loss_plain(y_local, y_full, jidx, jval, exag, z, *,
                          row_chunk: int = 4096):
    """Plain version of B4: per-row partial KL [nloc]."""
    return torch.cat([
        _plain_loss(y_local[s:s + row_chunk],
                    y_full[jidx[s:s + row_chunk].long()],
                    jval[s:s + row_chunk], exag, z)
        for s in range(0, y_local.shape[0], row_chunk)])


# ---- wrappers ---------------------------------------------------------------

def _check_cuda(name, y_local, y_full, jidx, jval, planes=()):
    """Device, dtype, shape and contiguity of a head kernel's operands;
    ``planes`` are [nloc, m] f32 state planes."""
    dev = y_local.device
    if not y_local.is_cuda:
        raise ValueError(f"{name} kernel takes CUDA tensors, got {dev}")
    nloc, m = y_local.shape
    if m not in (2, 3) or y_full.dim() != 2 or y_full.shape[1] != m:
        raise ValueError(f"{name} kernel takes [N, m] embeddings with m = 2 "
                         f"or 3; got {tuple(y_local.shape)} and "
                         f"{tuple(y_full.shape)}")
    w = jidx.shape[1]
    want = [(y_local, torch.float32, (nloc, m)),
            (y_full, torch.float32, tuple(y_full.shape)),
            (jidx, torch.int32, (nloc, w)), (jval, torch.float32, (nloc, w))]
    want += [(p, torch.float32, (nloc, m)) for p in planes]
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} kernel: expected {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")


def fused_step_update(y_local, y_full, jidx, jval, exag, tail_att, repz,
                      valid, update, gains, momentum, *, eta, min_gain,
                      row_chunk: int = 4096):
    """THE fused attraction + integration step over a CSR head
    ``(jidx, jval)`` [nloc, W]: ``(y, update, gains, gsq)`` — new tensors,
    the inputs are left untouched.  ``repz`` is rep/Z, ``valid`` the
    padded-row mask or None; ``exag``/``momentum``/``eta``/``min_gain``
    are host floats."""
    if y_local.device.type == "cpu":
        return fused_step_plain(y_local, y_full, jidx, jval, exag, tail_att,
                                repz, valid, update, gains, momentum,
                                eta=eta, min_gain=min_gain,
                                row_chunk=row_chunk)
    nloc = y_local.shape[0]
    _check_cuda("B3", y_local, y_full, jidx, jval,
                (tail_att, repz, update, gains))
    mask = None
    if valid is not None:
        if valid.shape != (nloc,) or valid.device != y_local.device:
            raise ValueError(f"B3 kernel: valid must be [{nloc}] on "
                             f"{y_local.device}")
        mask = valid.to(torch.float32).contiguous()
    y2, u2, g2 = (torch.empty_like(y_local) for _ in range(3))
    gsq = torch.empty(nloc, device=y_local.device, dtype=torch.float32)
    if nloc:
        KERNELS["B3"](y_local.data_ptr(), y_full.data_ptr(), jidx.data_ptr(),
                      jval.data_ptr(), nloc, jidx.shape[1], y_local.shape[1],
                      tail_att.data_ptr(), repz.data_ptr(),
                      None if mask is None else mask.data_ptr(),
                      update.data_ptr(), gains.data_ptr(), float(exag),
                      float(momentum), float(eta), float(min_gain),
                      y2.data_ptr(), u2.data_ptr(), g2.data_ptr(),
                      gsq.data_ptr())
    return y2, u2, g2, gsq


def attraction_loss(y_local, y_full, jidx, jval, exag, z, *,
                    row_chunk: int = 4096):
    """Per-row partial KL over a CSR head: [nloc] (sum it for the
    scalar).  ``z`` is the global Z — a 0-d tensor (read on the device by
    the kernel, no host sync) or a float."""
    if y_local.device.type == "cpu":
        return attraction_loss_plain(y_local, y_full, jidx, jval, exag, z,
                                     row_chunk=row_chunk)
    _check_cuda("B4", y_local, y_full, jidx, jval)
    z = torch.as_tensor(z, dtype=torch.float32,
                        device=y_local.device).reshape(1).contiguous()
    nloc = y_local.shape[0]
    loss = torch.empty(nloc, device=y_local.device, dtype=torch.float32)
    if nloc:
        KERNELS["B4"](y_local.data_ptr(), y_full.data_ptr(), jidx.data_ptr(),
                      jval.data_ptr(), nloc, jidx.shape[1], y_local.shape[1],
                      float(exag), z.data_ptr(), loss.data_ptr())
    return loss
