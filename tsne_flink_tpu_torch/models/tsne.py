"""The t-SNE optimizer (port of ``tsne_flink_tpu/models/tsne.py``).

Ported: the configuration and state, the init, the vdM update and
centering, and the single-device main path ``tsne_embed`` -> ``optimize``
over the fused CSR branch:

* every iteration — exact repulsion (kernel B2), the CSR tail forces by a
  deterministic sorted segment sum, the fused head step (kernel B3), and
  centering;
* every ``LOSS_EVERY``-th iteration — the KL pass (kernel B4 + the tail's
  share), written into a loss trace that stays on the device.

The loop is a Python loop with no per-iteration host sync: the phase
gates (momentum, exaggeration, the KL report) depend on the iteration
number alone, and Z reaches the kernels as a device tensor.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
queue item: the rows/edges/blocks layouts and the unfused step (A6, with
kernel B5), FFT repulsion (A8), BH repulsion (A12), the repulsion stride,
autopilot, health sentinel, telemetry and landmark schedule (A10), and
mesh sharding (A14).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tsne_flink_tpu_torch.ops.metrics import metric_fn
from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
from tsne_flink_tpu_torch.utils.device import resolve_device, timed_stage

LOSS_EVERY = 10  # TsneHelpers.scala:297


@dataclass(frozen=True)
class TsneConfig:
    """Hyper-parameters: the JAX package's fields and defaults."""

    n_components: int = 2
    perplexity: float = 30.0
    early_exaggeration: float = 4.0
    learning_rate: float = 1000.0
    iterations: int = 300
    initial_momentum: float = 0.5
    final_momentum: float = 0.8
    theta: float = 0.25
    metric: str = "sqeuclidean"
    min_gain: float = 0.01
    repulsion: str = "exact"  # exact (ported) | bh | fft
    exact_impl: str = "auto"  # the JAX package's kernel choice; the port
    # always runs kernel B2 on CUDA tensors and its plain version on CPU
    attraction: str = "auto"  # auto | rows | edges | csr (csr ported)
    row_chunk: int = 2048
    repulsion_stride: int = 1
    autopilot: bool = False
    bh_levels: int | None = None
    bh_frontier: int | None = None
    bh_gate: str = "vdm"
    fft_grid: int | None = None
    fft_interp: int = 3

    @property
    def momentum_switch(self) -> int:
        return min(self.iterations, 20)  # TsneHelpers.scala:403

    @property
    def exaggeration_end(self) -> int:
        return min(self.iterations, 101)  # TsneHelpers.scala:403-405

    @property
    def n_loss_slots(self) -> int:
        return self.iterations // LOSS_EVERY


class TsneState(NamedTuple):
    """(y, lastUpdate, gains), each [N, m]."""

    y: torch.Tensor
    update: torch.Tensor
    gains: torch.Tensor


def init_working_set(generator: torch.Generator | None, n: int,
                     n_components: int = 2, dtype=torch.float32,
                     device=None, y0=None) -> TsneState:
    """y ~ N(0, 1e-4²) from ``generator`` (or the given ``y0``), update = 0,
    gains = 1.  ``torch.Generator`` streams differ from ``jax.random``, so
    parity tests pass the JAX init in as ``y0``."""
    device = resolve_device(device)
    if y0 is not None:
        y0 = np.array(y0) if isinstance(y0, np.ndarray) else y0  # writable
        y = torch.as_tensor(y0, dtype=dtype, device=device).clone()
    else:
        y = 1e-4 * torch.randn((n, n_components), generator=generator,
                               dtype=dtype, device=device)
    return TsneState(y=y, update=torch.zeros_like(y),
                     gains=torch.ones_like(y))


def _segment_sum(data, lengths):
    """Sorted segment sum: segment i owns the next ``lengths[i]`` rows of
    ``data``.  Each segment is reduced by one thread in order — no atomic
    scatter, so the result is the same on every run."""
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0)


def _edge_forces(y_local, y_full, src, dst, val, exag, lengths=None):
    """Attraction forces of a flat edge list sorted by ``src`` (the CSR
    tail): Σ_e val·exag·q (y_src − y_dst) per source row."""
    if lengths is None:
        lengths = torch.bincount(src.long(), minlength=y_local.shape[0])
    f = metric_fn("sqeuclidean")
    yi = y_local[src.long()]
    yj = y_full[dst.long()]
    q = 1.0 / (1.0 + f(yi, yj))
    w = val * exag * q
    return _segment_sum(w[:, None] * (yi - yj), lengths)


def _edge_loss(y_local, y_full, src, dst, val, exag, z, lengths=None):
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


def _repulsion(y_local, y_full, cfg: TsneConfig, row_offset=0,
               valid_full=None):
    """(rep [nloc, m], Z) with Z the global partition sum (a 0-d tensor):
    kernel B2's per-row partials summed in one fixed order."""
    if cfg.repulsion != "exact":
        item = {"fft": "A8", "bh": "A12"}.get(cfg.repulsion)
        if item is None:
            raise ValueError(f"unknown repulsion backend '{cfg.repulsion}'")
        raise NotImplementedError(f"repulsion='{cfg.repulsion}' is not "
                                  f"ported yet (ROADMAP queue {item})")
    rep, zrow = cuda_exact_repulsion(y_local, y_full, row_offset=row_offset,
                                     col_valid=valid_full, row_z=True,
                                     row_chunk=cfg.row_chunk)
    return rep, torch.sum(zrow)


def _update_embedding(state: TsneState, grad, momentum, cfg: TsneConfig):
    """vdM adaptive gains + momentum (TsneHelpers.scala:357-366)."""
    same_sign = (grad > 0.0) == (state.update > 0.0)
    gains = torch.where(same_sign, state.gains * 0.8, state.gains + 0.2)
    gains = torch.clamp(gains, min=cfg.min_gain)
    update = momentum * state.update - cfg.learning_rate * gains * grad
    return TsneState(y=state.y + update, update=update, gains=gains)


def _global_mean(x, valid=None):
    """Mean over the point axis, ignoring padded rows."""
    if valid is None:
        return torch.sum(x, dim=0) / x.shape[0]
    w = valid.to(x.dtype)
    return torch.sum(x * w[:, None], dim=0) / torch.sum(w)


def _center(state: TsneState, valid=None) -> TsneState:
    """Subtract the mean each iteration (TsneHelpers.scala:320-329)."""
    return state._replace(y=state.y - _global_mean(state.y, valid))


def loss_slot(i: int, n_slots: int) -> int:
    """Trace slot of 0-based iteration ``i`` (read when it reports): slot
    t holds the KL at 1-based iteration 10·(t+1)."""
    return min((i + 1) // LOSS_EVERY - 1, n_slots - 1)


def optimize(state: TsneState, jidx, jval, cfg: TsneConfig, *,
             valid=None, start_iter: int = 0, num_iters: int | None = None,
             loss_carry=None, csr=None, edges=None, fused_step=None,
             axis_name=None, with_health: bool = False,
             with_telemetry: bool = False):
    """The 3-phase gradient descent over the fused CSR branch.

    Returns ``(state, losses)``: ``losses[t]`` is the KL at 1-based
    iteration 10·(t+1), a device tensor never read on the host here.
    ``start_iter``/``num_iters`` run a segment of the schedule (gates and
    slots key off the absolute iteration) and ``loss_carry`` threads the
    trace between segments.  ``csr`` is ``(hidx, hval, tsrc, tdst, tval)``
    from ``ops/attraction_cuda.build_csr``; ``jidx``/``jval`` are unused by
    this branch and kept for the JAX signature."""
    if axis_name is not None:
        raise NotImplementedError("mesh sharding is not ported yet "
                                  "(ROADMAP queue A14)")
    if csr is None or edges is not None or fused_step is False:
        raise NotImplementedError(
            "only the fused CSR step is ported; the rows/edges/blocks "
            "layouts and the unfused step (kernel B5) are ROADMAP queue A6")
    if (cfg.repulsion_stride != 1 or cfg.autopilot or with_health
            or with_telemetry):
        raise NotImplementedError(
            "repulsion_stride, autopilot, the health sentinel and telemetry "
            "are not ported yet (ROADMAP queue A10)")
    from tsne_flink_tpu_torch.ops.attraction_cuda import (attraction_loss,
                                                          fused_step_update)

    hidx, hval, tsrc, tdst, tval = csr
    n = state.y.shape[0]
    tail_len = torch.bincount(tsrc.long(), minlength=n)
    n_slots = max(cfg.n_loss_slots, 1)
    losses = (loss_carry.clone() if loss_carry is not None
              else torch.zeros(n_slots, dtype=state.y.dtype,
                               device=state.y.device))
    num = cfg.iterations if num_iters is None else num_iters
    st = state
    for i in range(start_iter, start_iter + num):
        momentum = (cfg.initial_momentum if i < cfg.momentum_switch
                    else cfg.final_momentum)
        exag = (cfg.early_exaggeration if i < cfg.exaggeration_end else 1.0)
        record = (i + 1) % LOSS_EVERY == 0
        rep, z = _repulsion(st.y, st.y, cfg, valid_full=valid)
        if record:
            loss_rows = (attraction_loss(st.y, st.y, hidx, hval, exag, z,
                                         row_chunk=cfg.row_chunk)
                         + _edge_loss(st.y, st.y, tsrc, tdst, tval, exag, z,
                                      tail_len))
            losses[loss_slot(i, n_slots)] = torch.sum(loss_rows)
        tail = _edge_forces(st.y, st.y, tsrc, tdst, tval, exag,
                            tail_len).to(st.y.dtype)
        y2, u2, g2, _gsq = fused_step_update(
            st.y, st.y, hidx, hval, exag, tail, rep / z, valid, st.update,
            st.gains, momentum, eta=cfg.learning_rate,
            min_gain=cfg.min_gain, row_chunk=cfg.row_chunk)
        st = _center(TsneState(y=y2, update=u2, gains=g2), valid)
    return st, losses


def _plan_layout(jidx, jval, cfg: TsneConfig):
    """``(edges, csr)`` for the planned attraction layout: the CSR head +
    tail of ``build_csr`` (the only layout ported)."""
    from tsne_flink_tpu_torch.ops.affinities import plan_attraction
    layout, param = plan_attraction(jidx, jval, cfg.attraction)
    if layout != "csr":
        raise NotImplementedError(
            f"attraction layout '{layout}' is not ported yet (ROADMAP queue "
            "A6); pass TsneConfig(attraction='csr')")
    from tsne_flink_tpu_torch.ops.attraction_cuda import build_csr
    head, tail = build_csr(jidx, jval, param)
    return None, head + tail


def tsne_embed(x, cfg: TsneConfig | None = None, *,
               neighbors: int | None = None, knn_method: str = "bruteforce",
               seed: int = 0, device=None, y0=None,
               stats: dict | None = None):
    """Single-device end to end: kNN -> β-calibrated affinities ->
    symmetrized P -> CSR layout -> init -> optimize.  Returns
    ``(embedding [N, m], loss trace)`` on ``device`` (default ``cuda``).

    ``seed`` seeds the ``torch.Generator`` of the init (``y0`` replaces
    the draw).  ``stats``, when given, receives the stage seconds
    (``knn``, ``affinities``, ``plan``, ``optimize``), each measured to the
    end of the device's work."""
    cfg = cfg or TsneConfig()
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    n = x.shape[0]
    k = neighbors if neighbors is not None else 3 * int(cfg.perplexity)
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    prep = prepare(x, neighbors=k, knn_method=knn_method, metric=cfg.metric,
                   perplexity=cfg.perplexity, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = init_working_set(gen, n, cfg.n_components, x.dtype, device, y0)
    t0 = time.perf_counter()
    _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    t_plan = timed_stage(device, t0)
    t0 = time.perf_counter()
    state, losses = optimize(state, prep.jidx, prep.jval, cfg, csr=csr)
    t_opt = timed_stage(device, t0)
    if stats is not None:
        stats.update(knn=prep.knn_seconds, affinities=prep.affinity_seconds,
                     plan=t_plan, optimize=t_opt)
    return state.y, losses
