"""The t-SNE optimizer (port of ``tsne_flink_tpu/models/tsne.py``).

Ported: the configuration and state, the init, the vdM update and
centering, and the single-device ``tsne_embed`` -> ``optimize`` over
every attraction layout:

* every iteration — the repulsion (exact, kernel B2; or FFT, with the
  grid geometry built once per run and the spectral Z used as the global
  Z), then either the fused
  CSR step (the CSR tail forces by a deterministic sorted segment sum,
  then the head step, kernel B3) or the unfused step: the attraction
  forces of the armed layout (kernel B5 over the [N, S] rows, the blocks
  layout's forward block or a CSR head; sorted segment sums over an edge
  list, the blocks layout's reverse block or a CSR tail), grad = att −
  rep/Z, the vdM update; then centering;
* every ``LOSS_EVERY``-th iteration — the KL pass (kernel B4 over the row
  part + the edge part's share), written into a loss trace that stays on
  the device.

The loop is a Python loop with no per-iteration host sync: the phase
gates (momentum, exaggeration, the KL report) depend on the iteration
number alone, and Z reaches the kernels as a device tensor.

``tsne_embed`` takes every kNN method of ``ops/knn`` (the hybrid
``project`` plan with its own ``torch.Generator``).

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
queue item: BH repulsion (A12), the repulsion stride,
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
    repulsion: str = "exact"  # exact | fft (ported) | bh
    exact_impl: str = "auto"  # the JAX package's kernel choice; the port
    # always runs kernel B2 on CUDA tensors and its plain version on CPU
    attraction: str = "auto"  # auto | rows | edges | csr
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


def _without_padding(edges):
    """An edge list without its padding entries (val = 0; they add exactly
    nothing).  The padding all lands in row n-1's segment, and a sorted
    segment sum walks each segment in one thread: the blocks layout's
    1.7M padding slots at N = 60,000 cost 110 ms an iteration on an H100.
    One host sync, once per run."""
    keep = edges[2] > 0
    return tuple(a[keep] for a in edges)


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


def _repulsion_scratch(cfg: TsneConfig, m: int, dtype, device):
    """Loop-invariant repulsion scratch, built ONCE per ``optimize`` run:
    the FFT backend's circulant lattice (``ops/repulsion_fft
    .fft_geometry``); None for the exact backend."""
    if cfg.repulsion == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import fft_geometry
        return fft_geometry(m, cfg.fft_grid, dtype, device)
    return None


def _repulsion(y_local, y_full, cfg: TsneConfig, row_offset=0,
               valid_full=None, rep_scratch=None):
    """(rep [nloc, m], Z) with Z the global partition sum (a 0-d tensor):
    kernel B2's per-row partials summed in one fixed order, or the FFT
    backend's spectral Z, global already."""
    if cfg.repulsion == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import fft_repulsion
        return fft_repulsion(y_local, y_full, grid=cfg.fft_grid,
                             interp=cfg.fft_interp, row_offset=row_offset,
                             col_valid=valid_full, geom=rep_scratch)
    if cfg.repulsion != "exact":
        if cfg.repulsion != "bh":
            raise ValueError(f"unknown repulsion backend '{cfg.repulsion}'")
        raise NotImplementedError("repulsion='bh' is not ported yet "
                                  "(ROADMAP queue A12)")
    rep, zrow = cuda_exact_repulsion(y_local, y_full, row_offset=row_offset,
                                     col_valid=valid_full, row_z=True,
                                     row_chunk=cfg.row_chunk)
    return rep, torch.sum(zrow)


def _attraction_forces(y_local, y_full, jidx, jval, cfg: TsneConfig, exag,
                       edges=None, edges_extra=False, csr=None,
                       edge_len=None):
    """F_attr_i = Σ_j P_ij q_ij (y_i − y_j) over the armed layout: the
    CSR head (kernel B5) + tail, the split-blocks pair (B5 over the
    forward block + the reverse edges), the flat edge list, or the padded
    [N, S] rows (B5).  ``edge_len`` is the per-row length of the edge
    part, computed once per run.  Cast to the state dtype."""
    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_forces
    if csr is not None:
        hidx, hval, tsrc, tdst, tval = csr
        att = (attraction_forces(y_local, y_full, hidx, hval, exag,
                                 row_chunk=cfg.row_chunk)
               + _edge_forces(y_local, y_full, tsrc, tdst, tval, exag,
                              edge_len))
    elif edges is not None and edges_extra:
        att = (attraction_forces(y_local, y_full, jidx, jval, exag,
                                 row_chunk=cfg.row_chunk)
               + _edge_forces(y_local, y_full, *edges, exag, edge_len))
    elif edges is not None:
        att = _edge_forces(y_local, y_full, *edges, exag, edge_len)
    else:
        att = attraction_forces(y_local, y_full, jidx, jval, exag,
                                row_chunk=cfg.row_chunk)
    return att.to(y_local.dtype)


def _attraction_loss(y_local, y_full, jidx, jval, cfg: TsneConfig, exag, z,
                     edges=None, edges_extra=False, csr=None, edge_len=None):
    """Per-row partial KL Σ p log(p/(q/Z)) [nloc] over the armed layout
    (kernel B4 over the row part), cast to the state dtype."""
    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_loss
    if csr is not None:
        hidx, hval, tsrc, tdst, tval = csr
        loss = (attraction_loss(y_local, y_full, hidx, hval, exag, z,
                                row_chunk=cfg.row_chunk)
                + _edge_loss(y_local, y_full, tsrc, tdst, tval, exag, z,
                             edge_len))
    elif edges is not None and edges_extra:
        loss = (attraction_loss(y_local, y_full, jidx, jval, exag, z,
                                row_chunk=cfg.row_chunk)
                + _edge_loss(y_local, y_full, *edges, exag, z, edge_len))
    elif edges is not None:
        loss = _edge_loss(y_local, y_full, *edges, exag, z, edge_len)
    else:
        loss = attraction_loss(y_local, y_full, jidx, jval, exag, z,
                               row_chunk=cfg.row_chunk)
    return loss.to(y_local.dtype)


def _gradient(y_local, jidx, jval, cfg: TsneConfig, exag, valid_full=None,
              edges=None, edges_extra=False, csr=None, want_loss=True,
              edge_len=None, rep_scratch=None):
    """``(grad, loss)``: grad_i = F_attr_i − F_rep_i / Z
    (TsneHelpers.scala:311-317), and the KL as a 0-d tensor when
    ``want_loss``, else None (the KL pass does not run)."""
    rep, z = _repulsion(y_local, y_local, cfg, valid_full=valid_full,
                        rep_scratch=rep_scratch)
    layout = dict(edges=edges, edges_extra=edges_extra, csr=csr,
                  edge_len=edge_len)
    att = _attraction_forces(y_local, y_local, jidx, jval, cfg, exag,
                             **layout)
    loss = (torch.sum(_attraction_loss(y_local, y_local, jidx, jval, cfg,
                                       exag, z, **layout))
            if want_loss else None)
    return att - rep / z, loss


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
             loss_carry=None, edges=None, edges_extra: bool = False,
             csr=None, fused_step=None, axis_name=None,
             with_health: bool = False, with_telemetry: bool = False):
    """The 3-phase gradient descent over the armed attraction layout.

    Returns ``(state, losses)``: ``losses[t]`` is the KL at 1-based
    iteration 10·(t+1), a device tensor never read on the host here.
    ``start_iter``/``num_iters`` run a segment of the schedule (gates and
    slots key off the absolute iteration) and ``loss_carry`` threads the
    trace between segments.

    The layout, as in the JAX function: ``csr`` = ``(hidx, hval, tsrc,
    tdst, tval)`` from ``ops/attraction_cuda.build_csr``; ``edges`` =
    ``(src, dst, val)`` sorted by src (``ops/affinities.assemble_edges``),
    or with ``edges_extra`` the blocks layout's reverse block beside the
    forward rows ``(jidx, jval)``; neither = the padded [N, S] rows
    ``(jidx, jval)``.  ``fused_step`` (None means on) runs the CSR layout
    through the fused step, kernel B3; ``False``, and every other layout,
    takes the unfused step."""
    if axis_name is not None:
        raise NotImplementedError("mesh sharding is not ported yet "
                                  "(ROADMAP queue A14)")
    if (cfg.repulsion_stride != 1 or cfg.autopilot or with_health
            or with_telemetry):
        raise NotImplementedError(
            "repulsion_stride, autopilot, the health sentinel and telemetry "
            "are not ported yet (ROADMAP queue A10)")
    from tsne_flink_tpu_torch.ops.attraction_cuda import fused_step_update

    fused = csr is not None and fused_step is not False
    n = state.y.shape[0]
    if csr is not None:
        csr = csr[:2] + _without_padding(csr[2:])
    elif edges is not None:
        edges = _without_padding(edges)
    # the edge part's per-row lengths, for its sorted segment sums
    esrc = csr[2] if csr is not None else None if edges is None else edges[0]
    edge_len = (None if esrc is None
                else torch.bincount(esrc.long(), minlength=n))
    layout = dict(edges=edges, edges_extra=edges_extra, csr=csr,
                  edge_len=edge_len)
    scratch = _repulsion_scratch(cfg, state.y.shape[1], state.y.dtype,
                                 state.y.device)
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
        if fused:
            rep, z = _repulsion(st.y, st.y, cfg, valid_full=valid,
                                rep_scratch=scratch)
            if record:
                losses[loss_slot(i, n_slots)] = torch.sum(_attraction_loss(
                    st.y, st.y, jidx, jval, cfg, exag, z, **layout))
            hidx, hval, tsrc, tdst, tval = csr
            tail = _edge_forces(st.y, st.y, tsrc, tdst, tval, exag,
                                edge_len).to(st.y.dtype)
            y2, u2, g2, _gsq = fused_step_update(
                st.y, st.y, hidx, hval, exag, tail, rep / z, valid,
                st.update, st.gains, momentum, eta=cfg.learning_rate,
                min_gain=cfg.min_gain, row_chunk=cfg.row_chunk)
            st = TsneState(y=y2, update=u2, gains=g2)
        else:
            grad, loss = _gradient(st.y, jidx, jval, cfg, exag,
                                   valid_full=valid, want_loss=record,
                                   rep_scratch=scratch, **layout)
            if record:
                losses[loss_slot(i, n_slots)] = loss
            if valid is not None:
                grad = grad * valid[:, None].to(grad.dtype)
            st = _update_embedding(st, grad, momentum, cfg)
        st = _center(st, valid)
    return st, losses


def _plan_layout(jidx, jval, cfg: TsneConfig):
    """``(edges, csr)`` for the planned attraction layout: the CSR head +
    tail of ``build_csr``, the flat edge list of ``assemble_edges``, or
    ``(None, None)`` for the padded rows."""
    from tsne_flink_tpu_torch.ops.affinities import (assemble_edges,
                                                     plan_attraction)
    layout, param = plan_attraction(jidx, jval, cfg.attraction)
    if layout == "csr":
        from tsne_flink_tpu_torch.ops.attraction_cuda import build_csr
        head, tail = build_csr(jidx, jval, param)
        return None, head + tail
    if layout == "edges":
        return assemble_edges(jidx, jval, param), None
    return None, None


def knn_generator(seed: int, device) -> torch.Generator:
    """The kNN stage's own ``torch.Generator``, separate from the init's:
    seeded from ``seed`` through a numpy ``SeedSequence`` spawn key, so the
    two streams never coincide."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(seed, spawn_key=(1,))
                        .generate_state(1, np.uint64)[0] >> 1))
    return gen


def tsne_embed(x, cfg: TsneConfig | None = None, *,
               neighbors: int | None = None, knn_method: str = "bruteforce",
               knn_iterations: int | None = None,
               knn_refine: int | None = None, knn_blocks: int = 8,
               seed: int = 0, sym_width: int | None = None,
               affinity_assembly: str | None = None, device=None, y0=None,
               stats: dict | None = None):
    """Single-device end to end: kNN -> β-calibrated affinities ->
    symmetrized P -> attraction layout -> init -> optimize.  Returns
    ``(embedding [N, m], loss trace)`` on ``device`` (default ``cuda``).

    ``affinity_assembly``: ``auto`` (None means auto) | ``sorted`` |
    ``split`` ([N, S] rows) | ``blocks`` (the forward rows + reverse edge
    list, never the [N, S] rows).  ``auto`` with an explicit ``sym_width``
    means ``sorted``.  Rows are then laid out by ``cfg.attraction``; the
    blocks layout is optimized as it is.

    ``knn_method``: bruteforce | partition | project | auto
    (``ops/knn.knn``); ``knn_iterations`` and ``knn_refine`` are the
    project plan's Z-order seed rounds and refine cycles (None = the auto
    policies), ``knn_blocks`` the partition schedule's block count.

    ``seed`` seeds the ``torch.Generator`` of the init (``y0`` replaces
    the draw) and, through :func:`knn_generator`, the kNN stage's own.
    ``stats``, when given, receives the stage seconds (``knn``,
    ``affinities``, ``plan``, ``optimize``), each measured to the end of
    the device's work, the kNN substage seconds (``knn_substages``), and
    the labels of the resolved ``assembly`` and attraction ``layout``
    (csr | edges | rows | blocks)."""
    cfg = cfg or TsneConfig()
    device = resolve_device(device)
    x = torch.as_tensor(x, device=device)
    n = x.shape[0]
    k = neighbors if neighbors is not None else 3 * int(cfg.perplexity)
    assembly = affinity_assembly or "auto"
    if assembly == "auto" and sym_width is not None:
        assembly = "sorted"  # a pinned width is a row-layout request
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    prep = prepare(x, neighbors=k, knn_method=knn_method, metric=cfg.metric,
                   knn_rounds=knn_iterations, knn_refine=knn_refine,
                   knn_blocks=knn_blocks,
                   generator=knn_generator(seed, device),
                   perplexity=cfg.perplexity, assembly=assembly,
                   sym_width=sym_width, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = init_working_set(gen, n, cfg.n_components, x.dtype, device, y0)
    t0 = time.perf_counter()
    if prep.extra_edges is not None:
        edges, csr, layout = prep.extra_edges, None, "blocks"
    else:
        edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
        layout = ("csr" if csr is not None
                  else "rows" if edges is None else "edges")
    t_plan = timed_stage(device, t0)
    t0 = time.perf_counter()
    state, losses = optimize(state, prep.jidx, prep.jval, cfg, edges=edges,
                             edges_extra=layout == "blocks", csr=csr)
    t_opt = timed_stage(device, t0)
    if stats is not None:
        stats.update(knn=prep.knn_seconds, affinities=prep.affinity_seconds,
                     plan=t_plan, optimize=t_opt, assembly=prep.label,
                     layout=layout, knn_substages=prep.knn_substages)
    return state.y, losses
