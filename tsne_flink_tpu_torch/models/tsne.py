"""The t-SNE optimizer (port of ``tsne_flink_tpu/models/tsne.py``).

Ported: the configuration and state, the init, the vdM update and
centering, and the single-device ``tsne_embed`` -> ``optimize`` over
every attraction layout:

* every iteration — the repulsion (exact, kernel B2; or FFT, with the
  grid geometry built once per run and the spectral Z used as the global
  Z), then either the fused CSR step (one launch of kernel B3: the head
  and tail forces, rep/Z and the vdM update, the rows with the longest
  tails visited first) or the unfused step: the attraction forces of
  the armed layout in one launch of kernel B5 over its row part (the
  [N, S] rows, the blocks layout's forward block or a CSR head) and its
  edge part (the flat edge list, the blocks layout's reverse block or a
  CSR tail), grad = att − rep/Z, the vdM update; then centering;
* every ``LOSS_EVERY``-th iteration — the KL pass (one launch of kernel
  B4 over both parts), written into a loss trace that stays on the
  device.

The loop is a Python loop with no per-iteration host sync: the phase
gates (momentum, exaggeration, the KL report) depend on the iteration
number alone, and Z reaches the kernels as a device tensor.

``tsne_embed`` takes every kNN method of ``ops/knn`` (the hybrid
``project`` plan with its own ``torch.Generator``).

The approximation policies and loop extras of the JAX ``optimize``:
Barnes-Hut repulsion (``ops/repulsion_bh``); the repulsion stride,
(rep, Z) refreshed every stride-th iteration and carried between; the
autopilot (``models/autopilot``: a stride driven by the grad-norm trend,
read on the host once a report boundary, and a coarse FFT grid during
early exaggeration); the divergence sentinel's finiteness flag and the
telemetry trace, both device tensors read once a segment
(``runtime/segments``); and the landmark schedule
(:func:`landmark_optimize`).

Under a point mesh (``parallel/mesh.ShardedOptimizer``) the same
``optimize`` is the per-shard program: ``axis_name`` is the shard's
collectives handle (``parallel/mesh.MeshAxis``), ``row_offset`` its
first global row and ``valid`` its rows' mask.  Each iteration gathers
y; Z, the KL, the telemetry sums and the grad norm are mesh-canonical
(:func:`_mesh_sum`: the gathered ``[N_padded]`` per-row vector reduced
in one fixed order), the centering mean sums the gathered masked rows,
and counts, minima and maxima combine exactly (:func:`_psum`,
:func:`_pmin`, :func:`_pmax`), so every mesh width that shares the
padding quantum gives the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
from tsne_flink_tpu_torch.utils.device import resolve_device, timed_stage

LOSS_EVERY = 10  # TsneHelpers.scala:297
#: columns of the telemetry trace (``optimize(with_telemetry=True)``):
#: one row a KL report slot
TELEMETRY_FIELDS = ("grad_norm", "gains_mean", "gains_max", "y_min",
                    "y_max")


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
    repulsion: str = "exact"  # exact | bh | fft
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

    def __post_init__(self):
        # every route builds its config before the kNN stage: the one
        # width refused (B2-B5 take every m >= 1)
        if self.n_components < 1:
            raise ValueError(f"n_components = {self.n_components}: an "
                             "embedding needs at least one dimension")

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


def _without_padding(edges):
    """An edge list without its padding entries (val = 0; they add exactly
    nothing).  The padding all lands in row n-1's segment, and a kernel
    walks each segment in one warp: the blocks layout's 1.7M padding slots
    at N = 60,000 would all fall to one row.  One host sync, once per
    run."""
    keep = edges[2] > 0
    return tuple(a[keep] for a in edges)


def _repulsion_scratch(cfg: TsneConfig, m: int, dtype, device):
    """Loop-invariant repulsion scratch, built ONCE per ``optimize`` run:
    the FFT backend's circulant lattice (``ops/repulsion_fft
    .fft_geometry``); None for the exact backend."""
    if cfg.repulsion == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import fft_geometry
        return fft_geometry(m, cfg.fft_grid, dtype, device)
    return None


def _pilot_scratch(cfg: TsneConfig, m: int, dtype, device):
    """The autopilot's FFT geometry ladder, built once per run: one
    ``fft_geometry`` per grid of ``models/autopilot.grid_ladder``; () off
    the FFT path."""
    from tsne_flink_tpu_torch.models.autopilot import grid_ladder
    from tsne_flink_tpu_torch.ops.repulsion_fft import fft_geometry
    return tuple(fft_geometry(m, g, dtype, device)
                 for g in grid_ladder(cfg, m))


def _psum(x, axis_name):
    """Sum of a per-shard value over the mesh (exact for the integer
    counts it is used for); ``x`` itself off a mesh."""
    return x if axis_name is None else axis_name.psum(x)


def _pmax(x, axis_name):
    return x if axis_name is None else axis_name.pmax(x)


def _pmin(x, axis_name):
    return x if axis_name is None else axis_name.pmin(x)


def _mesh_sum(per_row, axis_name):
    """Global sum of a per-row partial.  Under a mesh it is
    mesh-canonical: the ``[N_padded]`` per-row vector is gathered —
    the same content and shape on every mesh width that shares the
    padding quantum (``parallel/mesh.PAD_QUANTUM``) — and reduced in one
    fixed order, the reduction that mesh D == mesh 1 bit for bit rides
    on.  A mesh armed with ``mesh_reduce="psum"`` sums each shard's rows
    and combines the D scalars in shard order instead: less traffic, but
    the per-shard partials regroup with the width, so not bit-identical
    across widths (the JAX package guards it within the 0.05 KL
    guardrail).  Off a mesh, the plain sum."""
    if axis_name is None:
        return torch.sum(per_row)
    if axis_name.mesh_reduce == "psum":
        return axis_name.psum(torch.sum(per_row))
    return torch.sum(axis_name.all_gather(per_row))


def _repulsion(y_local, y_full, cfg: TsneConfig, row_offset=0,
               valid_full=None, rep_scratch=None, axis_name=None):
    """(rep [nloc, m], Z) with Z the global partition sum (a 0-d tensor):
    kernel B2's or Barnes-Hut's per-row partials summed in one fixed
    order (:func:`_mesh_sum`), or the FFT backend's spectral Z, global
    and replicated already (its grid is built from the gathered y).
    Barnes-Hut sizes its chunks by its own byte budget, not
    ``cfg.row_chunk``.  Under a mesh the per-row bits must not depend on
    the shard's row count: B2 takes the column-split count of the
    quantum-wide local size and Barnes-Hut restarts its chunks at every
    multiple of it (``axis_name.split_rows``)."""
    if cfg.repulsion == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import fft_repulsion
        return fft_repulsion(y_local, y_full, grid=cfg.fft_grid,
                             interp=cfg.fft_interp, row_offset=row_offset,
                             col_valid=valid_full, geom=rep_scratch)
    split_rows = None if axis_name is None else axis_name.split_rows
    if cfg.repulsion == "bh":
        from tsne_flink_tpu_torch.ops.repulsion_bh import bh_repulsion
        rep, sq = bh_repulsion(y_local, y_full, theta=cfg.theta,
                               levels=cfg.bh_levels,
                               frontier=cfg.bh_frontier, gate=cfg.bh_gate,
                               row_offset=row_offset, col_valid=valid_full,
                               row_z=axis_name is not None,
                               row_block=split_rows)
        return rep, (sq if axis_name is None else _mesh_sum(sq, axis_name))
    if cfg.repulsion != "exact":
        raise ValueError(f"unknown repulsion backend '{cfg.repulsion}'")
    rep, zrow = cuda_exact_repulsion(y_local, y_full, row_offset=row_offset,
                                     col_valid=valid_full, row_z=True,
                                     row_chunk=cfg.row_chunk,
                                     split_rows=split_rows)
    return rep, _mesh_sum(zrow, axis_name)


def _attraction_forces(y_local, y_full, fidx, fval, cfg: TsneConfig, exag,
                       ragged=None):
    """F_attr_i = Σ_j P_ij q_ij (y_i − y_j) over the armed layout, one
    launch of kernel B5: its row block ``(fidx, fval)`` — the CSR head,
    the blocks layout's forward block, the padded [N, S] rows, or None —
    and its ``ragged`` part (``ops/attraction_cuda.Ragged``) — the CSR
    tail, the blocks layout's reverse edges, the flat edge list, or None.
    Cast to the state dtype."""
    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_forces
    return attraction_forces(y_local, y_full, fidx, fval, exag,
                             ragged=ragged,
                             row_chunk=cfg.row_chunk).to(y_local.dtype)


def _attraction_loss(y_local, y_full, fidx, fval, cfg: TsneConfig, exag, z,
                     ragged=None):
    """Per-row partial KL Σ p log(p/(q/Z)) [nloc] over the same parts, one
    launch of kernel B4, cast to the state dtype."""
    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_loss
    return attraction_loss(y_local, y_full, fidx, fval, exag, z,
                           ragged=ragged,
                           row_chunk=cfg.row_chunk).to(y_local.dtype)


def _layout_parts(jidx, jval, n: int, edges, edges_extra: bool, csr):
    """The armed layout as B4/B5 take it, built once per run: ``(fidx,
    fval, ragged)`` — the row block (None for the flat edge list) and the
    edge part without its padding (None for the padded rows)."""
    from tsne_flink_tpu_torch.ops.attraction_cuda import ragged_edges
    if csr is not None:
        return csr[0], csr[1], ragged_edges(*_without_padding(csr[2:]), n)
    if edges is None:
        return jidx, jval, None
    ragged = ragged_edges(*_without_padding(edges), n)
    return (jidx, jval, ragged) if edges_extra else (None, None, ragged)


def _update_embedding(state: TsneState, grad, momentum, cfg: TsneConfig):
    """vdM adaptive gains + momentum (TsneHelpers.scala:357-366)."""
    same_sign = (grad > 0.0) == (state.update > 0.0)
    gains = torch.where(same_sign, state.gains * 0.8, state.gains + 0.2)
    gains = torch.clamp(gains, min=cfg.min_gain)
    update = momentum * state.update - cfg.learning_rate * gains * grad
    return TsneState(y=state.y + update, update=update, gains=gains)


def _mesh_count(x, valid, axis_name):
    """The global count of valid rows, as ``x``'s dtype: a sum of exact
    integers, so any reduction order gives the same bits."""
    if valid is None:
        return _psum(torch.tensor(float(x.shape[0]), dtype=x.dtype,
                                  device=x.device), axis_name)
    return _psum(torch.sum(valid.to(x.dtype)), axis_name)


def _global_mean(x, valid=None, axis_name=None, count=None):
    """Mean over the (global) point axis, ignoring padded rows.  Under a
    mesh the total is mesh-canonical: the masked ``[N_padded, m]`` rows
    are gathered and the same array is reduced on every width; ``count``
    is :func:`_mesh_count` (computed here when not given)."""
    if axis_name is None:
        if valid is None:
            return torch.sum(x, dim=0) / x.shape[0]
        w = valid.to(x.dtype)
        return torch.sum(x * w[:, None], dim=0) / torch.sum(w)
    xm = x if valid is None else x * valid.to(x.dtype)[:, None]
    total = torch.sum(axis_name.all_gather(xm), dim=0)
    if count is None:
        count = _mesh_count(x, valid, axis_name)
    return total / count


def _center(state: TsneState, valid=None, axis_name=None,
            count=None) -> TsneState:
    """Subtract the (global) mean each iteration
    (TsneHelpers.scala:320-329)."""
    return state._replace(
        y=state.y - _global_mean(state.y, valid, axis_name, count))


def center_input(x: torch.Tensor, axis_name=None, valid=None):
    """Subtract the global mean from an input point set (the reference's
    ``centerInput``, TsneHelpers.scala:331-339)."""
    return x - _global_mean(x, valid, axis_name)


def loss_slot(i: int, n_slots: int) -> int:
    """Trace slot of 0-based iteration ``i`` (read when it reports): slot
    t holds the KL at 1-based iteration 10·(t+1)."""
    return min((i + 1) // LOSS_EVERY - 1, n_slots - 1)


def _telemetry_row(st: TsneState, grad, valid=None, gsq=None,
                   axis_name=None):
    """One :data:`TELEMETRY_FIELDS` row from the post-update state: the
    global grad L2 norm, the gains' mean and max, the embedding's min and
    max, padded rows masked out.  ``grad`` is masked already; the fused
    step passes its per-row ‖grad‖² as ``gsq`` instead (``grad`` None).
    Under a mesh the floating sums are mesh-canonical (:func:`_mesh_sum`)
    and the count, minima and maxima combine exactly, so the row is the
    same on every shard and every mesh width."""
    dt = st.y.dtype
    if valid is None:
        gcnt = _psum(torch.tensor(float(st.gains.numel()), dtype=dt,
                                  device=st.y.device), axis_name)
        gmax = _pmax(torch.max(st.gains), axis_name)
        ymin = _pmin(torch.min(st.y), axis_name)
        ymax = _pmax(torch.max(st.y), axis_name)
        gains_m = st.gains
    else:
        vm = valid[:, None]
        w = valid.to(dt)
        gcnt = _psum(torch.sum(w), axis_name) * st.gains.shape[1]
        gmax = _pmax(torch.max(torch.where(vm, st.gains, -torch.inf)),
                     axis_name)
        ymin = _pmin(torch.min(torch.where(vm, st.y, torch.inf)), axis_name)
        ymax = _pmax(torch.max(torch.where(vm, st.y, -torch.inf)),
                     axis_name)
        gains_m = st.gains * w[:, None]
    if axis_name is None:
        gn2 = torch.sum(grad * grad) if gsq is None else torch.sum(gsq)
        gsum = torch.sum(gains_m)
    else:
        gn2 = _mesh_sum(torch.sum(grad * grad, dim=1) if gsq is None
                        else gsq, axis_name)
        gsum = _mesh_sum(torch.sum(gains_m, dim=1), axis_name)
    return torch.stack([torch.sqrt(gn2), gsum / gcnt, gmax, ymin,
                        ymax]).to(dt)


def optimize(state: TsneState, jidx, jval, cfg: TsneConfig, *,
             valid=None, start_iter: int = 0, num_iters: int | None = None,
             loss_carry=None, edges=None, edges_extra: bool = False,
             csr=None, fused_step=None, axis_name=None, row_offset: int = 0,
             with_health: bool = False, with_telemetry: bool = False,
             telemetry_carry=None, pilot_carry=None):
    """The 3-phase gradient descent over the armed attraction layout.

    Returns ``(state, losses[, telemetry][, (pvec, trace)][, ok])``, the
    JAX function's order: ``losses[t]`` is the KL at 1-based iteration
    10·(t+1), a device tensor never read on the host here.
    ``start_iter``/``num_iters`` run a segment of the schedule (gates and
    slots key off the absolute iteration) and ``loss_carry`` threads the
    trace between segments.

    The layout, as in the JAX function: ``csr`` = ``(hidx, hval, tsrc,
    tdst, tval)`` from ``ops/attraction_cuda.build_csr``; ``edges`` =
    ``(src, dst, val)`` sorted by src (``ops/affinities.assemble_edges``),
    or with ``edges_extra`` the blocks layout's reverse block beside the
    forward rows ``(jidx, jval)``; neither = the padded [N, S] rows
    ``(jidx, jval)``.  ``fused_step`` (None means on) runs the CSR layout
    through the fused step, one launch of kernel B3 over head and tail;
    ``False``, and every other layout, takes the unfused step.

    The extras, each off by default (then the loop is the plain one, bit
    for bit):

    * ``cfg.repulsion_stride`` > 1 refreshes (rep, Z) at the segment
      start and at every stride-th absolute iteration and carries them
      between;
    * ``cfg.autopilot`` drives that stride from the controller
      (``models/autopilot.pilot_update``), its level read on the host
      once a report boundary, and on the FFT path selects the coarse grid
      during early exaggeration (refreshing at the boundary);
      ``pilot_carry`` resumes its ``(pvec, trace)`` pair, which is
      returned; the autopilot together with a stride raises
      ``ValueError``;
    * ``with_telemetry`` writes a :func:`_telemetry_row` into a
      ``[n_slots, 5]`` trace at every report iteration
      (``telemetry_carry`` threads it);
    * ``with_health`` folds the finiteness of y, the gains and the KL
      (then computed every iteration) into a 0-d bool tensor.

    Under a mesh (``axis_name``: a ``parallel/mesh.MeshAxis``) this is one
    shard's program: ``state``, ``jidx``/``jval``, the layout and
    ``valid`` hold the shard's rows (global column ids; a CSR tail or
    edge list with local sources), ``row_offset`` is its first global
    row, and every returned value but the state is replicated.  The
    shards meet at each iteration's collectives; with ``with_health`` the
    flag is combined over the shards once, after the loop."""
    mesh = axis_name
    stride = max(1, int(cfg.repulsion_stride))
    ap = bool(cfg.autopilot)
    if ap and stride > 1:
        raise ValueError("autopilot supersedes repulsion_stride — arm one "
                         "approximation policy, not both")
    from tsne_flink_tpu_torch.ops.attraction_cuda import (fused_step_update,
                                                          visit_order)

    y0 = state.y
    dt, dev, m = y0.dtype, y0.device, y0.shape[1]
    fused = csr is not None and fused_step is not False
    fidx, fval, ragged = _layout_parts(jidx, jval, y0.shape[0], edges,
                                       edges_extra, csr)
    # loop-invariant: the global validity mask and row count, gathered once
    valid_full = (valid if mesh is None or valid is None
                  else mesh.all_gather(valid))
    count = None if mesh is None else _mesh_count(y0, valid, mesh)
    # the hubs first: B3's longest warps start with the launch (no bit moves)
    order = visit_order(ragged) if fused else None
    geoms = _pilot_scratch(cfg, m, dt, dev) if ap else ()
    scratch = None if geoms else _repulsion_scratch(cfg, m, dt, dev)
    n_slots = max(cfg.n_loss_slots, 1)
    losses = (loss_carry.clone() if loss_carry is not None
              else torch.zeros(n_slots, dtype=dt, device=dev))
    tel = None
    if with_telemetry:
        tel = (torch.as_tensor(telemetry_carry, dtype=dt, device=dev).clone()
               if telemetry_carry is not None
               else torch.zeros((n_slots, len(TELEMETRY_FIELDS)), dtype=dt,
                                device=dev))
    ok = torch.ones((), dtype=torch.bool, device=dev) if with_health else None
    if ap:
        from tsne_flink_tpu_torch.models import autopilot as pilot
        if pilot_carry is not None:
            pvec = torch.as_tensor(pilot_carry[0], dtype=dt, device=dev)
            ptr = torch.as_tensor(pilot_carry[1], dtype=dt, device=dev)
            # graftlint: disable=host-sync -- the resumed controller's stride
            # level, read once before the loop (the level a resume starts at)
            level = pilot.read_level(pvec)
        else:
            pvec, ptr = (pilot.pilot_init(cfg, dt, dev),
                         pilot.trace_init(cfg, dt, dev))
            level = 0
    carried = ap or stride > 1
    rep_c = z_c = None
    num = cfg.iterations if num_iters is None else num_iters
    start, end = start_iter, start_iter + num
    st = state
    for i in range(start, end):
        momentum = (cfg.initial_momentum if i < cfg.momentum_switch
                    else cfg.final_momentum)
        exag = (cfg.early_exaggeration if i < cfg.exaggeration_end else 1.0)
        record = (i + 1) % LOSS_EVERY == 0
        # the sentinel reads the KL's finiteness every iteration
        want_loss = with_health or record
        refresh = True
        geom = scratch
        if carried:
            if ap:
                refresh = (i == start or i % pilot.stride_of(level) == 0
                           or (bool(geoms) and i == cfg.exaggeration_end))
                if geoms:
                    geom = geoms[pilot.grid_phase(i, cfg)]
            else:
                refresh = i == start or i % stride == 0
        y_full = st.y if mesh is None else mesh.all_gather(st.y)
        if refresh:
            rep_c, z_c = _repulsion(st.y, y_full, cfg, row_offset,
                                    valid_full, geom, mesh)
        grad = gsq = loss = None
        if fused:
            if want_loss:
                loss = _mesh_sum(_attraction_loss(st.y, y_full, fidx, fval,
                                                  cfg, exag, z_c, ragged),
                                 mesh)
            y2, u2, g2, gsq = fused_step_update(
                st.y, y_full, fidx, fval, exag, rep_c, z_c, valid, st.update,
                st.gains, momentum, eta=cfg.learning_rate,
                min_gain=cfg.min_gain, ragged=ragged, order=order,
                row_chunk=cfg.row_chunk)
            st = TsneState(y=y2, update=u2, gains=g2)
        else:
            att = _attraction_forces(st.y, y_full, fidx, fval, cfg, exag,
                                     ragged)
            if want_loss:
                loss = _mesh_sum(_attraction_loss(st.y, y_full, fidx, fval,
                                                  cfg, exag, z_c, ragged),
                                 mesh)
            grad = att - rep_c / z_c
            if valid is not None:
                grad = grad * valid[:, None].to(grad.dtype)
            st = _update_embedding(st, grad, momentum, cfg)
        st = _center(st, valid, mesh, count)
        slot = loss_slot(i, n_slots)
        row = None
        if record:
            losses[slot] = loss
            if with_telemetry:
                row = _telemetry_row(st, grad, valid, gsq, mesh)
                tel[slot] = row
        if with_health:
            ok = (ok & torch.all(torch.isfinite(st.y))
                  & torch.all(torch.isfinite(st.gains))
                  & torch.isfinite(loss))
        if ap:
            gn = None
            if record:
                if row is not None:
                    gn = row[0]
                else:
                    if gsq is None:
                        gsq = torch.sum(grad * grad, dim=1)
                    gn = torch.sqrt(_mesh_sum(gsq, mesh))
            pvec, ptr = pilot.pilot_update(i, gn, pvec, ptr, refresh, slot,
                                           record, cfg)
            if record and i + 1 < end:
                # graftlint: disable=host-sync -- the step's one host read: the
                # autopilot's stride level at a report boundary (every 10th
                # iteration), which picks the next refreshes on the host
                # the level moves only here: one host read a boundary
                # (under a mesh, one a shard of the replicated value)
                level = pilot.read_level(pvec)
    res = [st, losses]
    if with_telemetry:
        res.append(tel)
    if ap:
        res.append((pvec, ptr))
    if with_health:
        if mesh is not None:
            # one collective after the loop makes the flag global
            ok = _psum((~ok).to(torch.int32), mesh) == 0
        res.append(ok)
    return tuple(res)


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


def landmark_optimize(state: TsneState, jidx, jval, cfg: TsneConfig, *,
                      seed: int = 0, fraction: float = 0.25, layout=None,
                      pilots: dict | None = None):
    """The landmark coarse-to-fine schedule, single-device, over one
    absolute iteration axis (the JAX function's three phases):

    1. landmark descent ``[0, tail_start)`` — the seeded subsample
       (``models/autopilot.landmark_points``, ``fraction`` of the rows)
       under its own joint P (``ops/affinities.subsample_affinities``)
       and its own attraction plan, at the landmark FFT grid;
    2. placement — every row at the affinity-weighted mean of its
       landmark neighbours (``serve/transform.interpolation_init`` over
       ``landmark_placement_rows``), the landmarks at their optimized
       positions;
    3. joint polish ``[tail_start, iterations)`` — the full-N optimize as
       a segment, fresh update and gains, the landmark phase's KL in the
       early loss slots.

    ``layout`` is the full P's planned ``(edges, csr)`` (None: planned
    here); ``pilots``, when given, receives the autopilot pair of each
    phase (``landmark``, ``polish``).  Returns ``(y, losses, info)`` —
    ``info`` the policy block's landmark dict — or None when the
    schedule degenerates (too few iterations or points)."""
    from dataclasses import replace

    from tsne_flink_tpu_torch.models.autopilot import (landmark_fraction,
                                                       landmark_grid,
                                                       landmark_points,
                                                       landmark_schedule)
    from tsne_flink_tpu_torch.ops.affinities import (landmark_placement_rows,
                                                     subsample_affinities)
    from tsne_flink_tpu_torch.serve.transform import interpolation_init

    n = state.y.shape[0]
    land_iters, polish = landmark_schedule(cfg)
    if land_iters < LOSS_EVERY or polish <= 0 or n < 16:
        return None
    lm = landmark_points(n, seed, fraction)
    n_land = int(lm.shape[0])
    if n_land < 8 or n_land >= n:
        return None

    sub_idx, sub_val = subsample_affinities(jidx, jval, lm)
    cfg_land = replace(cfg, iterations=land_iters,
                       fft_grid=landmark_grid(cfg, state.y.shape[1]))
    edges_l, csr_l = _plan_layout(sub_idx, sub_val, cfg_land)
    lm_t = torch.as_tensor(lm, device=state.y.device)
    st_land = TsneState(y=state.y[lm_t], update=state.update[lm_t],
                        gains=state.gains[lm_t])
    out1 = optimize(st_land, sub_idx, sub_val, cfg_land, edges=edges_l,
                    csr=csr_l)
    y_land = out1[0].y

    ridx, rval = landmark_placement_rows(jidx, jval, lm)
    y_full = interpolation_init(rval, ridx, y_land)
    y_full[lm_t] = y_land

    st3 = TsneState(y=y_full, update=torch.zeros_like(y_full),
                    gains=torch.ones_like(y_full))
    edges_f, csr_f = (layout if layout is not None
                      else _plan_layout(jidx, jval, cfg))
    n_slots = max(cfg.n_loss_slots, 1)
    loss_carry = torch.zeros(n_slots, dtype=state.y.dtype,
                             device=state.y.device)
    n1 = min(land_iters // LOSS_EVERY, n_slots)
    if n1:
        loss_carry[:n1] = out1[1][:n1]
    out3 = optimize(st3, jidx, jval, cfg, edges=edges_f, csr=csr_f,
                    start_iter=land_iters, num_iters=polish,
                    loss_carry=loss_carry)
    if pilots is not None and cfg.autopilot:
        pilots.update(landmark=out1[2], polish=out3[2])
    info = {"landmark": True,
            "landmark_fraction": float(landmark_fraction(fraction)),
            "n_landmark": n_land, "landmark_iters": land_iters,
            "polish_iters": polish,
            "landmark_grid": cfg_land.fft_grid}
    return out3[0].y, out3[1], info


def knn_generator(seed: int, device) -> torch.Generator:
    """The kNN stage's own ``torch.Generator``, separate from the init's:
    seeded from ``seed`` through a numpy ``SeedSequence`` spawn key, so the
    two streams never coincide."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence(seed, spawn_key=(1,))
                        .generate_state(1, np.uint64)[0] >> 1))
    return gen


class _Prepared(NamedTuple):
    prep: object        # utils/artifacts.Prepared
    state: TsneState    # the init
    layout: object      # () -> (edges, csr, label): the layout's plan


def _prepare_run(x, cfg: TsneConfig, *, neighbors, knn_method,
                 knn_iterations, knn_refine, knn_blocks, seed, sym_width,
                 affinity_assembly, device, y0=None, artifact_cache=None,
                 knn_autotune=False, supervise=None,
                 on_stage=None, matmul_dtype=None) -> _Prepared:
    """The stages before optimize of :func:`tsne_embed` and of
    ``runtime/supervisor.supervised_embed``: prepare (kNN, affinities),
    the init from ``seed`` (or ``y0``), and the attraction layout's plan,
    deferred — ``layout()`` plans it and returns ``(edges, csr, label)``
    with label csr | edges | rows | blocks.

    ``supervise(fn, on_stage=...)`` (the run supervisor's
    ``run_prepare``) runs prepare as ``fn(on_stage=..., **overrides)`` and
    relaunches it with the OOM ladder's overrides; without it prepare runs
    once.  ``on_stage`` is prepare's progress hook."""
    x = torch.as_tensor(x, device=device)
    n = x.shape[0]
    k = neighbors if neighbors is not None else 3 * int(cfg.perplexity)
    assembly = affinity_assembly or "auto"
    if assembly == "auto" and sym_width is not None:
        assembly = "sorted"  # a pinned width is a row-layout request
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    def run_prepare(on_stage=None, assembly=assembly, knn_tiles=None,
                    on_graph=None):
        return prepare(x, neighbors=k, knn_method=knn_method,
                       metric=cfg.metric, knn_rounds=knn_iterations,
                       knn_refine=knn_refine, knn_blocks=knn_blocks,
                       seed=seed, perplexity=cfg.perplexity,
                       assembly=assembly, sym_width=sym_width, device=device,
                       cache=artifact_cache, knn_tiles=knn_tiles,
                       knn_autotune=knn_autotune, on_stage=on_stage,
                       on_graph=on_graph, matmul_dtype=matmul_dtype)

    prep = (run_prepare(on_stage=on_stage) if supervise is None
            else supervise(run_prepare, on_stage=on_stage))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = init_working_set(gen, n, cfg.n_components, x.dtype, device, y0)

    def layout():
        if prep.extra_edges is not None:
            return prep.extra_edges, None, "blocks"
        edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
        return edges, csr, ("csr" if csr is not None
                            else "rows" if edges is None else "edges")
    return _Prepared(prep, state, layout)


def tsne_embed(x, cfg: TsneConfig | None = None, *,
               neighbors: int | None = None, knn_method: str = "bruteforce",
               knn_iterations: int | None = None,
               knn_refine: int | None = None, knn_blocks: int = 8,
               seed: int = 0, sym_width: int | None = None,
               affinity_assembly: str | None = None, device=None, y0=None,
               stats: dict | None = None, artifact_cache=None,
               knn_autotune: bool = False, landmark: str = "auto",
               landmark_fraction: float = 0.25, matmul_dtype=None):
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

    ``matmul_dtype`` (None, or ``torch.bfloat16``: mixed precision, the
    JAX package's ``set_matmul_dtype``) is the operand dtype of the kNN
    stage's distance and projection products (``ops/knn``); ``x``, the
    affinities and the optimizer keep their own dtype.

    ``seed`` seeds the ``torch.Generator`` of the init (``y0`` replaces
    the draw) and, through :func:`knn_generator`, the kNN stage's own.
    ``artifact_cache`` (a ``utils/artifacts.ArtifactCache``) and
    ``knn_autotune`` go to ``prepare``: a warm cache skips the kNN and
    affinity stages with the same bits.
    ``landmark`` (``auto`` | ``on`` | ``off``) and ``landmark_fraction``
    steer the landmark schedule (:func:`landmark_optimize`; the JAX
    package reads them from ``TSNE_LANDMARK`` and
    ``TSNE_LANDMARK_FRACTION``): ``auto`` runs it under the autopilot
    from 20,000 rows, never on the blocks layout.

    ``stats``, when given, receives the stage seconds (``knn``,
    ``affinities``, ``plan``, ``optimize``), each measured to the end of
    the device's work, the kNN substage seconds (``knn_substages``), the
    labels of the resolved ``assembly`` and attraction ``layout`` (csr |
    edges | rows | blocks), and, under the autopilot or the landmark
    schedule, the run's ``policy`` block (``models/autopilot
    .policy_report``) and its autopilot pairs (``pilots``: ``run``, or
    ``landmark`` and ``polish``)."""
    cfg = cfg or TsneConfig()
    device = resolve_device(device)
    run = _prepare_run(x, cfg, neighbors=neighbors, knn_method=knn_method,
                       knn_iterations=knn_iterations, knn_refine=knn_refine,
                       knn_blocks=knn_blocks, seed=seed, sym_width=sym_width,
                       affinity_assembly=affinity_assembly, device=device,
                       y0=y0, artifact_cache=artifact_cache,
                       knn_autotune=knn_autotune, matmul_dtype=matmul_dtype)
    prep, state, plan_layout = run
    with obtrace.span("embed.plan", cat="optimize") as sp:
        edges, csr, layout = plan_layout()
        t_plan = timed_stage(device, sp)
    n = state.y.shape[0]
    sp_opt = obtrace.begin("embed.optimize", cat="optimize")
    from tsne_flink_tpu_torch.models.autopilot import (pick_landmark,
                                                       policy_report)
    got, pilots = None, {}
    # the blocks layout has no row restriction: no landmark schedule
    if layout != "blocks" and pick_landmark(cfg, n, landmark):
        got = landmark_optimize(state, prep.jidx, prep.jval, cfg, seed=seed,
                                fraction=landmark_fraction,
                                layout=(edges, csr), pilots=pilots)
    if got is not None:
        y, losses, info = got
    else:
        out = optimize(state, prep.jidx, prep.jval, cfg, edges=edges,
                       edges_extra=layout == "blocks", csr=csr)
        y, losses, info = out[0].y, out[1], None
        if cfg.autopilot:
            pilots["run"] = out[2]
    t_opt = timed_stage(device, sp_opt)
    sp_opt.end()
    if stats is not None:
        stats.update(knn=prep.knn_seconds, affinities=prep.affinity_seconds,
                     plan=t_plan, optimize=t_opt, assembly=prep.label,
                     layout=layout, knn_substages=prep.knn_substages)
        if cfg.autopilot or info is not None:
            stats.update(pilots=pilots,
                         policy=policy_report(cfg, pilots.get("run"),
                                              landmark=info))
    return y, losses
