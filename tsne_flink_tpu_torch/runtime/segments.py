"""The segment runner: ``optimize`` in segments, with the divergence
sentinel's rollback, shared by the command line, the estimator and the
sharded optimizer.

The counterpart of the JAX package's
``parallel/mesh.ShardedOptimizer.__call__`` loop.  A segment runs
``models/tsne.optimize`` on one device, or, given a ``runner`` (a
``parallel/mesh.ShardedOptimizer`` whose rows are placed), its
``segment`` over every shard of the mesh; the rollback, the fault site
and the span below work once a run, not once a shard.  It runs iterations
[start_iter, cfg.iterations) in segments of ``every``, threading the
loss trace, the telemetry trace and the autopilot pair across them, and
calls ``on_boundary`` after each segment but the last (the checkpoint
hook).  Every gate of the schedule keys off the absolute iteration, so
the segments give one run's bits, save that each segment starts with a
repulsion refresh under a stride or the autopilot, as in the JAX package.

With ``health_check`` each segment also returns the sentinel's flag,
read once at its boundary; a non-finite segment is rolled back and
retried by ``runtime/health``'s policy: the segment-start state, eta
halved for the rest of the run, the momentum buffer zeroed, the
autopilot collapsed, a :func:`~tsne_flink_tpu_torch.runtime.health
.rollback_event` appended to ``events`` (and a ``sentinel.rollback``
trace instant); past ``health_retries`` rollbacks in a run it raises
``DivergenceError``.

The ``optimize`` fault site (``runtime/faults.py``) fires here, as in
the JAX loop: at each segment's start (``oom``; ``nan`` poisons a copy
of the segment's input y on the device, so the rollback is exercised end
to end with no host sync) and after each boundary's checkpoint hook
(``kill``).  Each segment runs under an ``optimize.segment`` span, which
ends after the sentinel's read when it is armed and measures host time
otherwise: it adds no sync.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from tsne_flink_tpu_torch.models import tsne
from tsne_flink_tpu_torch.obs import metrics as obmetrics
from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.runtime import faults, health


class SegmentsResult(NamedTuple):
    state: tsne.TsneState
    losses: torch.Tensor
    telemetry: torch.Tensor | None  # [n_slots, 5] or None
    pilot: tuple | None             # (pvec, trace) or None
    cfg: tsne.TsneConfig            # the config the run ended with


def _fit_rows(a: torch.Tensor, n_slots: int) -> torch.Tensor:
    """A resumed trace padded with zero rows or cut to ``n_slots``."""
    if a.shape[0] < n_slots:
        pad = a.new_zeros((n_slots - a.shape[0],) + tuple(a.shape[1:]))
        return torch.cat([a, pad])
    return a[:n_slots]


def run_segments(state: tsne.TsneState, jidx, jval, cfg: tsne.TsneConfig,
                 *, start_iter: int = 0, every: int = 0, loss_carry=None,
                 edges=None, edges_extra: bool = False, csr=None,
                 health_check: bool = False, health_retries: int = 3,
                 events: list | None = None, telemetry: bool = False,
                 telemetry_carry=None, pilot_carry=None,
                 on_boundary=None, runner=None) -> SegmentsResult:
    """Run [start_iter, cfg.iterations) in segments of ``every`` (0: one
    segment).  ``on_boundary(state, next_iter, losses, pilot)`` fires
    after every segment but the last.  Carries (``loss_carry``,
    ``telemetry_carry``, ``pilot_carry``) may be numpy arrays or tensors;
    a trace of another length is padded or cut to this schedule's.
    ``runner`` (a sharded optimizer) runs each segment over its mesh in
    place of ``optimize`` on ``jidx``/``jval`` and the layout, which it
    then ignores."""
    dt, dev = state.y.dtype, state.y.device
    n_slots = max(cfg.n_loss_slots, 1)

    def tensor(a):
        return _fit_rows(torch.as_tensor(a, dtype=dt, device=dev), n_slots)

    losses = (tensor(loss_carry) if loss_carry is not None
              else torch.zeros(n_slots, dtype=dt, device=dev))
    tel = None
    if telemetry:
        tel = (tensor(telemetry_carry) if telemetry_carry is not None
               else torch.zeros((n_slots, len(tsne.TELEMETRY_FIELDS)),
                                dtype=dt, device=dev))
    pilot = None
    if cfg.autopilot and pilot_carry is not None:
        pilot = (torch.as_tensor(pilot_carry[0], dtype=dt, device=dev),
                 tensor(pilot_carry[1]))
    inj = faults.injector()
    total = cfg.iterations
    seg = every if every > 0 else total - start_iter
    it = start_iter
    seg_index = 0
    retries_left = health_retries
    while it < total:
        step = min(seg, total - it)
        seg_index += 1
        run_state = state
        if inj is not None:
            f = inj.fire("optimize", seg=seg_index, point="start")
            if f is not None and f.kind == "nan":
                # poison a copy of the segment's input; the segment-start
                # state stays clean for the sentinel's rollback
                y = state.y.clone()
                y[0, 0] = float("nan")
                run_state = state._replace(y=y)
        with obtrace.span("optimize.segment", cat="optimize",
                          seg=seg_index, start_iter=int(it),
                          num_iters=int(step)) as sp:
            if runner is not None:
                out = runner.segment(run_state, cfg, start_iter=it,
                                     num_iters=step, loss_carry=losses,
                                     with_health=health_check,
                                     with_telemetry=telemetry,
                                     telemetry_carry=tel, pilot_carry=pilot)
            else:
                out = tsne.optimize(run_state, jidx, jval, cfg,
                                    start_iter=it, num_iters=step,
                                    loss_carry=losses, edges=edges,
                                    edges_extra=edges_extra, csr=csr,
                                    with_health=health_check,
                                    with_telemetry=telemetry,
                                    telemetry_carry=tel, pilot_carry=pilot)
            new_state, new_losses = out[0], out[1]
            nxt = 2
            new_tel = new_pilot = None
            if telemetry:
                new_tel, nxt = out[nxt], nxt + 1
            if cfg.autopilot:
                new_pilot = out[nxt]
            diverged = health_check and not bool(out[-1])  # one read
            if diverged:
                sp.set(rollback=True)
        if diverged:
            if retries_left <= 0:
                raise health.DivergenceError(it, health_retries)
            retries_left -= 1
            seg_index -= 1  # the retry re-runs the segment
            eta = cfg.learning_rate
            cfg = health.halved_eta(cfg)
            state = health.fresh_momentum(state)
            if pilot is not None:
                from tsne_flink_tpu_torch.models.autopilot import \
                    pilot_collapse
                pilot = (pilot_collapse(pilot[0]), pilot[1])
            ev = health.rollback_event(segment_start=it, step=step,
                                       eta_before=eta,
                                       eta_after=cfg.learning_rate,
                                       retries_left=retries_left)
            if events is not None:
                events.append(ev)
            obmetrics.counter("runtime.rollback").inc()
            obtrace.instant("sentinel.rollback", cat="runtime",
                            **{k: v for k, v in ev.items() if k != "type"})
            print(f"# sentinel: non-finite segment at iteration {it}; "
                  f"rolled back, eta {eta} -> {cfg.learning_rate}, "
                  "retrying", file=sys.stderr)
            continue
        state, losses, tel, pilot = new_state, new_losses, new_tel, new_pilot
        it += step
        if on_boundary is not None and it < total:
            on_boundary(state, it, losses, pilot)
        if inj is not None:
            # kill@optimize:segN — after the boundary's checkpoint, so the
            # resume contract is what the kill exercises
            inj.fire("optimize", seg=seg_index, point="boundary")
    return SegmentsResult(state, losses, tel, pilot, cfg)
