"""The segment runner: ``optimize`` in segments, with the divergence
sentinel's rollback, shared by the command line and the estimator.

The single-device counterpart of the JAX package's
``parallel/mesh.ShardedOptimizer.__call__`` loop.  It runs iterations
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
.rollback_event` appended to ``events``; past ``health_retries``
rollbacks in a run it raises ``DivergenceError``.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from tsne_flink_tpu_torch.models import tsne
from tsne_flink_tpu_torch.runtime import health


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
                 on_boundary=None) -> SegmentsResult:
    """Run [start_iter, cfg.iterations) in segments of ``every`` (0: one
    segment).  ``on_boundary(state, next_iter, losses, pilot)`` fires
    after every segment but the last.  Carries (``loss_carry``,
    ``telemetry_carry``, ``pilot_carry``) may be numpy arrays or tensors;
    a trace of another length is padded or cut to this schedule's."""
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
    total = cfg.iterations
    seg = every if every > 0 else total - start_iter
    it = start_iter
    retries_left = health_retries
    while it < total:
        step = min(seg, total - it)
        out = tsne.optimize(state, jidx, jval, cfg, start_iter=it,
                            num_iters=step, loss_carry=losses, edges=edges,
                            edges_extra=edges_extra, csr=csr,
                            with_health=health_check,
                            with_telemetry=telemetry, telemetry_carry=tel,
                            pilot_carry=pilot)
        new_state, new_losses = out[0], out[1]
        nxt = 2
        new_tel = new_pilot = None
        if telemetry:
            new_tel, nxt = out[nxt], nxt + 1
        if cfg.autopilot:
            new_pilot = out[nxt]
        if health_check and not bool(out[-1]):  # one read a segment
            if retries_left <= 0:
                raise health.DivergenceError(it, health_retries)
            retries_left -= 1
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
            print(f"# sentinel: non-finite segment at iteration {it}; "
                  f"rolled back, eta {eta} -> {cfg.learning_rate}, "
                  "retrying", file=sys.stderr)
            continue
        state, losses, tel, pilot = new_state, new_losses, new_tel, new_pilot
        it += step
        if on_boundary is not None and it < total:
            on_boundary(state, it, losses, pilot)
    return SegmentsResult(state, losses, tel, pilot, cfg)


def segmented_embed(x, cfg: tsne.TsneConfig, *, neighbors=None,
                    knn_method: str = "bruteforce", knn_iterations=None,
                    knn_refine=None, knn_blocks: int = 8, seed: int = 0,
                    sym_width=None, affinity_assembly=None, device=None,
                    artifact_cache=None, knn_autotune: bool = False,
                    health_check: bool = False, telemetry: bool = False,
                    events: list | None = None) -> SegmentsResult:
    """``tsne_embed``'s prepare, init and plan, then :func:`run_segments`
    in the JAX estimator's segments (``max(10, min(50, iterations //
    10))`` iterations; ``runtime/supervisor.supervised_embed``).  The
    estimator takes this path when the sentinel, telemetry or the
    autopilot is armed; like the JAX one it runs no landmark schedule."""
    from tsne_flink_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    run = tsne._prepare_run(x, cfg, neighbors=neighbors,
                            knn_method=knn_method,
                            knn_iterations=knn_iterations,
                            knn_refine=knn_refine, knn_blocks=knn_blocks,
                            seed=seed, sym_width=sym_width,
                            affinity_assembly=affinity_assembly,
                            device=device, artifact_cache=artifact_cache,
                            knn_autotune=knn_autotune)
    iters = cfg.iterations
    every = max(tsne.LOSS_EVERY, min(50, iters // 10 or iters))
    return run_segments(run.state, run.prep.jidx, run.prep.jval, cfg,
                        every=every, edges=run.edges,
                        edges_extra=run.layout == "blocks", csr=run.csr,
                        health_check=health_check, events=events,
                        telemetry=telemetry)
