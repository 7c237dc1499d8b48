"""The divergence sentinel's policy (port of
``tsne_flink_tpu/runtime/health.py``): rollback, eta halving, fresh
momentum.

``models/tsne.optimize(with_health=True)`` folds a finiteness flag over
(y, gains, KL) into a device tensor, read once a segment by the segment
runner (``runtime/segments.run_segments``), which applies this policy
to a non-finite segment:

* roll back to the segment-start state;
* halve the learning rate, for the rest of the run;
* zero the momentum buffer (it carries the blow-up's direction) and keep
  the adaptive gains;
* retry the segment, at most ``health_retries`` times in a run, each
  rollback recorded as a :func:`rollback_event`.
"""

from __future__ import annotations

from dataclasses import replace

import torch


def halved_eta(cfg):
    """The retry config: same schedule, half the learning rate."""
    return replace(cfg, learning_rate=cfg.learning_rate / 2.0)


def fresh_momentum(state):
    """Zero the update buffer, keep y and the adaptive gains."""
    return state._replace(update=torch.zeros_like(state.update))


def rollback_event(*, segment_start: int, step: int, eta_before: float,
                   eta_after: float, retries_left: int) -> dict:
    """Structured record of one sentinel rollback (the JAX package's
    keys)."""
    return {"type": "sentinel-rollback", "stage": "optimize",
            "segment_start": int(segment_start), "segment_iters": int(step),
            "eta_before": float(eta_before), "eta_after": float(eta_after),
            "retries_left": int(retries_left)}


class DivergenceError(RuntimeError):
    """The sentinel's retries are spent and the segment is still
    non-finite."""

    def __init__(self, start_iter: int, retries: int):
        super().__init__(
            f"optimize segment at iteration {start_iter} still non-finite "
            f"after {retries} sentinel retries (eta halved each time); "
            "lower --learningRate or --earlyExaggeration")
