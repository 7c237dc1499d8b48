"""The optimize loop's approximation autopilot (port of
``tsne_flink_tpu/models/autopilot.py``).

Two approximation knobs become one recorded, KL-guarded policy:

* **stride control** (closed loop): at every KL report boundary the
  controller compares the global grad norm with the previous report's;
  a smooth trend (relative change < :data:`SMOOTH_REL`) climbs one rung
  of :data:`STRIDE_LADDER`, a rough one (> :data:`ROUGH_REL`) or the
  convergence tail (:func:`tail_start`) collapses to stride 1, and a
  sentinel rollback resets it (:func:`pilot_collapse`);
* **phase-aware FFT grid** (open loop): early exaggeration runs a coarse
  grid, the rest the configured one (:func:`grid_ladder`,
  :func:`grid_phase`), with a refresh forced at the boundary.

Every decision is a function of the absolute iteration and carried
values, so a resumed run makes the same decisions; each lands in a
policy trace, one row a report slot (:func:`policy_report` renders it).

The controller state and trace are device tensors; :func:`pilot_update`
takes the iteration, the refresh and the report flag as host values (the
port's loop is a Python loop that knows them) and touches the device
only.  The loop reads the stride level back once a report boundary
(:func:`read_level`), when it can have changed; :func:`host_reads` counts
those reads.

The JAX package reads ``TSNE_LANDMARK`` and ``TSNE_LANDMARK_FRACTION``;
here they are the arguments ``mode`` and ``fraction``, with the JAX
registry's defaults (``"auto"``, 0.25).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tsne_flink_tpu_torch.models.tsne import LOSS_EVERY, TsneConfig

#: stride rungs the controller climbs (index = stride level)
STRIDE_LADDER = (1, 2, 4, 8)
#: relative grad-norm change per report interval below which the trend
#: is smooth (climb one rung) ...
SMOOTH_REL = 0.15
#: ... and above which it is rough (collapse to stride 1); in between the
#: level holds
ROUGH_REL = 0.40
#: the pinned |final KL(autopilot) − final KL(exact)| tolerance
KL_GUARDRAIL_TOL = 0.05
#: smallest dataset where ``mode="auto"`` engages the landmark schedule
LANDMARK_MIN_N = 20_000
#: the landmark fraction's default (the JAX registry's
#: TSNE_LANDMARK_FRACTION)
LANDMARK_FRACTION = 0.25
#: columns of the policy trace (one row a KL report slot)
PILOT_TRACE_FIELDS = ("stride", "grid_level", "grad_norm", "trigger")
#: trigger codes of the trace's ``trigger`` column
PILOT_TRIGGERS = ("hold", "raise", "collapse-rough", "collapse-tail",
                  "warmup")
#: the controller state, one float vector
PILOT_STATE_FIELDS = ("stride_level", "grad_norm_prev", "refreshes")

_READS = [0]
_READS_LOCK = threading.Lock()  # mesh shards read from their threads


def host_reads() -> int:
    """Reads of the stride level back to the host since the last
    :func:`reset_host_reads`."""
    return _READS[0]


def reset_host_reads() -> None:
    _READS[0] = 0


def read_level(pvec) -> int:
    """The stride level of the controller state, on the host (one device
    read, counted)."""
    with _READS_LOCK:
        _READS[0] += 1
    return int(pvec[0].item())


def tail_start(cfg: TsneConfig) -> int:
    """First iteration of the convergence tail (stride pinned at 1): the
    final 20% of the schedule, at least two report intervals."""
    return max(0, cfg.iterations - max(2 * LOSS_EVERY,
                                       cfg.iterations // 5))


# graftlint: disable=policy-recorded -- the port has no bench record;
# the decision lands in policy_report's landmark block (the run's
# stats['policy'], TSNE.policy_)
def pick_landmark(cfg: TsneConfig, n: int, mode: str = "auto") -> bool:
    """Does the landmark schedule run?  ``mode`` ``on``/``off`` forces it;
    ``auto`` runs it under the autopilot from :data:`LANDMARK_MIN_N`."""
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"landmark '{mode}' not defined (auto | on | off)")
    return bool(cfg.autopilot) and n >= LANDMARK_MIN_N


def landmark_fraction(fraction: float = LANDMARK_FRACTION) -> float:
    """The subsample fraction, clamped to [0.01, 0.9]."""
    return min(0.9, max(0.01, float(fraction)))


def landmark_points(n: int, seed: int,
                    fraction: float = LANDMARK_FRACTION) -> np.ndarray:
    """Seeded landmark choice: the sorted row ids (numpy int64) of the
    subsample, drawn by numpy's ``RandomState(seed)`` as in the JAX
    package, so the ids are its ids."""
    n_land = max(8, min(n - 1, int(round(n * landmark_fraction(fraction)))))
    rs = np.random.RandomState(seed)
    return np.sort(rs.choice(n, n_land, replace=False))


def landmark_schedule(cfg: TsneConfig) -> tuple[int, int]:
    """``(landmark_iters, polish_iters)``: the landmarks run up to the
    convergence tail, the joint polish the tail."""
    ts = tail_start(cfg)
    return ts, cfg.iterations - ts


def _fine_grid(cfg: TsneConfig, m: int) -> int:
    from tsne_flink_tpu_torch.ops.repulsion_fft import DEFAULT_GRID
    return int(cfg.fft_grid if cfg.fft_grid is not None
               else DEFAULT_GRID.get(m))


def landmark_grid(cfg: TsneConfig, m: int) -> int | None:
    """FFT grid of the landmark phase (half the configured one, floor 32),
    or None off the FFT path."""
    if cfg.repulsion != "fft":
        return None
    return max(32, _fine_grid(cfg, m) // 2)


def grid_ladder(cfg: TsneConfig, m: int) -> tuple[int, ...]:
    """(coarse, fine) FFT grids: half the configured grid (floor 32)
    during early exaggeration, then the grid itself; () off the FFT
    path."""
    if cfg.repulsion != "fft":
        return ()
    g = _fine_grid(cfg, m)
    return (max(32, g // 2), g)


def grid_phase(i: int, cfg: TsneConfig) -> int:
    """Ladder index of iteration ``i``: 0 during early exaggeration, 1
    after."""
    return 0 if i < cfg.exaggeration_end else 1


def pilot_init(cfg: TsneConfig, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Fresh controller state: level 0, no grad-norm history, no
    refreshes."""
    return torch.zeros(len(PILOT_STATE_FIELDS), dtype=dtype, device=device)


def trace_init(cfg: TsneConfig, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Empty policy trace, one row a KL report slot."""
    return torch.zeros((max(cfg.n_loss_slots, 1), len(PILOT_TRACE_FIELDS)),
                       dtype=dtype, device=device)


def pilot_collapse(pvec: torch.Tensor) -> torch.Tensor:
    """The sentinel's reset: level 0 and the trend history cleared (the
    refresh count survives).  A new tensor on ``pvec``'s device."""
    out = pvec.clone()
    out[0] = 0.0
    out[1] = 0.0
    return out


def stride_of(level: int) -> int:
    """The stride of a controller level."""
    return STRIDE_LADDER[level]


def pilot_update(i: int, gn, pvec: torch.Tensor, trace: torch.Tensor,
                 refreshed: bool, slot: int, record: bool,
                 cfg: TsneConfig):
    """One controller step at the end of iteration ``i`` (the decision
    applies from ``i + 1``): count the refresh; at a report boundary
    (``record``) compare ``gn`` (a 0-d device tensor; unused off the
    boundary) with the previous report's, move the level and stamp trace
    slot ``slot`` with (stride, next iteration's grid level, ``gn``,
    trigger).  The slot that crosses the exaggeration boundary is warmup:
    the level holds and the history re-primes.  Returns new ``(pvec,
    trace)`` tensors; nothing is read back."""
    dt = trace.dtype
    refreshes = pvec[2] + float(bool(refreshed))
    if not record:
        return torch.stack([pvec[0], pvec[1], refreshes]), trace
    level = pvec[0].to(torch.int64)
    gn_prev = pvec[1]
    gn = torch.as_tensor(gn, dtype=dt, device=pvec.device)
    crossed = grid_phase(i, cfg) != grid_phase(i - LOSS_EVERY, cfg)
    warm = (gn_prev <= 0) | crossed
    rel = torch.abs(gn - gn_prev) / torch.clamp(gn_prev, min=1e-12)
    in_tail = (i + 1) >= tail_start(cfg)
    max_level = len(STRIDE_LADDER) - 1
    climb = ~warm & (rel < SMOOTH_REL) & (not in_tail)
    rough = ~warm & (rel > ROUGH_REL)
    zero = torch.zeros_like(level)
    if in_tail:
        new_level, trigger = zero, zero + 3
    else:
        new_level = torch.where(rough, zero, torch.where(
            climb, torch.clamp(level + 1, max=max_level), level))
        trigger = torch.where(rough, 2, torch.where(
            climb, 1, torch.where(warm, 4, 0)))
    ladder = torch.tensor(STRIDE_LADDER, dtype=dt, device=pvec.device)
    row = torch.stack([ladder[new_level],
                       torch.tensor(float(grid_phase(i + 1, cfg)), dtype=dt,
                                    device=pvec.device),
                       gn, trigger.to(dt)])
    trace = trace.clone()
    trace[slot] = row
    return torch.stack([new_level.to(dt), gn, refreshes]), trace


def policy_report(cfg: TsneConfig, pilot, iterations_run: int | None = None,
                  landmark: dict | None = None, *, fused_step: bool = True,
                  mesh_reduce: str = "canonical") -> dict:
    """The JSON-safe ``policy`` block of a run from its final pilot pair
    ``(pvec, trace)`` (None: the static policy): the ladders, the
    decision transitions, the refresh count and the landmark decision.
    ``fused_step`` and ``mesh_reduce`` are what the port resolves: the
    fused CSR step unless a caller turns it off, and the one-device
    reduction."""
    iters = int(iterations_run if iterations_run is not None
                else cfg.iterations)
    stride = max(1, int(cfg.repulsion_stride))
    base = {
        "autopilot": bool(cfg.autopilot),
        "fused_step": bool(fused_step),
        "mesh_reduce": mesh_reduce,
        "stride_ladder": list(STRIDE_LADDER),
        "grid_ladder": list(grid_ladder(cfg, cfg.n_components)),
        "kl_guardrail_tol": KL_GUARDRAIL_TOL,
        "smooth_rel": SMOOTH_REL, "rough_rel": ROUGH_REL,
        "tail_start": tail_start(cfg),
        "decide_every": LOSS_EVERY,
        "landmark": False, "landmark_fraction": 0.0, "n_landmark": 0,
        "landmark_iters": 0, "polish_iters": iters, "landmark_grid": None,
    }
    if landmark:
        base.update({k: landmark.get(k, base[k]) for k in
                     ("landmark", "landmark_fraction", "n_landmark",
                      "landmark_iters", "polish_iters", "landmark_grid")})
    if pilot is None:
        base.update({"transitions": [],
                     "repulsion_refreshes": (iters + stride - 1) // stride
                     if iters else 0,
                     "final_stride": stride})
        return base
    pvec, trace = (np.asarray(_host(pilot[0]), np.float64),
                   np.asarray(_host(pilot[1]), np.float64))
    transitions = []
    prev_stride, prev_grid = 1.0, 0.0
    n_slots = min(trace.shape[0], max(iters // LOSS_EVERY, 0))
    for t in range(n_slots):
        stride_t, grid_t, gn_t, trig_t = trace[t]
        if stride_t != prev_stride or grid_t != prev_grid:
            transitions.append({
                "iter": LOSS_EVERY * (t + 1),
                "trigger": PILOT_TRIGGERS[int(trig_t)]
                if stride_t != prev_stride else "phase",
                "stride": [int(prev_stride), int(stride_t)],
                "grid_level": [int(prev_grid), int(grid_t)],
                "grad_norm": float(gn_t)})
        prev_stride, prev_grid = stride_t, grid_t
    base.update({"transitions": transitions,
                 "repulsion_refreshes": int(pvec[2]),
                 "final_stride": int(prev_stride)})
    return base


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
