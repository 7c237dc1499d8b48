"""Admission control — the memory model as a scheduler gate (port of
``tsne_flink_tpu/runtime/admission.py``).

A fleet job is admitted only while

    sum(predicted peak of every running job) + its own predicted peak
        <= the fleet budget,

each job's peak being ``plan_hbm_report(plan)["peak_hbm_est"]`` over its
:class:`~tsne_flink_tpu_torch.analysis.audit.plan.PlanConfig` at the
widest rows its run may build (:func:`predicted_peak_bytes`) — the max
over its stages, so the sum is a safe co-residency bound.  On the card
each job's peak carries the caching allocator's reserve and the process's
CUDA context (``analysis/audit/hbm.py``): what the other processes on the
card see.  A job that does not fit may be **degraded at admission**
(the OOM ladder's rung 2, ``assembly=blocks``) when that makes it fit,
else queued until a running job releases its reservation.

The serve daemon admits models the same way
(:func:`decide_residency`), and overload sheds bulk requests
(:func:`decide_shed`).

The budget: an explicit one, else on ``cuda`` the card's memory, else
(the CPU) none.  The port reads no environment variable (the JAX
package's ``TSNE_FLEET_HBM_BUDGET``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

#: admission outcomes (``Decision.action``)
ADMIT = "admit"
DEGRADE = "admit-degraded"
QUEUE = "queue"
#: overload-shedding outcome (``ShedDecision.action``)
SHED = "shed"


@dataclass(frozen=True)
class Decision:
    """One admission verdict for one job plan or model."""

    action: str                 # admit | admit-degraded | queue
    predicted_peak: int         # bytes the admitted plan is charged for
    overrides: dict = field(default_factory=dict)  # {} unless degraded
    reason: str = ""

    def as_dict(self) -> dict:
        return {"action": self.action,
                "predicted_peak": int(self.predicted_peak),
                "overrides": dict(self.overrides), "reason": self.reason}


def predicted_peak_bytes(plan) -> int:
    """The memory model's plan-level peak (max over stage peaks) at the
    widest rows the plan's run may build (``analysis/audit/hbm
    .charged_peak_bytes``) — the number one running job is charged
    against the budget.  A job admitted before its kNN graph exists is
    charged the widest its assembly allows; the fleet re-admits it at the
    graph's width bound once the job reports it."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import charged_peak_bytes
    return int(charged_peak_bytes(plan))


def default_budget(backend: str, budget_bytes: int | None = None,
                   device=None) -> int | None:
    """``budget_bytes`` when given, else on ``cuda`` the card's memory,
    else None (unlimited)."""
    if budget_bytes:
        return int(budget_bytes)
    if backend == "cuda":
        from tsne_flink_tpu_torch.analysis.audit.plan import \
            card_memory_bytes
        return card_memory_bytes(device)
    return None


def decide_residency(resident_peaks, model_id: str, peak_bytes: int,
                     budget_bytes: int | None, *,
                     process_bytes: int = 0) -> Decision:
    """Admit a new model only while the sum of every resident model's
    transform peak plus its own fits ``budget_bytes``.  Each term is the
    model's full peak (arrays plus its per-bucket transients), so the sum
    is conservative: the daemon's double-buffered tick holds at most two
    buckets in flight.  ``process_bytes`` is charged once beside the
    models (on the card the daemon process's CUDA context; 0 on the CPU,
    the JAX gate).  No degrade rung: a refused model leaves the resident
    set unchanged."""
    in_use = int(sum(int(v) for v in resident_peaks.values())
                 + int(process_bytes))
    total = in_use + int(peak_bytes)
    if budget_bytes is None or total <= int(budget_bytes):
        return Decision(ADMIT, total, {},
                        f"model {model_id} peak {int(peak_bytes)} joins "
                        f"{len(resident_peaks)} resident model(s) "
                        f"({in_use} bytes); total {total} fits budget "
                        f"{budget_bytes}")
    return Decision(QUEUE, total, {},
                    f"model {model_id} peak {int(peak_bytes)} + resident "
                    f"{in_use} = {total} exceeds budget "
                    f"{int(budget_bytes)}; model refused, resident set "
                    "unchanged")


@dataclass(frozen=True)
class ShedDecision:
    """One overload-shedding verdict for one spooled request."""

    action: str                 # admit | shed
    retry_after_ms: float       # client back-off hint (0 when admitted)
    reason: str

    def as_dict(self) -> dict:
        return {"action": self.action,
                "retry_after_ms": float(self.retry_after_ms),
                "reason": self.reason}


def decide_shed(backlog: int, rows: int, bucket: int, shed_depth: int,
                deadline_ms: float) -> ShedDecision:
    """Brownout policy for one claimed request: past ``shed_depth``
    pending requests, BULK-lane requests (more rows than one bucket) are
    refused with a ``retry_after_ms`` hint that grows one deadline unit
    per request of excess; express requests are never shed before
    bulk."""
    if shed_depth <= 0 or backlog <= shed_depth:
        return ShedDecision(ADMIT, 0.0,
                            f"backlog {backlog} within shed depth "
                            f"{shed_depth}")
    if rows <= int(bucket):
        return ShedDecision(ADMIT, 0.0,
                            f"express lane ({rows} rows <= bucket "
                            f"{bucket}) is never shed before bulk")
    retry_ms = float(deadline_ms) * (backlog - int(shed_depth))
    return ShedDecision(
        SHED, round(retry_ms, 3),
        f"backlog {backlog} exceeds shed depth {shed_depth}: bulk "
        f"request ({rows} rows) refused, retry in ~{round(retry_ms)}ms")


def bounded_claim_rows(default_rows: int, bucket: int, peak_bytes: int,
                       budget_bytes: int | None) -> int:
    """The daemon's claim horizon bounded by the budget: at most
    ``budget // peak_bytes`` buckets of queue depth (each charged one
    transform peak), never below one bucket nor above ``default_rows``;
    with no budget the default stands."""
    default_rows = int(default_rows)
    if budget_bytes is None or int(peak_bytes) <= 0:
        return default_rows
    depth = max(1, int(budget_bytes) // int(peak_bytes))
    return max(int(bucket), min(default_rows, depth * int(bucket)))


class AdmissionController:
    """Stateless policy: callers (the fleet) track ``in_use_bytes``."""

    def __init__(self, budget_bytes: int | None, *, degrade: bool = True):
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self.degrade = bool(degrade)

    def fits(self, peak: int, in_use_bytes: int) -> bool:
        if self.budget_bytes is None:
            return True
        return in_use_bytes + peak <= self.budget_bytes

    def decide(self, plan, in_use_bytes: int) -> Decision:
        """Admit, degrade-and-admit, or queue ``plan`` given the bytes
        already charged to running jobs."""
        peak = predicted_peak_bytes(plan)
        if self.fits(peak, in_use_bytes):
            return Decision(ADMIT, peak, {},
                            f"predicted peak {peak} fits in-use "
                            f"{in_use_bytes} within budget")
        if self.degrade and plan.resolved_assembly() != "blocks":
            # the ladder's rung-2 demotion, applied statically: blocks
            # never materializes the hub-widened [N, S] rows
            demoted = replace(plan, assembly="blocks")
            peak_b = predicted_peak_bytes(demoted)
            if peak_b < peak and self.fits(peak_b, in_use_bytes):
                return Decision(
                    DEGRADE, peak_b, {"assembly": "blocks"},
                    f"peak {peak} over budget; blocks assembly predicts "
                    f"{peak_b}, which fits")
        return Decision(QUEUE, peak, {},
                        f"predicted peak {peak} + in-use {in_use_bytes} "
                        f"exceeds budget {self.budget_bytes}; queued until "
                        "a running job releases")
