"""Admission control for the serve daemon (port of the serving subset of
``tsne_flink_tpu/runtime/admission.py``).

A model is admitted only while the sum of every resident model's
predicted transform peak (``serve/model.FrozenModel.transform_peak``)
plus its own fits the device budget: an explicit budget, else the card's
memory (``torch.cuda.get_device_properties(...).total_memory``), else
(the CPU) none.  The fleet job gate and its degrade rung are the
multi-job tier, ROADMAP queue A15.
"""

from __future__ import annotations

from dataclasses import dataclass

#: admission outcomes (``Decision.action``)
ADMIT = "admit"
QUEUE = "queue"


@dataclass(frozen=True)
class Decision:
    """One admission verdict."""

    action: str            # admit | queue
    predicted_peak: int    # bytes charged with this model admitted
    reason: str


def default_budget(backend: str, budget_bytes: int | None = None,
                   device=None) -> int | None:
    """``budget_bytes`` when given, else on ``cuda`` the card's memory,
    else None (unlimited)."""
    if budget_bytes:
        return int(budget_bytes)
    if backend == "cuda":
        import torch
        return int(torch.cuda.get_device_properties(
            device if device is not None else 0).total_memory)
    return None


def decide_residency(resident_peaks, model_id: str, peak_bytes: int,
                     budget_bytes: int | None) -> Decision:
    """Admit a new model only while the sum of every resident model's
    transform peak plus its own fits ``budget_bytes``.  Each term is the
    model's full peak (arrays plus its per-bucket transients), so the sum
    is conservative: the daemon's double-buffered tick holds at most two
    buckets in flight.  No degrade rung: a refused model leaves the
    resident set unchanged."""
    in_use = int(sum(int(v) for v in resident_peaks.values()))
    total = in_use + int(peak_bytes)
    if budget_bytes is None or total <= int(budget_bytes):
        return Decision(ADMIT, total,
                        f"model {model_id} peak {int(peak_bytes)} joins "
                        f"{len(resident_peaks)} resident model(s) "
                        f"({in_use} bytes); total {total} fits budget "
                        f"{budget_bytes}")
    return Decision(QUEUE, total,
                    f"model {model_id} peak {int(peak_bytes)} + resident "
                    f"{in_use} = {total} exceeds budget "
                    f"{int(budget_bytes)}; model refused, resident set "
                    "unchanged")


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
