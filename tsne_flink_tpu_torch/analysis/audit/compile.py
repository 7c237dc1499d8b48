"""compile-audit — the kernel-library builds a plan implies (the port's
form of ``tsne_flink_tpu/analysis/audit/compile.py``).

Eager PyTorch has no per-shape executables: the port compiles one thing,
the kernel library (``kernels/build``: every ``csrc/*.cu`` into one
shared object, keyed by the sources' hash, loaded once a process).  So:

* :func:`plan_compile_count` — the library builds a plan implies: 1 on
  the card, 0 on the CPU (the plain versions need none).  The checkpoint's
  ``audit.compile_count`` carries it, as the JAX summary's executable
  count;
* the audit runs a segmented run — checkpoint boundaries, the divergence
  sentinel, the autopilot — and fails if it loads the library more than
  the plan implies (a second load would be a rebuild or a reload a
  segment).

Not applicable, with the reason (ROADMAP §A16): the JAX segment-key and
cycle-reuse checks (``compile.py:47-109`` there) — the port has no jit
cache keyed by segment length, and the hybrid kNN's cycles call the same
Python function.
"""

from __future__ import annotations

from tsne_flink_tpu_torch.analysis.core import Finding

RULE = "compile-audit"

NOT_APPLICABLE = {
    "segment_keys": "no jit: a segment of any length runs the same eager "
                    "code and the same kernel library",
    "cycle_reuse": "no traced program per kNN cycle: each cycle calls the "
                   "same Python function and the same kernels",
}


def plan_compile_count(plan) -> int:
    """Kernel-library builds one invocation of ``plan`` implies: 1 on the
    card, 0 on the CPU — whatever its segmentation (segments share the
    process's one library)."""
    return 1 if plan.backend == "cuda" else 0


def library_loads() -> int:
    """This process's kernel-library loads so far (builds and hits of
    ``kernels/build.build``)."""
    from tsne_flink_tpu_torch.obs import metrics
    return int(metrics.counter_value("kernels.library_builds")
               + metrics.counter_value("kernels.library_hits"))


def segmented_run_loads(device) -> dict:
    """Library loads of a segmented run of the tiny case on ``device``:
    segments of 5 with a checkpoint callback, the sentinel and the
    autopilot armed."""
    import torch

    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.kernels import build
    from tsne_flink_tpu_torch.runtime.segments import run_segments

    prep = cases.prepared(device)
    cfg = cases.config(iterations=20, repulsion="exact", autopilot=True)
    n = int(prep.jidx.shape[0])
    before = library_loads()
    loaded_before = build._library.cache_info().currsize
    boundaries = []
    run = run_segments(cases.state(n, cfg.n_components, device),
                       prep.jidx, prep.jval, cfg, every=5,
                       on_boundary=lambda *a: boundaries.append(a[1]),
                       health_check=True)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"loads": library_loads() - before,
            "already_loaded": bool(loaded_before),
            "boundaries": boundaries, "finite": bool(
                torch.isfinite(run.state.y).all())}


def audit_compile(plans, device) -> tuple[list, dict]:
    findings: list = []
    report: dict = {"not_applicable": NOT_APPLICABLE, "plans": {}}
    for plan in plans:
        report["plans"][plan.name] = {
            "compile_count": plan_compile_count(plan)}
    run = segmented_run_loads(device)
    report["segmented_run"] = run
    import torch
    want = 0 if (torch.device(device).type == "cpu"
                 or run["already_loaded"]) else 1
    if run["loads"] > want:
        findings.append(Finding(
            RULE, "tsne_flink_tpu_torch/kernels/build.py", 1, 0,
            f"a segmented run (checkpoints every 5, the sentinel, the "
            f"autopilot) loads the kernel library {run['loads']} times; "
            f"the plan implies {want}"))
    report["ok"] = not findings
    return findings, report
