"""graftcheck of the port — the audit tier (mirrors
``tsne_flink_tpu/analysis/audit``).

PyTorch has no abstract trace of this code, so the analyzers run tiny
concrete cases (n <= 256) under the dispatch recorder
(:mod:`.record`) and hold what they issue; the memory model stays
arithmetic.  Six analyzers, one report format shared with graftlint:

* ``hbm-footprint``     (:mod:`.hbm`) — per-stage peak device memory of
  a :class:`~.plan.PlanConfig`, gated against the card's memory;
* ``dtype-contract``    (:mod:`.dtype`) — every registered op
  (:mod:`.contracts`) run on float32 inputs against its declared output
  dtypes, with a float64 scan and a bf16 check;
* ``compile-audit``     (:mod:`.compile`) — the kernel-library builds a
  plan implies; a segmented run must not load the library twice;
* ``sharding-contract`` (:mod:`.sharding`) — every collective on the
  live axis, every shard in one sequence (thread mesh 2 and 4, a
  two-process gloo job);
* ``determinism-audit`` (:mod:`.determinism`) — no unblessed floating
  psum or unordered scatter-add in optimize (mesh 1, 2, 4) or the
  transform;
* ``comms-audit``       (:mod:`.comms`) — every collective on the
  ``BLESSED_COMMS`` registry, per-iteration vs per-segment bytes, the
  canonical-vs-psum A/B, seconds under the card's NVLink model.

Entry points: ``python -m tsne_flink_tpu_torch.analysis --audit
[--device cpu]``; the CLI's ``--auditPlan`` runs the plan-level part
before a launch and refuses a predicted OOM.  The audit runs on the card
unless the caller passes ``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import json

from tsne_flink_tpu_torch.analysis.audit.plan import (  # noqa: F401
    PlanConfig, bench_plan)

ANALYZERS = ("hbm-footprint", "dtype-contract", "compile-audit",
             "sharding-contract", "determinism-audit", "comms-audit")

#: the backends a plan may name (a TPU plan is the JAX package's)
BACKENDS = ("cuda", "cpu")


def default_plans() -> list:
    """The representative plans: the 60k headline shape on the card and
    on the CPU, and the smoke's ``[large]`` run (1,306,127 x 50, k = 150,
    the hybrid kNN, the blocks layout, FFT repulsion) on the card."""
    return [
        bench_plan(backend="cuda"),
        bench_plan(backend="cpu"),
        PlanConfig(n=1_306_127, d=50, k=150, backend="cuda",
                   knn_method="project", repulsion="fft",
                   assembly="blocks", name="large-1.3m-blocks-fft-cuda"),
    ]


def check_plans(plans) -> None:
    """Refuse a plan of a backend the port does not run, by name."""
    for plan in plans:
        if plan.backend not in BACKENDS:
            raise SystemExit(
                f"plan '{plan.name}' names backend '{plan.backend}': the "
                f"port audits {' | '.join(BACKENDS)} plans (a 'tpu' plan "
                "is the JAX package's: python -m tsne_flink_tpu.analysis "
                "--audit)")


def run_audit(plans=None, analyzers=None, device=None) -> tuple[list, dict]:
    """Run the selected analyzers on ``device`` (None: the card, which
    must exist); returns (findings, report)."""
    from tsne_flink_tpu_torch.utils.device import resolve_device

    plans = default_plans() if plans is None else list(plans)
    check_plans(plans)
    selected = set(ANALYZERS if analyzers is None else analyzers)
    unknown = selected - set(ANALYZERS)
    if unknown:
        raise SystemExit(f"unknown analyzer(s) {sorted(unknown)}; known: "
                         f"{list(ANALYZERS)}")
    device = resolve_device(device)
    findings: list = []
    report: dict = {"plans": {p.name: p.as_dict() for p in plans},
                    "device": str(device)}
    if "hbm-footprint" in selected:
        from tsne_flink_tpu_torch.analysis.audit import hbm
        f, rep = hbm.audit_hbm(plans)
        findings.extend(f)
        report["hbm"] = rep
    if "compile-audit" in selected:
        from tsne_flink_tpu_torch.analysis.audit import compile as comp
        f, rep = comp.audit_compile(plans, device)
        findings.extend(f)
        report["compile"] = rep
    if "dtype-contract" in selected:
        from tsne_flink_tpu_torch.analysis.audit import dtype
        f, rep = dtype.audit_dtype(device)
        findings.extend(f)
        report["dtype"] = rep
    if "sharding-contract" in selected:
        from tsne_flink_tpu_torch.analysis.audit import sharding
        f, rep = sharding.audit_sharding(device)
        findings.extend(f)
        report["sharding"] = rep
    if "determinism-audit" in selected:
        from tsne_flink_tpu_torch.analysis.audit import determinism
        f, rep = determinism.audit_determinism(device)
        findings.extend(f)
        report["determinism"] = rep
    if "comms-audit" in selected:
        from tsne_flink_tpu_torch.analysis.audit import comms
        f, rep = comms.audit_comms(device, plans)
        findings.extend(f)
        report["comms"] = rep
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, report


def render_audit_json(findings, report) -> str:
    """The JAX schema: findings / counts / analyzers / ok, plus the
    per-analyzer reports under ``audit``."""
    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return json.dumps({"findings": [f.as_dict() for f in findings],
                       "counts": counts, "analyzers": list(ANALYZERS),
                       "ok": not findings, "audit": report}, indent=2,
                      default=str)


def render_audit_human(findings, report) -> str:
    lines = [f.format() for f in findings]
    for name, rep in sorted(report.get("hbm", {}).items()):
        lines.append(
            f"graftcheck: plan {name}: peak HBM est "
            f"{rep['peak_hbm_est_gib']} GiB in '{rep['peak_stage']}' "
            + ("(no budget)" if rep["hbm_budget"] is None else
               f"vs {round(rep['hbm_budget'] / (1 << 30), 2)} GiB budget "
               f"-> {'ok' if rep['ok'] else 'PREDICTED OOM'}"))
    comms = report.get("comms")
    if comms:
        lines.append(
            f"graftcheck: comms: {comms['unblessed']} unblessed "
            f"collective(s) across {len(comms['programs'])} recorded "
            f"program(s)")
        for name, pair in sorted(comms.get("plan_models", {}).items()):
            c = pair["canonical"]
            lines.append(
                f"graftcheck: comms: plan {name}: mesh {c['mesh']}: "
                f"{c['per_iter_bytes']} B/iter sent/device canonical, "
                f"reduce slice {c['per_iter_reduce_bytes']} -> "
                f"{pair['psum']['per_iter_reduce_bytes']} B under psum")
    det = report.get("determinism")
    if det:
        unblessed = sum(p.get("unblessed", 0)
                        for p in det["programs"].values())
        lines.append(
            f"graftcheck: determinism: {unblessed} unblessed reduction(s) "
            f"across {len(det['programs'])} recorded program(s)")
    shard = report.get("sharding")
    if shard:
        lines.append(f"graftcheck: sharding: {len(shard['runs'])} sharded "
                     "run(s), every shard in one sequence"
                     if shard["ok"] else "graftcheck: sharding: MISMATCH")
    lines.append(f"graftcheck: {len(findings)} finding(s) across "
                 f"{len(report.get('plans', {}))} plan(s) on "
                 f"{report.get('device')}")
    return "\n".join(lines)
