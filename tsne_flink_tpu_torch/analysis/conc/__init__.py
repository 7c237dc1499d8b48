"""graftrace — static concurrency/protocol analysis for serve/runtime.

The port's copy of the JAX package's third tier (``tsne_flink_tpu/
analysis/conc``), beside graftlint (syntactic rules) and graftcheck (the
audit tier): a pure-stdlib, torch-free checker of the port's CONCURRENT
invariants — the invariants chaos tests exercise dynamically, proven
here over the source instead.  The protocol specs name the port's spool
path classes, ``utils/io.atomic_write`` and ``utils/locks.FileLock``:

* :mod:`~tsne_flink_tpu_torch.analysis.conc.protocol` — filesystem protocols
  as machine-checkable specs (``conc-protocol-bypass`` / ``-rmw`` /
  ``-tmp``);
* :mod:`~tsne_flink_tpu_torch.analysis.conc.locks` — FileLock discipline
  (``conc-lock-release`` / ``-order`` / ``-blocking``);
* :mod:`~tsne_flink_tpu_torch.analysis.conc.statemachine` — the graftsched
  claim → bind → dispatch → terminal tick (``conc-tick-terminal`` /
  ``-protocol`` / ``-binding`` / ``-buffer``).

Surface: ``python -m tsne_flink_tpu_torch.analysis --conc`` (exit 0 = clean),
default scope ``runtime//serve//utils/``.  Suppressions use the
graftlint grammar — ``# graftlint: disable=<rule> -- rationale`` — and
every suppression lands on the ``--suppressions`` ledger.
"""

from __future__ import annotations

import json
import os

from tsne_flink_tpu_torch.analysis.core import Finding, load_project
from tsne_flink_tpu_torch.analysis.conc.locks import analyze_locks
from tsne_flink_tpu_torch.analysis.conc.protocol import (
    analyze_protocol, protocol_report)
from tsne_flink_tpu_torch.analysis.conc.statemachine import (
    analyze_statemachine, is_daemon_like)

#: the concurrent layer: where every FileLock, spool file and tick lives
DEFAULT_DIRS = ("runtime", "serve", "utils")

#: rule name -> one-line doc (the ``--conc`` side of ``--list-rules``)
CONC_RULES = {
    "conc-protocol-bypass": "raw write to a protocol-governed path class "
                            "bypassing its blessed primitive",
    "conc-protocol-rmw": "read-modify-write of a governed path class "
                         "with no FileLock in evidence",
    "conc-protocol-tmp": "tmp-file write without atomic rename on all "
                         "paths / without finally-unlink",
    "conc-lock-release": "lock acquired outside `with` with no "
                         "guaranteed release and no hand-off",
    "conc-lock-order": "cross-module lock-order cycle (static deadlock)",
    "conc-lock-blocking": "blocking call under a lexically held lock "
                          "outside a declared site",
    "conc-tick-terminal": "a claimed request can reach zero or two "
                          "terminal files",
    "conc-tick-protocol": "terminal writer skips request delete / lock "
                          "release, or deletes before the terminal lands",
    "conc-tick-binding": "model bound after claim (stale hot-swap "
                         "window)",
    "conc-tick-buffer": "double-buffer discipline: result written "
                        "before dispatch or off an unmaterialized handle",
}


def default_paths() -> list:
    """``runtime/ serve/ utils/`` of the installed package tree."""
    pkg = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return [os.path.join(pkg, d) for d in DEFAULT_DIRS]


def run_conc(paths=None, root: str | None = None):
    """Run all three conc analyzers; returns (findings, report).
    Suppressed findings are dropped here, exactly like graftlint's
    runner, so the analyzers stay suppression-blind."""
    root = root or os.getcwd()
    project = load_project(paths or default_paths(), root)
    findings: list = []
    tick = []
    for mod in project.modules:
        findings.extend(analyze_protocol(mod))
        if is_daemon_like(mod):
            got, summary = analyze_statemachine(mod)
            findings.extend(got)
            tick.append(summary)
    lock_findings, lock_report = analyze_locks(project.modules)
    findings.extend(lock_findings)

    by_display = {m.display: m for m in project.modules}
    kept: list = []
    for f in findings:
        mod = by_display.get(f.path)
        if mod is not None and mod.is_suppressed(f.rule, f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    counts: dict = {}
    for f in kept:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    report = {
        "protocols": protocol_report(),
        "locks": lock_report,
        "tick": tick,
        "counts": counts,
        "files_scanned": len(project.modules),
        "ok": not kept,
    }
    return kept, report


def render_conc_human(findings, report) -> str:
    lines = [f.format() for f in findings]
    locks = report["locks"]
    lines.append(
        f"graftrace: {len(findings)} finding(s) in "
        f"{report['files_scanned']} file(s); "
        f"{len(report['protocols'])} protocol(s), "
        f"{locks['lock_sites']} lock site(s), "
        f"{len(locks['order_cycles'])} lock-order cycle(s), "
        f"{len(report['tick'])} daemon module(s)")
    return "\n".join(lines)


def render_conc_json(findings, report) -> str:
    return json.dumps({"findings": [f.as_dict() for f in findings],
                       "conc": report}, indent=2)


__all__ = ["CONC_RULES", "DEFAULT_DIRS", "Finding", "default_paths",
           "run_conc", "render_conc_human", "render_conc_json"]
