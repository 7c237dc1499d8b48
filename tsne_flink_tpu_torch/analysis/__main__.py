"""``python -m tsne_flink_tpu_torch.analysis`` — the port's graftlint /
graftrace / graftcheck CLI (the JAX package's flags and exit codes).

Exit status: 0 = clean, 1 = findings, 2 = usage error.  The lint and
conc paths import no torch, so they run anywhere the source tree exists;
``--audit`` switches to graftcheck (:mod:`.audit`), which runs a tiny
concrete case of the pipeline under a recorder and therefore imports
torch.  It runs on the card unless ``--device cpu`` is given, and
without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tsne_flink_tpu_torch.analysis import core


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tsne_flink_tpu_torch.analysis",
        description="graftlint: the port's static analysis (hot-path "
                    "hygiene, contracts, concurrency) and graftcheck audit")
    p.add_argument("paths", nargs="*",
                   help="files/directories to scan (e.g. "
                        "tsne_flink_tpu_torch)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset of rules to run")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    p.add_argument("--env-table", action="store_true",
                   help="print the environment registry as a markdown table "
                        "(the port's is empty)")
    p.add_argument("--audit", action="store_true",
                   help="run graftcheck, the audit tier: hbm-footprint, "
                        "dtype-contract, compile-audit, sharding-contract, "
                        "determinism-audit and comms-audit over the port's "
                        "representative plans and a tiny recorded run "
                        "(imports torch)")
    p.add_argument("--plan", action="append", default=None,
                   help="(--audit) audit these PlanConfig JSON file(s) "
                        "instead of the built-in representative plans")
    p.add_argument("--analyzers", default=None,
                   help="(--audit) comma-separated subset of the six "
                        "analyzers to run")
    p.add_argument("--device", default=None,
                   help="(--audit) the device the recorded runs use: the "
                        "card by default, 'cpu' for the plain versions")
    p.add_argument("--conc", action="store_true",
                   help="run graftrace, the concurrency/protocol tier: "
                        "protocol bypass/rmw/tmp, lock discipline and the "
                        "serve tick state machine over runtime//serve//"
                        "utils/ (stdlib-only, no torch)")
    p.add_argument("--suppressions", action="store_true",
                   help="print the suppression ledger: every 'graftlint: "
                        "disable' under the targets with file:line, "
                        "rules and rationale")
    args = p.parse_args(argv)

    if args.audit:
        return _audit(args)
    if args.conc:
        return _conc(args)
    if args.suppressions:
        return _suppressions(args)
    if args.env_table:
        from tsne_flink_tpu_torch.analysis.rules import env_table_markdown
        print(env_table_markdown())
        return 0
    if args.list_rules:
        from tsne_flink_tpu_torch.analysis import rules
        for name, fn in sorted(core.RULES.items()):
            print(f"{name}: {fn.rule_doc}")
        for name, why in sorted(rules.NOT_APPLICABLE.items()):
            print(f"{name}: not applicable — {why}")
        return 0
    if not args.paths:
        p.error("no paths given (and neither --env-table nor --list-rules)")
    selected = ([r.strip() for r in args.rules.split(",") if r.strip()]
                if args.rules else None)
    findings, n_files = core.run(args.paths, rules=selected)
    if args.json:
        print(core.render_json(findings, n_files))
    else:
        print(core.render_human(findings, n_files))
    return 1 if findings else 0


def _conc(args) -> int:
    """The graftrace entry: stdlib-only like the lint paths."""
    from tsne_flink_tpu_torch.analysis.conc import (render_conc_human,
                                                    render_conc_json,
                                                    run_conc)
    findings, report = run_conc(paths=args.paths or None)
    if args.json:
        print(render_conc_json(findings, report))
    else:
        print(render_conc_human(findings, report))
    return 1 if findings else 0


def _suppressions(args) -> int:
    """The suppression ledger: every disable comment is an auditable,
    deliberate exception — the tests pin the count."""
    if args.paths:
        paths, root = args.paths, None
    else:
        pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        root = os.path.dirname(pkg)
        paths = [pkg]
    rows = core.collect_suppressions(paths, root=root)
    if args.json:
        print(json.dumps({"suppressions": rows, "count": len(rows)},
                         indent=2))
    else:
        for r in rows:
            why = r["rationale"] or "(no rationale)"
            scope = "[file] " if r["scope"] == "file" else ""
            print(f"{r['path']}:{r['line']}: {scope}"
                  f"{','.join(r['rules'])} -- {why}")
        print(f"graftlint: {len(rows)} suppression(s)")
    return 0


def _audit(args) -> int:
    """The graftcheck entry: the six analyzers on the requested device."""
    from tsne_flink_tpu_torch.analysis.audit import (PlanConfig,
                                                     render_audit_human,
                                                     render_audit_json,
                                                     run_audit)
    plans = None
    if args.plan:
        plans = [PlanConfig.from_json(path) for path in args.plan]
    analyzers = ([a.strip() for a in args.analyzers.split(",") if a.strip()]
                 if args.analyzers else None)
    findings, report = run_audit(plans=plans, analyzers=analyzers,
                                 device=args.device)
    if args.json:
        print(render_audit_json(findings, report))
    else:
        print(render_audit_human(findings, report))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
