"""The port's graftrace (``tsne_flink_tpu_torch/analysis/conc``) against
the JAX package's, and over the port's ``runtime/ serve/ utils/`` (CPU,
stdlib only).

* on each seeded fixture of ``tests/lint_fixtures/serve`` and on the
  directory whole, the port's findings are the JAX's (rule, path, line,
  col) — the one-level helper following of the tick analysis changes
  none of them;
* the port's tree is conc-clean: the daemon's ``_terminal`` helper
  settles ``_fail``'s delete and release, and the two declared sites
  carry rationale'd suppressions;
* the protocol registry names the port's spool classes, and every row
  maps to a fault site of ``runtime/faults.SITES`` or says why not.
"""

import json
import os
import subprocess
import sys

import pytest

from tsne_flink_tpu.analysis.conc import run_conc as jrun_conc
from tsne_flink_tpu_torch.analysis.conc import (CONC_RULES, default_paths,
                                                run_conc)
from tsne_flink_tpu_torch.analysis.conc.protocol import PROTOCOLS
from tsne_flink_tpu_torch.runtime import faults

pytestmark = pytest.mark.fast

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures", "serve")


def _key(findings):
    return sorted((f.rule, f.path, f.line, f.col) for f in findings)


@pytest.mark.parametrize("target", ["fx_conc_statemachine.py",
                                    "fx_conc_locks.py",
                                    "fx_conc_protocol.py", ""])
def test_port_graftrace_gives_the_jax_findings(target):
    paths = [os.path.join(FIXTURES, target)]
    want, _ = jrun_conc(paths, root=REPO)
    got, report = run_conc(paths, root=REPO)
    assert want and _key(got) == _key(want)
    assert {f.rule for f in got} <= set(CONC_RULES)


def test_port_tree_is_conc_clean():
    findings, report = run_conc(root=REPO)
    assert report["files_scanned"] > 15
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)
    tick = report["tick"]
    assert [t["module"] for t in tick] == [
        "tsne_flink_tpu_torch/serve/daemon.py"]
    assert "_fail" in tick[0]["err_terminals"]
    assert "_write_result" in tick[0]["res_terminals"]
    assert report["locks"]["lock_sites"] >= 3
    assert default_paths()[0].endswith(os.path.join("tsne_flink_tpu_torch",
                                                    "runtime"))


def test_protocols_map_to_fault_sites():
    names = {p.name for p in PROTOCOLS}
    assert {"spool-request", "spool-result", "spool-error", "checkpoint",
            "kernel-library", "heartbeat", "claim-epoch"} <= names
    for p in PROTOCOLS:
        assert p.fault_site in faults.SITES or p.chaos_rationale, p.name


def test_conc_entry_point():
    r = subprocess.run([sys.executable, "-m", "tsne_flink_tpu_torch.analysis",
                        "--conc", "--json"], capture_output=True, text=True,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert json.loads(r.stdout)["conc"]["ok"] is True
    r = subprocess.run([sys.executable, "-m", "tsne_flink_tpu_torch.analysis",
                        "--conc", os.path.join(FIXTURES,
                                               "fx_conc_locks.py")],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 1
