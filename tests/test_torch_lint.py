"""The port's graftlint (``tsne_flink_tpu_torch/analysis``) against the JAX
package's, and over the port's own tree (CPU, stdlib only).

* the port's ``core`` reads the same suppressions as the JAX one on every
  file of ``tests/lint_fixtures/`` (the per-line map, the file scope and
  the ledger rows);
* each rule ported as it is gives the JAX rule's findings (rule, path,
  line, col) on those fixtures;
* each rule in the port's idiom fires exactly at the seeded violations of
  ``tests/torch_lint_fixtures/`` and stays quiet on the clean and
  suppressed twins;
* the port's tree is lint-clean, and its suppression count is pinned;
* the lint tier imports no torch (a subprocess's ``sys.modules``); the
  entry point's exit codes and JSON.
"""

import json
import os
import subprocess
import sys

import pytest

from tsne_flink_tpu.analysis import core as jcore
from tsne_flink_tpu.analysis import run as jrun
from tsne_flink_tpu_torch.analysis import RULES
from tsne_flink_tpu_torch.analysis import core as tcore
from tsne_flink_tpu_torch.analysis import rules as trules
from tsne_flink_tpu_torch.analysis import run as trun

pytestmark = pytest.mark.fast

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
JAX_FIXTURES = os.path.join("tests", "lint_fixtures")
FIXTURES = os.path.join("tests", "torch_lint_fixtures")
PORT = "tsne_flink_tpu_torch"

#: graftlint disable comments (and BLESSED_COMMS rows) in the port's tree;
#: a new one is a reviewed diff (CHANGES.md lists each)
SUPPRESSIONS = 50


def _key(findings):
    return sorted((f.rule, f.path, f.line, f.col) for f in findings)


def _violations(*paths):
    out = set()
    for p in paths:
        with open(os.path.join(REPO, p)) as f:
            out |= {(p, i) for i, line in enumerate(f, 1)
                    if "VIOLATION" in line}
    return out


def _fixture_files():
    return tcore.iter_py_files([os.path.join(REPO, JAX_FIXTURES)])


@pytest.mark.parametrize("path", _fixture_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_core_reads_the_jax_suppressions(path):
    disp = os.path.relpath(path, REPO)
    j, t = jcore.Module(path, disp), tcore.Module(path, disp)
    assert t.line_disable == j.line_disable
    assert t.file_disable == j.file_disable
    assert (tcore.collect_suppressions([path], root=REPO)
            == jcore.collect_suppressions([path], root=REPO))


UNCHANGED = {
    "cli-api-parity": ["fx_cli_parity.py"],
    "exception-hygiene": ["ops/fx_exception_hygiene.py"],
    "resource-hygiene": ["runtime/fx_resource_hygiene.py",
                         "serve/fx_resource_hygiene.py"],
    "timing-hygiene": ["tsne_flink_tpu/fx_timing_hygiene.py",
                       "tsne_flink_tpu/serve/fx_timing_hygiene.py"],
    "policy-recorded": ["ops/fx_policy_recorded.py",
                        "serve/fx_policy_recorded.py"],
}


@pytest.mark.parametrize("rule", sorted(UNCHANGED))
def test_unchanged_rule_gives_the_jax_findings(rule):
    for fx in UNCHANGED[rule] + [""]:  # each fixture, then the whole tree
        paths = [os.path.join(REPO, JAX_FIXTURES, fx)]
        want, _ = jrun(paths, root=REPO, rules=[rule])
        got, _ = trun(paths, root=REPO, rules=[rule])
        assert want, f"the JAX {rule} finds nothing in {fx!r}"
        assert _key(got) == _key(want), fx


IDIOM = {
    "env-registry": ["fx_env_registry.py"],
    "host-sync": ["ops/fx_host_sync.py"],
    "dtype-drift": ["ops/fx_dtype_drift.py", "ops/metrics.py"],
    "mesh-hygiene": ["tsne_flink_tpu_torch/fx_mesh_hygiene.py"],
    "audit-contract": ["ops/fx_audit_contract.py", "models/tsne.py"],
}


@pytest.mark.parametrize("rule", sorted(IDIOM))
def test_idiom_rule_fires_exactly_at_the_seeded_violations(rule):
    files = [os.path.join(FIXTURES, f) for f in IDIOM[rule]]
    got, _ = trun([os.path.join(REPO, f) for f in files], root=REPO,
                  rules=[rule])
    assert {f.rule for f in got} == {rule}
    assert {(f.path, f.line) for f in got} == _violations(*files)


def test_host_sync_spares_python_scalars_and_follows_one_helper():
    """float()/int() of a scalar parameter or a shape is no finding; a
    hot-path call of an out-of-scope helper that reads the device is."""
    got, _ = trun([os.path.join(REPO, PORT)], root=REPO,
                  rules=["host-sync"])
    assert got == []
    tree, _ = trun([os.path.join(REPO, PORT, "ops", "attraction_cuda.py")],
                   root=REPO, rules=["host-sync"])
    assert tree == []  # float(exag) etc. at the ctypes launches
    src = os.path.join(REPO, PORT, "models", "tsne.py")
    with open(src) as f:
        text = f.read()
    assert text.count("disable=host-sync") == 2  # the two read_level sites


def test_rules_registered_and_not_applicable_declared():
    assert set(RULES) == {"env-registry", "host-sync", "dtype-drift",
                          "cli-api-parity", "audit-contract",
                          "exception-hygiene", "timing-hygiene",
                          "resource-hygiene", "mesh-hygiene",
                          "policy-recorded"}
    assert set(trules.NOT_APPLICABLE) == {"jit-hygiene", "carry-hygiene",
                                          "bench-record-contract"}
    assert set(RULES) | set(trules.NOT_APPLICABLE) == set(jcore.RULES)


def test_port_tree_is_lint_clean_and_its_suppressions_pinned():
    findings, n_files = trun([os.path.join(REPO, PORT)], root=REPO)
    assert n_files > 60
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)
    rows = tcore.collect_suppressions([os.path.join(REPO, PORT)], root=REPO)
    assert len(rows) == SUPPRESSIONS, [f"{r['path']}:{r['line']}"
                                       for r in rows]
    assert all(r["rationale"] for r in rows)


def test_contract_registry_covers_the_rule():
    """Every contract the lint rule reads is one the audit runs."""
    from tsne_flink_tpu_torch.analysis.audit.contracts import \
        declared_names
    project = tcore.load_project([os.path.join(REPO, PORT)], REPO)
    assert trules._declared_contract_names(project) == declared_names()


def test_lint_and_conc_tiers_import_no_torch():
    code = ("import sys\n"
            "import tsne_flink_tpu_torch.analysis\n"
            "import tsne_flink_tpu_torch.analysis.rules\n"
            "import tsne_flink_tpu_torch.analysis.conc\n"
            "from tsne_flink_tpu_torch.analysis.__main__ import main\n"
            "assert main(['tsne_flink_tpu_torch']) == 0\n"
            "assert main(['--conc']) == 0\n"
            "bad = [m for m in sys.modules if m == 'torch' or "
            "m.startswith('torch.') or m == 'jax' or m.startswith('jax.') "
            "or m == 'tsne_flink_tpu' or m.startswith('tsne_flink_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   capture_output=True)


def test_entry_point_json_and_exit_codes():
    r = subprocess.run(
        [sys.executable, "-m", "tsne_flink_tpu_torch.analysis", "--json",
         PORT], capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    payload = json.loads(r.stdout)
    assert payload["ok"] is True and payload["findings"] == []
    r = subprocess.run(
        [sys.executable, "-m", "tsne_flink_tpu_torch.analysis", "--json",
         os.path.join(FIXTURES, "fx_env_registry.py")],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 1
    assert any(f["rule"] == "env-registry"
               for f in json.loads(r.stdout)["findings"])
    r = subprocess.run(
        [sys.executable, "-m", "tsne_flink_tpu_torch.analysis"],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 2
    r = subprocess.run(
        [sys.executable, "-m", "tsne_flink_tpu_torch.analysis",
         "--env-table"], capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0 and "| variable |" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "tsne_flink_tpu_torch.analysis",
         "--suppressions", "--json"], capture_output=True, text=True,
        cwd=REPO)
    assert json.loads(r.stdout)["count"] == SUPPRESSIONS
