"""What ``tests/test_torch_audit.py`` and ``tests/test_torch_audit_mesh.py``
share: loading a seeded fixture of ``tests/torch_audit_fixtures/``, the
lines it marks ``# VIOLATION``, and running an audit that must end."""

import importlib.util
import os
import threading

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_audit_fixtures")


def fixture(name):
    """The fixture module ``name`` (loaded by path: not a package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def violations(name, func=None):
    """The 1-based lines marked ``VIOLATION`` in fixture ``name`` (within
    the top-level function ``func`` when given)."""
    with open(os.path.join(FIXTURES, name + ".py")) as f:
        lines = f.read().splitlines()
    lo, hi = 0, len(lines)
    if func is not None:
        lo = next(i for i, s in enumerate(lines) if s.startswith(
            f"def {func}("))
        hi = next((i for i in range(lo + 1, len(lines))
                   if lines[i].startswith("def ")), len(lines))
    return {i + 1 for i in range(lo, hi) if "VIOLATION" in lines[i]}


def run_guarded(fn, seconds=60.0):
    """``fn()`` in a thread that must end within ``seconds`` (a mismatch
    must raise, never hang)."""
    out = {}

    def work():
        out["value"] = fn()
    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the audit hung"
    return out["value"]
