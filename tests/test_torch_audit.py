"""The port's graftcheck (``tsne_flink_tpu_torch/analysis/audit``) on the
CPU: recorded tiny runs instead of the JAX package's abstract traces.

* ``audit_hbm`` gives the JAX findings on the committed 1M plans (the JAX
  budget), the JAX terms equal at rtol 1e-12 (as ``test_torch_hbm.py``);
* the recorder sees every shard's ops and collectives under the thread
  mesh, and on the CPU names the kernels' plain versions;
* determinism is clean at mesh 1, 2 and 4 (every optimize variant, the
  transform) and flags the seeded fixture at its lines, without hanging;
* the dtype contracts hold on the CPU, the float64 / bf16 scans fire on a
  seeded run, and the compile audit counts no library load on the CPU.
"""

import json
import math
import os

import pytest
import torch

from tsne_flink_tpu.analysis.audit import hbm as jhbm
from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu_torch.analysis.audit import (cases, contracts,
                                                 determinism, dtype)
from tsne_flink_tpu_torch.analysis.audit import compile as comp
from tsne_flink_tpu_torch.analysis.audit import hbm as thbm
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.analysis.audit.record import Recorder
from tsne_flink_tpu_torch.parallel.mesh import run_shards
from torch_audit_helpers import fixture, run_guarded, violations

pytestmark = pytest.mark.fast

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
AUDIT_FIXTURES = os.path.join(REPO, "tests", "audit_fixtures")


def _key(findings):
    return sorted((f.rule, f.path, f.line, f.col) for f in findings)


# ---- hbm-footprint ----------------------------------------------------------

@pytest.mark.parametrize("name", ["plan_1m_prefix_sorted", "plan_1m_blocks",
                                  "plan_1m_blocks_v5e8"])
def test_audit_hbm_gives_the_jax_findings(name, monkeypatch):
    with open(os.path.join(AUDIT_FIXTURES, name + ".json")) as f:
        spec = json.load(f)
    jplan = JPlan.from_dict(spec)
    want, jrep = jhbm.audit_hbm([jplan])
    budget = jrep[jplan.name]["hbm_budget"]
    plan = PlanConfig.from_dict(dict(spec, backend="cpu"))
    monkeypatch.setattr(PlanConfig, "hbm_budget", lambda self: budget)
    got, rep = thbm.audit_hbm([plan])
    assert _key(got) == _key(want)
    assert rep[plan.name]["ok"] == jrep[jplan.name]["ok"]
    # the JAX terms, at rtol 1e-12 (the port adds terms of its own)
    jcpu = JPlan.from_dict(dict(spec, backend="cpu"))
    terms = thbm.stage_terms(plan)
    for stage, fn in (("knn", jhbm._knn_stage),
                      ("affinities", jhbm._affinity_stage),
                      ("optimize", jhbm._optimize_stage)):
        for t, v in fn(jcpu).items():
            if t == "peak" or isinstance(v, str):
                continue
            assert math.isclose(terms[stage][t], v, rel_tol=1e-12), (stage,
                                                                     t)


# ---- the recorder -----------------------------------------------------------

def test_recorder_sees_every_shard_under_the_thread_mesh():
    events = determinism.optimize_events("cpu", cases.VARIANTS[0], 4)
    for kind in ("aten", "collective"):
        assert {e["shard"] for e in events if e["kind"] == kind} >= {0, 1, 2,
                                                                     3}
    # shard r's collectives are made on its own index of a width-4 axis
    for e in events:
        if e["kind"] == "collective":
            assert e["size"] == 4 and e["index"] == e["shard"]
    # the CPU runs the plain versions, named after their kernels
    plain = {e.get("plain_of") for e in events if e["kind"] == "aten"}
    assert {"B2", "B3"} <= plain
    assert not [e for e in events if e["kind"] == "kernel"]
    assert {e["iteration"] for e in events if e["kind"] == "collective"} \
        >= {8, 9, None}


# ---- determinism-audit ------------------------------------------------------

@pytest.mark.parametrize("mesh", [1, 2, 4])
def test_determinism_clean_at_mesh(mesh):
    for variant in cases.VARIANTS:
        events = determinism.optimize_events("cpu", variant, mesh)
        found, blessed = determinism.scan_events(events, variant[0])
        assert found == [], [f.format() for f in found]
        if mesh > 1:
            assert "_mesh_count (models/tsne.py)" in blessed
    for repulsion in ("exact", "fft"):
        found, _ = determinism.scan_events(
            determinism.transform_events("cpu", repulsion), repulsion)
        assert found == []


def test_determinism_flags_the_seeded_fixture():
    fx = fixture("fx_determinism")

    def run():
        with Recorder() as rec:
            run_shards(["cpu"] * 2, fx.shard_fn)
        return determinism.scan_events(rec.events, "fx")
    found, _ = run_guarded(run)
    path = "tests/torch_audit_fixtures/fx_determinism.py"
    assert {f.path for f in found} == {path}
    assert {f.line for f in found} == violations("fx_determinism")


# ---- dtype-contract, compile-audit ------------------------------------------

def test_dtype_contracts_hold_on_the_cpu():
    found, report = dtype.audit_dtype("cpu")
    assert found == [], [f.format() for f in found]
    assert set(report) == set(contracts.REGISTRY)


def test_dtype_scans_fire_on_a_seeded_run():
    with Recorder() as rec:
        (torch.ones(3) * 2).double().sum()
        torch.ones(2, dtype=torch.bfloat16) + 1
    found = dtype.scan_events(rec.events, "fx", "fx.py")
    assert len(found) == 2
    assert "float64" in found[0].message and "bfloat16" in found[1].message


def _bf16_fixture(leak: bool, widen: bool = False):
    """A seeded product op for the bf16 pass: ``leak`` multiplies one
    operand that bypassed ``ops/metrics.matmul_operands``; ``widen``
    returns the bf16 copy itself (bf16 leaking out of the op)."""
    from tsne_flink_tpu_torch.ops.metrics import matmul_operands

    def make(device, matmul_dtype=None):
        g = torch.Generator().manual_seed(4)
        x = torch.randn((32, 12), generator=g).to(device)

        def fn(a, b):
            am, bm = matmul_operands(a, b, matmul_dtype)
            if widen and matmul_dtype is not None:
                return a.to(matmul_dtype)
            return am @ (b if leak else bm).T
        return fn, (x[:8], x)
    return contracts.OpContract("fx.bf16", "fx.py", ("float32",), make,
                                matmul_dim=12)


def test_dtype_bf16_pass_finds_a_leak_and_a_widened_output():
    """The JAX bf16-leak case: under bf16 operands a float32 product over
    the feature axis whose operand bypassed matmul_operands is found; a
    bf16 output is an output dtype change and bf16 off the blessed cast;
    the clean op passes, and its f32 run holds no bf16 at all."""
    found, rep = dtype.audit_contract(_bf16_fixture(leak=False), "cpu")
    assert found == [] and rep["bf16_checked"]
    assert rep["bf16_products"] == 1
    found, _ = dtype.audit_contract(_bf16_fixture(leak=True), "cpu")
    assert len(found) == 1 and "off the bf16 grid" in found[0].message
    found, _ = dtype.audit_contract(_bf16_fixture(leak=False, widen=True),
                                    "cpu")
    msgs = " | ".join(f.message for f in found)
    assert "output dtypes change" in msgs
    assert "outside ops/metrics.matmul_operands" in msgs


def test_compile_counts_no_library_on_the_cpu():
    found, report = comp.audit_compile(
        [PlanConfig(n=60_000, d=784, name="card"),
         PlanConfig(n=60_000, d=784, backend="cpu", name="cpu")], "cpu")
    assert found == []
    assert [p["compile_count"] for p in report["plans"].values()] == [1, 0]
    assert report["segmented_run"]["loads"] == 0
    assert report["segmented_run"]["boundaries"] == [5, 10, 15]
