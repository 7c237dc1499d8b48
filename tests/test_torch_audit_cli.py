"""The analysis tier's command-line surfaces of the port, on the CPU.

* ``--auditPlan`` prints the JAX gate's lines (peak and stage, budget,
  per-stage terms, determinism, comms) and carries the JAX summary keys
  in the v2 checkpoint's ``audit``; a predicted OOM (the budget patched
  to 1 MiB) is refused with the JAX message before the kNN stage, and
  ``=warn`` launches; without ``--symWidth`` a hub-heavy plan the
  pre-read gate passes is re-checked at the graph's width bound after
  the kNN stage and refused before the affinities, on both routes; a
  resumed run's drifted prediction warns;
* ``--executionPlan`` writes ``tsne_executionPlan.json`` (program,
  backend, devices, ``ops``: the CSR run's B2 and B3, then B4 on the KL
  pass) and no CSV nor checkpoint, and refuses ``blocks``;
  ``SpmdPipeline.lower`` records the sharded prepare and one iteration;
* the two-process gloo job issues one sequence of collectives a rank;
* ``python -m tsne_flink_tpu_torch.analysis --audit`` raises without a
  card, and refuses a ``tpu`` plan by name.
"""

import json
import os

import numpy as np
import pytest
import torch

from tsne_flink_tpu_torch.analysis.__main__ import main as analysis_main
from tsne_flink_tpu_torch.analysis.audit import sharding
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.analysis.audit.record import kernel_steps
from tsne_flink_tpu_torch.utils import cli as tcli
from tsne_flink_tpu_torch.utils import checkpoint as ckpt

pytestmark = pytest.mark.fast

N, D = 200, 6


@pytest.fixture(scope="module")
def coo(tmp_path_factory):
    rng = np.random.default_rng(0)
    centers = rng.normal(0.0, 8.0, (4, D))
    x = centers[rng.integers(0, 4, N)] + rng.normal(size=(N, D))
    path = tmp_path_factory.mktemp("audit_cli") / "in.csv"
    with open(path, "w") as f:
        f.writelines(f"{i},{j},{float(x[i, j])!r}\n" for i in range(N)
                     for j in range(D))
    return str(path)


def _argv(coo, tmp_path, *extra):
    return ["--input", coo, "--output", str(tmp_path / "o.csv"),
            "--dimension", str(D), "--knnMethod", "bruteforce",
            "--perplexity", "6", "--iterations", "40", "--noCache",
            "--loss", str(tmp_path / "loss.txt"), *extra]


#: the JAX gate's summary keys (``tsne_flink_tpu/utils/cli.py``)
JAX_SUMMARY_KEYS = {"peak_hbm_est", "peak_stage", "hbm_budget", "ok",
                    "compile_count", "determinism", "comms"}


def test_audit_plan_prints_the_gate_and_rides_the_checkpoint(coo, tmp_path,
                                                            capsys):
    ck = str(tmp_path / "ck.npz")
    assert tcli.main(_argv(coo, tmp_path, "--auditPlan", "--checkpoint", ck,
                           "--checkpointEvery", "20"), device="cpu") == 0
    out = capsys.readouterr().out
    for key in ("# auditPlan: peak HBM est", "# auditPlan:   knn:",
                "# auditPlan:   affinities:", "# auditPlan:   optimize:",
                "# auditPlan: plan: knn_method=bruteforce",
                "# auditPlan: determinism: 0 unblessed",
                "# auditPlan: comms: mode canonical"):
        assert key in out, key
    payload = ckpt.load_resume(ck)[3]
    summary = json.loads(str(payload["audit"]))
    assert set(summary) == JAX_SUMMARY_KEYS
    assert summary["compile_count"] == 0 and summary["ok"] is True


def test_audit_plan_refuses_a_predicted_oom_before_the_knn(coo, tmp_path,
                                                           monkeypatch,
                                                           capsys):
    from tsne_flink_tpu_torch.utils import artifacts
    monkeypatch.setattr(PlanConfig, "hbm_budget", lambda self: 1 << 20)

    def no_prepare(*a, **k):
        raise AssertionError("the kNN stage ran")
    monkeypatch.setattr(artifacts, "prepare", no_prepare)
    with pytest.raises(SystemExit, match="plan predicted to OOM: peak HBM "
                       "estimate .* exceeds the 0.00 GiB device budget.*"
                       "--auditPlan=warn"):
        tcli.main(_argv(coo, tmp_path, "--auditPlan"), device="cpu")
    assert not (tmp_path / "o.csv").exists()
    monkeypatch.undo()
    monkeypatch.setattr(PlanConfig, "hbm_budget", lambda self: 1 << 20)
    assert tcli.main(_argv(coo, tmp_path, "--auditPlan=warn"),
                     device="cpu") == 0
    assert "launching anyway (--auditPlan=warn)" in capsys.readouterr().err
    assert (tmp_path / "o.csv").exists()


#: the hub-and-spoke points of the width re-check (C5): unit spokes in 64
#: dimensions, the hub at the origin the nearest point of every spoke
N_HUB, D_HUB, K_HUB = 600, 64, 18


def _hub_points():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_HUB, D_HUB))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[0] = 0.0
    return x.astype(np.float32)


def _hub_budget(mesh: int = 1):
    """(budget, width bound): a budget the pre-read gate's plan (rows of
    2k) fits and the plan at the graph's width bound does not."""
    from dataclasses import replace

    from tsne_flink_tpu_torch.analysis.audit.hbm import plan_hbm_report
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.ops.knn import knn
    w = width_bound(knn(torch.from_numpy(_hub_points()), K_HUB,
                        "bruteforce")[0])
    plan = PlanConfig(n=N_HUB, d=D_HUB, k=K_HUB, backend="cpu",
                      knn_method="bruteforce", mesh=mesh)
    given = plan_hbm_report(plan)["peak_hbm_est"]
    at_w = plan_hbm_report(replace(plan, sym_width=w))
    assert at_w["peak_stage"] == "affinities" and at_w["peak_hbm_est"] > \
        2 * given
    return (given + at_w["peak_hbm_est"]) // 2, w


def test_audit_plan_rechecks_at_the_width_bound_after_the_knn(
        tmp_path, monkeypatch, capsys):
    """C5: without --symWidth the pre-read gate charges rows of 2k, so a
    hub-heavy plan passes it; once the kNN stage ends the plan is charged
    at the graph's width bound, the width printed, and refused before any
    affinity work.  A pinned --symWidth runs no re-check."""
    from tsne_flink_tpu_torch.ops import affinities as aff
    budget, w = _hub_budget()
    assert w > 2 * K_HUB
    x = _hub_points()
    coo = tmp_path / "hub.csv"
    with open(coo, "w") as f:
        f.writelines(f"{i},{j},{float(x[i, j])!r}\n" for i in range(N_HUB)
                     for j in range(D_HUB))
    argv = ["--input", str(coo), "--output", str(tmp_path / "o.csv"),
            "--dimension", str(D_HUB), "--knnMethod", "bruteforce",
            "--perplexity", str(K_HUB // 3), "--iterations", "30",
            "--noCache", "--loss", str(tmp_path / "loss.txt")]
    monkeypatch.setattr(PlanConfig, "hbm_budget", lambda self: budget)

    def no_affinities(*a, **k):
        raise AssertionError("the affinities stage ran")
    for name in ("affinity_auto", "affinity_blocks", "affinity_pipeline"):
        monkeypatch.setattr(aff, name, no_affinities)
    with pytest.raises(SystemExit, match="plan predicted to OOM: peak HBM "
                       "estimate .* in the 'affinities' stage exceeds .*"
                       "--auditPlan=warn"):
        tcli.main([*argv, "--auditPlan"], device="cpu")
    out = capsys.readouterr().out
    assert "# auditPlan: gate" in out  # the pre-read gate let it through
    assert f"# auditPlan: after kNN: width bound {w}: peak HBM est" in out
    assert not (tmp_path / "o.csv").exists()
    # a pinned width: no re-check, and the run goes on
    monkeypatch.undo()
    monkeypatch.setattr(PlanConfig, "hbm_budget", lambda self: budget)
    assert tcli.main([*argv, "--auditPlan", "--symWidth", str(2 * K_HUB)],
                     device="cpu") == 0
    assert "after kNN" not in capsys.readouterr().out


def test_spmd_recheck_refuses_on_every_shard(monkeypatch, capsys):
    """The multi-controller route's re-check: each shard gathers the
    global graph's width bound once the ring ends and refuses before the
    affinities."""
    import argparse

    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.parallel import pipeline as pl
    budget, w = _hub_budget(mesh=2)
    monkeypatch.setattr(PlanConfig, "hbm_budget", lambda self: budget)

    def no_affinities(*a, **k):
        raise AssertionError("the affinities stage ran")
    monkeypatch.setattr(pl, "pairwise_affinities", no_affinities)
    plan = PlanConfig(n=N_HUB, d=D_HUB, k=K_HUB, backend="cpu",
                      knn_method="bruteforce", mesh=2)
    pipe = pl.SpmdPipeline(
        cases.config(iterations=30), N_HUB, D_HUB, K_HUB,
        knn_method="bruteforce", devices=["cpu"] * 2,
        on_graph=tcli._spmd_recheck(argparse.Namespace(auditPlan=True),
                                    plan, True))
    with pytest.raises(SystemExit, match="plan predicted to OOM"):
        pipe.prepare(torch.from_numpy(_hub_points()))
    assert f"after kNN: width bound {w}:" in capsys.readouterr().out


def test_resumed_drift_warns(capsys):
    import argparse
    plan = PlanConfig(n=60_000, d=784, backend="cpu")
    args = argparse.Namespace(checkpointEvery=0)
    tcli.check_resumed_audit(args, plan, {"audit": json.dumps(
        {"peak_hbm_est": 1 << 20, "ok": True})})
    assert "config drift between save and resume" in capsys.readouterr().err
    tcli.check_resumed_audit(args, plan, {})
    assert capsys.readouterr().err == ""


def test_execution_plan_writes_json_and_no_csv(coo, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    ck = tmp_path / "ck.npz"
    assert tcli.main(_argv(coo, tmp_path, "--executionPlan", "--attraction",
                           "csr", "--checkpoint", str(ck)),
                     device="cpu") == 0
    assert "assembly auto resolves to sorted" in capsys.readouterr().err
    with open(tmp_path / "tsne_executionPlan.json") as f:
        plan = json.load(f)
    assert {"program", "backend", "devices", "ops"} <= set(plan)
    assert (plan["program"], plan["backend"], plan["devices"]) == (
        "tsne_optimize", "cpu", 1)
    steps = kernel_steps(plan["ops"])
    assert steps[:2] == ["B2", "B3"] and steps[-1] == "B4"
    assert {r["section"] for r in plan["ops"]} == {"iteration", "kl_pass"}
    assert not (tmp_path / "o.csv").exists() and not ck.exists()
    with pytest.raises(SystemExit, match="--affinityAssembly blocks does "
                       "not lower an execution plan"):
        tcli.main(_argv(coo, tmp_path, "--executionPlan",
                        "--affinityAssembly", "blocks"), device="cpu")


def test_spmd_pipeline_lower_records_prepare_and_one_iteration():
    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    cfg = cases.config(iterations=30, repulsion="exact")
    pipe = SpmdPipeline(cfg, cases.N, cases.D, cases.K,
                        knn_method="bruteforce", sym_width=48,
                        devices=["cpu"] * 2)
    plan = pipe.lower(torch.as_tensor(cases.blobs()), 0)
    assert (plan["program"], plan["backend"], plan["devices"]) == (
        "tsne_spmd_pipeline", "cpu", 2)
    steps = kernel_steps(plan["ops"])
    assert steps[0] == "B1" and "B2" in steps
    assert any("collective" in r for r in plan["ops"])
    iters = {r["iteration"] for r in plan["ops"]} - {None}
    assert iters == {0}
    assert pipe.cfg is cfg and pipe._runner is None


def test_two_process_gloo_job_issues_one_sequence():
    found, report = sharding.process_job("cpu")
    assert found == [], [f.format() for f in found]
    assert report["ranks"] == 2 and report["per_rank"] > 10


def test_audit_entry_needs_the_card_and_refuses_a_tpu_plan(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            analysis_main(["--audit", "--analyzers", "hbm-footprint"])
    spec = PlanConfig(n=1000, d=8, backend="cpu").as_dict()
    spec.update(backend="tpu", name="jax-plan")
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(SystemExit, match="backend 'tpu'"):
        analysis_main(["--audit", "--device", "cpu", "--plan", str(path)])
    assert analysis_main(["--audit", "--device", "cpu", "--analyzers",
                          "hbm-footprint,compile-audit"]) == 0
