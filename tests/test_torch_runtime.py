"""PyTorch port, the run supervisor, the OOM ladder and admission vs the
JAX package (CPU).

* ``OomLadder`` takes JAX's rungs in JAX's order for the same plans and
  OOM stages (actions, before/after, budgets, exhaustion, overrides);
* ``AdmissionController.decide`` (given the same peaks), ``decide_shed``
  and ``backoff_seconds`` return JAX's answers;
* ``is_oom`` knows a CUDA out-of-memory error, cuBLAS's allocation
  failure and the injected one, and refuses a sticky CUDA error;
* the supervisor: ``oom@knn`` completes through the ladder with the kNN
  stage relaunched and no other stage; the kNN graph's width bound
  reaches the ladder's records and the fleet's hook; an affinity OOM takes the blocks
  rung and equals a run given blocks from the start, bit for bit;
  ``on_oom="fail"`` propagates; past the last rung ``LadderExhausted``;
  a clean supervised run, a traced one and ``tsne_embed`` give the same
  bits; ``nan@optimize`` is rolled back by the sentinel;
* the CLI: ``kill@optimize:seg1`` in a subprocess then ``--resume`` is
  bit identical to an uninterrupted run; ``--stageTimeout`` exits 124;
  ``--trace``/``--metricsOut``/``--profile`` write their files and change
  no bit; ``corrupt@checkpoint`` is caught with its path and hash; the
  watchdog is stopped when ``main`` returns; the estimator's
  ``fault_plan`` records the degradation.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu.runtime import admission as jadm
from tsne_flink_tpu.runtime import ladder as jladder
from tsne_flink_tpu.runtime import supervisor as jsup
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.models.tsne import TsneConfig, tsne_embed
from tsne_flink_tpu_torch.obs import trace as ttrace
from tsne_flink_tpu_torch.runtime import admission as tadm
from tsne_flink_tpu_torch.runtime import faults
from tsne_flink_tpu_torch.runtime import ladder as tladder
from tsne_flink_tpu_torch.runtime import supervisor as tsup

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D = 300, 10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_state():
    faults.activate(None)
    yield
    faults.activate(None)
    ttrace.set_enabled(None)


def problem(n=N, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(4, D)) * 5
    return c[rng.integers(0, 4, n)] + rng.normal(size=(n, D))


def small_cfg(iters=60):
    return TsneConfig(iterations=iters, perplexity=8.0, repulsion="exact")


# ---- the ladder ------------------------------------------------------------

LADDER_PLANS = [dict(n=2000, d=64, k=30),
                dict(n=100_000, d=784, k=90, sym_width=3608),
                dict(n=60_000, d=784, k=90, assembly="blocks"),
                dict(n=1_306_127, d=50, k=150, repulsion="fft")]
LADDER_STAGES = [["knn"] * 4 + ["optimize"] * 3,
                 ["affinities", "knn", "knn", "knn", "optimize"],
                 ["optimize", "affinities", "knn", "knn", "knn"]]


def _rung(d):
    if d is None:
        return None
    if d.action == "shrink-knn-tiles":
        return (d.seq, d.stage, d.action, d.before["budget"],
                d.after["budget"], d.after["source"])
    return (d.seq, d.stage, d.action, d.before, d.after)


@pytest.mark.parametrize("plan", LADDER_PLANS, ids=str)
@pytest.mark.parametrize("stages", LADDER_STAGES, ids=str)
def test_ladder_decisions_match_jax(plan, stages):
    got_l = tladder.OomLadder(PlanConfig(backend="cpu", **plan))
    want_l = jladder.OomLadder(JPlan(backend="cpu", **plan))
    for stage in stages:
        assert _rung(got_l.demote(stage)) == _rung(want_l.demote(stage))
    assert set(got_l.overrides()) == set(want_l.overrides())
    assert got_l.assembly == want_l.assembly
    assert got_l.repulsion == want_l.repulsion
    assert got_l.tile_shrinks == want_l.tile_shrinks


def test_ladder_records_the_models_peaks():
    lad = tladder.OomLadder(PlanConfig(n=100_000, d=784, k=90,
                                       backend="cuda", sym_width=3608))
    d = lad.demote("affinities")
    assert d.action == "assembly-blocks"
    assert d.peak_hbm_after < d.peak_hbm_before
    rec = lad.records()[0]
    assert rec["peak_hbm_before"] == d.peak_hbm_before


# ---- admission -------------------------------------------------------------

#: the same peaks for both packages: the decisions, not the models, are
#: what this holds (test_torch_hbm holds the models)
PEAKS = {"sorted": 700, "auto": 700, "split": 700, "blocks": 300}


@pytest.mark.parametrize("budget,in_use,assembly,degrade", [
    (None, 0, "auto", True), (1000, 0, "auto", True),
    (1000, 400, "auto", True), (1000, 400, "auto", False),
    (1000, 800, "auto", True), (1000, 400, "blocks", True),
    (650, 0, "sorted", True), (200, 0, "auto", True)])
def test_admission_decide_matches_jax(monkeypatch, budget, in_use, assembly,
                                      degrade):
    for mod in (tadm, jadm):
        monkeypatch.setattr(mod, "predicted_peak_bytes",
                            lambda plan: PEAKS[plan.assembly])
    kw = dict(n=60_000, d=784, k=90, assembly=assembly, backend="cpu")
    got = tadm.AdmissionController(budget, degrade=degrade).decide(
        PlanConfig(**kw), in_use)
    want = jadm.AdmissionController(budget, degrade=degrade).decide(
        JPlan(**kw), in_use)
    assert got.as_dict() == want.as_dict()


def test_admission_charges_the_memory_model():
    plan = PlanConfig(n=60_000, d=784, k=90, backend="cuda",
                      knn_method="bruteforce", sym_width=3474)
    from tsne_flink_tpu_torch.analysis.audit.hbm import plan_hbm_report
    peak = tadm.predicted_peak_bytes(plan)
    assert peak == plan_hbm_report(plan)["peak_hbm_est"]
    ctl = tadm.AdmissionController(peak + 10)
    assert ctl.decide(plan, 0).action == tadm.ADMIT
    got = ctl.decide(plan, 20)
    assert got.action == tadm.DEGRADE
    assert got.overrides == {"assembly": "blocks"}


@pytest.mark.parametrize("args", [(5, 2000, 256, 4, 10.0),
                                  (5, 200, 256, 4, 10.0),
                                  (3, 2000, 256, 4, 10.0),
                                  (9, 1024, 256, 0, 5.0),
                                  (12, 300, 256, 4, 7.5)])
def test_decide_shed_matches_jax(args):
    assert (tadm.decide_shed(*args).as_dict()
            == jadm.decide_shed(*args).as_dict())


@pytest.mark.parametrize("attempt,base,cap,token", [
    (0, 0.25, 30.0, "knn"), (3, 0.25, 30.0, "job-a"), (9, 0.25, 30.0, "x"),
    (2, 0.0, 30.0, "x"), (4, 1.0, 2.0, "fleet"), (1, None, None, "opt")])
def test_backoff_seconds_matches_jax(attempt, base, cap, token):
    assert tsup.backoff_seconds(attempt, base, cap, token) == (
        jsup.backoff_seconds(attempt, base, cap, token))


# ---- is_oom ----------------------------------------------------------------

@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                  "cublasCreate(handle)"), True),
    (faults.InjectedOom("affinities"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (RuntimeError("tsne_knn_f32 launch failed: CUDA error 700 (an illegal "
                  "memory access was encountered)"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
    (RuntimeError("CUDA error: misaligned address (out of memory?)"), False),
    (ValueError("k must be positive"), False)], ids=lambda v: str(v)[:40])
def test_is_oom(exc, want):
    assert tsup.is_oom(exc) is want


# ---- the supervisor --------------------------------------------------------

def _supervised(x, cfg, plan_spec=None, cache=None, on_oom="ladder",
                max_retries=2, **kw):
    faults.activate(plan_spec)
    sup = tsup.Supervisor(
        tsup.run_plan_from_fit(x.shape[0], x.shape[1], 24, cfg, "auto",
                               "bruteforce", backend="cpu"),
        max_retries=max_retries, on_oom=on_oom, retry_backoff=0.0)
    try:
        run = tsup.supervised_embed(torch.as_tensor(x), cfg, supervisor=sup,
                                    neighbors=24, seed=0, device="cpu",
                                    artifact_cache=cache, **kw)
    finally:
        faults.activate(None)
    return run, sup


def test_oom_at_knn_relaunches_the_knn_stage_only(monkeypatch):
    from tsne_flink_tpu_torch.ops import affinities, knn
    calls = {"knn": 0, "affinities": 0}
    real_knn, real_aff = knn.knn, affinities.affinity_auto

    def counted_knn(*a, **k):
        calls["knn"] += 1
        return real_knn(*a, **k)

    def counted_aff(*a, **k):
        calls["affinities"] += 1
        return real_aff(*a, **k)
    monkeypatch.setattr(knn, "knn", counted_knn)
    monkeypatch.setattr(affinities, "affinity_auto", counted_aff)
    x, cfg = problem(), small_cfg()
    run, sup = _supervised(x, cfg, "oom@knn:1")
    assert torch.isfinite(run.state.y).all()
    assert [d["action"] for d in sup.degradations] == ["shrink-knn-tiles"]
    assert [e["type"] for e in sup.events] == ["oom", "degrade", "backoff"]
    # the injected OOM fires at the stage's entry: the kNN sweep ran once,
    # in the relaunch, and the affinity stage once
    assert calls == {"knn": 1, "affinities": 1}
    assert [r["stage"] for r in sup.releases] == ["knn"]
    # the degraded plan from the start: the same bits
    clean, _ = _supervised(x, cfg)
    np.testing.assert_array_equal(run.state.y.numpy(),
                                  clean.state.y.numpy())


def test_affinity_oom_takes_blocks_equal_to_blocks_from_the_start(tmp_path):
    from tsne_flink_tpu_torch.utils.artifacts import ArtifactCache
    x, cfg = problem(), small_cfg()
    cache = ArtifactCache(str(tmp_path))
    run, sup = _supervised(x, cfg, "oom@affinities:1", cache=cache)
    assert [d["action"] for d in sup.degradations] == ["assembly-blocks"]
    blocks, _ = _supervised(x, cfg, affinity_assembly="blocks")
    np.testing.assert_array_equal(run.state.y.numpy(),
                                  blocks.state.y.numpy())
    np.testing.assert_array_equal(run.losses.numpy(), blocks.losses.numpy())


def test_on_oom_fail_propagates_and_the_ladder_exhausts():
    x, cfg = problem(), small_cfg()
    with pytest.raises(faults.InjectedOom):
        _supervised(x, cfg, "oom@knn", on_oom="fail")
    # two tile shrinks and the blocks rung, then nothing left for knn
    with pytest.raises(tsup.LadderExhausted, match="exhausted"):
        _supervised(x, cfg, "oom@knn:1,oom@knn:2,oom@knn:3,oom@knn:4",
                    max_retries=5)
    # the retry bound comes first when it is lower
    with pytest.raises(faults.InjectedOom):
        _supervised(x, cfg, "oom@knn:1,oom@knn:2", max_retries=1)


def test_optimize_oom_demotes_repulsion_from_the_last_boundary():
    x, cfg = problem(), small_cfg()
    run, sup = _supervised(x, cfg, "oom@optimize:seg2")
    assert [d["action"] for d in sup.degradations] == ["repulsion-demote"]
    relaunch = [e for e in sup.events if e["type"] == "relaunch"]
    assert relaunch == [{"type": "relaunch", "stage": "optimize",
                         "from_iter": 10, "repulsion": "bh"}]
    assert run.cfg.repulsion == "bh" and torch.isfinite(run.state.y).all()


def test_clean_supervised_run_is_tsne_embeds_bits_traced_or_not():
    x, cfg = problem(), small_cfg()
    y0, l0 = tsne_embed(torch.as_tensor(x), cfg, neighbors=24, seed=0,
                        device="cpu")
    run, sup = _supervised(x, cfg)
    assert sup.events == [] and sup.degradations == []
    np.testing.assert_array_equal(run.state.y.numpy(), y0.numpy())
    np.testing.assert_array_equal(run.losses.numpy(), l0.numpy())
    i0 = ttrace.event_count()
    with ttrace.collecting():
        traced, _ = _supervised(x, cfg)
    names = {e["name"] for e in ttrace.events_since(i0)}
    assert {"prepare.knn", "prepare.affinities", "knn.exact_sweep",
            "optimize.segment"} <= names
    np.testing.assert_array_equal(traced.state.y.numpy(), y0.numpy())


def test_the_supervisor_charges_the_graphs_width_bound():
    from tsne_flink_tpu_torch.analysis.audit.hbm import charged_peak_bytes
    from tsne_flink_tpu_torch.ops.affinities import width_bound
    from tsne_flink_tpu_torch.ops.knn import knn
    x, cfg = problem(), small_cfg()
    seen = []
    faults.activate("oom@affinities:1")
    plan = tsup.run_plan_from_fit(N, D, 24, cfg, "auto", "bruteforce",
                                  backend="cpu")
    sup = tsup.Supervisor(plan, retry_backoff=0.0, on_width=seen.append)
    try:
        tsup.supervised_embed(torch.as_tensor(x), cfg, supervisor=sup,
                              neighbors=24, seed=0, device="cpu")
    finally:
        faults.activate(None)
    want = width_bound(knn(torch.as_tensor(x), 24, "bruteforce")[0])
    # reported once a kNN stage ends: the relaunch reports it again
    assert sup.width_bound == want and seen == [want, want]
    assert sup.ladder.width == want and sup.ladder.plan.sym_width is None
    (deg,) = sup.degradations
    at = PlanConfig(**{**plan.as_dict(), "sym_width": want})
    assert deg["peak_hbm_before"] == charged_peak_bytes(at)
    assert deg["peak_hbm_after"] == charged_peak_bytes(
        PlanConfig(**{**plan.as_dict(), "assembly": "blocks"}))
    # nothing asks for the bound: nothing is read
    bare = tsup.Supervisor(None)
    tsup.supervised_embed(torch.as_tensor(x), cfg, supervisor=bare,
                          neighbors=24, seed=0, device="cpu")
    assert bare.width_bound is None


def test_a_pinned_width_plans_the_sorted_layout():
    cfg = small_cfg()
    plan = tsup.run_plan_from_fit(N, D, 24, cfg, "auto", "bruteforce",
                                  sym_width=64, backend="cpu")
    assert (plan.assembly, plan.sym_width) == ("sorted", 64)
    free = tsup.run_plan_from_fit(N, D, 24, cfg, "auto", "bruteforce",
                                  backend="cpu")
    assert (free.assembly, free.sym_width) == ("auto", None)


def test_nan_at_optimize_is_rolled_back_by_the_sentinel():
    x, cfg = problem(), small_cfg()
    faults.activate("nan@optimize:seg2")
    sup = tsup.Supervisor(None, health_check=True)
    try:
        i0 = ttrace.event_count()
        with ttrace.collecting():
            run = tsup.supervised_embed(torch.as_tensor(x), cfg,
                                        supervisor=sup, neighbors=24,
                                        device="cpu")
        inj = faults.injector()
        assert inj.log == [("nan", "optimize", "seg2")]
    finally:
        faults.activate(None)
    rb = [e for e in sup.events if e["type"] == "sentinel-rollback"]
    assert len(rb) == 1 and rb[0]["segment_start"] == 10
    assert torch.isfinite(run.state.y).all()
    assert run.cfg.learning_rate == cfg.learning_rate / 2
    assert "sentinel.rollback" in {e["name"]
                                   for e in ttrace.events_since(i0)}


# ---- the CLI and the estimator ---------------------------------------------

def _csv(tmp_path, n=N):
    x = problem(n)
    path = tmp_path / "in.csv"
    path.write_text("".join(f"{i},{j},{float(x[i, j])!r}\n"
                            for i in range(n) for j in range(D)))
    return str(path)


def _argv(tmp_path, inp, out, *extra):
    return ["--input", inp, "--output", str(tmp_path / out), "--dimension",
            str(D), "--knnMethod", "bruteforce", "--perplexity", "8",
            "--iterations", "60", "--noCache",
            "--loss", str(tmp_path / (out + ".loss")), *extra]


def _subprocess_main(argv, timeout=240):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tsne_flink_tpu_torch.utils.cli import main\n"
            "main(%r, device='cpu')\n") % (ROOT, argv)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout)


def test_cli_kill_then_resume_is_bit_identical(tmp_path):
    from tsne_flink_tpu_torch.utils.cli import main
    inp = _csv(tmp_path)
    ck = str(tmp_path / "ck.npz")
    got = _subprocess_main(_argv(tmp_path, inp, "killed.csv",
                                 "--checkpoint", ck, "--checkpointEvery",
                                 "20", "--fatCheckpoint", "--faultPlan",
                                 "kill@optimize:seg1"))
    assert got.returncode == -9, got.stderr[-2000:]
    assert os.path.exists(ck) and not os.path.exists(tmp_path / "killed.csv")
    main(_argv(tmp_path, inp, "resumed.csv", "--resume", ck), device="cpu")
    main(_argv(tmp_path, inp, "whole.csv"), device="cpu")
    assert ((tmp_path / "resumed.csv").read_text()
            == (tmp_path / "whole.csv").read_text())
    assert ((tmp_path / "resumed.csv.loss").read_text()
            == (tmp_path / "whole.csv.loss").read_text())


def test_cli_stage_timeout_exits_124(tmp_path):
    inp = _csv(tmp_path)
    got = _subprocess_main(_argv(tmp_path, inp, "o.csv", "--stageTimeout",
                                 "0.001"))
    assert got.returncode == 124, got.stderr[-2000:]
    assert "watchdog: stage timeout" in got.stderr
    assert not os.path.exists(tmp_path / "o.csv")


def test_cli_obs_flags_write_files_and_change_no_bit(tmp_path):
    from tsne_flink_tpu_torch.utils.cli import main
    inp = _csv(tmp_path)
    main(_argv(tmp_path, inp, "plain.csv"), device="cpu")
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    main(_argv(tmp_path, inp, "traced.csv", "--trace", trace, "--metricsOut",
               metrics, "--profile", str(tmp_path / "prof"), "--telemetry",
               "--jobTimeout", "3600", "--noAotCache"), device="cpu")
    assert ((tmp_path / "plain.csv").read_text()
            == (tmp_path / "traced.csv").read_text())
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert {"cli.run", "prepare.knn", "prepare.affinities",
            "knn.exact_sweep", "optimize.segment"} <= names
    snap = json.load(open(metrics))
    assert snap["schema"] == 1 and "telemetry.grad_norm" in snap["gauges"]
    assert os.listdir(tmp_path / "prof")
    # main() restored the process: tracer off, no watchdog thread left
    assert not ttrace.enabled()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("watchdog-")]
    from tsne_flink_tpu_torch.kernels.build import cache_enabled
    assert cache_enabled() is None


def test_corrupt_checkpoint_is_caught_with_path_and_hash(tmp_path):
    from tsne_flink_tpu_torch.models.tsne import TsneState
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    st = TsneState(y=np.ones((50, 2)), update=np.zeros((50, 2)),
                   gains=np.ones((50, 2)))
    path = str(tmp_path / "c.npz")
    faults.activate("corrupt@checkpoint")
    ckpt.save(path, st, 10, np.zeros(3))
    assert faults.injector().log == [("corrupt", "checkpoint", "1")]
    faults.activate(None)
    with pytest.raises(ckpt.CheckpointCorrupt) as e:
        ckpt.load(path)
    # the zip's CRC or the content hash catches the flip; either way the
    # error names the file and the content hash it was written with
    assert path in str(e.value)
    assert e.value.expected_hash and e.value.expected_hash in str(e.value)


def test_estimator_fault_plan_records_the_degradation():
    from tsne_flink_tpu_torch import TSNE
    x = problem()
    plain = TSNE(device="cpu", n_iter=60, perplexity=8).fit(x)
    est = TSNE(device="cpu", n_iter=60, perplexity=8,
               fault_plan="oom@knn").fit(x)
    assert [d["action"] for d in est.degradations_] == ["shrink-knn-tiles"]
    assert [e["type"] for e in est.runtime_events_] == [
        "oom", "degrade", "backoff"]
    np.testing.assert_array_equal(est.embedding_, plain.embedding_)
    assert {"prepare.knn", "supervisor.oom"} <= {
        e["name"] for e in est.trace_}
    assert est.metrics_["counters"]["runtime.oom"] >= 1
    assert plain.runtime_events_ == [] and plain.degradations_ == []
    assert faults.injector() is None  # the fit's plan ends with it
    with pytest.raises(faults.InjectedOom):
        TSNE(device="cpu", n_iter=60, perplexity=8, on_oom="fail",
             fault_plan="oom@knn").fit(x)


def test_estimator_keeps_its_events_when_the_sentinel_gives_up():
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.runtime.health import DivergenceError
    est = TSNE(device="cpu", n_iter=60, perplexity=8, learning_rate=1e30,
               health_check=True)
    x = problem().astype(np.float32)
    with pytest.raises(DivergenceError):
        est.fit(x)
    etas = [e["eta_after"] for e in est.runtime_events_]
    assert etas == [5e29, 2.5e29, 1.25e29]
