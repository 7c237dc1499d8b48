"""PyTorch port, the job fleet and the kernel library's build lock (CPU).

* three tiny jobs under a budget that admits two: the third queues, the
  sum of the predicted peaks stays within the budget at every admission,
  every job is re-admitted once at its graph's width bound with a charge
  that falls, and every job's embedding equals its solo run (a fresh
  process of the same entry point) bit for bit;
* ``kill@job:1`` SIGKILLs job 1's first attempt, which retries once and
  ends with the solo run's bits; the fleet record counts it;
* a job that would fit only degraded waits while a running job's charge
  may still fall, then runs whole;
* ``main`` takes exactly one of ``--job`` / ``--serve`` /
  ``--serve-fleet`` (the serve modes: tests/test_torch_replicas.py), and
  a JobSpec round-trips through JSON with its ``fleet`` and ``device``;
* two processes building the kernel library at once with a stand-in
  compiler: one builds, both load the same file.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tsne_flink_tpu_torch.runtime import fleet as tfleet
from tsne_flink_tpu_torch.runtime.admission import predicted_peak_bytes

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _input(tmp_path, n=240, d=8, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(4, d)) * 4
    x = (c[rng.integers(0, 4, n)] + rng.normal(size=(n, d))).astype(
        np.float32)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    return path


def _jobs(inp, count=3):
    return [tfleet.JobSpec(name=f"j{i}", input=inp, iterations=40,
                           perplexity=6.0, seed=i, device="cpu")
            for i in range(count)]


def _solo(tmp_path, spec):
    """The job alone, in a fresh process of the fleet's entry point."""
    solo = tfleet.JobSpec.from_dict({**spec.as_dict(), "name": "solo",
                                     "out": str(tmp_path / "solo.npy"),
                                     "record": "", "fault_plan": None})
    path = solo.save(str(tmp_path / "solo.json"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    got = subprocess.run([sys.executable, "-m",
                          "tsne_flink_tpu_torch.runtime.fleet", "--job",
                          path], capture_output=True, text=True, env=env,
                         timeout=240)
    assert got.returncode == 0, got.stderr[-2000:]
    return np.load(solo.out)


def test_fleet_queues_over_budget_and_retries_a_killed_job(tmp_path):
    inp = _input(tmp_path)
    jobs = _jobs(inp)
    peak = predicted_peak_bytes(tfleet.job_plan(jobs[0]))
    budget = 2 * peak
    rec = tfleet.Fleet(jobs, str(tmp_path / "fleet"), budget_bytes=budget,
                       fault_plan="kill@job:1", backoff_base=0.0,
                       retries=1).run()
    fl = rec["fleet"]
    assert fl["backend"] == "cpu" and fl["budget_bytes"] == budget
    assert fl["completed"] == 3 and fl["failed"] == 0
    # two at the first charge; the third joins once a charge falls to its
    # graph's width bound or a job ends
    assert fl["max_running"] >= 2 and fl["queue_depth_max"] >= 1
    assert fl["admission_rejections"] >= 1 and fl["retries"] == 1
    for _, in_use, p in rec["admissions"]:
        assert in_use + p <= budget
    # one re-admission a job: the killed job's retry is admitted at the
    # width its first attempt reported
    readmit = rec["readmissions"]
    assert sorted(r["job"] for r in readmit) == ["j0", "j1", "j2"]
    assert fl["readmissions"] == 3
    for r in readmit:
        assert r["attempt"] == 1 and r["after"] < r["before"] == peak
        assert r["in_use"] <= budget
    by = {j["name"]: j for j in rec["jobs"]}
    assert by["j1"]["attempts"] == 2 and by["j0"]["attempts"] == 1
    assert rec["chaos"] == [{"clause": "kill@job:1", "job": "j1",
                             "attempt": 1,
                             "injected": "kill@optimize:seg1"}]
    r1 = by["j1"]["record"]
    assert r1["status"] == "ok" and r1["fleet"]["attempt"] == 2
    # the retry reports nothing, and its graph gives the same bound
    widths = {r["job"]: r["sym_width"] for r in readmit}
    assert r1["fleet"]["width_path"] == ""
    assert r1["width_bound"] == widths["j1"]
    assert by["j0"]["record"]["width_bound"] == widths["j0"]
    assert r1["faults_fired"] == [] and r1["backend"] == "cpu"
    assert rec["metrics"]["counters"]["fleet.retries"] >= 1
    assert "fleet.queue_depth" in rec["metrics"]["gauges"]
    # the killed-and-retried job and a survivor equal their solo runs
    for name in ("j1", "j2"):
        spec = next(j for j in jobs if j.name == name)
        np.testing.assert_array_equal(np.load(by[name]["out"]),
                                      _solo(tmp_path, spec))


def test_a_job_waits_for_readmissions_rather_than_degrade(tmp_path):
    from dataclasses import replace
    inp = _input(tmp_path, n=200)
    jobs = _jobs(inp)
    plan = tfleet.job_plan(jobs[0])
    peak = predicted_peak_bytes(plan)
    blocks = predicted_peak_bytes(replace(plan, assembly="blocks"))
    # the third fits degraded beside two first charges, and whole once
    # they fall
    budget = 2 * peak + blocks
    rec = tfleet.Fleet(jobs, str(tmp_path / "fleet"), budget_bytes=budget,
                       backoff_base=0.0).run()
    # the record counts this run only, whatever ran before it
    assert rec["fleet"]["completed"] == 3 and rec["fleet"]["retries"] == 0
    assert [j["decision"]["action"] for j in rec["jobs"]] == ["admit"] * 3
    assert all(j["record"]["degradations"] == [] for j in rec["jobs"])
    assert sorted(r["job"] for r in rec["readmissions"]) == [
        "j0", "j1", "j2"]
    for _, in_use, p in rec["admissions"]:
        assert in_use + p <= budget


def test_fleet_refuses_an_unschedulable_job(tmp_path):
    inp = _input(tmp_path, n=120)
    rec = tfleet.Fleet(_jobs(inp, 1), str(tmp_path / "f"), budget_bytes=10,
                       backoff_base=0.0).run()
    job = rec["jobs"][0]
    assert job["status"] == "failed" and job["attempts"] == 0
    assert rec["fleet"]["failed"] == 1


def test_main_takes_exactly_one_mode(tmp_path):
    with pytest.raises(SystemExit):
        tfleet.main([])
    with pytest.raises(SystemExit):
        tfleet.main(["--serve", "a.json", "--serve-fleet", "b.json"])
    # --serve-fleet runs a fleet: one replica, an empty spool, an idle exit
    spec = tfleet.ServeFleetSpec(
        name="idle", spool=str(tmp_path / "spool"),
        workdir=str(tmp_path / "work"), replicas=1, run_s=0.3,
        serve={"model": "missing.npz", "input": "missing.npy",
               "device": "cpu"},
        max_attempts=1, record=str(tmp_path / "rec.json"))
    assert tfleet.main(["--serve-fleet", spec.save(
        str(tmp_path / "spec.json"))]) == 0
    rec = json.load(open(tmp_path / "rec.json"))
    assert rec["replicas"] == ["idle-r0"]


def test_jobspec_round_trip(tmp_path):
    spec = tfleet.JobSpec(name="a", input="x.npy", device="cpu",
                          fleet={"index": 2, "attempt": 1})
    path = spec.save(str(tmp_path / "a.json"))
    assert tfleet.JobSpec.load(path) == spec
    assert json.load(open(path))["fleet"] == {"index": 2, "attempt": 1}
    assert tfleet.JobSpec(name="b", input="x").k() == 30


def test_watchdog_fires_and_stops():
    fired = []
    wd = tfleet.Watchdog(None, 0.05, on_timeout=fired.append,
                         poll_s=0.01).start()
    import time
    time.sleep(0.3)
    wd.stop()
    assert fired == ["stage"]
    idle = tfleet.Watchdog()
    assert not idle.armed and idle.start()._thread is None


FAKE_NVCC = """\
#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(0.5)
open(out, "w").write("stand-in")
"""

BUILDER = """\
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from tsne_flink_tpu_torch.kernels import build
build.BUILD_DIR = Path({build_dir!r})
build.nvcc = lambda: {nvcc!r}
got = build.build()
print(json.dumps({{"path": str(got.path), "state": build.cache_state()}}))
"""


def test_concurrent_builds_compile_once(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    code = BUILDER.format(root=ROOT, build_dir=str(tmp_path / "build"),
                          nvcc=str(nvcc))
    env = dict(os.environ, FAKE_NVCC_LOG=str(log))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    from tsne_flink_tpu_torch.kernels.build import sources
    lines = log.read_text().split()
    assert lines.count("link") == 1
    assert lines.count("compile") == len(sources())
    assert outs[0]["path"] == outs[1]["path"]
    assert sorted(o["state"] for o in outs) == ["built", "hit"]
    left = [p.name for p in (tmp_path / "build").iterdir()]
    assert left == [os.path.basename(outs[0]["path"])]


def test_private_build_directory(tmp_path, monkeypatch):
    from tsne_flink_tpu_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_PRIVATE_DIR", None)
    prev = build.cache_enabled()
    try:
        build.set_cache(False)
        private = build._build_dir()
        assert private.parent == tmp_path / "build"
        assert private.name.startswith(f"private_{os.getpid()}_")
        build.set_cache(True)
        assert build._build_dir() == tmp_path / "build"
    finally:
        build.set_cache(prev)
