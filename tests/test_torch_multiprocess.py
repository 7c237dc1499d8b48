"""The multi-controller job across processes on the CPU: N ranks of a
``torch.distributed`` gloo group on localhost, each a process of its own
(``tests/torch_spmd_worker.py``, which imports torch and the port, never
JAX), against the same job in-process on the thread mesh.

* 2 and 4 processes give the thread mesh's embedding at the same width bit
  for bit (exact ring + replicated, + alltoall, the project kNN, the flat
  edge layout), and mesh 1's where the job is width-invariant;
  ``TSNE(spmd=True)`` in each of 2 processes runs its rank's shard of
  the same job;
* the command line: only rank 0 writes; a two-process checkpoint at
  iteration 5, resumed by two processes, equals the uninterrupted run bit
  for bit (the JAX ``tests/test_multiprocess.py``); ``--symSlack 1
  --symStrict`` ends both ranks non-zero; ``--auditPlan`` refuses a
  predicted OOM on both ranks, rank 0 alone reports, and the summary
  rides the checkpoint;
* a rank that raises ends the other within the group's timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_spmd_worker.py")
N, DIM, K, PERPLEXITY, ITERATIONS = 61, 6, 9, 4.0, 20
#: the group's collective timeout in these jobs (the ranks run at a lower
#: priority, tests/torch_spmd_worker.py, and may lag on a loaded host),
#: and the most a job may take here (spawning each process and importing
#: torch included)
GROUP_TIMEOUT_S = 60
JOB_LIMIT_S = 300


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n=N, d=DIM, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d)) * 4.0
    return centers[rng.integers(0, 4, n)] + rng.normal(size=(n, d))


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _job(world, spec, argvs=None):
    """Run ``world`` worker processes (rank r gets ``spec`` with its rank,
    or ``argvs[r]`` for the command line); returns their exit codes and
    the seconds the job took."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    coord = f"127.0.0.1:{_port()}"
    procs = []
    for r in range(world):
        s = dict(spec, rank=r, world=world, coordinator=coord,
                 timeout_s=GROUP_TIMEOUT_S)
        if argvs is not None:
            s["argv"] = [a.replace("{coord}", coord) for a in argvs[r]]
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, json.dumps(s)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    rcs, logs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOB_LIMIT_S)
            rcs.append(p.returncode)
            logs.append(out)
    finally:
        for p in procs:
            p.kill()
    return rcs, time.perf_counter() - t0, logs


ARMS = [("bruteforce", "replicated", "auto"),
        ("bruteforce", "alltoall", "auto"),
        ("bruteforce", "replicated", "edges"),
        ("project", "replicated", "auto")]
#: the arms whose embedding is the same at every width (the alltoall
#: normaliser sums the shards' parts, and the project draws take the
#: local shape, as in the JAX package)
WIDTH_FREE = {"bruteforce-replicated-auto", "bruteforce-replicated-edges"}


def _in_process(x, d, method, mode, attraction):
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact", attraction=attraction)
    pipe = SpmdPipeline(cfg, N, DIM, K, knn_method=method, sym_mode=mode,
                        knn_refine=1 if method == "project" else None,
                        n_devices=d, device="cpu")
    y, _ = pipe(torch.from_numpy(x), 3)
    return y.numpy(), pipe._runner.layout


@pytest.mark.parametrize("world", [2, 4])
def test_processes_equal_the_thread_mesh_and_mesh_1(tmp_path, world):
    x = _blobs()
    np.save(tmp_path / "x.npy", x)
    # (the project arm runs one refine cycle)
    spec = dict(kind="pipeline", x=str(tmp_path / "x.npy"),
                out=str(tmp_path), arms=[list(a) for a in ARMS], k=K,
                perplexity=PERPLEXITY, iterations=ITERATIONS, seed=3,
                refine=1)
    est = dict(perplexity=PERPLEXITY, n_iter=ITERATIONS, neighbors=K,
               knn_method="bruteforce", random_state=3)
    if world == 2:
        spec["estimator"] = est
    rcs, _, logs = _job(world, spec)
    assert rcs == [0] * world, logs
    layouts = [json.load(open(tmp_path / f"layouts_{r}.json"))
               for r in range(world)]
    for method, mode, attraction in ARMS:
        tag = f"{method}-{mode}-{attraction}"
        want, layout = _in_process(x, world, method, mode, attraction)
        for r in range(world):  # every rank holds the embedding
            assert np.array_equal(np.load(tmp_path / f"y_{tag}_{r}.npy"),
                                  want), (tag, r)
            assert layouts[r][tag] == layout
        if tag in WIDTH_FREE:
            assert np.array_equal(want, _in_process(x, 1, method, mode,
                                                    attraction)[0]), tag
    assert layouts[0]["bruteforce-replicated-edges"] == "edges"
    if world == 2:
        # TSNE(spmd=True) under the group: this rank's shard of the job
        from tsne_flink_tpu_torch import TSNE
        cfg = TSNE(device="cpu", **est)._config(N, "cpu")
        want, _ = SpmdPipeline(cfg, N, DIM, K, n_devices=2,
                               device="cpu")(torch.from_numpy(x), 3)
        for r in range(world):
            assert np.array_equal(np.load(tmp_path / f"y_est_{r}.npy"),
                                  want.numpy())


def _write_coo(path, x):
    with open(path, "w") as f:
        for i, row in enumerate(x):
            for j, v in enumerate(row):
                f.write(f"{i},{j},{float(v)!r}\n")


def _read_y(path):
    """The embedding CSV's y columns (each float written so that it reads
    back to the same float64)."""
    return np.loadtxt(path, delimiter=",", ndmin=2)[:, 1:]


def _cli_argv(tmp_path, rank, *extra):
    return ["--input", str(tmp_path / "x.csv"), "--output",
            str(tmp_path / f"out{rank}.csv"), "--loss",
            str(tmp_path / f"loss{rank}.txt"), "--dimension", str(DIM),
            "--knnMethod", "bruteforce", "--perplexity", str(PERPLEXITY),
            "--neighbors", str(K), "--iterations", "10", "--randomState",
            "3", "--noCache", "--spmd", "--coordinator", "{coord}",
            "--numProcesses", "2", "--processId", str(rank), *extra]


def test_cli_checkpoint_resume_across_processes(tmp_path):
    """Two CLI ranks write a checkpoint every 5 iterations under the
    sentinel and telemetry (rank 0 alone writes the checkpoint, the
    embedding, the loss and the metrics); two more resume the iteration-5
    file and end with the uninterrupted run's bits, which equal the
    in-process job's."""
    x = _blobs()
    _write_coo(tmp_path / "x.csv", x)
    ck = str(tmp_path / "ck.npz")
    rcs, _, logs = _job(2, dict(kind="cli"), argvs=[
        _cli_argv(tmp_path, r, "--checkpoint", ck, "--checkpointEvery", "5",
                  "--healthCheck", "--telemetry", "--metricsOut",
                  str(tmp_path / f"m{r}.json")) for r in range(2)])
    assert rcs == [0, 0], logs
    assert os.path.exists(ck) and os.path.exists(ck + ".1")
    for name in ("out1.csv", "loss1.txt", "m1.json"):
        assert not os.path.exists(tmp_path / name)
    with open(tmp_path / "m0.json") as f:
        assert "telemetry.grad_norm" in f.read()
    full = _read_y(tmp_path / "out0.csv")
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=10,
                     repulsion="exact")
    pipe = SpmdPipeline(cfg, N, DIM, K, n_devices=2, device="cpu")
    want, _ = pipe(torch.from_numpy(x.astype(np.float32)), 3)
    np.testing.assert_array_equal(full, want.numpy().astype(np.float64))
    os.rename(tmp_path / "out0.csv", tmp_path / "full.csv")
    rcs, _, logs = _job(2, dict(kind="cli"), argvs=[
        _cli_argv(tmp_path, r, "--resume", ck + ".1") for r in range(2)])
    assert rcs == [0, 0], logs
    assert "resumed from" in logs[0] and "iteration 5" in logs[0]
    resumed = _read_y(tmp_path / "out0.csv")
    np.testing.assert_array_equal(resumed, full)


def test_cli_sym_strict_ends_both_ranks(tmp_path):
    """--symMode alltoall with a pinned slack of 1 drops transpose edges:
    under --symStrict every rank reads the same psum'd counters and exits
    non-zero, with no hang; nothing is written."""
    x = _blobs()
    _write_coo(tmp_path / "x.csv", x)
    rcs, secs, logs = _job(2, dict(kind="cli"), argvs=[
        _cli_argv(tmp_path, r, "--symMode", "alltoall", "--symSlack", "1",
                  "--symStrict") for r in range(2)])
    assert all(rc != 0 for rc in rcs), logs
    assert all("--symStrict set" in log for log in logs), logs
    assert not os.path.exists(tmp_path / "out0.csv")


def test_cli_audit_plan_across_processes(tmp_path):
    """--auditPlan on the multi-controller route: with the budget pinned
    to 1 byte in each rank (the tiny job's peak is kilobytes), both ranks refuse the predicted OOM with the
    JAX message and write nothing; under no budget rank 0 alone prints
    the report, and the plan's summary rides rank 0's checkpoint."""
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    x = _blobs()
    _write_coo(tmp_path / "x.csv", x)
    rcs, _, logs = _job(2, dict(kind="cli", hbm_budget=1), argvs=[
        _cli_argv(tmp_path, r, "--auditPlan") for r in range(2)])
    assert all(rc != 0 for rc in rcs), logs
    for log in logs:
        assert "plan predicted to OOM: peak HBM estimate" in log, log
        assert "--auditPlan=warn" in log, log
    assert "# auditPlan: peak HBM est" in logs[0]
    assert "# auditPlan:" not in logs[1]
    assert not os.path.exists(tmp_path / "out0.csv")
    ck = str(tmp_path / "ck.npz")
    rcs, _, logs = _job(2, dict(kind="cli"), argvs=[
        _cli_argv(tmp_path, r, "--auditPlan", "--checkpoint", ck)
        for r in range(2)])
    assert rcs == [0, 0], logs
    for key in ("# auditPlan: plan: knn_method=bruteforce",
                "mesh=2", "# auditPlan: determinism: 0 unblessed",
                "# auditPlan: comms: mode canonical"):
        assert key in logs[0], (key, logs[0])
    assert "# auditPlan:" not in logs[1]
    summary = json.loads(str(ckpt.load_resume(ck)[3]["audit"]))
    assert {"peak_hbm_est", "peak_stage", "hbm_budget", "ok",
            "compile_count", "determinism", "comms"} == set(summary)
    assert summary["ok"] is True and summary["comms"]["mesh"] == 2


def test_a_raising_rank_ends_the_other(tmp_path):
    """Rank 1 raises before its first collective; rank 0, in the ring,
    ends with an error within the group's timeout instead of hanging."""
    x = _blobs()
    np.save(tmp_path / "x.npy", x)
    rcs, secs, logs = _job(2, dict(
        kind="raise", fail=1, x=str(tmp_path / "x.npy"), out=str(tmp_path),
        arms=[list(ARMS[0])], k=K, perplexity=PERPLEXITY,
        iterations=ITERATIONS, seed=3))
    assert rcs[0] != 0 and rcs[1] != 0, logs
    assert "fails on purpose" in logs[1]
    assert secs < GROUP_TIMEOUT_S + 30, secs
