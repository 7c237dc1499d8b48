"""PyTorch port, the serve daemon's scheduler, locks and residency vs the
JAX package (CPU).

* ``MicroBatcher``'s packing decisions — ``ready``, the batches and their
  parts, the promotions — equal JAX's on the same request sequences
  (express ahead of bulk, service-proportional deadlines, a starved bulk
  request promoted, one model per batch, a long random stream);
* the pickers' defaults equal the JAX package's environment defaults;
* ``decide_residency`` and ``bounded_claim_rows`` equal JAX's;
* ``FileLock``: the same lock-file body as JAX's (each package reads the
  other's payload), the claim-style release, the stale break by age and
  by a dead holder, the bounded wait;
* the scheduled daemon: mixed sizes (a bulk request in slices) bit for
  bit the direct transforms, the latency record's scheduling keys,
  residency admission refusing an over-budget model, a hot swap under
  load with every response naming the model bound at its claim, a
  broken swap file isolated in its done file, and a claim left by a dead
  daemon broken and served once.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsne_flink_tpu.runtime import admission as jadm
from tsne_flink_tpu.serve import sched as jsched
from tsne_flink_tpu.utils import locks as jlocks
from tsne_flink_tpu_torch.runtime import admission as tadm
from tsne_flink_tpu_torch.serve import sched as tsched
from tsne_flink_tpu_torch.serve.daemon import (SWAP_DONE_SUFFIX, SWAP_SUFFIX,
                                               ServeDaemon, read_result,
                                               submit)
from tsne_flink_tpu_torch.serve.model import PlanConfig, from_arrays
from tsne_flink_tpu_torch.serve.transform import transform
from tsne_flink_tpu_torch.utils import locks as tlocks

pytestmark = pytest.mark.fast

D, M = 6, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(n=96, seed=0, name="sched-test", dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(dtype)
    y = (0.1 * rng.standard_normal((n, M))).astype(dtype)
    return from_arrays(x, y, PlanConfig(n=n, d=D, k=12, backend="cpu",
                                        repulsion="exact", name=name),
                       perplexity=4.0, learning_rate=100.0, device="cpu")


def _queries(rows, seed=9):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, D)).astype(np.float32)


# ---- MicroBatcher: the same decisions as the JAX package --------------------

class _NoLock:
    def release(self):
        pass


def _stream_decisions(mod, stream, *, bucket=16, deadline_s=0.05,
                      starve_s=10.0):
    """Feed ``stream`` — (op, ...) steps: ("add", rid, rows, arrival,
    model) or ("tick", now, device_idle) — to ``mod``'s MicroBatcher and
    record every decision it makes."""
    mb = mod.MicroBatcher(bucket, deadline_s=deadline_s, starve_s=starve_s)
    out = []
    for step in stream:
        if step[0] == "add":
            _, rid, rows, arrival, model = step
            r = mod.Request(rid, rid + ".req.npz", _NoLock(),
                            np.zeros((rows, 3), np.float32), model,
                            arrival=arrival, deadline_s=deadline_s,
                            seq=mb.next_seq(), bucket=bucket, out_width=M,
                            out_dtype=np.float32, poll_ms=1.0)
            mb.add(r)
            out.append(("add", r.lane, r.deadline, mb.pending_rows(),
                        mb.earliest_deadline()))
            continue
        _, now, idle = step
        ready = mb.ready(now, device_idle=idle)
        out.append(("ready", ready))
        if ready:
            b = mb.next_batch(now)
            out.append(None if b is None else (
                b.model_id, b.rows, b.fill,
                [(r.rid, s, t, o, r.promoted) for r, s, t, o in b.parts]))
    out.append(("promotions", mb.promotions, len(mb.abandon())))
    return out


def _random_stream(seed, steps=120):
    rng = np.random.default_rng(seed)
    stream, t = [], 0.0
    for i in range(steps):
        t += float(rng.exponential(0.01))
        if rng.random() < 0.55:
            stream.append(("add", f"r{i}", int(rng.choice([1, 5, 16, 17, 40,
                                                           64])),
                           t, str(rng.choice(["A", "B"], p=[0.8, 0.2]))))
        else:
            stream.append(("tick", t, bool(rng.random() < 0.3)))
    return stream


STREAMS = {
    "express-ahead": [("add", "big", 40, 0.0, "m"),
                      ("add", "tiny", 8, 0.001, "m"),
                      ("tick", 0.002, False), ("tick", 0.002, False),
                      ("tick", 0.002, True)],
    "deadlines": [("add", "mid", 16, 0.0, "m"), ("add", "small", 4, 0.0, "m"),
                  ("tick", 0.0, True), ("tick", 0.0, True),
                  ("add", "old", 16, 0.5, "m"), ("add", "fresh", 4, 1.0, "m"),
                  ("tick", 1.0, True)],
    "work-conserving": [("tick", 0.0, True), ("add", "a", 4, 0.0, "m"),
                        ("tick", 0.01, False), ("tick", 0.051, False),
                        ("add", "b", 12, 0.06, "m"), ("tick", 0.061, False)],
    "one-model-a-batch": [("add", "a1", 8, 0.0, "A"),
                          ("add", "b1", 8, 0.001, "B"),
                          ("add", "a2", 8, 0.002, "A"),
                          ("tick", 0.003, True), ("tick", 0.003, True)],
    "random-0": _random_stream(0),
    "random-1": _random_stream(1),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_microbatcher_decisions_match_jax(name):
    want = _stream_decisions(jsched, STREAMS[name])
    assert _stream_decisions(tsched, STREAMS[name]) == want
    assert len(want) > len(STREAMS[name])  # some batches were packed


def test_microbatcher_starvation_promotion_matches_jax():
    stream = [("add", "big", 32, 0.0, "m"), ("add", "tiny", 4, 1.0, "m"),
              ("tick", 1.0, True), ("tick", 1.0, True)]
    want = _stream_decisions(jsched, stream, starve_s=0.5)
    got = _stream_decisions(tsched, stream, starve_s=0.5)
    assert got == want and got[-1][1] == 1  # one promotion
    assert got[3][3][0][0] == "big"  # the promoted bulk leads


def test_pickers_default_to_the_jax_environment_defaults(monkeypatch):
    # the JAX serve package's __init__ re-exports the function transform
    jtr = importlib.import_module("tsne_flink_tpu.serve.transform")
    ttr = importlib.import_module("tsne_flink_tpu_torch.serve.transform")
    for var in ("TSNE_SERVE_SCHED", "TSNE_SERVE_DEADLINE_MS",
                "TSNE_SERVE_STARVE_MS", "TSNE_SERVE_POLL_MAX_MS",
                "TSNE_SERVE_BUCKET", "TSNE_TRANSFORM_ITERS",
                "TSNE_TRANSFORM_ETA"):
        monkeypatch.delenv(var, raising=False)
    for name in ("pick_serve_sched", "pick_serve_deadline_ms",
                 "pick_serve_starve_ms", "pick_poll_max_ms"):
        assert getattr(tsched, name)() == getattr(jsched, name)()
    for name in ("pick_serve_bucket", "pick_transform_iters",
                 "pick_transform_eta"):
        assert getattr(ttr, name)() == getattr(jtr, name)()
    assert tsched.SCHED_RECORD_KEYS == jsched.SCHED_RECORD_KEYS
    with pytest.raises(ValueError, match="on\\|off"):
        tsched.pick_serve_sched("maybe")
    with pytest.raises(ValueError):
        tsched.pick_serve_starve_ms(0.0)


# ---- admission --------------------------------------------------------------

@pytest.mark.parametrize("resident,peak,budget", [
    ({"a": 100}, 50, None), ({"a": 100}, 50, 150), ({"a": 100}, 51, 150),
    ({}, 10, 5), ({"a": 1, "b": 2}, 3, 6)])
def test_decide_residency_matches_jax(resident, peak, budget):
    got = tadm.decide_residency(resident, "m", peak, budget)
    want = jadm.decide_residency(resident, "m", peak, budget)
    assert (got.action, got.predicted_peak, got.reason) == (
        want.action, want.predicted_peak, want.reason)


@pytest.mark.parametrize("args", [(16384, 256, 1000, None),
                                  (16384, 256, 1000, 5000),
                                  (16384, 256, 10, 10 ** 9),
                                  (1024, 256, 0, 100)])
def test_bounded_claim_rows_matches_jax(args):
    assert tadm.bounded_claim_rows(*args) == jadm.bounded_claim_rows(*args)


def test_default_budget():
    assert tadm.default_budget("cpu") is None
    assert tadm.default_budget("cpu", 123) == 123
    assert tadm.default_budget("cuda", 7) == 7


# ---- file locks -------------------------------------------------------------

def test_lock_body_and_payload_cross_the_packages(tmp_path):
    path = str(tmp_path / "r.req.npz.lock")
    lock = tlocks.FileLock(path, payload={"claim": "serve"})
    assert lock.acquire(timeout_s=0.0)
    lock.write_payload({"epoch": 3})
    body = open(path).read()
    assert body == f"pid={os.getpid()}\nclaim=serve\nepoch=3\n"
    assert jlocks.read_lock_payload(path) == tlocks.read_lock_payload(path)
    assert not jlocks.FileLock(path).acquire(timeout_s=0.0)  # held
    lock.release()
    assert not os.path.exists(path)
    jl = jlocks.FileLock(path, payload={"claim": "serve"})
    assert jl.acquire(timeout_s=0.0)
    jl.write_payload({"epoch": 1})
    assert tlocks.read_lock_payload(path) == {
        "pid": str(os.getpid()), "claim": "serve", "epoch": "1"}
    assert not tlocks.FileLock(path).acquire(timeout_s=0.01)
    jl.release()


def test_lock_stale_break_and_claim_style_release(tmp_path):
    path = str(tmp_path / "x.lock")
    with open(path, "w") as f:
        f.write("pid=1\n")
    os.utime(path, (0, 0))  # ancient: broken by age
    lock = tlocks.FileLock(path, stale_s=60.0)
    assert lock.acquire(timeout_s=0.0) or lock.acquire(timeout_s=0.1)
    lock.release()
    never = tlocks.FileLock(path, stale_fn=lambda p, age: False)
    assert never.acquire(timeout_s=0.0)
    other = tlocks.FileLock(path, stale_s=0.0, stale_fn=lambda p, a: False)
    assert not other.acquire(timeout_s=0.05)  # False: never broken
    never.release()
    # a claim-style lock that was broken and taken is not removed
    claim = tlocks.FileLock(path, payload={"claim": "serve"})
    assert claim.acquire(timeout_s=0.0)
    with open(path, "w") as f:
        f.write("pid=999999999\nclaim=serve\n")
    claim.release()
    assert os.path.exists(path)
    taker = tlocks.FileLock(path, stale_fn=lambda p, age: True)
    assert taker.acquire(timeout_s=0.05)  # True: broken at once
    assert tlocks.read_lock_payload(path)["pid"] == str(os.getpid())
    taker.release()
    assert not os.path.exists(path)


# ---- the scheduled daemon ---------------------------------------------------

def test_sched_daemon_mixed_sizes_bit_identical_with_sliced_bulk(tmp_path):
    model = _model()
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    reqs = {"bulk": _queries(40, seed=1), "tiny": _queries(5, seed=2),
            "exact": _queries(16, seed=3)}
    for rid, q in reqs.items():
        submit(spool, q, rid)
    d = ServeDaemon(model, spool, bucket=16, iters=6, tick_s=0.001,
                    sched="on", idle_exit_s=0.05)
    summary = d.serve_forever(max_ticks=30)
    assert summary["served"] == 3 and summary["sched"] == "on"
    assert summary["batches"] == 4 and 0 < summary["batch_fill_mean"] <= 1
    lat = {}
    for rid, q in reqs.items():
        np.testing.assert_array_equal(read_result(spool, rid),
                                      transform(model, q, bucket=16,
                                                iters=6))
        with open(os.path.join(spool, rid + ".lat.json")) as f:
            lat[rid] = json.load(f)
    assert lat["bulk"]["lane"] == "bulk" and lat["bulk"]["slices"] == 3
    assert lat["tiny"]["lane"] == "express"
    for rec in lat.values():
        assert rec["queue_ms"] >= 0 and rec["compute_ms"] >= 0
        assert rec["epoch"] == 1 and rec["replica"] is None


def test_residency_refuses_an_over_budget_model(tmp_path):
    a, b = _model(seed=0, name="res-a"), _model(seed=1, name="res-b")
    peak = a.transform_peak(8)
    d = ServeDaemon(a, str(tmp_path), bucket=8, iters=2,
                    budget_bytes=int(1.5 * peak))
    event = d.load_model(b)
    assert event["action"] == tadm.QUEUE and "refused" in event["reason"]
    assert b.model_id not in d.models and d.active_id == a.model_id
    res = d.summary()["residency"]
    assert res["resident"] == [a.model_id]
    with pytest.raises(KeyError, match="not resident"):
        d.activate(b.model_id)
    with pytest.raises(ValueError, match="active"):
        d.evict(a.model_id)


def test_hot_swap_under_load_answers_the_bound_model(tmp_path):
    a, b = _model(seed=0, name="swap-a"), _model(seed=1, name="swap-b")
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    d = ServeDaemon(a, spool, bucket=16, iters=6, tick_s=0.001, sched="on",
                    idle_exit_s=0.05)
    q1, q2, q3 = _queries(10, 1), _queries(10, 2), _queries(10, 3)
    submit(spool, q1, "r1")
    d.serve_forever(max_ticks=20)
    assert d.load_model(b, activate=True)["action"] == tadm.ADMIT
    assert d.active_id == b.model_id
    submit(spool, q2, "r2")                       # binds the active B
    submit(spool, q3, "r3", model_id=a.model_id)  # pinned to A
    d.serve_forever(max_ticks=20)
    bound = {}
    for rid in ("r1", "r2", "r3"):
        with open(os.path.join(spool, rid + ".lat.json")) as f:
            bound[rid] = json.load(f)["model_id"]
    assert bound == {"r1": a.model_id, "r2": b.model_id, "r3": a.model_id}
    for rid, model, q in (("r1", a, q1), ("r2", b, q2), ("r3", a, q3)):
        np.testing.assert_array_equal(read_result(spool, rid),
                                      transform(model, q, bucket=16,
                                                iters=6))
    res = d.summary()["residency"]
    assert res["report"]["models"] == 2 and res["report"]["peak_bytes"] > 0
    d.evict(a.model_id)
    assert list(d.models) == [b.model_id]


def test_broken_swap_file_lands_in_its_done_file(tmp_path):
    model = _model()
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    with open(os.path.join(spool, "broken" + SWAP_SUFFIX), "w") as f:
        json.dump({"model": str(tmp_path / "missing.npz"),
                   "input": str(tmp_path / "missing.npy")}, f)
    q = _queries(7, seed=6)
    submit(spool, q, "r0")
    d = ServeDaemon(model, spool, bucket=16, iters=4, tick_s=0.001,
                    sched="on", idle_exit_s=0.05)
    assert d.serve_forever(max_ticks=20)["served"] == 1
    with open(os.path.join(spool, "broken" + SWAP_DONE_SUFFIX)) as f:
        done = json.load(f)
    assert done["status"] == "error" and done["error"]
    assert d.active_id == model.model_id
    np.testing.assert_array_equal(read_result(spool, "r0"),
                                  transform(model, q, bucket=16, iters=4))


def test_claim_of_a_dead_daemon_is_broken_and_served_once(tmp_path):
    """A claim lock whose holder is gone (and its epoch sidecar) is
    broken at once; the request is served with epoch 2 and counted as
    redispatched."""
    model = _model()
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    q = _queries(9, seed=4)
    submit(spool, q, "r")
    dead = subprocess.run([sys.executable, "-c", "import os; "
                           "print(os.getpid())"], capture_output=True,
                          text=True, check=True).stdout.strip()
    with open(os.path.join(spool, "r.req.npz.lock"), "w") as f:
        f.write(f"pid={dead}\nclaim=serve\nepoch=1\n")
    with open(os.path.join(spool, "r.epoch.json"), "w") as f:
        json.dump({"req": "r", "epoch": 1}, f)
    d = ServeDaemon(model, spool, bucket=16, iters=4, tick_s=0.001,
                    sched="off", idle_exit_s=0.05)
    summary = d.serve_forever(max_ticks=5)
    assert summary["served"] == 1 and summary["redispatched"] == 1
    with open(os.path.join(spool, "r.lat.json")) as f:
        assert json.load(f)["epoch"] == 2
    np.testing.assert_array_equal(read_result(spool, "r"),
                                  transform(model, q, bucket=16, iters=4))
    assert sorted(os.listdir(spool)) == ["r.lat.json", "r.res.npz"]
