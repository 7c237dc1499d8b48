"""PyTorch port, the replicated serve fleet vs the JAX package (CPU).

The protocol units, each held to the JAX package's ``serve/replicas``
where it has one:

* the knob resolvers and their bounds; ``ServeSpec`` / ``ServeFleetSpec``
  JSON round trips (a JAX-written fleet spec loads in the port);
* heartbeats, the dead/hung/slow verdicts of ``claim_stale_verdict`` (the
  two packages give the same verdict on the same lock and beat files,
  and each reads the other's beats and epoch sidecars), no stale break of
  a live beating holder, ``break_dead_claims``, the epoch sidecars, the
  rename guard against a zombie's late write;
* ``decide_shed``'s decisions equal to the JAX package's; a daemon sheds
  bulk before express; the ``hang`` payload; the daemon's watchdog beat
  and the ``serve`` fault site's kill boundary;

then fleets of ``python -m tsne_flink_tpu_torch.runtime.fleet --serve``
children over one spool, each under its own time limit (the fleet's
``run_s`` deadline SIGKILLs stragglers, and a test asserts it was not
hit; a command-line child has a ``subprocess`` timeout): the
``--serve-fleet`` command line (clean), ``kill@serve:seg0`` on both
replicas, ``hang@serve:2``, a hot swap under pinned load, a mixed storm
and a watchdog ending (exit 124, relaunched clean).  Every request
reaches exactly one terminal, bit for bit the port's direct
``transform`` in this process; a float64 fleet also agrees with the JAX
``transform`` to rtol 1e-9.  Children run on one CPU thread, as this
process does.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu.runtime import admission as jadmission
from tsne_flink_tpu.runtime import fleet as jfleet
from tsne_flink_tpu.serve import replicas as jquorum
from tsne_flink_tpu.serve.model import load_frozen as jload_frozen
from tsne_flink_tpu.serve.transform import transform as jtransform
from tsne_flink_tpu.utils.locks import FileLock as JFileLock
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.models.tsne import TsneState
from tsne_flink_tpu_torch.runtime import faults
from tsne_flink_tpu_torch.runtime.admission import ADMIT, SHED, decide_shed
from tsne_flink_tpu_torch.runtime.fleet import (EXIT_TIMEOUT, ServeFleetSpec,
                                                ServeSpec, Watchdog,
                                                run_serve_fleet)
from tsne_flink_tpu_torch.serve import replicas as quorum
from tsne_flink_tpu_torch.serve.daemon import (ServeDaemon, StaleClaim,
                                               _claim_current, read_result,
                                               submit)
from tsne_flink_tpu_torch.serve.model import from_arrays, load_frozen
from tsne_flink_tpu_torch.serve.transform import transform
from tsne_flink_tpu_torch.utils import checkpoint as ckpt
from tsne_flink_tpu_torch.utils.io import atomic_write
from tsne_flink_tpu_torch.utils.locks import FileLock, read_lock_payload

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one frozen-model shape for the module (the JAX file's)
N, D, M, K = 64, 5, 2, 8
BUCKET, ITERS = 16, 6
PERP, LR = 4.0, 100.0
#: the stated tolerance of a transform against the JAX package, f64 (as
#: tests/test_torch_serve.py)
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- fixtures ---------------------------------------------------------------

def _frozen_fixture(base_dir, seed=3, stem="model", dtype=np.float32):
    """A fat v2 checkpoint (written by the port) and its input features on
    disk: the files a replica spec names."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(dtype)
    y = torch.from_numpy((0.1 * rng.standard_normal((N, M))).astype(dtype))
    st = TsneState(y=y, update=torch.zeros_like(y), gains=torch.ones_like(y))
    model_path = os.path.join(str(base_dir), stem + ".npz")
    ckpt.save(model_path, st, 10, np.asarray([0.5]))
    input_path = os.path.join(str(base_dir), stem + "_x.npy")
    np.save(input_path, x)
    return x, model_path, input_path


def _oracle(model_path, x):
    plan = PlanConfig(n=N, d=D, k=K, backend="cpu", repulsion="exact",
                      name="quorum-oracle")
    return load_frozen(model_path, x, plan, perplexity=PERP,
                       learning_rate=LR, device="cpu")


def _serve_template(model_path, input_path, **extra):
    """The ServeSpec template a fleet spec stamps replica fields onto:
    fast ticks, a beat at least every 0.2 s while idle, and an idle exit,
    so a drained fleet ends."""
    return {"model": model_path, "input": input_path, "perplexity": PERP,
            "learning_rate": LR, "neighbors": K, "repulsion": "exact",
            "bucket": BUCKET, "iters": ITERS, "tick_s": 0.01,
            "poll_max_ms": 200.0, "idle_exit_s": 0.5, "device": "cpu",
            **extra}


#: the children's environment: one thread, as this process
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _queries(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, D)).astype(np.float32)


def _terminal_listing(rids, extra=()):
    names = list(extra)
    for rid in rids:
        names += [rid + ".lat.json", rid + ".res.npz"]
    return sorted(names)


@pytest.fixture(scope="module")
def quorum_env(tmp_path_factory):
    base = tmp_path_factory.mktemp("quorum")
    x, model_path, input_path = _frozen_fixture(base)
    return {"base": base, "x": x, "model": model_path, "input": input_path,
            "oracle": _oracle(model_path, x)}


# ---- knob resolvers and specs ------------------------------------------------

def test_knob_resolvers_defaults_and_bounds():
    assert quorum.pick_serve_replicas() == 2
    assert quorum.pick_serve_replicas(3) == 3
    with pytest.raises(ValueError, match="replica count"):
        quorum.pick_serve_replicas(0)
    assert quorum.pick_replica_stale_ms() == 5000.0
    assert quorum.pick_replica_stale_ms(250.0) == 250.0
    with pytest.raises(ValueError, match="stale bound"):
        quorum.pick_replica_stale_ms(0.0)
    assert quorum.pick_shed_depth() == 0      # 0: shedding off
    assert quorum.pick_shed_depth(7) == 7
    with pytest.raises(ValueError, match="shed depth"):
        quorum.pick_shed_depth(-1)
    # the JAX package's defaults, which it reads from its environment
    from tsne_flink_tpu.utils.env import env_float, env_int
    assert quorum.DEFAULT_REPLICAS == env_int("TSNE_SERVE_REPLICAS")
    assert quorum.DEFAULT_STALE_MS == env_float("TSNE_REPLICA_STALE_MS")
    assert quorum.DEFAULT_SHED_DEPTH == env_int("TSNE_SERVE_SHED_DEPTH")


def test_serve_specs_round_trip_and_read_jax_files(tmp_path):
    spec = ServeFleetSpec(name="f", spool="/s", workdir="/w", replicas=2,
                          fault_plans={"0": "kill@serve:seg0"})
    path = spec.save(str(tmp_path / "fleet.json"))
    assert ServeFleetSpec.load(path).as_dict() == spec.as_dict()
    aug = {**spec.as_dict(), "not_a_field": 1}
    assert ServeFleetSpec.from_dict(aug).as_dict() == spec.as_dict()
    # a JAX-written fleet spec is a port fleet spec, field for field
    jspec = jfleet.ServeFleetSpec(name="f", spool="/s", workdir="/w",
                                  replicas=2,
                                  fault_plans={"0": "kill@serve:seg0"})
    jpath = jspec.save(str(tmp_path / "jfleet.json"))
    assert ServeFleetSpec.load(jpath).as_dict() == spec.as_dict()
    # every JAX ServeSpec field is a port field; the port adds the knobs
    # a JAX child reads from its environment, and its device
    serve = ServeSpec(name="r", model="m.npz", input="x.npy", spool="/s",
                      replica="r0", tick_s=0.01, device="cpu")
    assert ServeSpec.load(serve.save(str(tmp_path / "s.json"))) == serve
    jkeys = set(jfleet.ServeSpec.__dataclass_fields__)
    extra = set(ServeSpec.__dataclass_fields__) - jkeys
    assert jkeys <= set(ServeSpec.__dataclass_fields__)
    assert extra == {"tick_s", "idle_exit_s", "lock_stale_s", "max_batch",
                     "fault_delay_s", "device"}
    assert ServeSpec(name="r", model="m", input="x", spool="s").k() == 30


# ---- shed policy ---------------------------------------------------------------

SHED_CASES = [(4, 2048, 256, 4, 400.0), (5, 256, 256, 4, 400.0),
              (9, 2048, 256, 4, 400.0), (10_000, 4096, 256, 0, 400.0),
              (3, 257, 256, 1, 50.0), (2, 0, 16, 1, 50.0)]


@pytest.mark.parametrize("case", SHED_CASES)
def test_decide_shed_equals_jax(case):
    assert decide_shed(*case).as_dict() == jadmission.decide_shed(
        *case).as_dict()


def test_decide_shed_bulk_only_and_retry_hint():
    assert decide_shed(4, 2048, 256, 4, 400.0).action == ADMIT
    # over depth: express (fits one bucket) is never shed before bulk
    assert decide_shed(5, 256, 256, 4, 400.0).action == ADMIT
    v = decide_shed(9, 2048, 256, 4, 400.0)
    assert v.action == SHED and "backlog" in v.reason
    assert v.retry_after_ms == pytest.approx(400.0 * 5)
    assert decide_shed(10_000, 4096, 256, 0, 400.0).action == ADMIT


# ---- the hang fault kind and the serve site --------------------------------------

def test_hang_fault_parses_and_fires_at_site_entry():
    (f,) = faults.parse_plan("hang@serve:2")
    assert (f.kind, f.site, f.trigger, f.fired) == ("hang", "serve", "2",
                                                    False)
    assert faults.POINT_FOR_KIND["hang"] == "start"
    with pytest.raises(ValueError, match="site 'job' takes kinds"):
        faults.parse_plan("hang@job:1")
    # the serve site is taken by activate
    inj = faults.activate("kill@serve:seg0,hang@serve:2")
    try:
        assert faults.injector() is inj and len(inj.faults) == 2
    finally:
        faults.activate(None)


def test_hang_payload_blocks_forever_pid_alive():
    """``hang@knn:1`` wedges the process at the site entry: no exit, no
    output, the pid alive and signalable (a torch-free child)."""
    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from tsne_flink_tpu_torch.runtime import faults\n"
            "faults.activate('hang@knn:1')\n"
            "faults.injector().fire('knn')\n"
            "print('unreachable')\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        with pytest.raises(subprocess.TimeoutExpired):
            p.wait(timeout=3.0)
        assert p.poll() is None and quorum.pid_alive(p.pid)
    finally:
        p.kill()
        p.wait()


def test_supervisor_imports_no_torch():
    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import tsne_flink_tpu_torch.runtime.fleet as f\n"
            "import tsne_flink_tpu_torch.serve.replicas\n"
            "assert callable(f.run_serve_fleet)\n"
            "print('torch' in sys.modules)\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip() == "False"


# ---- heartbeats and the dead/hung/slow triage ---------------------------------------

def test_heartbeat_roundtrip_sweep_and_jax_reads(tmp_path):
    spool = str(tmp_path)
    assert quorum.read_beat(spool, "r0") is None
    quorum.write_beat(spool, "r0", 3, ["b", "a"])
    beat = quorum.read_beat(spool, "r0")
    assert beat["replica"] == "r0" and beat["seq"] == 3
    assert beat["pid"] == os.getpid() and beat["claimed"] == ["a", "b"]
    # each package reads the other's beats
    assert jquorum.read_beat(spool, "r0") == beat
    jquorum.write_beat(spool, "r1", 5, ["c"])
    assert quorum.read_beat(spool, "r1") == jquorum.read_beat(spool, "r1")
    quorum.clear_beats(spool)
    assert os.listdir(spool) == []
    assert quorum.read_beat(spool, "") is None


def _write_claim(spool, rid, pid, replica=None):
    lines = [f"pid={pid}\n"]
    if replica is not None:
        lines.append(f"replica={replica}\n")
    path = os.path.join(spool, rid + quorum.CLAIM_LOCK_SUFFIX)
    with open(path, "w") as f:
        f.write("".join(lines))
    return path


def _dead_pid():
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def test_claim_stale_verdict_dead_hung_slow_equals_jax(tmp_path):
    spool = str(tmp_path)
    dead = _write_claim(spool, "d0", _dead_pid(), "rX")
    live = _write_claim(spool, "l0", os.getpid(), "rY")
    jquorum.write_beat(spool, "rY", 1, ["l0"])   # a JAX-written beat
    bare = _write_claim(spool, "b0", os.getpid(), "rZ")
    anon = os.path.join(spool, "a0" + quorum.CLAIM_LOCK_SUFFIX)
    with open(anon, "w") as f:
        f.write("claim=serve\n")
    cases = [(dead, 0.0, 60.0, True),      # dead holder: break now
             (live, 1e6, 60.0, False),     # alive and beating: never
             (live, 1e6, 0.0, None),       # the beat too old: age rule
             (bare, 0.0, 60.0, None),      # alive, no beat: age rule
             (anon, 0.0, 60.0, None)]      # anonymous: age rule
    for path, age, stale_s, want in cases:
        got = quorum.claim_stale_verdict(path, age, spool=spool,
                                         replica_stale_s=stale_s)
        ref = jquorum.claim_stale_verdict(path, age, spool=spool,
                                          replica_stale_s=stale_s)
        assert got is want and ref is want, os.path.basename(path)


def test_stale_break_never_fires_on_live_beating_holder(tmp_path):
    """A torch-free child holds a claim far past the plain age bound while
    beating; a contender must not break it.  Once the holder dies the
    verdict is dead and the break immediate."""
    spool = str(tmp_path)
    lock_path = os.path.join(spool, "h0" + quorum.CLAIM_LOCK_SUFFIX)
    code = ("import sys, time\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from tsne_flink_tpu_torch.serve import replicas as quorum\n"
            "from tsne_flink_tpu_torch.utils.locks import FileLock\n"
            f"lock = FileLock({lock_path!r}, stale_s=3600.0,\n"
            "                payload={'replica': 'rH'})\n"
            "assert lock.acquire(timeout_s=2.0)\n"
            f"quorum.write_beat({spool!r}, 'rH', 1, ['h0'])\n"
            "print('ready', flush=True)\n"
            "time.sleep(120)\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "ready"

        def stale(path, age):
            return quorum.claim_stale_verdict(path, age, spool=spool,
                                              replica_stale_s=60.0)
        contender = FileLock(lock_path, stale_s=0.05, stale_fn=stale)
        assert contender.acquire(timeout_s=0.6) is False
        assert read_lock_payload(lock_path).get("replica") == "rH"
        p.kill()
        p.wait()
        assert contender.acquire(timeout_s=2.0) is True
        contender.release()
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_break_dead_claims_only_dead_same_replica(tmp_path):
    spool = str(tmp_path)
    _write_claim(spool, "a", _dead_pid(), "r0")          # dead r0: break
    live = _write_claim(spool, "b", os.getpid(), "r0")   # relaunched r0
    other = _write_claim(spool, "c", _dead_pid(), "r1")  # r1's corpse
    anon = os.path.join(spool, "d" + quorum.CLAIM_LOCK_SUFFIX)
    with open(anon, "w") as f:
        f.write("claim=serve\n")
    assert quorum.break_dead_claims(spool, "r0") == ["a"]
    assert not os.path.exists(os.path.join(
        spool, "a" + quorum.CLAIM_LOCK_SUFFIX))
    assert os.path.exists(live) and os.path.exists(other)
    assert os.path.exists(anon)
    # the JAX package breaks the same set on the same files
    assert jquorum.break_dead_claims(spool, "r1") == ["c"]
    assert quorum.break_dead_claims(spool, "r1") == []


# ---- claim epochs and the rename guard -------------------------------------------

def test_epoch_sidecar_bump_read_clear_across_packages(tmp_path):
    spool = str(tmp_path)
    assert quorum.read_epoch(spool, "r") == 0
    lock = FileLock(os.path.join(spool, "r" + quorum.CLAIM_LOCK_SUFFIX),
                    payload={"replica": "r0"})
    with pytest.raises(RuntimeError, match="claim lock"):
        quorum.bump_epoch(spool, "r", lock)   # not held
    assert lock.acquire(timeout_s=0.0)
    try:
        assert quorum.bump_epoch(spool, "r", lock) == 1
        assert quorum.bump_epoch(spool, "r", lock) == 2
        assert quorum.read_epoch(spool, "r") == 2
        assert jquorum.read_epoch(spool, "r") == 2
    finally:
        lock.release()
    jlock = JFileLock(os.path.join(spool, "r" + quorum.CLAIM_LOCK_SUFFIX),
                      payload={"replica": "r1"})
    assert jlock.acquire(timeout_s=0.0)
    try:
        assert jquorum.bump_epoch(spool, "r", jlock) == 3
        assert quorum.read_epoch(spool, "r") == 3
    finally:
        jlock.release()
    quorum.clear_epoch(spool, "r")
    assert quorum.read_epoch(spool, "r") == 0
    quorum.clear_epoch(spool, "r")   # idempotent


def test_rename_guard_discards_zombie_write(tmp_path):
    """Claim at epoch 1, get broken and re-claimed at epoch 2: the
    zombie's late write raises StaleClaim inside the writer, atomic_write
    drops its tmp, and the live claimant's bytes stand alone."""
    spool = str(tmp_path)
    lock_path = os.path.join(spool, "z0" + quorum.CLAIM_LOCK_SUFFIX)
    res = os.path.join(spool, "z0.res.npz")

    zombie = FileLock(lock_path, payload={"replica": "r0"})
    assert zombie.acquire(timeout_s=0.0)
    e1 = quorum.bump_epoch(spool, "z0", zombie)
    zombie.write_payload({"epoch": e1})
    assert _claim_current(zombie, e1)

    os.remove(lock_path)   # the supervisor breaking the dead claim
    live = FileLock(lock_path, payload={"replica": "r1"})
    assert live.acquire(timeout_s=0.0)
    e2 = quorum.bump_epoch(spool, "z0", live)
    live.write_payload({"epoch": e2})
    assert e2 == 2 and _claim_current(live, e2)
    assert not _claim_current(zombie, e1)

    def write_live(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, y=np.full((3, M), 2.0, np.float32))
        if not _claim_current(live, e2):
            raise StaleClaim("z0")
    atomic_write(res, write_live, tag=f"e{e2}")

    def write_zombie(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, y=np.zeros((3, M), np.float32))
        if not _claim_current(zombie, e1):
            raise StaleClaim("z0")
    with pytest.raises(StaleClaim):
        atomic_write(res, write_zombie, tag=f"e{e1}")

    with np.load(res) as z:
        np.testing.assert_array_equal(z["y"],
                                      np.full((3, M), 2.0, np.float32))
    assert not [n for n in os.listdir(spool) if n.endswith(".tmp")]
    live.release()


# ---- the daemon in replica mode ----------------------------------------------------

def _small_model(seed=0, n=96, d=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (0.1 * rng.standard_normal((n, M))).astype(np.float32)
    plan = PlanConfig(n=n, d=d, k=12, backend="cpu", repulsion="exact",
                      name="shed-test")
    return from_arrays(x, y, plan, perplexity=PERP, learning_rate=LR,
                       device="cpu"), rng


@pytest.mark.parametrize("sched", ["on", "off"])
def test_daemon_sheds_bulk_before_express(tmp_path, sched):
    """Backlog 5 > depth 1: every multi-bucket (bulk) request gets a fast
    ``retry_after_ms`` refusal; every single-bucket (express) request is
    served, bit for bit a direct transform."""
    model, rng = _small_model()
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    express = {f"e{i}": rng.standard_normal((8, 6)).astype(np.float32)
               for i in range(2)}
    bulk = {f"b{i}": rng.standard_normal((32, 6)).astype(np.float32)
            for i in range(3)}
    for rid, q in {**express, **bulk}.items():
        submit(spool, q, rid)
    d = ServeDaemon(model, spool, bucket=BUCKET, iters=4, tick_s=0.001,
                    shed_depth=1, sched=sched, replica="r0")
    summary = d.serve_forever(max_ticks=10)
    assert summary["shed_depth"] == 1 and summary["replica"] == "r0"
    assert summary["served"] == 2 and summary["shed"] == 3
    assert summary["failed"] == 0
    for rid, q in express.items():
        np.testing.assert_array_equal(
            read_result(spool, rid),
            transform(model, q, bucket=BUCKET, iters=4))
    for rid in bulk:
        with open(os.path.join(spool, rid + ".err.json")) as f:
            err = json.load(f)
        assert err["shed"] is True and err["req"] == rid
        assert err["retry_after_ms"] > 0
    # the replica's beat: one a tick, its claims listed (the fleet sweeps
    # it; a daemon alone leaves it)
    beat = quorum.read_beat(spool, "r0")
    assert beat["seq"] == 10 and beat["claimed"] == []
    assert sorted(os.listdir(spool)) == _terminal_listing(
        express, extra=[rid + ".err.json" for rid in bulk] + [
            "r0" + quorum.BEAT_SUFFIX])


def test_slow_healthy_tick_keeps_its_beat_fresh(tmp_path, monkeypatch):
    """A replica whose ticks run past ``stale_ms`` while they make progress
    (each bucket's dispatch made 0.4 s slow, two buckets a tick, stale_ms
    700) beats after each step, so its beat stays younger than
    ``stale_ms`` throughout: the supervisor's hung triage (a live pid
    whose beat is older than stale_ms) never finds it hung, and it serves
    every request bit for bit.  The beat's ``seq`` still counts ticks."""
    import threading
    import time

    from tsne_flink_tpu_torch.obs.trace import walltime
    from tsne_flink_tpu_torch.serve import daemon as tdaemon
    model, rng = _small_model()
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    queries = {f"s{i}": rng.standard_normal((BUCKET, 6)).astype(np.float32)
               for i in range(4)}
    for rid, q in queries.items():
        submit(spool, q, rid)
    real = tdaemon.dispatch_bucket

    def slow(*args, **kwargs):
        time.sleep(0.4)
        return real(*args, **kwargs)
    monkeypatch.setattr(tdaemon, "dispatch_bucket", slow)
    stale_ms = 700.0
    d = ServeDaemon(model, spool, bucket=BUCKET, iters=2, tick_s=0.001,
                    sched="on", replica="r0", stale_ms=stale_ms)
    ticks, ages, stop = [], [], threading.Event()
    tick = d._sched_tick

    def timed_tick():
        t0 = time.perf_counter()
        out = tick()
        ticks.append(time.perf_counter() - t0)
        return out
    d._sched_tick = timed_tick

    def watch():
        while not stop.is_set():
            beat = quorum.read_beat(spool, "r0")
            if beat is not None:
                ages.append(walltime() - float(beat["t"]))
            time.sleep(0.005)
    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        summary = d.serve_forever(max_ticks=4)
    finally:
        stop.set()
        watcher.join()
    assert summary["served"] == len(queries)
    assert max(ticks) > stale_ms / 1e3
    assert ages and max(ages) < stale_ms / 1e3, max(ages)
    assert quorum.read_beat(spool, "r0")["seq"] == 4
    for rid, q in queries.items():
        np.testing.assert_array_equal(
            read_result(spool, rid),
            transform(model, q, bucket=BUCKET, iters=2))


def test_daemon_summary_keys_equal_jax(tmp_path):
    """The port daemon's summary carries every key of the JAX one."""
    from tsne_flink_tpu.serve.daemon import ServeDaemon as JDaemon
    from tsne_flink_tpu.serve.model import from_arrays as jfrom_arrays
    model, _ = _small_model()
    jm = jfrom_arrays(model.x.numpy(), model.y.numpy(),
                      JPlan(n=96, d=6, k=12, backend="cpu",
                            repulsion="exact", name="shed-test"),
                      perplexity=PERP, learning_rate=LR)
    keys = []
    for name, daemon, m in (("j", JDaemon, jm), ("t", ServeDaemon, model)):
        spool = str(tmp_path / name)
        os.makedirs(spool)
        keys.append(set(daemon(m, spool, bucket=BUCKET, iters=2,
                               tick_s=0.001, replica="r0").serve_forever(
                                   max_ticks=2)))
    assert keys[0] <= keys[1]


def test_daemon_watchdog_beats_every_tick_and_fires_on_a_delay(tmp_path):
    """The watchdog is started by the loop, beaten once a tick and stopped
    at exit; a ``delay@serve`` past its stage timeout fires it (observed
    here through ``on_timeout``; a fleet child ends with exit 124)."""
    model, rng = _small_model()
    spool = str(tmp_path)
    submit(spool, rng.standard_normal((4, 6)).astype(np.float32), "q")
    fired = []
    wd = Watchdog(stage_timeout=0.2, on_timeout=fired.append, poll_s=0.01)
    faults.activate("delay@serve:2", delay_s=0.5)
    try:
        ServeDaemon(model, spool, bucket=BUCKET, iters=2, tick_s=0.001,
                    watchdog=wd).serve_forever(max_ticks=3)
    finally:
        faults.activate(None)
    assert fired == ["stage"] and wd._thread is None   # stopped
    assert read_result(spool, "q") is not None


def test_kill_boundary_lands_after_compute_before_write(tmp_path):
    """``kill@serve:seg0`` in a daemon child: SIGKILL after the first
    request is computed, before its result; the request file and its
    epoch-1 claim stay for the next claimant, who serves it at epoch 2."""
    model, rng = _small_model()
    x_path = str(tmp_path / "x.npy")
    np.save(x_path, model.x.numpy())
    st = TsneState(y=model.y, update=torch.zeros_like(model.y),
                   gains=torch.ones_like(model.y))
    m_path = str(tmp_path / "m.npz")
    ckpt.save(m_path, st, 10, np.asarray([0.5]))
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    q = rng.standard_normal((5, 6)).astype(np.float32)
    submit(spool, q, "k0")
    spec = ServeSpec(name="k", model=m_path, input=x_path, spool=spool,
                     neighbors=12, perplexity=PERP, learning_rate=LR,
                     repulsion="exact", bucket=BUCKET, iters=3,
                     tick_s=0.01, idle_exit_s=0.5, replica="k-r0",
                     fault_plan="kill@serve:seg0", device="cpu",
                     record=str(tmp_path / "rec.json"))
    path = spec.save(str(tmp_path / "spec.json"))
    got = subprocess.run([sys.executable, "-m",
                          "tsne_flink_tpu_torch.runtime.fleet", "--serve",
                          path], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT, **CHILD_ENV))
    assert got.returncode == -signal.SIGKILL, got.stderr[-2000:]
    assert read_result(spool, "k0") is None
    assert quorum.read_epoch(spool, "k0") == 1
    assert read_lock_payload(os.path.join(spool, "k0.req.npz.lock"))[
        "replica"] == "k-r0"
    d = ServeDaemon(load_frozen(m_path, model.x.numpy(), PlanConfig(
        n=96, d=6, k=12, backend="cpu", repulsion="exact"), perplexity=PERP,
        learning_rate=LR, device="cpu"), spool, bucket=BUCKET, iters=3,
        tick_s=0.001)
    assert d.serve_forever(max_ticks=2)["redispatched"] == 1
    np.testing.assert_array_equal(read_result(spool, "k0"), transform(
        d.model, q, bucket=BUCKET, iters=3))
    with open(os.path.join(spool, "k0.lat.json")) as f:
        assert json.load(f)["epoch"] == 2


# ---- the fleet ---------------------------------------------------------------------

def _run_fleet(quorum_env, tmp_path, tag, *, replicas, rids,
               fault_plans=None, stale_ms=60000.0, run_s=60.0,
               serve_extra=None, model_id=None, submit_extra=None):
    spool = str(tmp_path / f"{tag}_spool")
    workdir = str(tmp_path / f"{tag}_work")
    os.makedirs(spool)
    queries = {}
    for i, (rid, rows) in enumerate(rids.items()):
        queries[rid] = _queries(rows, seed=200 + i)
        submit(spool, queries[rid], rid, model_id=model_id)
    if submit_extra:
        submit_extra(spool)
    spec = ServeFleetSpec(
        name=tag, spool=spool, workdir=workdir,
        serve=_serve_template(quorum_env["model"], quorum_env["input"],
                              **(serve_extra or {})),
        replicas=replicas, stale_ms=stale_ms, run_s=run_s, poll_s=0.05,
        max_attempts=3, backoff_base=0.05, backoff_cap=0.2,
        fault_plans=fault_plans or {}, env=CHILD_ENV,
        record=str(tmp_path / f"{tag}_record.json"))
    return run_serve_fleet(spec), spool, queries


def _assert_exactly_once_bitidentical(quorum_env, spool, queries,
                                      extra=()):
    """Every request: exactly one terminal, bit for bit the port's direct
    transform in this process; the drained spool holds terminals only."""
    oracle = quorum_env["oracle"]
    for rid, q in queries.items():
        got = read_result(spool, rid)
        assert got is not None, f"{rid} has no result"
        np.testing.assert_array_equal(
            got, transform(oracle, q, bucket=BUCKET, iters=ITERS))
    assert sorted(os.listdir(spool)) == _terminal_listing(queries,
                                                          extra=extra)


def test_fleet_clean_cli_record(quorum_env, tmp_path):
    """``python -m tsne_flink_tpu_torch.runtime.fleet --serve-fleet``:
    two replicas, the spool drained to terminals only, the record whole,
    every answer bit for bit a direct transform."""
    rids = {"c00": 7, "c01": 16, "c02": 33}
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    queries = {rid: _queries(rows, seed=100 + i)
               for i, (rid, rows) in enumerate(rids.items())}
    for rid, q in queries.items():
        submit(spool, q, rid)
    record_path = str(tmp_path / "fleet.json")
    spec = ServeFleetSpec(
        name="clean", spool=spool, workdir=str(tmp_path / "work"),
        serve=_serve_template(quorum_env["model"], quorum_env["input"]),
        replicas=2, stale_ms=60000.0, run_s=90.0, env=CHILD_ENV,
        record=record_path)
    path = spec.save(str(tmp_path / "fleet.spec.json"))
    got = subprocess.run(
        [sys.executable, "-m", "tsne_flink_tpu_torch.runtime.fleet",
         "--serve-fleet", path], capture_output=True, text=True,
        timeout=110, env=dict(os.environ, PYTHONPATH=ROOT))
    assert got.returncode == 0, got.stderr[-2000:]
    with open(record_path) as f:
        rec = json.load(f)
    assert rec["replicas"] == ["clean-r0", "clean-r1"]
    assert rec["deadline_hit"] is False and rec["sigkills"] == 0
    assert rec["redispatched"] == [] and rec["relaunches"] == 0
    assert rec["attempts"] == {"clean-r0": 1, "clean-r1": 1}
    subs = rec["replica_records"]
    assert sum(s["served"] for s in subs.values()) == len(rids)
    for name, sub in subs.items():
        assert sub["status"] == "ok" and sub["replica"] == name
        assert sub["memory"] is None and sub["warm_s"] > 0
        assert sub["admission"]["charged_bytes"] == sub["admission"][
            "peak_bytes"]   # the CPU gate: the JAX terms
    _assert_exactly_once_bitidentical(quorum_env, spool, queries)
    for rid in rids:
        with open(os.path.join(spool, rid + ".lat.json")) as f:
            lat = json.load(f)
        assert lat["replica"] in subs and lat["epoch"] == 1


def test_fleet_kill_chaos_exactly_once_bitidentical(quorum_env, tmp_path):
    """Both replicas die by their own ``kill@serve:seg0`` (SIGKILL after
    computing a first request, before its result) while holding claims;
    the supervisor breaks the dead claims, relaunches clean with backoff,
    and the drained spool is bit for bit a run where nothing failed."""
    rids = {"q00": 7, "q01": 16, "q02": 9, "q03": 3, "q04": 12}
    rec, spool, queries = _run_fleet(
        quorum_env, tmp_path, "killfleet", replicas=2, rids=rids,
        fault_plans={"0": "kill@serve:seg0", "1": "kill@serve:seg0"})
    assert rec["deadline_hit"] is False
    _assert_exactly_once_bitidentical(quorum_env, spool, queries)
    assert 1 <= len(rec["redispatched"]) and set(rec["redispatched"]) <= set(
        rids)
    assert rec["relaunches"] >= 1 and max(rec["attempts"].values()) >= 2
    assert rec["sigkills"] == 0      # self-inflicted, not the triage's
    exits = [e for e in rec["events"] if e["event"] == "exit"]
    assert any(e["rc"] == -signal.SIGKILL for e in exits)
    with open(os.path.join(spool, rec["redispatched"][0] + ".lat.json")) as f:
        lat = json.load(f)
    assert lat["epoch"] >= 2 and lat["replica"] in rec["attempts"]
    for name, sub in rec["replica_records"].items():
        assert sub is not None and sub["status"] == "ok", name


def test_fleet_hang_chaos_sigkill_redispatch(quorum_env, tmp_path):
    """``hang@serve:2`` wedges the only replica with claims held and its
    pid alive; its beat protects the claims until the beat goes stale,
    then the hung triage SIGKILLs, breaks the claims and relaunches, and
    the backlog drains exactly once."""
    rids = {"h00": 8, "h01": 8, "h02": 8, "h03": 8}
    rec, spool, queries = _run_fleet(
        quorum_env, tmp_path, "hangfleet", replicas=1, rids=rids,
        fault_plans={"0": "hang@serve:2"}, stale_ms=1000.0)
    assert rec["deadline_hit"] is False
    _assert_exactly_once_bitidentical(quorum_env, spool, queries)
    assert rec["sigkills"] == 1
    hung = [e for e in rec["events"] if e["event"] == "sigkill-hung"]
    assert len(hung) == 1 and hung[0]["beat_age_ms"] > 1000.0
    assert len(rec["redispatched"]) >= 1
    assert rec["attempts"]["hangfleet-r0"] == 2
    sub = rec["replica_records"]["hangfleet-r0"]
    assert sub is not None and sub["status"] == "ok"
    assert sub["redispatched"] >= 1


def test_fleet_hotswap_under_load_pinned_bitidentical(quorum_env,
                                                      tmp_path):
    """A swap file activates model B on whichever replica takes it while
    requests pinned to model A flow on both: every answer stays bit for
    bit A's, and exactly one replica acknowledges the swap."""
    _, model_b, input_b = _frozen_fixture(tmp_path, seed=11, stem="model_b")
    mid_a = quorum_env["oracle"].model_id

    def swap_file(spool):
        swap = {"model": model_b, "input": input_b, "perplexity": PERP,
                "learning_rate": LR, "neighbors": K, "repulsion": "exact",
                "activate": True}
        tmp = os.path.join(spool, "swapb.swap.json.part")
        with open(tmp, "w") as f:
            json.dump(swap, f)
        os.replace(tmp, os.path.join(spool, "swapb.swap.json"))
    rids = {"s00": 6, "s01": 11, "s02": 16, "s03": 5}
    rec, spool, queries = _run_fleet(
        quorum_env, tmp_path, "swapfleet", replicas=2, rids=rids,
        model_id=mid_a, submit_extra=swap_file)
    assert rec["deadline_hit"] is False
    _assert_exactly_once_bitidentical(quorum_env, spool, queries,
                                      extra=["swapb.swap.done.json"])
    with open(os.path.join(spool, "swapb.swap.done.json")) as f:
        done = json.load(f)
    assert done["status"] == "ok" and done["action"] == "admit"
    subs = [s for s in rec["replica_records"].values() if s]
    assert len(subs) == 2 and sum(s["swaps"] for s in subs) == 1
    swapped = next(s for s in subs if s["swaps"] == 1)
    assert swapped["residency"]["active"] != mid_a
    assert mid_a in swapped["residency"]["resident"]
    for rid in rids:
        with open(os.path.join(spool, rid + ".lat.json")) as f:
            assert json.load(f)["model_id"] == mid_a


def test_fleet_chaos_storm_mixed_faults_availability(quorum_env,
                                                     tmp_path):
    """Three replicas, one killed and one hung, under a wider backlog:
    every request reaches exactly one terminal, bit for bit serial —
    nothing lost, nothing served twice."""
    rids = {f"st{i:02d}": rows for i, rows in
            enumerate([7, 16, 9, 3, 12, 8, 15, 4])}
    rec, spool, queries = _run_fleet(
        quorum_env, tmp_path, "stormfleet", replicas=3, rids=rids,
        fault_plans={"0": "kill@serve:seg0", "1": "hang@serve:2"},
        stale_ms=1000.0)
    assert rec["deadline_hit"] is False
    _assert_exactly_once_bitidentical(quorum_env, spool, queries)
    for rid in rids:
        with open(os.path.join(spool, rid + ".lat.json")) as f:
            assert json.load(f)["replica"] in rec["attempts"]
    assert rec["relaunches"] >= 1
    for name, sub in rec["replica_records"].items():
        assert sub is not None and sub["status"] == "ok", name


def test_fleet_watchdog_ends_a_delayed_replica_relaunched_clean(
        quorum_env, tmp_path):
    """``delay@serve:2`` past the replica's stage timeout: its watchdog
    ends it with exit 124 (no torn result), the supervisor relaunches it
    clean, and every request is answered bit for bit."""
    rids = {"w00": 8, "w01": 8, "w02": 8}
    rec, spool, queries = _run_fleet(
        quorum_env, tmp_path, "wdfleet", replicas=1, rids=rids,
        fault_plans={"0": "delay@serve:2"},
        serve_extra={"stage_timeout": 1.0, "fault_delay_s": 3.0,
                     "sched": "off", "max_batch": 8})
    assert rec["deadline_hit"] is False
    _assert_exactly_once_bitidentical(quorum_env, spool, queries)
    exits = [e["rc"] for e in rec["events"] if e["event"] == "exit"]
    assert exits == [EXIT_TIMEOUT, 0]
    assert rec["attempts"]["wdfleet-r0"] == 2 and rec["sigkills"] == 0
    assert rec["replica_records"]["wdfleet-r0"]["status"] == "ok"


def test_fleet_float64_matches_jax_transform(tmp_path):
    """A float64 fleet (``x64``, the CPU): every answer bit for bit the
    port's direct transform, and within rtol 1e-9 of the JAX transform on
    the same checkpoint and features."""
    x, model_path, input_path = _frozen_fixture(tmp_path, seed=5,
                                                dtype=np.float64)
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    rng = np.random.default_rng(7)
    queries = {f"f{i}": rng.standard_normal((rows, D))
               for i, rows in enumerate([5, 16, 21])}
    for rid, q in queries.items():
        submit(spool, q, rid)
    rec = run_serve_fleet(ServeFleetSpec(
        name="f64", spool=spool, workdir=str(tmp_path / "work"),
        serve=_serve_template(model_path, input_path, x64=True),
        replicas=2, stale_ms=60000.0, run_s=90.0, env=CHILD_ENV))
    assert rec["deadline_hit"] is False
    plan = dict(n=N, d=D, k=K, backend="cpu", repulsion="exact")
    tm = load_frozen(model_path, x, PlanConfig(**plan), perplexity=PERP,
                     learning_rate=LR, device="cpu")
    jm = jload_frozen(model_path, x, JPlan(**plan), perplexity=PERP,
                      learning_rate=LR)
    for rid, q in queries.items():
        got = read_result(spool, rid)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, transform(tm, q, bucket=BUCKET,
                                                     iters=ITERS))
        want = np.asarray(jtransform(jm, q, bucket=BUCKET, iters=ITERS))
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    assert sorted(os.listdir(spool)) == _terminal_listing(queries)


class _Dying:
    """A replica process that has been signalled but not yet reaped: its
    ``poll`` says running, as a CUDA process's does for a few hundred ms
    after SIGKILL while the driver tears its context down."""

    def __init__(self, proc):
        self._proc, self.pid = proc, proc.pid

    def poll(self):
        return None


def test_hung_replica_is_sigkilled_once_while_it_dies(tmp_path):
    spool = str(tmp_path)
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        rep = quorum._Replica("r0", str(tmp_path / "spec.json"))
        rep.proc = _Dying(child)
        fleet = quorum.ServeFleet(spool, [rep], stale_ms=100.0)
        with open(quorum.beat_path(spool, "r0"), "w") as f:
            json.dump({"replica": "r0", "pid": child.pid, "seq": 1,
                       "t": 0.0, "claimed": []}, f)   # long stale
        for _ in range(3):
            fleet._hung_pass()
        assert child.wait(timeout=10) == -signal.SIGKILL
        assert fleet.sigkills == 1
        assert [e["event"] for e in fleet.events] == ["sigkill-hung"]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def test_no_child_outlives_a_fleet(quorum_env, tmp_path):
    """A fleet whose deadline passes SIGKILLs its stragglers: every child
    is reaped before ``run_serve_fleet`` returns."""
    rec, spool, _ = _run_fleet(
        quorum_env, tmp_path, "deadline", replicas=1, rids={"d0": 4},
        fault_plans={"0": "hang@serve:1"}, run_s=0.5)
    assert rec["deadline_hit"] is True
    pids = [e["pid"] for e in rec["events"] if e["event"] == "spawn"]
    assert pids and not any(quorum.pid_alive(p) for p in pids)
    assert any(e["event"] == "sigkill-deadline" for e in rec["events"])
    # the request stays for the next fleet: its dead claim was broken
    assert os.path.exists(os.path.join(spool, "d0.req.npz"))
    assert not os.path.exists(os.path.join(spool, "d0.req.npz.lock"))
