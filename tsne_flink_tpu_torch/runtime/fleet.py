"""The job fleet — admission-controlled multi-job scheduler (port of the
job tier of ``tsne_flink_tpu/runtime/fleet.py``).

Many embed jobs share one card under one memory budget:

* **admission control** (``runtime/admission.py``): a job launches only
  while the sum of the memory model's per-job peaks fits the fleet
  budget (on the card each peak carries the allocator's reserve and the
  CUDA context: what the other processes see); a job that does not fit
  is statically degraded (blocks assembly) when that makes it fit, else
  queued FIFO until a running job releases its reservation;
* **re-admission at the graph's width**: a job is admitted before its kNN
  graph exists, so it is charged the widest rows its assembly allows;
  once its kNN stage ends the child reports the graph's row-width bound
  (``ops/affinities.width_bound``) in a file the fleet names
  (``JobSpec.fleet["width_path"]``), and the fleet lowers the job's
  charge to the plan at that width — a charge only ever falls, so the
  budget is never over-committed — which may admit a queued job; while a
  running job's charge may still fall, a job that fits only degraded
  waits instead;
* **isolation**: every job is its own OS process (``python -m
  tsne_flink_tpu_torch.runtime.fleet --job spec.json``, started with
  ``subprocess``, never a fork of a process that holds a CUDA context),
  with its own output and record files;
* **retries with backoff**: a failed, killed or timed-out job is
  relaunched up to ``retries`` times after ``supervisor.backoff_seconds``
  (deterministic jitter keyed on the job name);
* **wall-clock timeouts**: the in-job :class:`Watchdog` enforces
  ``job_timeout``/``stage_timeout`` (the CLI's ``--jobTimeout`` /
  ``--stageTimeout``) by ending the process with exit code
  :data:`EXIT_TIMEOUT`; the fleet kills a job that outlives its deadline
  anyway (hung before the watchdog armed);
* **fleet chaos** (``runtime/faults.py``, the ``job`` site):
  ``kill@job:1`` SIGKILLs job 1 at its first segment boundary,
  ``delay@job:1`` slows its kNN stage, ``oom@job:1`` injects an OOM
  there — on the job's FIRST attempt only, so its retry runs clean;
* **shared caches**: jobs share one artifact cache and one kernel
  library, each write under its cross-process lock;
* **observability**: a ``fleet.run`` span with launch/exit/admit/reject/
  retry instants, the counters ``fleet.admission_rejections`` /
  ``fleet.preemptions`` / ``fleet.retries`` and the ``fleet.queue_depth``
  gauge; every job writes a record (its events, degradations, fired
  faults, metrics and measured memory) and :meth:`Fleet.run` returns the
  fleet record embedding them all.

The same entry point runs the serve daemon's two process modes:
``--serve spec.json`` (:class:`ServeSpec`, :func:`run_serve`: one daemon,
a replica when the spec names one) and ``--serve-fleet spec.json``
(:class:`ServeFleetSpec`, :func:`run_serve_fleet`: N replicas over one
spool under ``serve/replicas.ServeFleet``, whose process imports no
torch).

The fleet context the JAX package passes in ``TSNE_FLEET_JOB`` is the
``JobSpec.fleet`` field here, and the knobs a JAX serve child reads from
its environment are :class:`ServeSpec` fields; the port reads no
environment variable.  Jobs and daemons run on the card unless their
spec's ``device`` (or the fleet's) says ``"cpu"``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import asdict, dataclass, field, replace

from tsne_flink_tpu_torch.obs import metrics as obmetrics
from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.obs.trace import walltime
from tsne_flink_tpu_torch.runtime import faults
from tsne_flink_tpu_torch.runtime.admission import (DEGRADE, QUEUE,
                                                    AdmissionController,
                                                    default_budget,
                                                    predicted_peak_bytes)
from tsne_flink_tpu_torch.runtime.supervisor import backoff_seconds

#: exit code of a watchdog-ended (job/stage timeout) process — the
#: ``timeout(1)`` convention, distinct from crashes and SIGKILL
EXIT_TIMEOUT = 124

#: job lifecycle states (the record's ``status``)
PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"

#: the directory that holds the package, put on a child's import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def child_env(extra: dict | None = None) -> dict:
    """A fleet child's environment: this process's, with ``extra`` and the
    package's root first on the import path."""
    env = dict(os.environ)
    env.update(extra or {})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


class Watchdog:
    """In-process wall-clock limits: end the process when the JOB exceeds
    ``job_timeout`` seconds, or when no heartbeat (:meth:`beat` — prepare
    stage completions, segment boundaries) arrives within
    ``stage_timeout`` seconds.

    Ending is ``os._exit(EXIT_TIMEOUT)`` by default (every output writer
    is atomic, so a mid-write exit leaves no torn file); ``on_timeout``
    observes instead of ending.  A watchdog with neither limit starts no
    thread.  Callers stop it in a ``finally``, so that an in-process
    caller is never ended by a stale watchdog."""

    def __init__(self, job_timeout: float | None = None,
                 stage_timeout: float | None = None, label: str = "job",
                 on_timeout=None, poll_s: float = 0.05):
        self.job_timeout = float(job_timeout) if job_timeout else None
        self.stage_timeout = float(stage_timeout) if stage_timeout else None
        self.label = label
        self.on_timeout = on_timeout
        self.poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread = None
        self._t0 = None
        self._last_beat = None
        self._stage = "start"

    @property
    def armed(self) -> bool:
        return self.job_timeout is not None or self.stage_timeout is not None

    def beat(self, stage: str = "") -> None:
        """Progress heartbeat: resets the stage-timeout clock."""
        self._last_beat = walltime()
        if stage:
            self._stage = stage

    def _fire(self, kind: str, limit: float) -> None:
        msg = (f"# watchdog: {kind} timeout — {self.label} exceeded "
               f"{limit:.1f}s (last stage: {self._stage}); terminating "
               f"with exit code {EXIT_TIMEOUT}")
        print(msg, file=sys.stderr, flush=True)
        obtrace.instant("watchdog.timeout", cat="runtime", kind=kind,
                        limit=limit, stage=self._stage)
        obmetrics.counter("runtime.watchdog_timeout").inc()
        if self.on_timeout is not None:
            self.on_timeout(kind)
            return
        os._exit(EXIT_TIMEOUT)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            now = walltime()
            if (self.job_timeout is not None
                    and now - self._t0 > self.job_timeout):
                self._fire("job", self.job_timeout)
                return
            if (self.stage_timeout is not None
                    and now - self._last_beat > self.stage_timeout):
                self._fire("stage", self.stage_timeout)
                return

    def start(self) -> "Watchdog":
        if not self.armed or self._thread is not None:
            return self
        self._t0 = self._last_beat = walltime()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"watchdog-{self.label}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


@dataclass
class JobSpec:
    """One embed job, JSON-serializable (the fleet<->child contract)."""

    name: str
    input: str                     # [n, d] points, .npy
    out: str = ""                  # embedding .npy (fleet fills)
    record: str = ""               # per-job record JSON (fleet fills)
    iterations: int = 100
    perplexity: float = 10.0
    neighbors: int | None = None   # default 3 * perplexity
    knn_method: str = "bruteforce"
    repulsion: str = "auto"
    assembly: str | None = None    # None = auto (admission may pin)
    row_chunk: int = 2048
    seed: int = 0
    x64: bool = False              # float64 (the kernels' float64 forms)
    max_retries: int = 2           # in-job supervisor ladder relaunches
    fault_plan: str | None = None  # process-local chaos (job's own sites)
    job_timeout: float | None = None
    stage_timeout: float | None = None
    cache_dir: str | None = None   # shared artifact cache root
    device: str | None = None      # None: the card; "cpu"
    fleet: dict | None = None      # the scheduling context (fleet fills)

    def k(self) -> int:
        return (int(self.neighbors) if self.neighbors is not None
                else 3 * int(self.perplexity))

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)
        return path

    @classmethod
    def load(cls, path: str) -> "JobSpec":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def _input_shape(path: str) -> tuple[int, int]:
    """(n, d) from the .npy header without loading the data."""
    import numpy as np
    a = np.load(path, mmap_mode="r")
    return int(a.shape[0]), int(a.shape[1])


def _backend(device) -> str:
    return "cuda" if device is None else str(device).split(":")[0]


def _job_cfg(spec: JobSpec, n: int, backend: str):
    """The job's TsneConfig, its repulsion by the CLI's auto policy (a
    fleet job and a solo CLI run of the same spec dispatch the same)."""
    from dataclasses import replace

    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.utils.cli import pick_repulsion
    cfg = TsneConfig(iterations=int(spec.iterations),
                     perplexity=float(spec.perplexity),
                     row_chunk=int(spec.row_chunk))
    return replace(cfg, repulsion=pick_repulsion(
        spec.repulsion, cfg.theta, n, cfg.n_components,
        theta_explicit=False, backend=backend))


def job_plan(spec: JobSpec, backend: str | None = None):
    """The job's memory-model PlanConfig — the admission controller's
    input (the plan the in-job supervisor hands its ladder).  ``backend``
    defaults to the job's device type."""
    from tsne_flink_tpu_torch.runtime.supervisor import run_plan_from_fit
    backend = backend or _backend(spec.device)
    n, d = _input_shape(spec.input)
    return run_plan_from_fit(n, d, spec.k(), _job_cfg(spec, n, backend),
                             spec.assembly or "auto", spec.knn_method,
                             name=f"fleet-{spec.name}", backend=backend)


def _memory_record(device) -> dict | None:
    """The job process's measured peaks on the card (None elsewhere)."""
    import torch
    if device.type != "cuda":
        return None
    return {"peak_allocated": int(torch.cuda.max_memory_allocated(device)),
            "peak_reserved": int(torch.cuda.max_memory_reserved(device))}


# ---- the child: one job, one process ---------------------------------------

def _width_reporter(spec: JobSpec):
    """The child's half of re-admission: write the kNN graph's row-width
    bound where the fleet looks for it (None outside a fleet)."""
    path = (spec.fleet or {}).get("width_path")
    if not path:
        return None

    def report(width: int) -> None:
        from tsne_flink_tpu_torch.utils.io import atomic_write

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({"sym_width": int(width)}, f)
        atomic_write(path, write)
    return report


def _write_record(path: str, record: dict) -> None:
    """Write a process's record atomically at ``path`` (none when empty)."""
    if not path:
        return
    try:
        from tsne_flink_tpu_torch.utils.io import atomic_write

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(record, f, indent=2)
        atomic_write(path, write)
    except OSError:
        pass  # the record is evidence, not a result


def run_job(spec: JobSpec) -> dict:
    """Run one embed job in THIS process and return its record (the
    subprocess entry point below also writes it to ``spec.record``).

    The pipeline is ``supervisor.supervised_embed`` — the supervised
    prepare + segmented optimize the CLI and the estimator route through,
    so ladder and sentinel recovery and the fault sites behave alike in
    and out of a fleet."""
    import numpy as np
    import torch

    from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
                                                         supervised_embed)
    from tsne_flink_tpu_torch.utils import io as tio
    from tsne_flink_tpu_torch.utils.artifacts import ArtifactCache
    from tsne_flink_tpu_torch.utils.device import resolve_device

    faults.activate(spec.fault_plan)
    wd = Watchdog(spec.job_timeout, spec.stage_timeout,
                  label=spec.name).start()
    sp = obtrace.begin("fleet.job", cat="fleet", job=spec.name)
    record = {"name": spec.name, "status": "ok", "n": None,
              "iterations": int(spec.iterations), "fleet": spec.fleet}
    device = None
    try:
        device = resolve_device(spec.device)
        x = np.load(spec.input)
        record["n"] = int(x.shape[0])
        dtype = torch.float64 if spec.x64 else torch.float32
        cfg = _job_cfg(spec, x.shape[0], device.type)
        sup = Supervisor(job_plan(spec, device.type),
                         max_retries=int(spec.max_retries),
                         on_width=_width_reporter(spec))
        stages: dict = {}

        def on_stage(stage, secs, cache_state):
            stages[stage] = {"seconds": round(float(secs), 3),
                             "cache": cache_state}
            wd.beat(stage)

        run = supervised_embed(
            torch.as_tensor(x, dtype=dtype), cfg, supervisor=sup,
            neighbors=spec.k(), knn_method=spec.knn_method,
            seed=int(spec.seed), affinity_assembly=spec.assembly,
            device=device,
            artifact_cache=(ArtifactCache(spec.cache_dir)
                            if spec.cache_dir else None),
            on_stage=on_stage,
            checkpoint_cb=lambda *a: wd.beat("optimize"))
        y = run.state.y.cpu().numpy()
        if not np.isfinite(y).all():
            raise RuntimeError(f"job '{spec.name}' produced a non-finite "
                               "embedding")
        if spec.out:
            def write(tmp):
                with open(tmp, "wb") as f:
                    np.save(f, y)
            tio.atomic_write(spec.out, write)
        inj = faults.injector()
        record.update(
            stages=stages, degradations=sup.degradations, events=sup.events,
            releases=sup.releases, width_bound=sup.width_bound,
            faults_fired=[list(t) for t in (inj.log if inj else [])],
            final_loss=float(run.losses[-1]), backend=device.type)
    except BaseException as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}")
        raise
    finally:
        sp.end()
        record["seconds"] = round(sp.seconds, 3)
        record["metrics"] = obmetrics.snapshot()
        if device is not None:
            record["memory"] = _memory_record(device)
        wd.stop()
        faults.activate(None)
        _write_record(spec.record, record)
    return record


# ---- the serve daemon's process modes ---------------------------------------

@dataclass
class ServeSpec:
    """One serve daemon, JSON-serializable (the fleet<->daemon contract).
    The knobs a JAX child reads from its environment are fields here, with
    the JAX defaults: ``tick_s`` (``TSNE_SERVE_TICK_S``), ``idle_exit_s``
    (``TSNE_SERVE_IDLE_EXIT_S``; None: run until killed), ``lock_stale_s``
    (``TSNE_LOCK_STALE_S``), ``max_batch`` (``TSNE_SERVE_MAX_BATCH``),
    ``fault_delay_s`` (``TSNE_FAULT_DELAY_S``) and ``device`` (None: the
    card; ``"cpu"`` for ``TSNE_FORCE_CPU``)."""

    name: str
    model: str                     # fat v2 checkpoint (the frozen map)
    input: str                     # [n, d] base features, .npy
    spool: str                     # request spool directory
    record: str = ""               # serving-summary JSON (written at exit)
    perplexity: float = 10.0
    learning_rate: float = 1000.0
    metric: str = "sqeuclidean"
    neighbors: int | None = None   # default 3 * perplexity
    repulsion: str = "auto"
    bucket: int | None = None
    iters: int | None = None
    eta: float | None = None
    max_ticks: int | None = None   # None: until idle exit or a kill
    x64: bool = False              # a float64 model (its own dtype on the card)
    fault_plan: str | None = None
    job_timeout: float | None = None
    stage_timeout: float | None = None
    sched: str | None = None       # on | off (None: on)
    deadline_ms: float | None = None
    starve_ms: float | None = None
    poll_max_ms: float | None = None
    replica: str | None = None     # replica name (None: a solo daemon)
    shed_depth: int | None = None  # None: 0, no shedding
    stale_ms: float | None = None  # None: 5,000 ms
    models: list | None = None     # extra resident models: [{"model":
    #   ckpt, "input": npy, "perplexity"?, "learning_rate"?, "metric"?,
    #   "neighbors"?, "repulsion"?, "activate"?: bool}, ...]
    tick_s: float | None = None    # None: 0.05 s
    idle_exit_s: float | None = None
    lock_stale_s: float | None = None  # None: 60 s
    max_batch: int | None = None   # None: 1,024 rows
    fault_delay_s: float | None = None  # None: faults.DELAY_S
    device: str | None = None      # None: the card; "cpu"

    def k(self) -> int:
        return (int(self.neighbors) if self.neighbors is not None
                else 3 * int(self.perplexity))

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeSpec":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)
        return path

    @classmethod
    def load(cls, path: str) -> "ServeSpec":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def run_serve(spec: ServeSpec) -> dict:
    """The daemon process: load the frozen model once, run one bucket so
    that the first request pays no start-up (the record's ``t_warm``),
    drain the spool until the idle exit, ``max_ticks`` or a watchdog
    ending (exit 124 on a wedged tick).  The fault plan is active before
    any site; the record (the daemon's summary, start-up seconds, this
    process's kernel launches and measured memory) is written atomically
    at exit."""
    import numpy as np
    import torch

    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    from tsne_flink_tpu_torch.kernels import build as kbuild
    from tsne_flink_tpu_torch.serve.daemon import ServeDaemon
    from tsne_flink_tpu_torch.serve.model import (frozen_from_files,
                                                  load_frozen)
    from tsne_flink_tpu_torch.serve.transform import warm_stages
    from tsne_flink_tpu_torch.utils.device import resolve_device

    faults.activate(spec.fault_plan, delay_s=spec.fault_delay_s)
    sp = obtrace.begin("fleet.serve", cat="fleet", job=spec.name)
    record = {"name": spec.name, "status": "ok", "pid": os.getpid()}
    wd = Watchdog(spec.job_timeout, spec.stage_timeout,
                  label=f"serve-{spec.name}")
    device = None
    try:
        device = resolve_device(spec.device)
        x = np.load(spec.input)
        if spec.x64:
            x = x.astype(np.float64)
        plan = PlanConfig(n=int(x.shape[0]), d=int(x.shape[1]), k=spec.k(),
                          backend=device.type, repulsion=spec.repulsion,
                          name=f"fleet-serve-{spec.name}")
        model = load_frozen(spec.model, x, plan,
                            perplexity=float(spec.perplexity),
                            learning_rate=float(spec.learning_rate),
                            metric=spec.metric, device=device,
                            dtype=torch.float64 if spec.x64 else None)
        daemon = ServeDaemon(model, spec.spool, bucket=spec.bucket,
                             iters=spec.iters, eta=spec.eta,
                             tick_s=spec.tick_s, max_batch=spec.max_batch,
                             idle_exit_s=spec.idle_exit_s, watchdog=wd,
                             sched=spec.sched, deadline_ms=spec.deadline_ms,
                             starve_ms=spec.starve_ms,
                             poll_max_ms=spec.poll_max_ms,
                             replica=spec.replica,
                             shed_depth=spec.shed_depth,
                             stale_ms=spec.stale_ms,
                             lock_stale_s=spec.lock_stale_s)
        for extra in (spec.models or []):
            daemon.load_model(
                frozen_from_files(
                    extra["model"], extra["input"],
                    perplexity=float(extra.get("perplexity",
                                               spec.perplexity)),
                    learning_rate=float(extra.get("learning_rate",
                                                  spec.learning_rate)),
                    metric=extra.get("metric", spec.metric),
                    neighbors=extra.get("neighbors", spec.neighbors),
                    repulsion=extra.get("repulsion", spec.repulsion),
                    name=spec.name, device=device,
                    dtype=torch.float64 if spec.x64 else None),
                activate=bool(extra.get("activate", False)))
        warm_stages(model, bucket=daemon.bucket, iters=daemon.iters,
                    eta=daemon.eta)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        record.update(warm_s=round(sp.elapsed(), 3), t_warm=walltime(),
                      kernel_cache=kbuild.cache_state())
        kbuild.reset_launches()   # the serving loop's launches alone
        record.update(daemon.serve_forever(max_ticks=spec.max_ticks))
        record["launches"] = kbuild.launches()
    except BaseException as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}")
        raise
    finally:
        sp.end()
        record["seconds"] = round(sp.seconds, 3)
        inj = faults.injector()
        record["faults_fired"] = [list(t) for t in (inj.log if inj else [])]
        if device is not None:
            record["memory"] = _memory_record(device)
        faults.activate(None)
        _write_record(spec.record, record)
    return record


@dataclass
class ServeFleetSpec:
    """N replica daemons over ONE spool, JSON-serializable (the
    ``serve/replicas.ServeFleet`` contract).  ``serve`` is a
    :class:`ServeSpec` template (model, input, bucket, scheduler knobs,
    device); the supervisor stamps each replica's ``name``, ``replica``,
    ``spool`` and ``record`` onto it and writes two spec files a replica:
    the chaos one (its ``fault_plans`` entry, keyed by index or name;
    first attempt) and the clean one (every relaunch)."""

    name: str
    spool: str
    workdir: str                   # replicas' specs, logs and records
    serve: dict = field(default_factory=dict)
    replicas: int | None = None    # None: 2
    stale_ms: float | None = None  # None: 5,000 ms
    shed_depth: int | None = None  # None: 0
    run_s: float = 120.0           # the supervisor's deadline
    poll_s: float = 0.05
    max_attempts: int = 3          # spawns a replica, the first included
    backoff_base: float | None = None
    backoff_cap: float | None = None
    fault_plans: dict = field(default_factory=dict)  # {"0"|name: plan}
    env: dict = field(default_factory=dict)          # extra child env
    record: str = ""               # the fleet record (written at exit)

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeFleetSpec":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)
        return path

    @classmethod
    def load(cls, path: str) -> "ServeFleetSpec":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def run_serve_fleet(spec: ServeFleetSpec) -> dict:
    """The replica supervisor: write each replica's chaos and clean
    :class:`ServeSpec` files, spawn N ``--serve`` children over the shared
    spool, and run the heartbeat triage, re-dispatch and relaunch loop
    until the spool drains or ``run_s`` passes.  Imports no torch."""
    from tsne_flink_tpu_torch.serve import replicas as quorum

    os.makedirs(spec.workdir, exist_ok=True)
    os.makedirs(spec.spool, exist_ok=True)
    n = quorum.pick_serve_replicas(spec.replicas)
    members = []
    for i in range(n):
        name = f"{spec.name}-r{i}"
        plan = spec.fault_plans.get(str(i)) or spec.fault_plans.get(name)
        base = dict(spec.serve)
        base.update(name=name, spool=spec.spool, replica=name,
                    shed_depth=spec.shed_depth, stale_ms=spec.stale_ms,
                    record=os.path.join(spec.workdir,
                                        name + ".record.json"))
        clean = ServeSpec.from_dict({**base, "fault_plan": None})
        clean_path = clean.save(
            os.path.join(spec.workdir, name + ".clean.spec.json"))
        chaos_path = clean_path
        if plan:
            chaos = ServeSpec.from_dict({**base, "fault_plan": str(plan)})
            chaos_path = chaos.save(
                os.path.join(spec.workdir, name + ".spec.json"))
        members.append(quorum._Replica(
            name, chaos_path, clean_spec_path=clean_path,
            log_path=os.path.join(spec.workdir, name + ".log")))
    fleet = quorum.ServeFleet(spec.spool, members, stale_ms=spec.stale_ms,
                              poll_s=spec.poll_s,
                              max_attempts=spec.max_attempts, env=spec.env,
                              backoff_base=spec.backoff_base,
                              backoff_cap=spec.backoff_cap)
    record = {"name": spec.name, "spool": spec.spool,
              "fault_plans": dict(spec.fault_plans)}
    record.update(fleet.run(spec.run_s))
    summaries = {}
    for rep in members:
        try:
            with open(os.path.join(spec.workdir, rep.name + ".record.json"),
                      encoding="utf-8") as f:
                summaries[rep.name] = json.load(f)
        except (OSError, ValueError):
            summaries[rep.name] = None   # died before its record landed
    record["replica_records"] = summaries
    _write_record(spec.record, record)
    return record


def main(argv=None) -> int:
    """Subprocess entry: ``python -m tsne_flink_tpu_torch.runtime.fleet
    --job spec.json`` (one embed job), ``--serve spec.json`` (one serve
    daemon) or ``--serve-fleet spec.json`` (the replica supervisor)."""
    import argparse
    p = argparse.ArgumentParser(prog="tsne-torch-fleet-job")
    p.add_argument("--job", help="JobSpec JSON path")
    p.add_argument("--serve", help="ServeSpec JSON path (one daemon)")
    p.add_argument("--serve-fleet", dest="serve_fleet",
                   help="ServeFleetSpec JSON path (replica supervisor)")
    args = p.parse_args(argv)
    if sum(map(bool, (args.job, args.serve, args.serve_fleet))) != 1:
        p.error("exactly one of --job / --serve / --serve-fleet "
                "is required")
    if args.serve:
        run_serve(ServeSpec.load(args.serve))
    elif args.serve_fleet:
        run_serve_fleet(ServeFleetSpec.load(args.serve_fleet))
    else:
        run_job(JobSpec.load(args.job))
    return 0


# ---- the scheduler ---------------------------------------------------------

@dataclass
class _JobState:
    """Scheduler-side bookkeeping for one job."""

    spec: JobSpec
    index: int
    plan: object
    chaos: list = field(default_factory=list)   # fleet faults for attempt 1
    attempts: int = 0
    status: str = PENDING
    not_before: float = 0.0      # fleet-clock seconds (backoff gate)
    decision: dict | None = None
    peak: int = 0
    proc: object = None
    launched_at: float = 0.0
    seconds: float = 0.0
    returncode: int | None = None
    failure: str | None = None   # error | killed | timeout
    counted_reject: bool = False
    log_path: str = ""
    width_path: str = ""         # the attempt's width report (re-admission)

    def record_path(self) -> str:
        return self.spec.record


class Fleet:
    """Run ``jobs`` concurrently under one memory budget.

    ``budget_bytes``: admission budget (None = the card's memory on
    ``cuda``, unlimited on the CPU).  ``device``: the jobs' device where
    a spec names none (None: the first job's, else the card).  ``retries``: relaunches per job
    after a crash, kill or timeout (chaos faults ride attempt 1 only).
    ``fault_plan``: fleet-level chaos, ``job``-site clauses only
    (``kill@job:1,delay@job:0`` — ``runtime/faults.split_fleet_plan``).
    ``env``: extra environment for every child.
    """

    def __init__(self, jobs, workdir: str, *, budget_bytes=None,
                 device=None, degrade: bool = True,
                 max_concurrent: int | None = None, retries: int = 1,
                 job_timeout: float | None = None,
                 stage_timeout: float | None = None,
                 backoff_base: float | None = None,
                 backoff_cap: float | None = None,
                 fault_plan: str | None = None,
                 cache_dir: str | None = None, env: dict | None = None,
                 poll_s: float = 0.05):
        jobs = list(jobs)
        if device is None and jobs:
            device = jobs[0].device  # the jobs' own device
        self.backend = _backend(device)
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.budget_bytes = default_budget(self.backend, budget_bytes)
        self.controller = AdmissionController(self.budget_bytes,
                                              degrade=degrade)
        self.max_concurrent = int(max_concurrent or 0)
        self.retries = int(retries)
        self.job_timeout = job_timeout
        self.stage_timeout = stage_timeout
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.cache_dir = cache_dir
        self.env = dict(env or {})
        self.poll_s = float(poll_s)
        by_job = faults.split_fleet_plan(fault_plan)
        self.jobs: list[_JobState] = []
        names = set()
        for i, spec in enumerate(jobs):
            if spec.name in names:
                raise ValueError(f"duplicate job name '{spec.name}' — "
                                 "names key outputs and records")
            names.add(spec.name)
            spec.out = spec.out or os.path.join(workdir,
                                                f"{spec.name}.y.npy")
            spec.record = spec.record or os.path.join(
                workdir, f"{spec.name}.record.json")
            spec.cache_dir = spec.cache_dir or cache_dir
            spec.device = spec.device or (None if device is None
                                          else str(device))
            spec.job_timeout = (self.job_timeout if spec.job_timeout is None
                                else spec.job_timeout)
            spec.stage_timeout = (self.stage_timeout
                                  if spec.stage_timeout is None
                                  else spec.stage_timeout)
            self.jobs.append(_JobState(
                spec=spec, index=i,
                plan=job_plan(spec, _backend(spec.device)),
                chaos=by_job.get(i, [])))
        self.max_running = 0
        self.queue_depth_max = 0
        self.chaos_log: list = []
        #: (job, in-use bytes before, the job's peak) at every admission
        self.admissions: list = []
        #: every charge lowered to a reported width bound
        self.readmissions: list = []
        self._counters0: dict = {}

    # ---- child launch ------------------------------------------------------

    def _attempt_fault_plan(self, job: _JobState) -> str | None:
        """The child's plan for this attempt: fleet chaos clauses (attempt
        1 only) translated via FLEET_KIND_PLAN, joined with the job's own
        process-local plan."""
        parts = []
        if job.attempts == 0:
            for f in job.chaos:
                parts.append(faults.FLEET_KIND_PLAN[f.kind])
                self.chaos_log.append(
                    {"clause": f"{f.kind}@job:{f.trigger}",
                     "job": job.spec.name, "attempt": job.attempts + 1,
                     "injected": parts[-1]})
        if job.spec.fault_plan:
            parts.append(job.spec.fault_plan)
        return ",".join(parts) or None

    def _launch(self, job: _JobState, elapsed: float) -> None:
        spec_path = os.path.join(
            self.workdir,
            f"{job.spec.name}.attempt{job.attempts + 1}.json")
        job.width_path = ""
        if job.plan.sym_width is None and job.spec.assembly != "blocks":
            job.width_path = os.path.join(
                self.workdir,
                f"{job.spec.name}.attempt{job.attempts + 1}.width.json")
        spec = JobSpec.from_dict({
            **job.spec.as_dict(), "fault_plan": self._attempt_fault_plan(job),
            "fleet": {"name": job.spec.name, "index": job.index,
                      "attempt": job.attempts + 1,
                      "budget_bytes": self.budget_bytes,
                      "predicted_peak": job.peak,
                      "width_path": job.width_path}})
        spec.save(spec_path)
        env = child_env(self.env)
        job.log_path = os.path.join(
            self.workdir, f"{job.spec.name}.attempt{job.attempts + 1}.log")
        with open(job.log_path, "wb") as logf:
            job.proc = subprocess.Popen(
                [sys.executable, "-m", "tsne_flink_tpu_torch.runtime.fleet",
                 "--job", spec_path],
                stdout=logf, stderr=subprocess.STDOUT, env=env)
        job.attempts += 1
        job.status = RUNNING
        job.launched_at = elapsed
        obtrace.instant("fleet.launch", cat="fleet", job=job.spec.name,
                        attempt=job.attempts, pid=job.proc.pid,
                        predicted_peak=job.peak)

    # ---- scheduling passes -------------------------------------------------

    def _pending(self):
        return [j for j in self.jobs if j.status == PENDING]

    def _running(self):
        return [j for j in self.jobs if j.status == RUNNING]

    def _in_use(self) -> int:
        return sum(j.peak for j in self._running())

    def _admit_pass(self, elapsed: float) -> None:
        for job in self._pending():
            if elapsed < job.not_before:
                continue  # backoff window: waiting, not rejected
            if (self.max_concurrent
                    and len(self._running()) >= self.max_concurrent):
                self._count_reject(job, "max-concurrent cap")
                continue
            in_use = self._in_use()
            decision = self.controller.decide(job.plan, in_use)
            if decision.action == QUEUE:
                self._count_reject(job, decision.reason)
                continue
            if decision.action == DEGRADE and any(
                    j.width_path for j in self._running()):
                # a running job's charge may still fall to its graph's
                # width: wait for it rather than degrade this job for good
                self._count_reject(job, "waiting for a running job's "
                                   "re-admission before degrading")
                continue
            job.decision = decision.as_dict()
            job.peak = decision.predicted_peak
            job.counted_reject = False
            self.admissions.append((job.spec.name, in_use, job.peak))
            if decision.overrides.get("assembly"):
                job.spec.assembly = decision.overrides["assembly"]
                job.plan = replace(job.plan,
                                   assembly=decision.overrides["assembly"])
            obtrace.instant("fleet.admit", cat="fleet", job=job.spec.name,
                            action=decision.action,
                            predicted_peak=decision.predicted_peak,
                            in_use=in_use)
            if decision.action != "admit":
                obmetrics.counter("fleet.admission_degrades").inc()
            self._launch(job, elapsed)
            self.max_running = max(self.max_running, len(self._running()))
        depth = len(self._pending())
        obmetrics.gauge("fleet.queue_depth").set(depth)
        obmetrics.gauge("fleet.in_use_bytes").set(self._in_use())
        self.queue_depth_max = max(self.queue_depth_max, depth)

    def _count_reject(self, job: _JobState, reason: str) -> None:
        if job.counted_reject:
            return  # one rejection per (job, queue residence)
        job.counted_reject = True
        obmetrics.counter("fleet.admission_rejections").inc()
        obtrace.instant("fleet.reject", cat="fleet", job=job.spec.name,
                        reason=reason)

    def _readmit_pass(self) -> bool:
        """Lower a running job's charge to its plan at the row-width bound
        its child reported; True when a charge changed.  The plan keeps
        the width, so a retry is admitted at it."""
        changed = False
        for job in self._running():
            if not job.width_path or not os.path.exists(job.width_path):
                continue
            try:
                with open(job.width_path, encoding="utf-8") as f:
                    width = int(json.load(f)["sym_width"])
            except (OSError, ValueError, KeyError):
                continue
            job.width_path = ""
            job.plan = replace(job.plan, sym_width=width)
            before, job.peak = job.peak, predicted_peak_bytes(job.plan)
            self.readmissions.append(
                {"job": job.spec.name, "attempt": job.attempts,
                 "sym_width": width, "before": before, "after": job.peak,
                 "in_use": self._in_use()})
            obmetrics.counter("fleet.readmissions").inc()
            obtrace.instant("fleet.readmit", cat="fleet", job=job.spec.name,
                            sym_width=width, before=before, after=job.peak)
            changed = True
        return changed

    def _poll_pass(self, elapsed: float) -> bool:
        """Reap finished children, kill deadline overruns, re-admit at
        reported widths; True when any job changed state or charge
        (capacity may have freed)."""
        changed = self._readmit_pass()
        for job in self._running():
            rc = job.proc.poll()
            if rc is None:
                limit = job.spec.job_timeout
                if limit and elapsed - job.launched_at > limit + 5.0:
                    # the child's own watchdog should have fired; a child
                    # hung before arming it is the fleet's to end
                    job.proc.kill()
                    job.proc.wait()
                    rc = EXIT_TIMEOUT
                    obmetrics.counter("fleet.preemptions").inc()
                    obtrace.instant("fleet.preempt", cat="fleet",
                                    job=job.spec.name, kind="job-deadline")
                else:
                    continue
            job.returncode = rc
            job.seconds = round(elapsed - job.launched_at, 3)
            changed = True
            if rc == 0:
                job.status = DONE
                job.counted_reject = False
                obmetrics.counter("fleet.jobs_completed").inc()
                obtrace.instant("fleet.exit", cat="fleet",
                                job=job.spec.name, returncode=rc,
                                attempts=job.attempts)
                continue
            job.failure = ("timeout" if rc == EXIT_TIMEOUT
                           else "killed" if rc < 0 else "error")
            if rc == EXIT_TIMEOUT:
                obmetrics.counter("fleet.preemptions").inc()
            obtrace.instant("fleet.exit", cat="fleet", job=job.spec.name,
                            returncode=rc, failure=job.failure,
                            attempts=job.attempts)
            if job.attempts <= self.retries:
                delay = backoff_seconds(job.attempts - 1,
                                        self.backoff_base,
                                        self.backoff_cap,
                                        token=job.spec.name)
                job.status = PENDING
                job.not_before = elapsed + delay
                job.counted_reject = False
                obmetrics.counter("fleet.retries").inc()
                obtrace.instant("fleet.retry", cat="fleet",
                                job=job.spec.name, attempt=job.attempts + 1,
                                backoff_s=round(delay, 3))
            else:
                job.status = FAILED
                obmetrics.counter("fleet.jobs_failed").inc()
        return changed

    # ---- run ---------------------------------------------------------------

    def run(self) -> dict:
        """Schedule every job to completion; returns the fleet record.
        Every child still running when the loop ends (an exception here)
        is killed.  The record's counts are this run's: the registry's
        counters less what they held when it began."""
        self._counters0 = dict(obmetrics.snapshot()["counters"])
        sp = obtrace.begin("fleet.run", cat="fleet",
                           jobs=len(self.jobs), budget=self.budget_bytes)
        try:
            self._admit_pass(sp.elapsed())
            while self._running() or self._pending():
                time.sleep(self.poll_s)
                now = sp.elapsed()
                if self._poll_pass(now) or self._pending():
                    self._admit_pass(now)
                if not self._running() and self._pending():
                    # nothing running and nothing admissible: a pending job
                    # is backoff-gated (wait for it) or over budget against
                    # an EMPTY fleet — refuse to spin forever on the latter
                    waiting = [j for j in self._pending()
                               if now < j.not_before]
                    if not waiting:
                        for job in self._pending():
                            job.status = FAILED
                            job.failure = "unschedulable"
                            obmetrics.counter("fleet.jobs_failed").inc()
        finally:
            for job in self._running():
                job.proc.kill()
                job.proc.wait()
            sp.end()
        return self._record(sp.seconds)

    def _record(self, seconds: float) -> dict:
        jobs = []
        for job in sorted(self.jobs, key=lambda j: j.index):
            rec = None
            try:
                with open(job.record_path(), encoding="utf-8") as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                pass
            jobs.append({
                "name": job.spec.name, "index": job.index,
                "status": job.status, "attempts": job.attempts,
                "returncode": job.returncode, "failure": job.failure,
                "seconds": job.seconds, "predicted_peak": job.peak,
                "decision": job.decision, "out": job.spec.out,
                "record": rec})
        before = self._counters0
        counters = {k: v - before.get(k, 0)
                    for k, v in obmetrics.snapshot()["counters"].items()}
        return {
            "fleet": {
                "backend": self.backend,
                "budget_bytes": self.budget_bytes,
                "jobs_total": len(self.jobs),
                "completed": sum(j.status == DONE for j in self.jobs),
                "failed": sum(j.status == FAILED for j in self.jobs),
                "max_running": self.max_running,
                "queue_depth_max": self.queue_depth_max,
                "admission_rejections":
                    int(counters.get("fleet.admission_rejections", 0)),
                "preemptions": int(counters.get("fleet.preemptions", 0)),
                "retries": int(counters.get("fleet.retries", 0)),
                "readmissions": len(self.readmissions),
                "seconds": round(seconds, 3),
            },
            "chaos": self.chaos_log,
            "admissions": [list(a) for a in self.admissions],
            "readmissions": list(self.readmissions),
            "jobs": jobs,
            "metrics": obmetrics.snapshot(),
        }


if __name__ == "__main__":
    sys.exit(main())
