"""The run supervisor: prepare + optimize end to end with recovery (port
of ``tsne_flink_tpu/runtime/supervisor.py``).

One :class:`Supervisor` wraps one run.  It owns the OOM ladder
(:mod:`~tsne_flink_tpu_torch.runtime.ladder`), threads the divergence
sentinel's flags into the segment runner (``runtime/segments.py``),
captures the last good (state, iteration, losses, pilot pair) at every
segment boundary, so an OOM relaunch resumes from the failed stage
instead of from zero, and logs every recovery decision as a structured
event (``events``, ``degradations``; the estimator's ``runtime_events_``
and ``degradations_``).

Consumed by ``utils/cli.py`` (``--maxRetries`` / ``--onOom`` /
``--healthCheck``), ``runtime/fleet.run_job`` and ``models/api.py`` (the
estimator keywords of the same names).  The optimize stage runs on one
device or, given a sharded optimizer, over its point mesh
(``parallel/mesh``): the ladder and the sentinel work the same way on
both.

Before a relaunch the failed attempt's memory is given back: the
exception and its traceback (whose frames hold the attempt's tensors) are
dropped when the handler ends, then ``gc.collect()`` and
``torch.cuda.empty_cache()`` run, and the bytes that freed are recorded
(:attr:`Supervisor.releases`).  Only a device allocation failure is
ladder-eligible (:func:`is_oom`); a sticky CUDA error (an illegal
address, a failed kernel launch) leaves the context unusable and always
propagates.
"""

from __future__ import annotations

import gc
import hashlib
import sys
import time

from tsne_flink_tpu_torch.obs import metrics as obmetrics
from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.runtime.ladder import OomLadder

#: substrings of a device out-of-memory error: the JAX package's (XLA's
#: spellings, and the injected form's RESOURCE_EXHAUSTED), PyTorch's
#: caching allocator ("CUDA out of memory") and cuBLAS's allocation
#: failure
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM when allocating", "CUBLAS_STATUS_ALLOC_FAILED")

#: substrings of a sticky CUDA error: after one the context is unusable,
#: so it is never an OOM to recover from, whatever else the text says
_STICKY_MARKERS = ("illegal memory access", "illegal address",
                   "illegal instruction", "misaligned address",
                   "unspecified launch failure", "device-side assert",
                   "launch timed out", "uncorrectable ECC")

#: the JAX package's registry defaults of TSNE_RETRY_BACKOFF and
#: TSNE_RETRY_BACKOFF_CAP (seconds)
RETRY_BACKOFF = 0.25
RETRY_BACKOFF_CAP = 30.0


def is_oom(exc: BaseException) -> bool:
    """True for a device allocation failure — ``torch.cuda
    .OutOfMemoryError``, cuBLAS's ``CUBLAS_STATUS_ALLOC_FAILED``, the
    injected :class:`~tsne_flink_tpu_torch.runtime.faults.InjectedOom` —
    the only failure the ladder handles; False for a sticky CUDA error."""
    text = str(exc)
    if any(m in text for m in _STICKY_MARKERS):
        return False
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return any(m in text for m in _OOM_MARKERS)


def backoff_seconds(attempt: int, base: float | None = None,
                    cap: float | None = None, token: str = "") -> float:
    """Exponential backoff with DETERMINISTIC jitter for relaunch attempt
    ``attempt`` (0-based): ``min(base * 2^attempt, cap)`` scaled by a
    factor in [0.5, 1.0] derived from sha256(token:attempt), so the same
    plan and run sleep the same schedule while distinct tokens (fleet job
    names) decorrelate.  ``base``/``cap`` default to :data:`RETRY_BACKOFF`
    / :data:`RETRY_BACKOFF_CAP`; base <= 0 disables the sleep."""
    base = RETRY_BACKOFF if base is None else base
    cap = RETRY_BACKOFF_CAP if cap is None else cap
    if base <= 0:
        return 0.0
    raw = min(base * (2.0 ** int(attempt)), cap)
    digest = hashlib.sha256(f"{token}:{int(attempt)}".encode()).hexdigest()
    jitter = int(digest[:8], 16) / 0xFFFFFFFF
    return raw * (0.5 + 0.5 * jitter)


class LadderExhausted(RuntimeError):
    def __init__(self, stage: str, cause: BaseException):
        super().__init__(
            f"device OOM in the '{stage}' stage and the degradation ladder "
            f"is exhausted (original error: {cause})")


def release_memory() -> dict:
    """Give a failed attempt's memory back: collect the garbage its
    dropped traceback left, then return the caching allocator's free
    blocks to the card.  ``{"freed_bytes", "reserved_after"}`` (zeros
    without a card)."""
    import torch
    gc.collect()
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {"freed_bytes": 0, "reserved_after": 0}
    before = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    return {"freed_bytes": int(before - after), "reserved_after": int(after)}


class Supervisor:
    """Recovery policy around one run.

    ``plan`` is the run's :class:`~tsne_flink_tpu_torch.analysis.audit
    .plan.PlanConfig` (the ladder's input); ``on_oom="fail"`` disables the
    ladder (OOMs propagate), ``max_retries`` bounds ladder relaunches per
    phase, ``health_check`` arms the divergence sentinel.
    """

    def __init__(self, plan=None, *, max_retries: int = 2,
                 on_oom: str = "ladder", health_check: bool = False,
                 health_retries: int = 3, events: list | None = None,
                 retry_backoff: float | None = None,
                 retry_backoff_cap: float | None = None, on_width=None):
        if on_oom not in ("ladder", "fail"):
            raise ValueError(f"on_oom '{on_oom}' not defined (ladder | fail)")
        self.ladder = OomLadder(plan) if plan is not None else None
        self.max_retries = int(max_retries)
        self.on_oom = on_oom
        self.health_check = bool(health_check)
        self.health_retries = int(health_retries)
        self.retry_backoff = retry_backoff
        self.retry_backoff_cap = retry_backoff_cap
        self.events: list = events if events is not None else []
        #: one record per relaunch: the stage and the bytes given back
        self.releases: list = []
        self._last = None
        #: the telemetry trace of the last run_optimize(telemetry=True)
        self.last_telemetry = None
        #: the autopilot (pvec, trace) pair of the last run
        self.last_pilot = None
        #: the kNN graph's row-width bound, once the kNN stage has run
        self.width_bound = None
        self.on_width = on_width

    # ---- shared ladder plumbing -------------------------------------------

    def _backoff(self, stage: str, attempt: int) -> None:
        """Sleep the attempt's backoff before the relaunch (a recorded
        span and a structured event)."""
        secs = backoff_seconds(attempt, self.retry_backoff,
                               self.retry_backoff_cap, token=stage)
        self.events.append({"type": "backoff", "stage": stage,
                            "attempt": attempt, "seconds": round(secs, 4)})
        obmetrics.counter("runtime.backoff").inc()
        if secs <= 0:
            return
        with obtrace.span("supervisor.backoff", cat="runtime", stage=stage,
                          attempt=attempt, seconds=secs):
            time.sleep(secs)

    def _handle_oom(self, stage: str, exc: BaseException, attempt: int):
        """Record the OOM and pick the ladder step, or re-raise."""
        if (self.on_oom != "ladder" or self.ladder is None
                or attempt >= self.max_retries or not is_oom(exc)):
            raise exc
        self.events.append({"type": "oom", "stage": stage,
                            "error": str(exc)[:200]})
        obmetrics.counter("runtime.oom").inc()
        obtrace.instant("supervisor.oom", cat="runtime", stage=stage)
        deg = self.ladder.demote(stage)
        if deg is None:
            raise LadderExhausted(stage, exc) from exc
        self.events.append({"type": "degrade", **deg.as_dict()})
        obmetrics.counter("runtime.degrade").inc()
        obtrace.instant("supervisor.degrade", cat="runtime", stage=stage,
                        action=deg.action)
        print(f"# supervisor: OOM in '{stage}' — {deg.action} "
              f"({deg.before!r} -> {deg.after!r}), relaunching the stage",
              file=sys.stderr)
        return deg

    def _relaunch(self, stage: str, attempt: int) -> None:
        """Between attempts, outside the handler (the failed attempt's
        traceback is gone): give its memory back, then back off."""
        rel = release_memory()
        rel["stage"] = stage
        self.releases.append(rel)
        obmetrics.gauge("runtime.freed_bytes").set(rel["freed_bytes"])
        self._backoff(stage, attempt)

    @property
    def degradations(self) -> list:
        """Ladder steps taken so far, as JSON-safe dicts."""
        return self.ladder.records() if self.ladder is not None else []

    def summary(self) -> dict:
        return {"events": list(self.events),
                "degradations": self.degradations}

    def observe_graph(self, idx) -> None:
        """Once the kNN stage has built ``idx``: the rows' width bound
        (``ops/affinities.width_bound``, one host read) goes to the ladder,
        whose records then charge the width the affinity stage can build
        instead of the widest the plan allows, and to ``on_width`` (a
        fleet job reports it for re-admission).  Read once a run, and only
        when one of them needs it."""
        lad = self.ladder
        need = (lad is not None and lad.plan.sym_width is None
                and lad.width is None)
        if self.on_width is None and not need:
            return
        from tsne_flink_tpu_torch.ops.affinities import width_bound
        self.width_bound = width_bound(idx)
        obmetrics.gauge("runtime.width_bound").set(self.width_bound)
        if need:
            lad.observe_width(self.width_bound)
        if self.on_width is not None:
            self.on_width(self.width_bound)

    # ---- prepare ----------------------------------------------------------

    def run_prepare(self, fn, on_stage=None):
        """Run the prepare stage with ladder recovery.

        ``fn(on_stage=..., on_graph=..., **overrides)`` runs the stage (a
        lambda over ``utils/artifacts.prepare``; ``on_graph`` is
        :meth:`observe_graph`); overrides are the ladder's accumulated
        ``knn_tiles`` / ``assembly``.  The failed stage is the
        first one whose ``on_stage`` completion did not arrive; with an
        artifact cache the relaunch recomputes only that stage."""
        for attempt in range(self.max_retries + 1):
            done: list = []

            def track(stage, secs, cache_state, _done=done):
                _done.append(stage)
                if on_stage is not None:
                    on_stage(stage, secs, cache_state)

            overrides = (self.ladder.overrides()
                         if self.ladder is not None else {})
            try:
                return fn(on_stage=track, on_graph=self.observe_graph,
                          **overrides)
            # graftlint: disable=exception-hygiene -- not a swallow:
            # _handle_oom re-raises everything that is not a
            # ladder-eligible device OOM (and logs the step it takes)
            except Exception as e:  # noqa: BLE001 — re-raised unless an OOM
                stage = "affinities" if "knn" in done else "knn"
                self._handle_oom(stage, e, attempt)
            self._relaunch(stage, attempt)
        raise AssertionError("unreachable: _handle_oom raises or demotes")

    # ---- optimize ---------------------------------------------------------

    def optimize_cfg(self, cfg):
        """``cfg`` with any ladder repulsion demotion applied."""
        if self.ladder is not None and self.ladder.repulsion is not None:
            from dataclasses import replace
            return replace(cfg, repulsion=self.ladder.repulsion)
        return cfg

    def run_optimize(self, cfg, state, jidx, jval, *, layout=None,
                     start_iter: int = 0, loss_carry=None, every: int = 0,
                     on_boundary=None, telemetry: bool = False,
                     pilot_carry=None, mesh=None):
        """Segmented optimize (``runtime/segments.run_segments``) with
        OOM-ladder relaunch and the sentinel.

        ``layout()`` returns the attraction layout ``(edges, edges_extra,
        csr)``; it runs inside the optimize stage's first attempt (on the
        card the CSR build is part of the stage's memory) and is kept for
        relaunches.  The boundary hook is shimmed to capture the last good
        snapshot, so a repulsion demotion relaunches from the last segment
        boundary, not from iteration 0.  Returns the ``SegmentsResult``;
        its telemetry and pilot pair also land in ``last_telemetry`` /
        ``last_pilot``.

        ``mesh`` (a ``parallel/mesh.ShardedOptimizer``) runs the segments
        over its point mesh; ``layout()`` then places the mesh's rows
        (:meth:`~tsne_flink_tpu_torch.parallel.mesh.ShardedOptimizer
        .shard_inputs`, which plans the layout on the padded rows) and
        returns ``(None, False, None)``."""
        from tsne_flink_tpu_torch.runtime.segments import run_segments

        self._last = {"state": state, "it": start_iter,
                      "losses": loss_carry, "pilot": pilot_carry}
        self.last_telemetry = None
        self.last_pilot = pilot_carry
        built: list = []

        def boundary(st, next_iter, losses, pilot):
            self._last = {"state": st, "it": next_iter, "losses": losses,
                          "pilot": pilot}
            self.last_pilot = pilot
            if on_boundary is not None:
                on_boundary(st, next_iter, losses, pilot)

        for attempt in range(self.max_retries + 1):
            try:
                if not built:
                    built.append(layout() if layout is not None
                                 else (None, False, None))
                edges, edges_extra, csr = built[0]
                run = run_segments(
                    self._last["state"], jidx, jval, self.optimize_cfg(cfg),
                    start_iter=self._last["it"], every=every,
                    loss_carry=self._last["losses"], edges=edges,
                    edges_extra=edges_extra, csr=csr,
                    health_check=self.health_check,
                    health_retries=self.health_retries, events=self.events,
                    telemetry=telemetry, pilot_carry=self._last["pilot"],
                    on_boundary=boundary, runner=mesh)
                self.last_telemetry = run.telemetry
                self.last_pilot = run.pilot
                return run
            # graftlint: disable=exception-hygiene -- not a swallow:
            # _handle_oom re-raises everything that is not a
            # ladder-eligible device OOM (and logs the step it takes)
            except Exception as e:  # noqa: BLE001 — re-raised unless an OOM
                self._handle_oom("optimize", e, attempt)
            self.events.append(
                {"type": "relaunch", "stage": "optimize",
                 "from_iter": int(self._last["it"]),
                 "repulsion": self.optimize_cfg(cfg).repulsion})
            obtrace.instant("supervisor.relaunch", cat="runtime",
                            stage="optimize", from_iter=int(self._last["it"]))
            self._relaunch("optimize", attempt)
        raise AssertionError("unreachable: _handle_oom raises or demotes")


def run_plan_from_fit(n: int, d: int, k: int, cfg, assembly: str,
                      knn_method: str, knn_rounds=None, knn_refine=None,
                      sym_width=None, mesh: int = 1, name: str = "fit",
                      backend: str = "cuda", matmul_dtype=None):
    """The memory model's PlanConfig for an in-process fit (the ladder's
    input); ``backend`` is the run's device type.  A pinned ``sym_width``
    under ``auto`` is the sorted layout at that width, as the run takes
    it; ``matmul_dtype`` the kNN products' operand dtype (B1's bf16 form
    stages a bf16 copy of x)."""
    from tsne_flink_tpu_torch.analysis.audit import PlanConfig
    from tsne_flink_tpu_torch.ops.metrics import matmul_dtype_name
    if assembly == "auto" and sym_width is not None:
        assembly = "sorted"
    return PlanConfig(
        n=int(n), d=int(d), k=int(k), backend=backend,
        n_components=cfg.n_components, iterations=cfg.iterations,
        knn_method=knn_method, knn_rounds=knn_rounds, knn_refine=knn_refine,
        repulsion=cfg.repulsion, theta=cfg.theta, assembly=assembly,
        attraction=cfg.attraction, sym_width=sym_width,
        row_chunk=cfg.row_chunk, mesh=int(mesh),
        fft_grid=cfg.fft_grid, autopilot=bool(cfg.autopilot), name=name,
        matmul_dtype=matmul_dtype_name(matmul_dtype), metric=cfg.metric)


def segment_every(iterations: int) -> int:
    """The supervised path's segment length (the JAX estimator's):
    ``max(10, min(50, iterations // 10))``."""
    from tsne_flink_tpu_torch.models.tsne import LOSS_EVERY
    return max(LOSS_EVERY, min(50, iterations // 10 or iterations))


def supervised_embed(x, cfg, *, supervisor: Supervisor,
                     neighbors: int | None = None,
                     knn_method: str = "bruteforce", knn_iterations=None,
                     knn_refine=None, knn_blocks: int = 8, seed: int = 0,
                     sym_width=None, affinity_assembly=None, device=None,
                     artifact_cache=None, knn_autotune: bool = False,
                     telemetry: bool = False, on_stage=None,
                     checkpoint_cb=None, every: int | None = None,
                     mesh=None, mesh_reduce: str = "canonical",
                     matmul_dtype=None):
    """Supervised pipeline: ``models/tsne.tsne_embed``'s prepare, init and
    layout (its ``_prepare_run``) with the supervisor around prepare and a
    segmented optimize (the sentinel needs segment boundaries to roll back
    to).  The same draws as ``tsne_embed`` (``seed`` seeds the init and,
    through ``knn_generator``, the kNN stage), so a clean single-device
    run gives its bits; like the JAX function it runs no landmark
    schedule.

    ``mesh`` (a width, or a device list: ``parallel/mesh.make_mesh``; the
    JAX function's ``mesh_devices``) runs the optimize stage on a
    ``parallel/mesh.ShardedOptimizer`` with ``mesh_reduce``; None is the
    single-device path.  Prepare runs on ``device`` either way, and a
    width past the visible devices raises before it.

    ``on_stage(name, seconds, cache_state)`` / ``checkpoint_cb(state,
    next_iter, losses, pilot)`` are progress hooks at prepare-stage
    completions and segment boundaries (the fleet's watchdog heartbeats);
    they change no bit.  ``every`` defaults to :func:`segment_every`.
    ``matmul_dtype`` is the kNN products' operand dtype (``tsne_embed``'s).
    Returns the ``runtime/segments.SegmentsResult``."""
    from tsne_flink_tpu_torch.models.tsne import _prepare_run
    from tsne_flink_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    runner = None
    if mesh is not None:
        from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
        width = mesh if isinstance(mesh, int) else None
        devices = None if width is not None else list(mesh)
        runner = ShardedOptimizer(cfg, len(x), width, devices=devices,
                                  device=device, mesh_reduce=mesh_reduce)
    prep, state, plan_layout = _prepare_run(
        x, cfg, neighbors=neighbors, knn_method=knn_method,
        knn_iterations=knn_iterations, knn_refine=knn_refine,
        knn_blocks=knn_blocks, seed=seed, sym_width=sym_width,
        affinity_assembly=affinity_assembly, device=device,
        artifact_cache=artifact_cache, knn_autotune=knn_autotune,
        supervise=supervisor.run_prepare, on_stage=on_stage,
        matmul_dtype=matmul_dtype)

    def layout():
        if runner is not None:  # the mesh plans on its padded rows
            runner.shard_inputs(prep.jidx, prep.jval, prep.extra_edges)
            return None, False, None
        edges, csr, label = plan_layout()
        return edges, label == "blocks", csr

    return supervisor.run_optimize(
        cfg, state, prep.jidx, prep.jval, layout=layout,
        every=segment_every(cfg.iterations) if every is None else every,
        on_boundary=checkpoint_cb, telemetry=telemetry, mesh=runner)
