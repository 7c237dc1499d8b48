"""The long-lived embed daemon: warm FrozenModels behind a spool directory
(port of the solo daemon of ``tsne_flink_tpu/serve/daemon.py``).

One process answers many small requests with everything expensive —
the model tensors, the FFT base field, the built stages — resident from
the first request to the last.  The spool protocol is the JAX package's,
file names and npz/json keys included, so a port daemon serves requests
written by the JAX ``submit`` and the JAX ``read_result`` reads its
answers:

* **requests** are ``<id>.req.npz`` (array ``x`` [B, d], optional string
  ``model`` pinning a resident model id), written atomically by
  :func:`submit`;
* **claims** are ``utils/locks.FileLock`` on ``<id>.req.npz.lock``, whose
  body carries the claim epoch kept in the ``<id>.epoch.json`` sidecar; a
  daemon killed mid-request leaves a lock the next one breaks (at once
  when its pid is gone, else by age) and re-serves bit-identically — the
  transform has no random draw;
* **results** are ``<id>.res.npz`` (array ``y``) and ``<id>.lat.json``
  (the latency record, the JAX package's keys), both atomic; the request
  is deleted only after its result lands, and each result write checks
  that the claim still names this pid and epoch.  A request that cannot
  be served (unknown model, wrong width) gets ``<id>.err.json``;
* **scheduling** (``sched="on"``): claimed requests ride
  ``serve/sched.MicroBatcher`` through a double-buffered tick —
  :func:`~tsne_flink_tpu_torch.serve.transform.dispatch_bucket` returns
  without a host sync, so claims and result writes overlap the card's
  compute; ``sched="off"`` is the serial drain (claim up to
  ``max_batch`` rows, one transform per model);
* **residency and hot swap**: several models keyed by ``model_id``, each
  admitted while the sum of transform peaks fits the budget
  (``runtime/admission.decide_residency``); :meth:`ServeDaemon.load_model`
  and :meth:`ServeDaemon.activate` swap the default between ticks, and a
  ``<name>.swap.json`` control file does it from another process
  (answered by ``<name>.swap.done.json``).  Requests bind their model at
  claim, so no response mixes models.

The fleet's watchdog (``runtime/fleet.Watchdog``, when given) beats
once a tick, so a wedged transform ends the process (exit 124) instead of
wedging the spool; the ``serve`` fault site fires at tick start (oom /
delay / hang) and at the boundary between computing a request and
writing its result (``kill@serve:segN``, N the requests served so far).

**Replica mode** (``serve/replicas.py``): a daemon given a ``replica``
name runs as one of N over a shared spool.  It writes a
``<replica>.beat.json`` heartbeat before every tick and after each step
of it that makes progress (a claim pass that claimed, a bucket
dispatched, computed or written), and names itself in each claim lock; the claim stale-break folds in the holder's pid and
heartbeat (dead: break now; alive and beating: never; anonymous: the age
rule); past ``shed_depth`` pending requests, bulk requests are refused
with a ``retry_after_ms`` hint, and express is never shed before bulk.
The claim epochs and the rename guard above keep a re-dispatched request
exactly-once.

The beat, the watchdog and the spans read nothing back from the card:
:func:`~tsne_flink_tpu_torch.serve.transform.dispatch_bucket` stays free
of host syncs.  The port reads no environment variable: every knob is an
argument whose default is the JAX package's.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from tsne_flink_tpu_torch.analysis.audit.hbm import (serving_charge,
                                                     serving_process_bytes)
from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.obs.trace import walltime
from tsne_flink_tpu_torch.runtime import faults
from tsne_flink_tpu_torch.runtime.admission import (ADMIT, SHED,
                                                    bounded_claim_rows,
                                                    decide_residency,
                                                    decide_shed,
                                                    default_budget)
from tsne_flink_tpu_torch.serve import replicas as quorum
from tsne_flink_tpu_torch.serve.model import residency_report
from tsne_flink_tpu_torch.serve.sched import (MicroBatcher, Request,
                                              pick_poll_max_ms,
                                              pick_serve_deadline_ms,
                                              pick_serve_sched,
                                              pick_serve_starve_ms)
from tsne_flink_tpu_torch.serve.transform import (dispatch_bucket,
                                                  pick_serve_bucket,
                                                  pick_transform_eta,
                                                  pick_transform_iters,
                                                  transform, warm_stages)
from tsne_flink_tpu_torch.utils.io import atomic_write
from tsne_flink_tpu_torch.utils.locks import (DEFAULT_STALE_S, FileLock,
                                              read_lock_payload)

REQ_SUFFIX = ".req.npz"
RES_SUFFIX = ".res.npz"
LAT_SUFFIX = ".lat.json"
ERR_SUFFIX = ".err.json"
SWAP_SUFFIX = ".swap.json"
SWAP_DONE_SUFFIX = ".swap.done.json"

#: the JAX package's defaults (TSNE_SERVE_TICK_S, TSNE_SERVE_MAX_BATCH)
DEFAULT_TICK_S = 0.05
DEFAULT_MAX_BATCH = 1024


def pick_spool(spool: str | None = None) -> str:
    """The spool directory (recorded on the summary as ``spool``)."""
    if not spool:
        raise ValueError("no spool directory: pass spool=")
    return str(spool)


def submit(spool: str, x, req_id: str, model_id: str | None = None) -> str:
    """Drop one request into the spool (atomic) and return its path;
    ``model_id`` pins it to a resident model, None serves it with the one
    active at claim."""
    xq = np.ascontiguousarray(np.asarray(x))
    if xq.ndim != 2:
        raise ValueError(f"request must be [B, d], got {xq.shape}")
    path = os.path.join(spool, req_id + REQ_SUFFIX)

    def write(tmp):
        with open(tmp, "wb") as f:
            if model_id is None:
                np.savez(f, x=xq)
            else:
                np.savez(f, x=xq, model=np.asarray(str(model_id)))
    atomic_write(path, write)
    return path


def read_result(spool: str, req_id: str):
    """The served embedding of ``req_id``, or None while pending."""
    path = os.path.join(spool, req_id + RES_SUFFIX)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["y"]


def _req_id(req_path: str) -> str:
    return os.path.basename(req_path)[:-len(REQ_SUFFIX)]


def _write_json(path: str, obj: dict) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)
    atomic_write(path, write)


class StaleClaim(Exception):
    """Raised inside a result writer when the claim lock no longer names
    this pid and epoch: the tmp file is dropped, the terminal never
    lands twice."""


def _claim_current(lock: FileLock, epoch: int) -> bool:
    claim = read_lock_payload(lock.path)
    return (claim.get("pid") == str(os.getpid())
            and claim.get("epoch") == str(int(epoch)))


class ServeDaemon:
    """The warm process: models resident, stages built, spool polled
    (with adaptive backoff) until ``max_ticks`` or ``idle_exit_s`` of an
    empty spool.  ``model`` is a ``serve/model.FrozenModel``; the daemon
    serves on its device.  ``watchdog`` (a ``runtime/fleet.Watchdog``)
    beats once a tick; ``replica`` names the daemon as one of a fleet's
    (heartbeats, claims that name it); ``stale_ms`` bounds the heartbeat's
    age for the claim stale-break; ``shed_depth`` is the brownout
    threshold (0: no shedding); ``lock_stale_s`` is the age past which an
    anonymous claim counts as abandoned."""

    def __init__(self, model, spool: str | None = None, *,
                 bucket: int | None = None, iters: int | None = None,
                 eta: float | None = None, tick_s: float | None = None,
                 max_batch: int | None = None,
                 idle_exit_s: float | None = None, watchdog=None,
                 budget_bytes=None, sched: str | None = None,
                 deadline_ms: float | None = None,
                 starve_ms: float | None = None,
                 poll_max_ms: float | None = None,
                 replica: str | None = None,
                 shed_depth: int | None = None,
                 stale_ms: float | None = None,
                 lock_stale_s: float | None = None):
        self.models = {model.model_id: model}
        self.active_id = model.model_id
        self.spool = pick_spool(spool)
        self.bucket = pick_serve_bucket(bucket)
        self.iters = pick_transform_iters(iters)
        self.eta = pick_transform_eta(eta)
        self.tick_s = float(tick_s) if tick_s is not None else DEFAULT_TICK_S
        self.max_batch = int(max_batch) if max_batch else DEFAULT_MAX_BATCH
        self.idle_exit_s = float(idle_exit_s) if idle_exit_s else None
        self.watchdog = watchdog
        self.sched = pick_serve_sched(sched)
        self.deadline_ms = pick_serve_deadline_ms(deadline_ms)
        self.starve_ms = pick_serve_starve_ms(starve_ms)
        self.poll_max_s = pick_poll_max_ms(poll_max_ms) / 1e3
        self.batcher = MicroBatcher(self.bucket,
                                    deadline_s=self.deadline_ms / 1e3,
                                    starve_s=self.starve_ms / 1e3)
        self.inflight: list = []   # dispatched, unmaterialized batches
        self.depth = 2             # double-buffered tick
        self._claimed: dict[str, Request] = {}
        self._poll_s = self.tick_s
        self._batches = 0
        self._fills: list[float] = []
        self._swaps = 0
        self._progress = False
        self.failed = 0
        self.redispatched = 0
        self.served = 0
        self.latencies_s: list[float] = []
        self.residency_events: list[dict] = []
        self.admission = self._admit(budget_bytes)
        # how far into the spool the scheduler may look: claimed requests
        # are host arrays and a held lock, the device holds one bucket at
        # a time, so 16 x max_batch rows, bounded by the budget
        self.claim_rows = bounded_claim_rows(
            16 * self.max_batch, self.bucket,
            self.admission["peak_bytes"], self.admission["budget_bytes"])
        # replica mode: identity (None: a solo daemon, no beats), the
        # heartbeat bound of the claim stale-break, the brownout threshold
        self.replica = str(replica) if replica else None
        self.stale_ms = quorum.pick_replica_stale_ms(stale_ms)
        self.shed_depth = quorum.pick_shed_depth(shed_depth)
        self.lock_stale_s = (float(lock_stale_s) if lock_stale_s
                             else DEFAULT_STALE_S)
        self._beat_seq = 0
        self.shed = 0

    @property
    def model(self):
        """The active model (requests without a pinned id bind to it at
        claim)."""
        return self.models[self.active_id]

    # ---- admission / residency ---------------------------------------------

    def _admit(self, budget_bytes) -> dict:
        """The model's charge must fit the budget (the explicit one, else
        the card's memory) before the daemon goes warm: its predicted
        transform peak, and on the card the allocator's reserve over it
        and the process's CUDA context (``analysis/audit/hbm
        .serving_charge``; the CPU charges the peak, as the JAX gate)."""
        dev = self.model.x.device
        self._backend = dev.type
        budget = default_budget(dev.type, budget_bytes, dev)
        peak = self.model.transform_peak(self.bucket)
        self._peaks = {self.active_id: peak}
        charged = (serving_charge(peak, dev.type)
                   + serving_process_bytes(dev.type))
        if budget is not None and charged > budget:
            raise RuntimeError(
                f"serve admission: predicted peak {peak} bytes (charged "
                f"{charged} with the process) exceeds budget {budget} for "
                f"bucket={self.bucket} (model n={self.model.n}); use a "
                "smaller bucket")
        return {"peak_bytes": peak, "charged_bytes": charged,
                "budget_bytes": budget}

    def load_model(self, model, *, activate: bool = False,
                   warm: bool = True) -> dict:
        """Admit ``model`` into the resident set (its transform peak joins
        the sum against the budget).  A refused model leaves the set
        unchanged; either way the decision is a residency event.  ``warm``
        runs one bucket now, so a later swap builds nothing on the
        serving path."""
        mid = model.model_id
        if mid in self.models:
            event = {"op": "load", "model_id": mid, "action": "resident",
                     "reason": "already resident"}
        else:
            peak = model.transform_peak(self.bucket)
            bt = self._backend
            decision = decide_residency(
                {m: serving_charge(p, bt) for m, p in self._peaks.items()},
                mid, serving_charge(peak, bt),
                self.admission["budget_bytes"],
                process_bytes=serving_process_bytes(bt))
            event = {"op": "load", "model_id": mid,
                     "action": decision.action,
                     "predicted_peak": int(decision.predicted_peak),
                     "reason": decision.reason}
            if decision.action == ADMIT:
                self.models[mid] = model
                self._peaks[mid] = peak
                if warm:
                    event["aot"] = ",".join(warm_stages(
                        model, bucket=self.bucket, iters=self.iters,
                        eta=self.eta))
        self.residency_events.append(event)
        obtrace.instant("serve.load_model", cat="serve", model=mid,
                        action=event["action"])
        if activate and mid in self.models:
            event["activated_from"] = self.activate(mid)
        return event

    def activate(self, model_id: str) -> str:
        """Make ``model_id`` the default serving model; returns the
        previous one.  Takes effect for requests claimed after the call."""
        if model_id not in self.models:
            raise KeyError(f"model {model_id} is not resident")
        prev, self.active_id = self.active_id, str(model_id)
        if prev != self.active_id:
            self._swaps += 1
            self.residency_events.append(
                {"op": "activate", "model_id": self.active_id,
                 "from": prev})
            obtrace.instant("serve.swap", cat="serve", model=self.active_id,
                            prev=prev)
        return prev

    def evict(self, model_id: str) -> None:
        """Drop a non-active model from the resident set."""
        if model_id == self.active_id:
            raise ValueError(f"cannot evict the active model {model_id}")
        self.models.pop(model_id, None)
        self._peaks.pop(model_id, None)
        self.residency_events.append({"op": "evict", "model_id": model_id})

    # ---- request plumbing --------------------------------------------------

    def _pending(self) -> list[str]:
        try:
            names = os.listdir(self.spool)
        except OSError:
            return []
        return sorted(os.path.join(self.spool, n) for n in names
                      if n.endswith(REQ_SUFFIX))

    def _beat(self, progress: bool = False) -> None:
        """The replica's heartbeat, written BEFORE each tick body (``seq``
        counts the ticks) and again, with the tick's ``seq`` and a fresh
        clock, after each step of the tick that made progress
        (``progress``): the claim pass, a bucket dispatched, a bucket
        computed and its results written.  So a healthy tick longer than
        ``stale_ms`` (a loaded host, a slow first bucket) keeps its beat
        fresh, while a tick that hangs — at its start or inside one step
        — writes no more, and its beat ages past ``stale_ms`` while the
        pid lives: the evidence the supervisor's hung triage and the
        claims' stale verdict key on.  A solo daemon writes none."""
        if not self.replica:
            return
        if not progress:
            self._beat_seq += 1
        quorum.write_beat(self.spool, self.replica, self._beat_seq,
                          [r.rid for r in self._claimed.values()])

    def _req_lock(self, req_path: str) -> FileLock:
        """A request's claim lock: its body names this replica (the
        supervisor's sweep key; the epoch is stamped after acquisition),
        and its stale-break is :func:`~tsne_flink_tpu_torch.serve.replicas
        .claim_stale_verdict` — a dead holder's claim breaks at once, a
        live beating holder's never, an anonymous one's by age."""
        spool, stale_s = self.spool, self.stale_ms / 1e3

        def stale(path, age):
            return quorum.claim_stale_verdict(path, age, spool=spool,
                                              replica_stale_s=stale_s)
        payload = ({"replica": self.replica} if self.replica
                   else {"claim": "serve"})
        return FileLock(req_path + ".lock", stale_s=self.lock_stale_s,
                        payload=payload, stale_fn=stale)

    def _claim(self, req_path: str):
        """``(lock, x, model_id, epoch)`` if we now hold the request's
        claim and it is unserved, else None.  The lock outlives this call
        (held from claim to result); every error path releases it."""
        rid = _req_id(req_path)
        if os.path.exists(os.path.join(self.spool, rid + RES_SUFFIX)):
            # served before a crash could delete the request: finish it
            try:
                os.remove(req_path)
            except OSError:
                pass
            quorum.clear_epoch(self.spool, rid)
            return None
        lock = self._req_lock(req_path)
        # graftlint: disable=resource-hygiene -- claim hand-off: the
        # lock deliberately OUTLIVES this function (held claim-to-result
        # is the spool crash story); it is returned to the caller, every
        # error path below releases, and abandoned claims are released
        # by the drain's finally or broken by the stale-lock timeout
        # after a SIGKILL.
        if not lock.acquire(timeout_s=0.0):
            return None
        try:
            # the claim generation, bumped under the lock and stamped into
            # its body: the writers' rename guard compares the two
            epoch = quorum.bump_epoch(self.spool, rid, lock)
            lock.write_payload({"epoch": epoch})
            if epoch > 1:
                self.redispatched += 1  # an earlier claim never finished
            with np.load(req_path) as z:
                x = np.asarray(z["x"])
                mid = (str(z["model"].item()) if "model" in z.files
                       else None)
            return lock, x, mid, epoch
        except (OSError, KeyError, ValueError):
            lock.release()
            return None

    def _terminal(self, req_path: str, lock: FileLock, epoch: int) -> None:
        """After a terminal file landed: delete the request, drop its
        sidecar, release the claim."""
        try:
            os.remove(req_path)
        except OSError:
            pass
        quorum.clear_epoch(self.spool, _req_id(req_path))
        lock.release()

    def _fail(self, req_path: str, lock: FileLock, reason: str, *,
              epoch: int = 0, shed: bool = False,
              retry_after_ms: float | None = None) -> None:
        """Refuse one request (unknown model, wrong width, or a shed
        verdict, which adds ``shed`` and ``retry_after_ms``): an atomic
        ``.err.json`` so the client stops waiting; the request is
        deleted.  The rename guard rides the refusal too."""
        rid = _req_id(req_path)

        def write_err(tmp):
            out = {"req": rid, "error": reason}
            if shed:
                out["shed"] = True
                out["retry_after_ms"] = float(retry_after_ms or 0.0)
            with open(tmp, "w") as f:
                json.dump(out, f)
            if epoch and not _claim_current(lock, epoch):
                raise StaleClaim(rid)
        try:
            atomic_write(os.path.join(self.spool, rid + ERR_SUFFIX),
                         write_err, tag=f"e{int(epoch)}")
        except StaleClaim:
            lock.release()
            return
        self._terminal(req_path, lock, epoch)
        if shed:
            self.shed += 1
        else:
            self.failed += 1

    def _shed(self, req_path: str, lock: FileLock, rows: int, epoch: int,
              backlog: int) -> bool:
        """Refuse a bulk request under brownout (``runtime/admission
        .decide_shed`` on the spool's backlog); True when shed."""
        verdict = decide_shed(backlog, rows, self.bucket, self.shed_depth,
                              self.deadline_ms)
        if verdict.action != SHED:
            return False
        self._fail(req_path, lock, verdict.reason, epoch=epoch, shed=True,
                   retry_after_ms=verdict.retry_after_ms)
        obtrace.instant("serve.shed", cat="serve", req=_req_id(req_path),
                        rows=rows, backlog=backlog,
                        retry_after_ms=verdict.retry_after_ms)
        return True

    # graftlint: disable=conc-tick-protocol -- a helper of _finish,
    # which deletes the request and releases the claim (_terminal)
    # once this returns True; on a stale claim it releases here
    def _write_result(self, rid: str, lock: FileLock, epoch: int,
                      y: np.ndarray) -> bool:
        """The ``.res.npz``, renamed into place only while the claim still
        names this pid and epoch; False when it no longer does."""
        def write_res(tmp):
            with open(tmp, "wb") as f:
                np.savez(f, y=y)
            if epoch and not _claim_current(lock, epoch):
                raise StaleClaim(rid)
        try:
            atomic_write(os.path.join(self.spool, rid + RES_SUFFIX),
                         write_res, tag=f"e{int(epoch)}")
        except StaleClaim:
            lock.release()
            return False
        return True

    def _finish(self, req_path: str, lock: FileLock, y: np.ndarray,
                seconds: float, *, model_id: str, epoch: int = 0) -> None:
        rid = _req_id(req_path)
        if not self._write_result(rid, lock, epoch, y):
            return
        _write_json(os.path.join(self.spool, rid + LAT_SUFFIX),
                    {"req": rid, "rows": int(y.shape[0]),
                     "seconds": round(float(seconds), 6),
                     "bucket": self.bucket, "iters": self.iters,
                     "eta": self.eta, "model_id": model_id,
                     "epoch": int(epoch), "replica": self.replica})
        self._terminal(req_path, lock, epoch)
        self.latencies_s.append(float(seconds))
        self.served += 1

    def _bind(self, req_path: str, lock, x, mid, epoch):
        """The model a claimed request binds to, or None after refusing
        it (unknown pinned model, wrong width)."""
        if mid is not None and mid not in self.models:
            self._fail(req_path, lock, f"model {mid} not resident",
                       epoch=epoch)
            return None
        bound = mid or self.active_id
        d = int(self.models[bound].x.shape[1])
        if x.ndim != 2 or x.shape[1] != d:
            self._fail(req_path, lock, f"queries must be [B, {d}], got "
                       f"{tuple(x.shape)}", epoch=epoch)
            return None
        return bound

    # ---- hot-swap control files --------------------------------------------

    def _control_pass(self) -> int:
        """Process ``<name>.swap.json`` files: load (and by default
        activate) the model named by checkpoint + input paths, answer with
        ``<name>.swap.done.json``.  A failed load lands in the done file;
        it never takes the serving loop down."""
        from tsne_flink_tpu_torch.serve.model import frozen_from_files
        try:
            names = sorted(os.listdir(self.spool))
        except OSError:
            return 0
        handled = 0
        for name in names:
            if not name.endswith(SWAP_SUFFIX):
                continue
            path = os.path.join(self.spool, name)
            lock = FileLock(path + ".lock")
            if not lock.acquire(timeout_s=0.0):
                continue
            try:
                try:
                    with open(path, encoding="utf-8") as f:
                        spec = json.load(f)
                except (OSError, ValueError):
                    continue   # torn or gone: not ours this tick
                out = {"op": "swap", "status": "ok"}
                try:
                    # graftlint: disable=conc-lock-blocking -- declared
                    # site: the swap lock SHOULD cover the model load —
                    # it serializes concurrent swap requests for the same
                    # control file (last-writer-wins on the done file
                    # would otherwise ack a swap that lost the race), and
                    # request claims use per-request locks, so serving is
                    # never behind this hold.
                    model = frozen_from_files(
                        spec["model"], spec["input"],
                        perplexity=float(spec.get("perplexity", 10.0)),
                        learning_rate=float(spec.get("learning_rate",
                                                     1000.0)),
                        metric=spec.get("metric", "sqeuclidean"),
                        neighbors=spec.get("neighbors"),
                        repulsion=spec.get("repulsion", "auto"),
                        name=name[:-len(SWAP_SUFFIX)],
                        device=self.model.x.device,
                        dtype=self.model.x.dtype)
                    out.update(self.load_model(
                        model, activate=bool(spec.get("activate", True))))
                except Exception as e:  # control-plane isolation
                    out.update(status="error",
                               error=f"{type(e).__name__}: {e}")
                _write_json(path[:-len(SWAP_SUFFIX)] + SWAP_DONE_SUFFIX, out)
                try:
                    os.remove(path)
                except OSError:
                    pass
                handled += 1
            finally:
                lock.release()
        return handled

    # ---- the serial tick (sched="off") -------------------------------------

    def drain_once(self) -> int:
        """One serial tick: claim pending requests up to ``max_batch``
        rows, one coalesced transform per bound model, write the results.
        Returns the requests completed."""
        inj = faults.injector()
        if inj:
            inj.fire("serve")  # oom / delay / hang at tick start
        self._control_pass()
        claimed = []
        rows = 0
        pending = self._pending()
        backlog = len(pending)   # the fleet-wide shed signal: the spool
        for req_path in pending:
            if rows >= self.max_batch:
                break
            got = self._claim(req_path)
            if got is None:
                continue
            lock, x, mid, epoch = got
            if self._shed(req_path, lock, int(x.shape[0]), epoch, backlog):
                continue
            bound = self._bind(req_path, lock, x, mid, epoch)
            if bound is None:
                continue
            claimed.append((req_path, lock, x, bound, epoch))
            rows += int(x.shape[0])
        if not claimed:
            return 0
        self._beat(progress=True)
        done = 0
        try:
            with obtrace.span("serve.drain", cat="serve",
                              requests=len(claimed), rows=rows) as sp:
                ys, offs = {}, {}
                for mid in dict.fromkeys(c[3] for c in claimed):
                    xs = np.concatenate([x for _, _, x, m, _ in claimed
                                         if m == mid])
                    ys[mid] = transform(self.models[mid], xs,
                                        bucket=self.bucket, iters=self.iters,
                                        eta=self.eta)
                    offs[mid] = 0
            self._beat(progress=True)
            per_req = sp.seconds / len(claimed)
            for req_path, lock, x, mid, epoch in claimed:
                b, off = int(x.shape[0]), offs[mid]
                if inj:
                    # kill@serve: after compute, before this request's
                    # result write; its file stays for the next claimant
                    inj.fire("serve", seg=self.served, point="boundary")
                self._finish(req_path, lock, ys[mid][off:off + b], per_req,
                             model_id=mid, epoch=epoch)
                offs[mid] = off + b
                done += 1
                self._beat(progress=True)
            claimed = []
        finally:
            for _, lock, _, _, _ in claimed:
                lock.release()  # crash path: unserved claims unlock now
        return done

    # ---- the scheduled tick (sched="on") -----------------------------------

    def _claim_pass(self) -> int:
        """Claim new requests into the batcher, each bound to its model,
        until the pending backlog reaches the claim horizon; runs while
        earlier buckets compute on the card."""
        new = 0
        pending = self._pending()
        backlog = len(pending)   # the fleet-wide shed signal: the spool
        for req_path in pending:
            if req_path in self._claimed:
                continue
            if self.batcher.pending_rows() >= self.claim_rows:
                break
            got = self._claim(req_path)
            if got is None:
                continue
            lock, x, mid, epoch = got
            if self._shed(req_path, lock, int(x.shape[0]), epoch, backlog):
                continue
            bound = self._bind(req_path, lock, x, mid, epoch)
            if bound is None:
                continue
            model = self.models[bound]
            req = Request(_req_id(req_path), req_path, lock,
                          np.ascontiguousarray(x, dtype=model.np_dtype),
                          bound, arrival=walltime(),
                          deadline_s=self.deadline_ms / 1e3,
                          seq=self.batcher.next_seq(), bucket=self.bucket,
                          out_width=int(model.y.shape[1]),
                          out_dtype=model.np_dtype,
                          poll_ms=self._poll_s * 1e3, epoch=epoch)
            self._claimed[req_path] = req
            if req.rows == 0:
                # an empty request: finished without a batch
                req.first_dispatch = req.compute_done = req.arrival
                inj = faults.injector()
                if inj:
                    inj.fire("serve", seg=self.served, point="boundary")
                self._finish_sched(req)
            else:
                self.batcher.add(req)
            new += 1
        return new

    def _dispatch(self, batch) -> None:
        """Pack one bucket and enqueue its compute without blocking; the
        unfilled tail rows are zeros, inert by per-row independence."""
        model = self.models[batch.model_id]
        qp = np.zeros((self.bucket, int(model.x.shape[1])),
                      dtype=model.np_dtype)
        for req, start, nrow, off in batch.parts:
            qp[off:off + nrow] = req.x[start:start + nrow]
        batch.handle = dispatch_bucket(model, qp, bucket=self.bucket,
                                       iters=self.iters, eta=self.eta)
        batch.t_dispatch = walltime()
        for req, _, _, _ in batch.parts:
            if req.first_dispatch is None:
                req.first_dispatch = batch.t_dispatch
        self.inflight.append(batch)
        self._batches += 1
        self._fills.append(batch.fill)
        obtrace.instant("serve.dispatch", cat="serve", rows=batch.rows,
                        fill=round(batch.fill, 3), model=batch.model_id,
                        inflight=len(self.inflight))

    def _resolve(self, batch) -> int:
        """Wait for one batch (later ones keep computing behind it) and
        scatter its rows back; completed requests write out."""
        with obtrace.span("serve.resolve", cat="serve", rows=batch.rows,
                          fill=round(batch.fill, 3), model=batch.model_id):
            y = batch.handle.cpu().numpy()
        batch.handle = None
        t_done = walltime()
        inj = faults.injector()
        done = 0
        for req, start, nrow, off in batch.parts:
            req.out[start:start + nrow] = y[off:off + nrow]
            req.done_rows += nrow
            req.slices += 1
            req.fills.append(batch.fill)
            if req.complete():
                req.compute_done = t_done
                if inj:
                    # kill@serve: after compute, before the result write
                    inj.fire("serve", seg=self.served, point="boundary")
                self._finish_sched(req)
                done += 1
        return done

    def _finish_sched(self, req: Request) -> None:
        """One scheduled request's result and its extended latency record
        (queue / compute / write split, lane, fill)."""
        t_w0 = walltime()
        if not self._write_result(req.rid, req.lock, req.epoch, req.out):
            self._claimed.pop(req.path, None)
            return
        write_ms = (walltime() - t_w0) * 1e3
        first = req.first_dispatch if req.first_dispatch else req.arrival
        comp = req.compute_done if req.compute_done else first
        seconds = walltime() - req.arrival
        _write_json(os.path.join(self.spool, req.rid + LAT_SUFFIX), {
            "req": req.rid, "rows": req.rows,
            "seconds": round(float(seconds), 6),
            "bucket": self.bucket, "iters": self.iters, "eta": self.eta,
            "model_id": req.model_id, "sched": "on", "lane": req.lane,
            "promoted": bool(req.promoted), "slices": req.slices,
            "batch_fill": (round(float(np.mean(req.fills)), 4)
                           if req.fills else 0.0),
            "queue_ms": round((first - req.arrival) * 1e3, 3),
            "compute_ms": round((comp - first) * 1e3, 3),
            "write_ms": round(write_ms, 3),
            "deadline_ms": self.deadline_ms, "starve_ms": self.starve_ms,
            "poll_ms": round(req.poll_ms, 3), "epoch": int(req.epoch),
            "replica": self.replica})
        self._terminal(req.path, req.lock, req.epoch)
        self._claimed.pop(req.path, None)
        self.latencies_s.append(float(seconds))
        self.served += 1

    def _sched_tick(self) -> int:
        """One double-buffered tick: control and claim passes (overlapping
        in-flight compute), dispatch up to ``depth`` batches, then wait
        for the OLDEST in-flight one, whose writes overlap the compute of
        the batch behind it.  Returns requests completed."""
        inj = faults.injector()
        if inj:
            inj.fire("serve")  # oom / delay / hang at tick start
        progress = bool(self._control_pass())
        if self._claim_pass():
            self._beat(progress=True)
            progress = True
        now = walltime()
        while (len(self.inflight) < self.depth
               and self.batcher.ready(now, device_idle=not self.inflight)):
            batch = self.batcher.next_batch(now)
            if batch is None:
                break
            self._dispatch(batch)
            self._beat(progress=True)
            progress = True
            now = walltime()
        done = 0
        if self.inflight:
            done = self._resolve(self.inflight.pop(0))
            self._beat(progress=True)
            progress = True
        self._progress = progress
        return done

    def _busy(self) -> bool:
        return bool(self.inflight) or bool(self.batcher.pending)

    def _shutdown_flush(self) -> None:
        """Clean exit: finish every in-flight batch, then release the
        claims of requests never completed; their files stay for the next
        daemon (results only ever land whole)."""
        while self.inflight:
            self._resolve(self.inflight.pop(0))
        self.batcher.abandon()
        for req in list(self._claimed.values()):
            self._claimed.pop(req.path, None)
            req.lock.release()

    # ---- the loop ----------------------------------------------------------

    def serve_forever(self, max_ticks: int | None = None) -> dict:
        """Poll the spool until ``max_ticks`` or ``idle_exit_s`` of idling;
        returns :meth:`summary`.  A replica beats before every tick and
        after each step of it that made progress (:meth:`_beat`); the
        watchdog (when given) is beaten after it, so a wedged tick stops
        its beat and the watchdog ends the process.  The poll interval
        doubles on every empty scan up to ``poll_max_ms`` and snaps back
        to ``tick_s`` on any progress."""
        if self.watchdog is not None:
            self.watchdog.start()
        last_work = walltime()
        ticks = 0
        poll = self.tick_s
        try:
            while max_ticks is None or ticks < max_ticks:
                ticks += 1
                self._beat()   # before the tick, which may hang
                if self.sched == "on":
                    self._sched_tick()
                    progress = self._progress
                else:
                    progress = self.drain_once() > 0
                if self.watchdog is not None:
                    self.watchdog.beat("serve")
                now = walltime()
                if progress:
                    last_work = now
                    poll = self.tick_s
                else:
                    if (self.idle_exit_s is not None and not self._busy()
                            and now - last_work > self.idle_exit_s):
                        break
                    sleep_s = poll
                    edl = (self.batcher.earliest_deadline()
                           if self.sched == "on" else None)
                    if edl is not None:
                        # wake for the coalescing deadline, not after it
                        sleep_s = min(sleep_s, max(edl - now, 0.0) + 1e-4)
                    time.sleep(sleep_s)
                    poll = min(poll * 2.0, self.poll_max_s)
                self._poll_s = poll
        finally:
            try:
                if self.sched == "on":
                    self._shutdown_flush()
            finally:
                if self.watchdog is not None:
                    self.watchdog.stop()
        return self.summary()

    run = serve_forever  # the JAX package's name above, and the short one

    # ---- evidence ----------------------------------------------------------

    def summary(self) -> dict:
        """Requests served, latency percentiles and every scheduling and
        residency knob."""
        lat = sorted(self.latencies_s)
        return {"served": self.served,
                "p50_ms": round(_pct(lat, 0.50) * 1e3, 3),
                "p99_ms": round(_pct(lat, 0.99) * 1e3, 3),
                "bucket": self.bucket, "iters": self.iters, "eta": self.eta,
                "model_id": self.active_id, "spool": self.spool,
                "admission": self.admission, "sched": self.sched,
                "deadline_ms": self.deadline_ms,
                "starve_ms": self.starve_ms,
                "poll_max_ms": round(self.poll_max_s * 1e3, 3),
                "batches": self._batches,
                "batch_fill_mean": (round(float(np.mean(self._fills)), 4)
                                    if self._fills else None),
                "promotions": self.batcher.promotions,
                "swaps": self._swaps, "failed": self.failed,
                "replica": self.replica, "stale_ms": self.stale_ms,
                "shed": self.shed, "shed_depth": self.shed_depth,
                "redispatched": self.redispatched,
                "residency": {
                    "resident": list(self.models), "active": self.active_id,
                    "resident_peak_sum": int(sum(self._peaks.values())),
                    "charged_sum": int(
                        sum(serving_charge(p, self._backend)
                            for p in self._peaks.values())
                        + serving_process_bytes(self._backend)),
                    "budget_bytes": self.admission["budget_bytes"],
                    "report": residency_report(
                        [m.serve_plan(self.bucket)
                         for m in self.models.values()]),
                    "events": list(self.residency_events)}}


def _pct(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[i])
