"""N serve-daemon replicas over ONE spool, supervised (port of
``tsne_flink_tpu/serve/replicas.py``).

The spool protocol (``serve/daemon.py``) makes a single daemon
crash-safe: requests are durable files, claims are O_EXCL locks, results
land atomically, and per-row independence of the transform makes any
packing bit-identical to serial.  A fleet of daemons needs three more
layers, kept here:

* **Failure detection.**  Every replica writes ``<replica>.beat.json``
  into the spool before each tick (a monotonic ``seq``, its pid, and the
  requests it holds claims on, all through ``atomic_write``).  The
  supervisor triages each replica as

  ========= ======================================== ==================
  state     evidence                                 action
  ========= ======================================== ==================
  dead      pid gone                                 break its claims
                                                     now, relaunch with
                                                     backoff
  hung      pid alive, beat older than ``stale_ms``  SIGKILL, then the
                                                     dead path
  slow      pid alive, beat fresh                    leave it alone
  ========= ======================================== ==================

  and the same triage decides the claim stale-break inside every daemon
  (:func:`claim_stale_verdict` is the claim lock's ``stale_fn``), so a
  replica that pauses but still beats is never served twice: lock age
  alone no longer breaks a live holder's claim.
* **Exactly-once re-dispatch.**  Each claim carries an epoch: a
  ``<id>.epoch.json`` sidecar, bumped under the claim lock and deleted
  with the request at its terminal, and the same epoch stamped into the
  lock body.  A dead replica's broken claim returns the request to the
  spool; the next claimant reads epoch N and claims at N + 1, and a
  zombie's late result write is discarded by the daemon's rename guard
  (the bytes land in an epoch-tagged tmp, renamed onto ``.res.npz`` only
  while the lock body still names the writer's pid and epoch).  Every
  request reaches exactly one terminal, bit-identical to an unfailed
  serial run.
* **Overload shedding.**  ``runtime/admission.decide_shed``: past
  ``shed_depth`` pending requests in the shared spool, bulk requests get
  a fast ``.err.json`` refusal with ``retry_after_ms``; express requests
  are never shed before bulk.  Each replica's claim horizon is bounded by
  its queue depth x transform peak against the budget
  (``runtime/admission.bounded_claim_rows``).

:class:`ServeFleet` is the supervisor loop ``runtime/fleet.py
--serve-fleet`` runs: spawn N ``python -m tsne_flink_tpu_torch.runtime
.fleet --serve`` children against the shared spool, poll their
heartbeats, SIGKILL the hung, break the dead replicas' claims, relaunch
with deterministic backoff (``runtime/supervisor.backoff_seconds``), and
stop when the spool is drained and every child has exited.  Chaos rides
each replica's own spec ``fault_plan`` and applies to its first attempt
only, so a killed replica's relaunch runs clean.  The supervisor
imports no torch: it is process and file plumbing, and survives whatever
a replica does to its card.

The JAX package reads its defaults from ``TSNE_SERVE_REPLICAS``,
``TSNE_REPLICA_STALE_MS`` and ``TSNE_SERVE_SHED_DEPTH``; the port reads
no environment variable and keeps those defaults as module constants.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.obs.trace import walltime
from tsne_flink_tpu_torch.utils.io import atomic_write
from tsne_flink_tpu_torch.utils.locks import read_lock_payload

#: per-replica heartbeat file in the spool (the supervisor's: swept at the
#: end of a fleet run, so a drained spool holds terminals only)
BEAT_SUFFIX = ".beat.json"

#: per-request claim-epoch sidecar (the claimant's: bumped under the claim
#: lock, deleted with the request when its terminal lands)
EPOCH_SUFFIX = ".epoch.json"

#: the claim-lock suffix the supervisor sweeps when it breaks a dead
#: replica's claims
CLAIM_LOCK_SUFFIX = ".req.npz.lock"

#: the JAX package's defaults (TSNE_SERVE_REPLICAS, TSNE_REPLICA_STALE_MS,
#: TSNE_SERVE_SHED_DEPTH)
DEFAULT_REPLICAS = 2
DEFAULT_STALE_MS = 5000.0
DEFAULT_SHED_DEPTH = 0

# ---- knob resolvers ----------------------------------------------------------

def pick_serve_replicas(n: int | None = None) -> int:
    """The serve fleet's replica count (the record's ``replicas``)."""
    got = int(n) if n is not None else DEFAULT_REPLICAS
    if got < 1:
        raise ValueError(f"replica count must be >= 1, got {got}")
    return got


def pick_replica_stale_ms(ms: float | None = None) -> float:
    """The heartbeat staleness bound of the dead/hung/slow triage: a
    replica whose beat is older than this while its pid lives is hung
    (the supervisor SIGKILLs it); a fresher beat marks it slow and
    protects its claims from the stale-break (the summary's
    ``stale_ms``)."""
    got = float(ms) if ms is not None else DEFAULT_STALE_MS
    if got <= 0:
        raise ValueError(f"replica stale bound must be > 0 ms, got {got}")
    return got


def pick_shed_depth(depth: int | None = None) -> int:
    """The brownout threshold: past this many pending requests, bulk
    claims are refused with a ``retry_after_ms`` hint (express is never
    shed before bulk); 0 disables shedding (the summary's
    ``shed_depth``, its refusals ``shed``)."""
    got = int(depth) if depth is not None else DEFAULT_SHED_DEPTH
    if got < 0:
        raise ValueError(f"shed depth must be >= 0, got {got}")
    return got


# ---- heartbeats --------------------------------------------------------------

def beat_path(spool: str, replica: str) -> str:
    return os.path.join(spool, replica + BEAT_SUFFIX)


def write_beat(spool: str, replica: str, seq: int, claimed) -> str:
    """One heartbeat: a monotonic ``seq``, the writer's pid, the wall
    clock and the ids of the requests this replica holds claims on (where
    the supervisor's post-mortem of a dead replica starts).  Atomic, like
    every spool write."""
    path = beat_path(spool, replica)
    payload = {"replica": replica, "pid": os.getpid(), "seq": int(seq),
               "t": walltime(), "claimed": sorted(claimed)}

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(payload, f)
    atomic_write(path, write)
    return path


def read_beat(spool: str, replica: str) -> dict | None:
    """The replica's last heartbeat, or None when absent or torn."""
    if not replica:
        return None
    try:
        with open(beat_path(spool, replica), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def clear_beats(spool: str) -> None:
    """Sweep the heartbeat files (a fleet run's epilogue: a drained spool
    holds terminals only)."""
    try:
        names = os.listdir(spool)
    except OSError:
        return
    for name in names:
        if name.endswith(BEAT_SUFFIX):
            try:
                os.remove(os.path.join(spool, name))
            except OSError:
                pass


def pid_alive(pid: int) -> bool:
    """True when ``pid`` exists (a signal-0 probe; EPERM still means
    alive)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def claim_stale_verdict(lock_path: str, age: float, *, spool: str,
                        replica_stale_s: float):
    """The dead/hung/slow triage of one claim lock — the ``stale_fn`` the
    daemon gives every request claim:

    * the holder's pid is gone → True (dead: break now, at any age);
    * the holder lives and its replica's heartbeat (same pid) is fresher
      than ``replica_stale_s`` → False (slow but alive: never broken,
      however old the lock; the claim epoch closes the zombie write left);
    * otherwise → None (an anonymous or beat-stale holder: the lock's age
      rule decides, as for a solo daemon).
    """
    claim = read_lock_payload(lock_path)
    pid_s = str(claim.get("pid", ""))
    if not pid_s.isdigit():
        return None                      # torn or anonymous: age rule
    if not pid_alive(int(pid_s)):
        return True                      # dead holder: break now
    beat = read_beat(spool, claim.get("replica", ""))
    if beat is not None and str(beat.get("pid")) == pid_s:
        if walltime() - float(beat.get("t", 0.0)) < replica_stale_s:
            return False                 # alive and beating: never broken
    return None


# ---- claim epochs ------------------------------------------------------------

def epoch_path(spool: str, rid: str) -> str:
    return os.path.join(spool, rid + EPOCH_SUFFIX)


def read_epoch(spool: str, rid: str) -> int:
    """The last claim generation of request ``rid`` (0: never claimed)."""
    try:
        with open(epoch_path(spool, rid), encoding="utf-8") as f:
            return int(json.load(f).get("epoch", 0))
    except (OSError, ValueError):
        return 0


def bump_epoch(spool: str, rid: str, lock) -> int:
    """Advance the claim epoch of ``rid`` and return it.  Called while
    ``lock`` (the request's claim lock) is held, which serializes the
    read-modify-write; the caller stamps the epoch into the lock body so
    the rename guard compares the two without reading the sidecar."""
    if lock is None or not lock._held:
        raise RuntimeError(f"bump_epoch({rid!r}) without its claim lock")
    epoch = read_epoch(spool, rid) + 1

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump({"req": rid, "epoch": epoch}, f)
    atomic_write(epoch_path(spool, rid), write)
    return epoch


def clear_epoch(spool: str, rid: str) -> None:
    """Drop the epoch sidecar once the request's terminal has landed (a
    request with a terminal has no next claimant)."""
    try:
        os.remove(epoch_path(spool, rid))
    except OSError:
        pass


def break_dead_claims(spool: str, replica: str) -> list[str]:
    """Break every claim lock in ``spool`` whose body names ``replica``
    and whose holder's pid is gone: the re-dispatch after a replica's
    death.  The request files never moved, so removing the locks returns
    the requests to the queue; the next claimant bumps each epoch.
    Returns the re-dispatched request ids."""
    try:
        names = os.listdir(spool)
    except OSError:
        return []
    freed: list[str] = []
    for name in sorted(names):
        if not name.endswith(CLAIM_LOCK_SUFFIX):
            continue
        lock_path = os.path.join(spool, name)
        claim = read_lock_payload(lock_path)
        if claim.get("replica") != replica:
            continue
        pid_s = str(claim.get("pid", ""))
        if pid_s.isdigit() and pid_alive(int(pid_s)):
            continue   # the relaunched replica's live claim
        try:
            os.remove(lock_path)
        except OSError:
            continue
        freed.append(name[:-len(CLAIM_LOCK_SUFFIX)])
    return freed


# ---- the fleet supervisor ----------------------------------------------------

class _Replica:
    """One supervised replica slot: its specs (chaos for the first
    attempt, clean for relaunches), the live process and its attempts."""

    __slots__ = ("name", "spec_path", "clean_spec_path", "log_path",
                 "proc", "attempts", "relaunch_at", "exited_clean",
                 "sigkilled")

    def __init__(self, name: str, spec_path: str,
                 clean_spec_path: str | None = None,
                 log_path: str | None = None):
        self.name = name
        self.spec_path = spec_path
        self.clean_spec_path = clean_spec_path or spec_path
        self.log_path = log_path or spec_path + ".log"
        self.proc = None
        self.attempts = 0
        self.relaunch_at: float | None = None
        self.exited_clean = False
        self.sigkilled: int | None = None   # the pid the triage killed


class ServeFleet:
    """Supervise N ``--serve`` replicas over one spool until it drains:
    heartbeat triage (dead / hung / slow), claim re-dispatch, relaunch
    with deterministic backoff."""

    def __init__(self, spool: str, members: list[_Replica], *,
                 stale_ms: float | None = None, poll_s: float = 0.05,
                 max_attempts: int = 3, env: dict | None = None,
                 backoff_base: float | None = None,
                 backoff_cap: float | None = None):
        self.spool = spool
        self.members = list(members)
        self.stale_s = pick_replica_stale_ms(stale_ms) / 1e3
        self.poll_s = float(poll_s)
        self.max_attempts = int(max_attempts)
        self.env = dict(env or {})
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.relaunches = 0
        self.sigkills = 0
        self.redispatched: list[str] = []
        self.events: list[dict] = []

    # ---- plumbing ----------------------------------------------------------

    def _event(self, kind: str, rep: _Replica, **extra) -> None:
        row = {"event": kind, "replica": rep.name, "attempt": rep.attempts,
               "t": walltime(), **extra}
        self.events.append(row)
        obtrace.instant(f"fleet.replica.{kind}", cat="fleet",
                        replica=rep.name, **extra)

    def _spawn(self, rep: _Replica) -> None:
        from tsne_flink_tpu_torch.runtime.fleet import child_env
        spec = rep.spec_path if rep.attempts == 0 else rep.clean_spec_path
        env = child_env(self.env)
        argv = [sys.executable, "-m", "tsne_flink_tpu_torch.runtime.fleet",
                "--serve", spec]
        with open(rep.log_path, "ab") as log:
            rep.proc = subprocess.Popen(argv, stdout=log,
                                        stderr=subprocess.STDOUT, env=env)
        rep.exited_clean = False
        rep.relaunch_at = None
        self._event("spawn", rep, pid=rep.proc.pid,
                    spec=os.path.basename(spec))

    def _pending(self) -> int:
        try:
            names = os.listdir(self.spool)
        except OSError:
            return 0
        return sum(1 for n in names if n.endswith(".req.npz"))

    # ---- the triage passes -------------------------------------------------

    def _hung_pass(self) -> None:
        """SIGKILL the replicas whose pid lives but whose beat went stale
        (the triage's hung row), once: a process that holds a CUDA context
        takes a few hundred ms to die after the signal, and the reap pass
        collects it.  A replica that has not beaten yet (still starting) is
        not judged; the run's deadline is its backstop."""
        for rep in self.members:
            if rep.proc is None or rep.proc.poll() is not None:
                continue
            if rep.sigkilled == rep.proc.pid:
                continue   # signalled, still dying
            beat = read_beat(self.spool, rep.name)
            if beat is None or str(beat.get("pid")) != str(rep.proc.pid):
                continue
            beat_age = walltime() - float(beat.get("t", 0.0))
            if beat_age > self.stale_s:
                try:
                    os.kill(rep.proc.pid, signal.SIGKILL)
                except OSError:
                    continue   # lost the race with its own exit
                rep.sigkilled = rep.proc.pid
                self.sigkills += 1
                self._event("sigkill-hung", rep, pid=rep.proc.pid,
                            beat_age_ms=round(beat_age * 1e3, 1))

    def _reap_pass(self) -> None:
        """Collect the exited replicas: break their dead claims (the
        re-dispatch) and schedule a backoff relaunch after an unclean
        exit."""
        from tsne_flink_tpu_torch.runtime.supervisor import backoff_seconds
        for rep in self.members:
            if rep.proc is None or rep.proc.poll() is None:
                continue
            rc = rep.proc.returncode
            freed = break_dead_claims(self.spool, rep.name)
            self.redispatched.extend(freed)
            self._event("exit", rep, rc=rc, redispatched=freed)
            rep.proc = None
            if rc == 0:
                rep.exited_clean = True
                continue
            if rep.attempts + 1 >= self.max_attempts:
                self._event("gave-up", rep, rc=rc)
                continue
            rep.attempts += 1
            delay = backoff_seconds(rep.attempts - 1, self.backoff_base,
                                    self.backoff_cap, token=rep.name)
            rep.relaunch_at = walltime() + delay
            self._event("relaunch-scheduled", rep,
                        delay_ms=round(delay * 1e3, 1))

    def _relaunch_pass(self, now: float) -> None:
        for rep in self.members:
            if rep.relaunch_at is not None and now >= rep.relaunch_at:
                self.relaunches += 1
                self._spawn(rep)
        if self._pending() and not any(
                rep.proc is not None or rep.relaunch_at is not None
                for rep in self.members):
            # work remains but every replica idle-exited (a late
            # submission raced the drain): bring one clean replica back
            for rep in self.members:
                if rep.exited_clean and rep.attempts < self.max_attempts:
                    rep.attempts += 1
                    self.relaunches += 1
                    self._spawn(rep)
                    break

    def _done(self) -> bool:
        return (self._pending() == 0
                and all(rep.proc is None and rep.relaunch_at is None
                        for rep in self.members))

    def _halt(self) -> None:
        """The deadline's epilogue: SIGKILL the stragglers, so the final
        reap breaks their claims and the record says what happened."""
        for rep in self.members:
            if rep.proc is not None and rep.proc.poll() is None:
                try:
                    os.kill(rep.proc.pid, signal.SIGKILL)
                except OSError:
                    pass
                self._event("sigkill-deadline", rep, pid=rep.proc.pid)
        for rep in self.members:
            if rep.proc is not None:
                rep.proc.wait()

    # ---- the loop ----------------------------------------------------------

    def run(self, run_s: float) -> dict:
        """Spawn every member and supervise until the spool drains and all
        replicas have exited (or ``run_s`` passes: then SIGKILL the
        stragglers); sweep the heartbeats and return the fleet record.
        No child outlives the call."""
        t0 = walltime()
        deadline_hit = False
        try:
            with obtrace.span("fleet.serve", cat="fleet",
                              replicas=len(self.members)):
                for rep in self.members:
                    self._spawn(rep)
                while True:
                    self._hung_pass()
                    self._reap_pass()
                    now = walltime()
                    self._relaunch_pass(now)
                    if self._done():
                        break
                    if now - t0 > float(run_s):
                        deadline_hit = True
                        self._halt()
                        self._reap_pass()
                        break
                    time.sleep(self.poll_s)
        finally:
            for rep in self.members:
                if rep.proc is not None and rep.proc.poll() is None:
                    rep.proc.kill()
                    rep.proc.wait()
            clear_beats(self.spool)
        return {"replicas": [rep.name for rep in self.members],
                "attempts": {rep.name: rep.attempts + 1
                             for rep in self.members},
                "relaunches": self.relaunches,
                "sigkills": self.sigkills,
                "redispatched": sorted(set(self.redispatched)),
                "deadline_hit": deadline_hit,
                "stale_ms": round(self.stale_s * 1e3, 3),
                "seconds": round(walltime() - t0, 3),
                "events": list(self.events)}
