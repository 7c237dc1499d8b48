"""Deterministic fault injection — every recovery path rehearsed, on the
CPU and on the card (port of ``tsne_flink_tpu/runtime/faults.py``: the
same grammar, kinds, sites, triggers and errors).

A fault plan is a comma-separated list of ``<kind>@<site>[:<trigger>]``
clauses, given by the CLI's ``--faultPlan``, a fleet job's
``JobSpec.fault_plan`` or the estimator's ``TSNE(fault_plan=...)`` and
installed with :func:`activate`.  The port reads no environment variable
(the JAX package's ``TSNE_FAULT_PLAN`` has no counterpart):

======= ======================= =========================================
kind    example                 effect at the instrumented site
======= ======================= =========================================
oom     ``oom@knn:1``           raise :class:`InjectedOom` (a synthetic
                                out-of-memory error) on the Nth entry
kill    ``kill@optimize:seg2``  SIGKILL the process at the chosen optimize
                                segment boundary (after its checkpoint)
corrupt ``corrupt@checkpoint``  bit-flip the just-written file
nan     ``nan@optimize:seg1``   poison the segment's input y with NaN on
                                the device (the caller applies it — see
                                :meth:`FaultInjector.fire`); no host sync
delay   ``delay@knn``           sleep :data:`DELAY_S` seconds (or the
                                injector's ``delay_s``) at the site
                                entry (a ``fault.delay`` span)
hang    ``hang@serve``          block forever at the site entry (a
                                ``fault.hang`` span that never ends): the
                                pid lives and makes no progress, so a
                                replica's heartbeat goes stale — what the
                                serve fleet's hung triage catches
======= ======================= =========================================

Triggers: a bare integer is the Nth call of that site (1-based, default
1); ``segN`` matches the optimize segment number.  Each fault fires at
most once, and the whole plan is a pure function of the call sequence.

Instrumented sites: ``knn`` and ``affinities`` (stage entries in
``utils/artifacts.prepare``), ``optimize`` (segment start for
oom/nan/delay/hang, segment boundary for kill —
``runtime/segments.run_segments``), ``checkpoint`` (after the atomic
write in ``utils/checkpoint.save``) and ``serve`` (the serve daemon:
tick start for oom/delay/hang, the boundary between computing a request
and writing its result for ``kill@serve:segN``, N the requests the
daemon has served).  Each hook is one :func:`injector` read — None when
no plan is active.

**Fleet site** (``runtime/fleet.py``): ``job`` is scheduler-level — the
trigger is the JOB INDEX, and the fleet translates the clause into the
targeted job's own plan for its FIRST attempt only
(:data:`FLEET_KIND_PLAN`); :func:`split_fleet_plan` separates the two
levels.  A serve fleet's chaos rides each replica's own spec
(``runtime/fleet.ServeFleetSpec.fault_plans``), first attempt only.
"""

from __future__ import annotations

import os
import signal
from dataclasses import dataclass, field

KINDS = ("oom", "kill", "corrupt", "nan", "delay", "hang")
SITES = ("knn", "affinities", "optimize", "checkpoint", "job", "serve")

#: where in a segment each optimize-site kind fires: oom/nan/delay/hang
#: at segment start (so the recovery path sees the failure before any
#: work is committed), kill at the boundary (after the checkpoint is
#: written — the resume contract is what the kill exercises).
POINT_FOR_KIND = {"oom": "start", "nan": "start", "kill": "boundary",
                  "corrupt": "boundary", "delay": "start",
                  "hang": "start"}

#: seconds a ``delay@site`` clause sleeps (the JAX package's
#: ``TSNE_FAULT_DELAY_S`` default)
DELAY_S = 2.0

#: what a fleet-level ``<kind>@job:N`` clause becomes inside job N's own
#: process (runtime/fleet.py injects it into the first attempt's plan).
FLEET_KIND_PLAN = {"kill": "kill@optimize:seg1", "delay": "delay@knn:1",
                   "oom": "oom@knn:1", "nan": "nan@optimize:seg1"}


class InjectedOom(RuntimeError):
    """Synthetic device OOM — its message carries the markers of a real
    allocation failure, so :func:`~tsne_flink_tpu_torch.runtime
    .supervisor.is_oom` treats both alike."""

    def __init__(self, site: str):
        self.site = site
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected out of memory at stage "
            f"'{site}' (fault plan)")


@dataclass
class Fault:
    """One parsed ``kind@site[:trigger]`` clause."""

    kind: str
    site: str
    trigger: str          # "N" (Nth site call) or "segN" (optimize)
    fired: bool = False

    def matches(self, count: int, seg: int | None) -> bool:
        if self.trigger.startswith("seg"):
            return seg is not None and seg == int(self.trigger[3:])
        n = int(self.trigger)
        # a segment-indexed site treats a bare integer as the segment
        # number; occurrence counters cover the plain stage sites
        return seg == n if seg is not None else count == n


def parse_plan(spec: str) -> list[Fault]:
    """Parse a fault-plan string; raises ValueError on a malformed clause
    (fail-fast: a typo'd plan must not silently inject nothing)."""
    faults = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        try:
            kind, rest = clause.split("@", 1)
        except ValueError:
            raise ValueError(f"fault clause '{clause}' is not "
                             "kind@site[:trigger]") from None
        site, _, trigger = rest.partition(":")
        kind, site = kind.strip(), site.strip()
        trigger = trigger.strip() or "1"
        if kind not in KINDS:
            raise ValueError(f"fault kind '{kind}' not defined "
                             f"({' | '.join(KINDS)})")
        if site not in SITES:
            raise ValueError(f"fault site '{site}' not defined "
                             f"({' | '.join(SITES)})")
        if not (trigger.isdigit()
                or (trigger.startswith("seg") and trigger[3:].isdigit())):
            raise ValueError(f"fault trigger '{trigger}' is not an "
                             "occurrence count or segN")
        if site == "job" and (kind not in FLEET_KIND_PLAN
                              or not trigger.isdigit()):
            raise ValueError(
                f"fleet clause '{clause}': site 'job' takes kinds "
                f"{' | '.join(sorted(FLEET_KIND_PLAN))} and a job-index "
                "trigger (e.g. kill@job:1)")
        faults.append(Fault(kind, site, trigger))
    return faults


def split_fleet_plan(spec: str | None) -> dict[int, list[Fault]]:
    """Parse a fleet chaos plan into ``{job_index: [Fault, ...]}``.
    Job-site clauses are the scheduler's to apply
    (:data:`FLEET_KIND_PLAN`); any non-job clause in a FLEET plan is an
    error — per-job process-local faults belong on the job spec's own
    ``fault_plan``, not the fleet's (one level, one owner)."""
    by_job: dict[int, list[Fault]] = {}
    for f in parse_plan(spec or ""):
        if f.site != "job":
            raise ValueError(
                f"fleet fault plan only takes site 'job' clauses "
                f"(got '{f.kind}@{f.site}:{f.trigger}'); put process-local "
                "faults on the job's own fault_plan")
        by_job.setdefault(int(f.trigger), []).append(f)
    return by_job


def _sleep_delay(site: str, secs: float) -> None:
    """The ``delay@site`` payload: sleep ``secs`` seconds, wrapped in an
    obs span so the injected latency is attributable in the trace."""
    import time

    from tsne_flink_tpu_torch.obs import trace as obtrace
    secs = float(secs)
    with obtrace.span("fault.delay", cat="fault", site=site, seconds=secs):
        time.sleep(secs)


def _hang(site: str) -> None:
    """The ``hang@site`` payload: block forever at the site entry.  The
    span BEGINS (so the trace shows where the process wedged) but never
    ends; only a signal (the fleet's backstop kill, or the watchdog's
    exit) ends the process."""
    import time

    from tsne_flink_tpu_torch.obs import trace as obtrace
    obtrace.begin("fault.hang", cat="fault", site=site)
    while True:
        time.sleep(3600.0)


def _flip_bit(path: str) -> None:
    """Flip one bit in the middle of ``path`` — the corrupt@ payload.
    Deterministic (fixed offset), and deliberately NOT a truncation: a
    bit-flip is the case only a content hash catches."""
    size = os.path.getsize(path)
    if size == 0:
        return
    off = size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x40]))


@dataclass
class FaultInjector:
    """Stateful injector over one parsed plan; site-call counters make
    integer triggers deterministic.  ``delay_s`` is a ``delay`` clause's
    sleep (None: :data:`DELAY_S`)."""

    faults: list[Fault] = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    log: list = field(default_factory=list)  # fired (kind, site, trigger)
    delay_s: float | None = None

    def fire(self, site: str, *, seg: int | None = None,
             path: str | None = None, point: str = "start"):
        """Check (and execute) any due fault at ``site``.

        Returns the triggering :class:`Fault` for kinds the CALLER must
        apply (``nan`` — the injector cannot reach the optimizer state),
        else None.  ``oom`` raises, ``kill`` never returns, ``corrupt``
        mutates ``path`` in place."""
        self.counts[site] = self.counts.get(site, 0) + (
            1 if seg is None else 0)
        result = None
        for f in self.faults:
            if f.fired or f.site != site:
                continue
            if POINT_FOR_KIND[f.kind] != point:
                continue
            if not f.matches(self.counts.get(site, 0), seg):
                continue
            f.fired = True
            self.log.append((f.kind, f.site, f.trigger))
            if f.kind == "oom":
                raise InjectedOom(site)
            if f.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            if f.kind == "corrupt" and path is not None:
                _flip_bit(path)
            if f.kind == "delay":
                _sleep_delay(site, DELAY_S if self.delay_s is None
                             else self.delay_s)
            if f.kind == "hang":
                _hang(site)
            if f.kind == "nan":
                result = f
        return result


_INJECTOR: FaultInjector | None = None


def injector() -> FaultInjector | None:
    """The process-global injector, or None when no plan is active
    (:func:`activate` installs one)."""
    return _INJECTOR


def activate(spec: str | None,
             delay_s: float | None = None) -> FaultInjector | None:
    """Install a fault plan (None or "" deactivates); ``delay_s`` sets its
    ``delay`` clauses' sleep (a serve replica's ``ServeSpec
    .fault_delay_s``)."""
    global _INJECTOR
    _INJECTOR = (FaultInjector(parse_plan(spec), delay_s=delay_s) if spec
                 else None)
    return _INJECTOR
