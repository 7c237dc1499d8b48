"""The deadline-driven micro-batch scheduler of the serve daemon (port of
``tsne_flink_tpu/serve/sched.py``; pure bookkeeping, no I/O, no device).

* **Slices.**  A claimed request is a row range with a cursor; the packer
  peels rows off it in bucket-width slices, so a 1,024-row request
  becomes four slices that stream back as their batches complete, and a
  64-row request rides the padding of whichever batch dispatches next.
  Per-row independence of the transform makes any packing bit-identical
  to serving each request alone.
* **Deadlines.**  Each request's deadline is ``arrival + deadline_ms ·
  rows / bucket``: slack in proportion to the work carried, so the EDF
  drain orders a 64-row request ahead of a same-instant 1,024-row one,
  yet stays starvation-free.  A batch dispatches when a bucket fills,
  when the earliest deadline arrives, or at once when the device is idle
  (work-conserving).
* **Lanes.**  Requests that fit one bucket ride the ``express`` lane
  ahead of multi-bucket ``bulk`` ones; a bulk request waiting past
  ``starve_ms`` is promoted ahead of express.
* **Determinism.**  Packing is a function of the claim order and the
  clock samples it is handed: (promoted, lane, deadline, claim seq).

The daemon (``serve/daemon.py``) drives it from a double-buffered tick.
The pickers take arguments whose defaults are the JAX package's
environment defaults; the port reads no environment variable.
"""

from __future__ import annotations

import numpy as np

#: lane names, rank order (lower packs first; promotion overrides)
EXPRESS = "express"
BULK = "bulk"
_LANE_RANK = {EXPRESS: 0, BULK: 1}

#: the JAX package's defaults (TSNE_SERVE_SCHED, _DEADLINE_MS, _STARVE_MS,
#: _POLL_MAX_MS)
DEFAULT_SCHED = "on"
DEFAULT_DEADLINE_MS = 50.0
DEFAULT_STARVE_MS = 30_000.0
DEFAULT_POLL_MAX_MS = 1_000.0

#: every key the scheduler puts on a latency record or the daemon
#: summary (the JAX package's list, replica keys included: a solo
#: daemon writes ``replica`` and ``epoch`` too)
SCHED_RECORD_KEYS = (
    "sched", "deadline_ms", "starve_ms", "poll_ms", "queue_ms",
    "compute_ms", "write_ms", "batch_fill", "lane", "slices", "spool",
    "promoted", "batches", "residency", "seconds",
    "replica", "epoch", "replicas", "stale_ms", "shed", "shed_depth",
    "retry_after_ms", "redispatched",
)


def pick_serve_sched(mode: str | None = None) -> str:
    """Scheduler mode, ``on`` or ``off`` (recorded as ``sched``)."""
    got = str(mode or DEFAULT_SCHED).lower()
    if got not in ("on", "off"):
        raise ValueError(f"sched must be on|off, got {got!r}")
    return got


def pick_serve_deadline_ms(ms: float | None = None) -> float:
    """Coalescing deadline unit (recorded as ``deadline_ms``)."""
    got = float(ms) if ms is not None else DEFAULT_DEADLINE_MS
    if got < 0:
        raise ValueError(f"deadline must be >= 0 ms, got {got}")
    return got


def pick_serve_starve_ms(ms: float | None = None) -> float:
    """Anti-starvation bound of the bulk lane (recorded as
    ``starve_ms``)."""
    got = float(ms) if ms is not None else DEFAULT_STARVE_MS
    if got <= 0:
        raise ValueError(f"starve bound must be > 0 ms, got {got}")
    return got


def pick_poll_max_ms(ms: float | None = None) -> float:
    """Ceiling of the adaptive spool-poll backoff (the interval in
    effect at claim time is recorded as ``poll_ms``)."""
    got = float(ms) if ms is not None else DEFAULT_POLL_MAX_MS
    if got <= 0:
        raise ValueError(f"poll ceiling must be > 0 ms, got {got}")
    return got


class Request:
    """One claimed request riding the scheduler: a row range with a
    pack cursor, its lock held from claim to result write (the spool
    protocol's crash story, unchanged)."""

    __slots__ = ("rid", "path", "lock", "x", "model_id", "rows",
                 "arrival", "deadline", "seq", "lane", "poll_ms",
                 "next_row", "done_rows", "out", "slices", "fills",
                 "first_dispatch", "compute_done", "promoted", "epoch")

    def __init__(self, rid: str, path: str, lock, x: np.ndarray,
                 model_id: str, *, arrival: float, deadline_s: float,
                 seq: int, bucket: int, out_width: int,
                 out_dtype, poll_ms: float, epoch: int = 0):
        self.rid = rid
        self.path = path
        self.lock = lock
        self.x = x
        self.model_id = model_id
        self.rows = int(x.shape[0])
        self.arrival = float(arrival)
        # service-proportional slack: the deadline scales with the
        # buckets of work the request carries (rows/bucket), so EDF
        # orders a 64-row request ahead of a same-instant 1024-row one
        # instead of degenerating to FIFO — while staying starvation-
        # free, because deadlines grow with arrival and an old bulk
        # request eventually precedes any fresh express one.
        self.deadline = (float(arrival)
                         + float(deadline_s) * self.rows / float(bucket))
        self.seq = int(seq)
        self.lane = EXPRESS if self.rows <= int(bucket) else BULK
        self.poll_ms = float(poll_ms)
        self.next_row = 0        # rows handed to a dispatched batch
        self.done_rows = 0       # rows materialized into ``out``
        self.out = np.empty((self.rows, out_width), dtype=out_dtype)
        self.slices = 0
        self.fills: list[float] = []
        self.first_dispatch: float | None = None
        self.compute_done: float | None = None
        self.promoted = False
        # claim generation (0 = unclaimed): stamped at claim, checked by
        # the result writer's rename guard
        self.epoch = int(epoch)

    def complete(self) -> bool:
        return self.done_rows >= self.rows


class Batch:
    """One dispatched bucket: the packed parts and (daemon-attached)
    the unmaterialized device result."""

    __slots__ = ("parts", "rows", "model_id", "handle", "t_dispatch",
                 "fill")

    def __init__(self, parts, rows: int, model_id: str, bucket: int):
        self.parts = parts              # [(req, req_start, n, batch_off)]
        self.rows = int(rows)
        self.model_id = model_id
        self.fill = float(rows) / float(bucket)
        self.handle = None
        self.t_dispatch = 0.0


class MicroBatcher:
    """The packing state machine — pure bookkeeping, no I/O, no device.

    ``add`` takes claimed requests in claim order; ``ready`` answers
    "should a batch dispatch now?"; ``next_batch`` peels rows off
    pending requests in priority order into one bucket.  Deterministic
    given the claim order and the ``now`` samples it is handed."""

    def __init__(self, bucket: int, *, deadline_s: float,
                 starve_s: float):
        self.bucket = int(bucket)
        self.deadline_s = float(deadline_s)
        self.starve_s = float(starve_s)
        self.pending: list[Request] = []   # claim order
        self._seq = 0
        self.promotions = 0

    # ---- intake ------------------------------------------------------------

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def add(self, req: Request) -> None:
        self.pending.append(req)

    # ---- introspection -----------------------------------------------------

    def pending_rows(self) -> int:
        return sum(r.rows - r.next_row for r in self.pending)

    def earliest_deadline(self) -> float | None:
        if not self.pending:
            return None
        return min(r.deadline for r in self.pending)

    # ---- the packing decision ----------------------------------------------

    def ready(self, now: float, *, device_idle: bool) -> bool:
        """Dispatch now?  Yes when a bucket can fill, when the earliest
        deadline has arrived, or whenever the device is idle (work
        conservation: batching only ever trades wait for fill while
        compute is the bottleneck)."""
        if not self.pending:
            return False
        if self.pending_rows() >= self.bucket:
            return True
        if device_idle:
            return True
        return now >= self.earliest_deadline()

    def _promote(self, now: float) -> None:
        for r in self.pending:
            if (not r.promoted and r.lane == BULK
                    and now - r.arrival > self.starve_s):
                r.promoted = True
                self.promotions += 1

    def _order(self, now: float) -> list[Request]:
        self._promote(now)
        return sorted(
            self.pending,
            key=lambda r: (0 if r.promoted else 1,
                           _LANE_RANK[r.lane], r.deadline, r.seq))

    def next_batch(self, now: float) -> Batch | None:
        """Pack one bucket: rows peel off pending requests in
        (promoted, lane, deadline, seq) order, one model per batch (the
        transform stages are model-keyed)."""
        order = self._order(now)
        if not order:
            return None
        model_id = order[0].model_id
        parts = []
        off = 0
        for r in order:
            if off >= self.bucket:
                break
            if r.model_id != model_id:
                continue
            take = min(self.bucket - off, r.rows - r.next_row)
            if take <= 0:
                continue
            parts.append((r, r.next_row, take, off))
            r.next_row += take
            off += take
        if not parts:
            return None
        self.pending = [r for r in self.pending if r.next_row < r.rows]
        return Batch(parts, off, model_id, self.bucket)

    # ---- crash/exit path ---------------------------------------------------

    def abandon(self) -> list[Request]:
        """Forget all pending requests (clean daemon exit): the caller
        releases their locks and leaves the request files for the next
        daemon — undispatched rows are never half-served because results
        only ever land whole."""
        out, self.pending = self.pending, []
        return out
