"""Hierarchical span tracer — the process-global timing source of truth
(port of ``tsne_flink_tpu/obs/trace.py``, the same names, events and
export formats).

A :class:`Span` ALWAYS measures (one ``perf_counter`` pair), so callers
use ``sp.seconds`` as their stage timing whether or not tracing is
enabled; the finished event is appended to the process buffer only when
tracing is on.

Enablement: the CLI's ``--trace[=path]`` via :func:`set_enabled`, or a
nestable :func:`collecting` scope (``TSNE.fit`` uses it to populate
``trace_`` without touching process state).  The port reads no
environment variable: the JAX package's ``$TSNE_TRACE`` has no
counterpart.

A span measures host time.  None synchronizes the device: a span around
device work ends where the caller already waits for the card (a stage's
end, a segment boundary's sentinel or loss read), so a traced run keeps
the untraced run's host reads and bits.  Device time is ``--profile``'s
(``torch.profiler``).

Export formats:

* :func:`write_chrome_trace` — Chrome trace event format (``traceEvents``
  with ``ph: "X"`` duration events and ``ph: "i"`` instants), loadable in
  Perfetto (https://ui.perfetto.dev) or chrome://tracing.
* :func:`write_jsonl` — one JSON event per line with explicit
  ``id``/``parent`` links.

Pure stdlib; thread-safe (per-thread span stacks, one buffer lock).
"""

from __future__ import annotations

import json
import os
import threading
import time

#: keys every exported span/instant event carries (the JAX package's
#: trace schema).  ``dur`` is None for instants.
EVENT_KEYS = ("id", "parent", "name", "cat", "ts", "dur", "pid", "tid",
              "args")

#: buffer hard cap: events beyond it are counted in ``dropped_events()``
#: instead of stored, so a pathological span loop cannot eat the host.
MAX_EVENTS = 200_000

_LOCK = threading.Lock()
_EVENTS: list[dict] = []
_DROPPED = 0
_NEXT_ID = [1]
_TLS = threading.local()

_ENABLED_OVERRIDE: bool | None = None
_COLLECT_DEPTH = 0


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def set_enabled(value: bool | None) -> None:
    """Process switch for the tracer: True records, False/None do not
    (the CLI's ``--trace`` sets True and restores the old value)."""
    global _ENABLED_OVERRIDE
    _ENABLED_OVERRIDE = value


def enabled_override() -> bool | None:
    """The current process override (callers that save/restore it around
    a run, like cli.main)."""
    return _ENABLED_OVERRIDE


def enabled() -> bool:
    if _COLLECT_DEPTH > 0:
        return True
    return bool(_ENABLED_OVERRIDE)


class collecting:
    """Nestable scope that turns recording on for its duration —
    ``TSNE.fit`` wraps itself in one so ``trace_`` is populated without
    flipping process-global state for other callers."""

    def __enter__(self):
        global _COLLECT_DEPTH
        _COLLECT_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _COLLECT_DEPTH
        _COLLECT_DEPTH -= 1
        return False


class Span:
    """One timed region.  Use as a context manager (``with span(...) as
    sp:``) or manually via :func:`begin` / :meth:`end`."""

    __slots__ = ("name", "cat", "args", "sid", "parent", "ts", "dur", "_t0")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.sid = None
        self.parent = None
        self.ts = None
        self.dur = None
        self._t0 = None

    def start(self) -> "Span":
        with _LOCK:
            self.sid = _NEXT_ID[0]
            _NEXT_ID[0] += 1
        stack = _stack()
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        self.ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        """Seconds since start — live while open, final after end()."""
        if self.dur is not None:
            return self.dur
        return time.perf_counter() - self._t0

    @property
    def seconds(self) -> float:
        return self.elapsed()

    def set(self, **args) -> "Span":
        """Attach/overwrite args (resolved labels known only at the end)."""
        self.args.update(args)
        return self

    def end(self) -> "Span":
        if self.dur is not None:
            return self  # idempotent
        self.dur = time.perf_counter() - self._t0
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # out-of-order end: keep the stack consistent
            stack.remove(self)
        if enabled():
            _append(self.as_dict())
        return self

    def as_dict(self) -> dict:
        return {"id": self.sid, "parent": self.parent, "name": self.name,
                "cat": self.cat, "ts": self.ts, "dur": self.dur,
                "pid": os.getpid(), "tid": threading.get_ident(),
                "args": dict(self.args)}

    def __enter__(self) -> "Span":
        if self._t0 is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def walltime() -> float:
    """Epoch seconds — the same clock span ``ts`` fields carry, for
    deadline arithmetic (the watchdog); durations flow through spans."""
    return time.time()


def span(name: str, cat: str = "stage", **args) -> Span:
    """A new (unstarted) span; entering the context starts it."""
    return Span(name, cat, args)


def begin(name: str, cat: str = "stage", **args) -> Span:
    """Manual form: a STARTED span the caller must ``.end()``."""
    return Span(name, cat, args).start()


def instant(name: str, cat: str = "event", **args) -> None:
    """A zero-duration event (supervisor retries, ladder steps, sentinel
    rollbacks).  Recorded only when tracing is enabled."""
    if not enabled():
        return
    with _LOCK:
        sid = _NEXT_ID[0]
        _NEXT_ID[0] += 1
    stack = _stack()
    _append({"id": sid, "parent": stack[-1].sid if stack else None,
             "name": name, "cat": cat, "ts": time.time(), "dur": None,
             "pid": os.getpid(), "tid": threading.get_ident(),
             "args": dict(args)})


def _append(event: dict) -> None:
    global _DROPPED
    with _LOCK:
        if len(_EVENTS) >= MAX_EVENTS:
            _DROPPED += 1
            return
        _EVENTS.append(event)


def events() -> list[dict]:
    """A snapshot copy of the recorded events (spans + instants)."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def event_count() -> int:
    with _LOCK:
        return len(_EVENTS)


def events_since(index: int) -> list[dict]:
    with _LOCK:
        return [dict(e) for e in _EVENTS[index:]]


def dropped_events() -> int:
    return _DROPPED


def reset() -> None:
    """Clear the buffer and the calling thread's span stack (tests; a
    long-lived server between requests)."""
    global _DROPPED
    with _LOCK:
        _EVENTS.clear()
        _DROPPED = 0
    _stack().clear()


def stage_seconds(prefix: str = "") -> dict:
    """Total recorded span seconds aggregated by span name (optionally
    name-prefix-filtered)."""
    out: dict[str, float] = {}
    for e in events():
        if e["dur"] is None or not e["name"].startswith(prefix):
            continue
        out[e["name"]] = out.get(e["name"], 0.0) + e["dur"]
    return out


def chrome_trace() -> dict:
    """The buffer as a Chrome trace event object (Perfetto-loadable)."""
    trace_events = []
    for e in events():
        ev = {"name": e["name"], "cat": e["cat"],
              "ts": e["ts"] * 1e6, "pid": e["pid"], "tid": e["tid"],
              "args": {**e["args"], "id": e["id"],
                       **({"parent": e["parent"]}
                          if e["parent"] is not None else {})}}
        if e["dur"] is None:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=e["dur"] * 1e6)
        trace_events.append(ev)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": _DROPPED}}


def _atomic_text(path: str, text: str) -> None:
    # local tmp+rename: the tracer stays stdlib-only
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_chrome_trace(path: str) -> str:
    _atomic_text(path, json.dumps(chrome_trace()))
    return path


def write_jsonl(path: str) -> str:
    _atomic_text(path, "".join(json.dumps(e) + "\n" for e in events()))
    return path


def write(path: str) -> str:
    """Format by extension: ``.jsonl`` -> event log, else Chrome trace."""
    if path.endswith(".jsonl"):
        return write_jsonl(path)
    return write_chrome_trace(path)
