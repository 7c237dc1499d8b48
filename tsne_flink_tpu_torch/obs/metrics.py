"""Typed counter/gauge/histogram registry — one snapshot schema (port of
``tsne_flink_tpu/obs/metrics.py``, the same names and layout).

The runtime supervisor counts every oom/degrade/rollback here, the fleet
its admissions, retries and preemptions, ``kernels/build`` its library
hits and builds, and :func:`snapshot` renders everything as one JSON-safe
dict consumed by ``TSNE.metrics_`` and the CLI's ``--metricsOut``.

Metric names are dotted (``compile.count``, ``aot.hits``,
``runtime.oom``, ``memory.knn.observed_bytes``); a name registers its
type on first use and re-registering it as a different type raises —
typed means typo'd dimensions fail fast instead of forking the schema.

Pure stdlib; always on (a counter bump is an add under a lock — there is
no disabled mode to bit-flip program behavior, unlike the tracer).
"""

from __future__ import annotations

import json
import os
import threading

#: top-level keys every snapshot carries (the JAX package's).
SNAPSHOT_KEYS = ("schema", "counters", "gauges", "histograms")

#: bump when the snapshot layout changes shape (consumers key on it).
SCHEMA_VERSION = 1

_LOCK = threading.Lock()
_REGISTRY: dict[str, object] = {}


class Counter:
    """Monotonic accumulator (float increments allowed: seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _LOCK:
            self.value += v


class Gauge:
    """Last-write-wins value (JSON-safe scalars/strings)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v) -> None:
        with _LOCK:
            self.value = v


class Histogram:
    """Streaming count/sum/min/max (mean derived at snapshot time)."""

    __slots__ = ("name", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        v = float(v)
        with _LOCK:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)


def _get(name: str, cls):
    with _LOCK:
        m = _REGISTRY.get(name)
    if m is None:
        m = cls(name)
        with _LOCK:
            m = _REGISTRY.setdefault(name, m)
    if not isinstance(m, cls):
        raise TypeError(f"metric '{name}' is a {type(m).__name__}, not a "
                        f"{cls.__name__} — one name, one type")
    return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def counter_value(name: str) -> float:
    """Current value of a counter (0.0 when never touched)."""
    with _LOCK:
        m = _REGISTRY.get(name)
    if m is None:
        return 0.0
    if not isinstance(m, Counter):
        raise TypeError(f"metric '{name}' is not a Counter")
    return m.value


def snapshot() -> dict:
    """Everything, as one JSON-safe dict: counters (ints stay ints),
    gauges, and histogram summaries."""
    with _LOCK:
        items = list(_REGISTRY.items())
    counters, gauges, hists = {}, {}, {}
    for name, m in sorted(items):
        if isinstance(m, Counter):
            v = m.value
            counters[name] = int(v) if float(v).is_integer() else v
        elif isinstance(m, Gauge):
            gauges[name] = m.value
        else:
            hists[name] = {"count": m.count, "sum": m.sum,
                           "min": m.min, "max": m.max,
                           "mean": (m.sum / m.count) if m.count else None}
    return {"schema": SCHEMA_VERSION, "counters": counters,
            "gauges": gauges, "histograms": hists}


def write_snapshot(path: str, extra: dict | None = None) -> str:
    """Atomic snapshot JSON (the CLI's ``--metricsOut``); ``extra`` keys
    are merged at the top level (run identity)."""
    snap = snapshot()
    if extra:
        snap.update(extra)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=2)
    os.replace(tmp, path)
    return path


def reset() -> None:
    """Drop every metric (tests / long-lived servers between jobs)."""
    with _LOCK:
        _REGISTRY.clear()
