"""PyTorch port, the tracing and metrics layer vs the JAX package (CPU).

* the metrics registry's snapshot has JAX's keys and schema version, and
  the same updates give the same snapshot;
* the tracer's events carry JAX's ``EVENT_KEYS``, its Chrome trace and
  JSONL exports have JAX's layout, ``collecting`` records without
  enabling, ``stage_seconds`` sums by name;
* the memory watermark's ``drift`` equals JAX's, a CPU sample is labelled
  ``rss``; the host probe's record has JAX's keys.
"""

import json

import pytest

from tsne_flink_tpu.obs import memory as jmem
from tsne_flink_tpu.obs import metrics as jmetrics
from tsne_flink_tpu.obs import trace as jtrace
from tsne_flink_tpu_torch.obs import calibrate as tcal
from tsne_flink_tpu_torch.obs import memory as tmem
from tsne_flink_tpu_torch.obs import metrics as tmetrics
from tsne_flink_tpu_torch.obs import trace as ttrace

pytestmark = pytest.mark.fast


def _fill(m):
    m.counter("runtime.oom").inc()
    m.counter("runtime.oom").inc(2)
    m.counter("compile.seconds").inc(0.5)
    m.gauge("fleet.queue_depth").set(3)
    m.gauge("memory.basis").set("rss")
    for v in (1.0, 4.0, 2.5):
        m.histogram("serve.latency_ms").observe(v)


def test_snapshot_matches_jax():
    assert tmetrics.SNAPSHOT_KEYS == jmetrics.SNAPSHOT_KEYS
    assert tmetrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION
    saved = dict(jmetrics._REGISTRY)
    try:
        jmetrics.reset()
        tmetrics.reset()
        _fill(jmetrics)
        _fill(tmetrics)
        got, want = tmetrics.snapshot(), jmetrics.snapshot()
        assert tuple(got) == tmetrics.SNAPSHOT_KEYS and got == want
        assert tmetrics.counter_value("runtime.oom") == 3
        with pytest.raises(TypeError, match="one name, one type"):
            tmetrics.gauge("runtime.oom")
    finally:
        jmetrics.reset()
        jmetrics._REGISTRY.update(saved)
        tmetrics.reset()


def test_write_snapshot_is_atomic_json(tmp_path):
    tmetrics.reset()
    tmetrics.counter("fleet.retries").inc()
    path = tmetrics.write_snapshot(str(tmp_path / "m" / "metrics.json"),
                                   extra={"run": "t"})
    got = json.loads(open(path).read())
    assert got["run"] == "t" and got["counters"] == {"fleet.retries": 1}
    assert not (tmp_path / "m" / "metrics.json.tmp").exists()
    tmetrics.reset()


def _spans(t):
    with t.span("prepare.knn", cat="prepare") as sp:
        with t.span("knn.exact_sweep", cat="knn", method="bruteforce"):
            pass
        t.instant("supervisor.oom", cat="runtime", stage="knn")
        sp.set(cache="off")
    t.begin("optimize.segment", cat="optimize", seg=1).end()


def test_event_keys_and_exports_match_jax(tmp_path):
    assert ttrace.EVENT_KEYS == jtrace.EVENT_KEYS
    ttrace.reset()
    jtrace.reset()
    ttrace.set_enabled(True)
    jtrace.set_enabled(True)
    try:
        _spans(ttrace)
        _spans(jtrace)
        got, want = ttrace.events(), jtrace.events()
        assert [tuple(e) for e in got] == [ttrace.EVENT_KEYS] * 4
        strip = ("id", "parent", "ts", "dur", "pid", "tid")

        def shape(evs):
            return [({k: v for k, v in e.items() if k not in strip},
                     e["dur"] is None, e["parent"] is None) for e in evs]
        assert shape(got) == shape(want)
        tc, jc = ttrace.chrome_trace(), jtrace.chrome_trace()
        assert set(tc) == set(jc)
        assert [sorted(e) for e in tc["traceEvents"]] == [
            sorted(e) for e in jc["traceEvents"]]
        assert [e["ph"] for e in tc["traceEvents"]] == ["X", "i", "X", "X"]
        ttrace.write(str(tmp_path / "t.json"))
        ttrace.write(str(tmp_path / "t.jsonl"))
        assert json.load(open(tmp_path / "t.json"))["traceEvents"]
        lines = open(tmp_path / "t.jsonl").read().splitlines()
        assert [json.loads(x)["name"] for x in lines] == [
            e["name"] for e in got]
        assert set(ttrace.stage_seconds("prepare")) == {"prepare.knn"}
    finally:
        ttrace.set_enabled(None)
        jtrace.set_enabled(None)
        ttrace.reset()
        jtrace.reset()


def test_spans_time_always_and_record_only_when_enabled():
    ttrace.reset()
    assert not ttrace.enabled()
    with ttrace.span("x") as sp:
        pass
    assert sp.seconds >= 0 and ttrace.event_count() == 0
    with ttrace.collecting():
        assert ttrace.enabled()
        with ttrace.span("y"):
            pass
    assert not ttrace.enabled()
    assert [e["name"] for e in ttrace.events()] == ["y"]
    ttrace.reset()


@pytest.mark.parametrize("obs,pred", [(10, 8), (8, 10), (5, None), (3, 0)])
def test_drift_matches_jax(obs, pred):
    assert tmem.drift(obs, pred) == jmem.drift(obs, pred)


def test_memory_sample_on_the_cpu_is_rss():
    rec = tmem.sample("knn", device="cpu")
    assert rec["basis"] == "rss" and rec["observed_bytes"] > 0
    assert tmem.observed_peak_bytes("cpu")[1] == "rss"
    with tmem.watermark("affinities", device="cpu") as w:
        pass
    assert w["basis"] == "rss"
    assert tmetrics.snapshot()["gauges"]["memory.basis"] == "rss"


def test_host_calibration_record():
    rec = tcal.host_calibration(size=64, reps=1)
    assert set(rec) == {"signature", "matmul_gflops", "backend", "size",
                        "reps"}
    assert rec["backend"] == "cpu" and rec["matmul_gflops"] > 0
    assert tcal.host_calibration() == rec  # measured once a process
