"""PyTorch port, fault injection vs the JAX package (CPU).

* ``parse_plan`` gives the JAX function's faults on every clause of the
  JAX package's own grammar tests (tests/test_runtime.py,
  tests/test_fleet.py) and raises on every malformed one, as JAX's does;
* ``split_fleet_plan`` partitions as JAX's and refuses what JAX's refuses;
* ``FaultInjector.fire`` makes JAX's decisions over the same call
  sequences (occurrence counts, segment triggers, start and boundary
  points, one fire each), and ``corrupt`` flips the same bit;
* ``activate`` takes the serve daemon's ``serve`` site (tick starts, and
  the request boundary a ``kill@serve:segN`` matches);
* ``delay`` sleeps inside a ``fault.delay`` span.
"""

import os

import pytest

from tsne_flink_tpu.runtime import faults as jfaults
from tsne_flink_tpu_torch.obs import trace as ttrace
from tsne_flink_tpu_torch.runtime import faults as tfaults

pytestmark = pytest.mark.fast

GOOD = ["oom@knn:1, kill@optimize:seg2,corrupt@checkpoint,nan@optimize:seg1",
        "delay@knn,kill@job:1,oom@optimize:seg2", "oom@affinities",
        "hang@serve", "nan@optimize:3", "oom@job:4, delay@job:0", "",
        " , oom@knn ,"]
BAD = ["boom@knn", "oom@nowhere", "oom-knn", "oom@knn:segx", "oom@knn:x",
       "corrupt@job:1", "kill@job:seg1", "delay@nowhere", "@knn",
       "oom@", "oom@knn:-1"]


def _triples(fs):
    return [(f.kind, f.site, f.trigger, f.fired) for f in fs]


@pytest.fixture(autouse=True)
def no_plan():
    tfaults.activate(None)
    yield
    tfaults.activate(None)


def test_tables_match_jax():
    assert tfaults.KINDS == jfaults.KINDS and tfaults.SITES == jfaults.SITES
    assert tfaults.POINT_FOR_KIND == jfaults.POINT_FOR_KIND
    assert tfaults.FLEET_KIND_PLAN == jfaults.FLEET_KIND_PLAN


@pytest.mark.parametrize("spec", GOOD)
def test_parse_plan_matches_jax(spec):
    assert _triples(tfaults.parse_plan(spec)) == _triples(
        jfaults.parse_plan(spec))


@pytest.mark.parametrize("spec", BAD)
def test_parse_plan_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as want:
        jfaults.parse_plan(spec)
    with pytest.raises(ValueError) as got:
        tfaults.parse_plan(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["kill@job:1,delay@job:0,oom@job:1",
                                  "nan@job:2", "", "oom@knn:1"])
def test_split_fleet_plan_matches_jax(spec):
    try:
        want = {i: _triples(fs) for i, fs in
                jfaults.split_fleet_plan(spec).items()}
    except ValueError as e:
        with pytest.raises(ValueError, match="site 'job'"):
            tfaults.split_fleet_plan(spec)
        assert "site 'job'" in str(e)
        return
    got = {i: _triples(fs) for i, fs in
           tfaults.split_fleet_plan(spec).items()}
    assert got == want


#: call sequences: (site, seg, point) tuples fired in order
SEQUENCES = [
    ("oom@knn:2", [("knn", None, "start")] * 3),
    ("nan@optimize:seg2", [("optimize", s, "start") for s in (1, 2, 2, 3)]),
    ("kill@optimize:seg1,nan@optimize:1",
     [("optimize", 1, "start"), ("optimize", 2, "start")]),
    ("oom@affinities,oom@knn:2,nan@optimize:seg1",
     [("knn", None, "start"), ("affinities", None, "start"),
      ("knn", None, "start"), ("optimize", 1, "start"),
      ("optimize", 1, "boundary")]),
    # the serve daemon's site: tick starts count, request boundaries carry
    # the requests served so far
    ("oom@serve:2,kill@serve:seg3",
     [("serve", None, "start"), ("serve", 0, "boundary"),
      ("serve", 1, "boundary"), ("serve", None, "start")]),
]


def _run(mod, spec, calls):
    inj = mod.FaultInjector(mod.parse_plan(spec))
    out = []
    # (no sequence fires a kill: it would end the test process)
    for site, seg, point in calls:
        try:
            f = inj.fire(site, seg=seg, point=point)
            out.append(None if f is None else (f.kind, f.trigger))
        except RuntimeError as e:
            out.append(("raised", type(e).__name__, getattr(e, "site", None)))
    return out, list(inj.log), dict(inj.counts)


@pytest.mark.parametrize("spec,calls", SEQUENCES,
                         ids=[s for s, _ in SEQUENCES])
def test_injector_decisions_match_jax(spec, calls):
    got = _run(tfaults, spec, calls)
    want = _run(jfaults, spec, calls)
    assert got == want


def test_injected_oom_is_an_oom_on_both():
    from tsne_flink_tpu.runtime.supervisor import is_oom as j_is_oom
    from tsne_flink_tpu_torch.runtime.supervisor import is_oom
    e = tfaults.InjectedOom("knn")
    assert is_oom(e) and j_is_oom(e) and e.site == "knn"


def test_corrupt_flips_the_same_bit_as_jax(tmp_path):
    payload = bytes(range(256)) * 3
    paths = []
    for name, mod in (("t", tfaults), ("j", jfaults)):
        p = tmp_path / name
        p.write_bytes(payload)
        inj = mod.FaultInjector(mod.parse_plan("corrupt@checkpoint"))
        inj.fire("checkpoint", path=str(p), point="boundary")
        paths.append(p.read_bytes())
    assert paths[0] == paths[1] != payload
    assert sum(a != b for a, b in zip(paths[0], payload)) == 1


def test_activate_takes_the_serve_site():
    inj = tfaults.activate("oom@knn,hang@serve:2,kill@serve:seg0")
    assert tfaults.injector() is inj
    assert _triples(inj.faults) == _triples(
        jfaults.parse_plan("oom@knn,hang@serve:2,kill@serve:seg0"))
    # a kill waits for its boundary: tick starts never fire it
    assert inj.fire("serve") is None and not inj.log
    inj = tfaults.activate("oom@knn")
    assert tfaults.injector() is inj
    assert tfaults.activate(None) is None and tfaults.injector() is None


def test_delay_sleeps_in_a_span(monkeypatch):
    monkeypatch.setattr(tfaults, "DELAY_S", 0.01)
    inj = tfaults.FaultInjector(tfaults.parse_plan("delay@knn"))
    i0 = ttrace.event_count()
    with ttrace.collecting():
        assert inj.fire("knn") is None
        assert inj.fire("knn") is None  # fires once
    evs = [e for e in ttrace.events_since(i0) if e["name"] == "fault.delay"]
    assert len(evs) == 1 and evs[0]["dur"] >= 0.01
    assert evs[0]["args"] == {"site": "knn", "seconds": 0.01}
    assert inj.log == [("delay", "knn", "1")]


def test_kill_ends_the_process_at_the_boundary(tmp_path):
    """kill@optimize:seg1 SIGKILLs at the boundary point, never at the
    segment's start."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tsne_flink_tpu_torch.runtime import faults\n"
            "inj = faults.FaultInjector(faults.parse_plan("
            "'kill@optimize:seg1'))\n"
            "inj.fire('optimize', seg=1, point='start')\n"
            "print('started', flush=True)\n"
            "inj.fire('optimize', seg=1, point='boundary')\n"
            "print('survived')\n") % os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert got.returncode == -9
    assert "started" in got.stdout and "survived" not in got.stdout
