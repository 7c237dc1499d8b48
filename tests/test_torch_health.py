"""PyTorch port, the divergence sentinel and telemetry vs the JAX package
(f64, CPU).

* ``_telemetry_row`` agrees with the JAX function to ±1e-9, from a grad
  (the unfused step) and from per-row ‖grad‖² (the fused step), with and
  without a validity mask;
* telemetry and the sentinel on leave y's bits as they are with them
  off, on the fused CSR step and the unfused rows step, and return the
  JAX function's tuple (telemetry trace ±1e-9, the flag);
* the segment runner on a segment forced non-finite: rolled back to the
  segment-start state, eta halved each time and kept, the momentum
  buffer zeroed, the gains kept, the autopilot collapsed, events equal
  to the JAX package's ``rollback_event`` dicts, and ``DivergenceError``
  after 3 retries; a run that recovers continues at the halved eta;
* the estimator's segmented path sets ``runtime_events_`` and
  ``metrics_``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.runtime import health as jhealth
from tsne_flink_tpu.utils.artifacts import prepare as jax_prepare
from tsne_flink_tpu_torch import TSNE, convert
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.runtime import health as thealth
from tsne_flink_tpu_torch.runtime import segments

pytestmark = pytest.mark.fast

N, K, PERPLEXITY = 400, 8, 8.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: contending intra-op pools of parallel test workers
    slow them down, so torch runs one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n=N, clusters=8, seed=1, d=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (clusters, d))
    return centers[rng.integers(0, clusters, n)] + rng.normal(0.0, 0.5,
                                                              (n, d))


@pytest.fixture(scope="module")
def prep():
    return jax_prepare(jnp.asarray(_blobs()), neighbors=K,
                       knn_method="bruteforce", perplexity=PERPLEXITY)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_telemetry_row_matches_jax(masked, fused):
    rng = np.random.default_rng(3)
    y = rng.standard_normal((50, 2)) * 4.0
    g = 0.5 + rng.random((50, 2))
    grad = rng.standard_normal((50, 2))
    valid = np.arange(50) < 43 if masked else None
    if valid is not None:
        grad = grad * valid[:, None]
    gsq = (grad * grad).sum(axis=1) if fused else None
    st_j = jtsne.TsneState(jnp.asarray(y), jnp.zeros_like(y), jnp.asarray(g))
    want = jtsne._telemetry_row(
        st_j, None if fused else jnp.asarray(grad), None,
        None if valid is None else jnp.asarray(valid),
        gsq=None if gsq is None else jnp.asarray(gsq))
    st_t = convert.state_from_numpy(y, None, g, device="cpu")
    got = ttsne._telemetry_row(
        st_t, None if fused else torch.from_numpy(grad),
        None if valid is None else torch.from_numpy(valid),
        gsq=None if gsq is None else torch.from_numpy(gsq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)
    assert ttsne.TELEMETRY_FIELDS == jtsne.TELEMETRY_FIELDS


@pytest.mark.parametrize("layout", ["csr", "rows"])
def test_telemetry_and_health_keep_the_bits(prep, layout):
    cfg = jtsne.TsneConfig(perplexity=PERPLEXITY, iterations=60,
                           row_chunk=64, attraction=layout)
    tcfg = convert.config_from_jax(cfg)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    edges, csr = ttsne._plan_layout(jidx, jval, tcfg)
    assert (csr is not None) == (layout == "csr")
    rng = np.random.default_rng(5)
    y0 = rng.standard_normal((N, 2)) * 3.0
    st = convert.state_from_numpy(y0, device="cpu")
    off = ttsne.optimize(st, jidx, jval, tcfg, edges=edges, csr=csr,
                         start_iter=120)
    on = ttsne.optimize(st, jidx, jval, tcfg, edges=edges, csr=csr,
                        start_iter=120, with_telemetry=True,
                        with_health=True)
    assert len(on) == 4 and bool(on[3]) and on[3].dtype == torch.bool
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    assert torch.equal(off[1], on[1])
    # and the trace is the JAX function's
    jedges, jcsr = jtsne._plan_layout(prep.jidx, prep.jval, cfg)
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, with_telemetry=True,
                          with_health=True))
    jout = run(jtsne.TsneState(jnp.asarray(y0), jnp.zeros((N, 2)),
                               jnp.ones((N, 2))), prep.jidx, prep.jval,
               edges=jedges, csr=jcsr, start_iter=120)
    np.testing.assert_allclose(on[2].numpy(), np.asarray(jout[2]),
                               rtol=1e-9, atol=1e-9)
    assert bool(jout[3])


class _Poison:
    """``optimize`` whose first ``bad`` calls come back non-finite (the
    JAX package's fault hooks are ROADMAP queue A15); records the states
    and learning rates it is called with."""

    def __init__(self, bad):
        self.bad = bad
        self.calls = []
        self.real = ttsne.optimize

    def __call__(self, state, jidx, jval, cfg, **kw):
        self.calls.append((state, cfg.learning_rate, kw["start_iter"]))
        out = list(self.real(state, jidx, jval, cfg, **kw))
        if len(self.calls) <= self.bad:
            st = out[0]
            out[0] = st._replace(y=st.y.clone().fill_(float("nan")))
            out[-1] = torch.zeros((), dtype=torch.bool)
        return tuple(out)


def _segment_problem(prep):
    cfg = ttsne.TsneConfig(perplexity=PERPLEXITY, iterations=60,
                           learning_rate=200.0, autopilot=True)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    rng = np.random.default_rng(6)
    st = convert.state_from_numpy(rng.standard_normal((N, 2)),
                                  rng.standard_normal((N, 2)) * 0.1,
                                  1.0 + rng.random((N, 2)), device="cpu")
    return cfg, jidx, jval, st


def test_rollback_halves_eta_and_recovers(prep, monkeypatch):
    cfg, jidx, jval, st = _segment_problem(prep)
    poison = _Poison(bad=2)
    monkeypatch.setattr(segments.tsne, "optimize", poison)
    events = []
    run = segments.run_segments(st, jidx, jval, cfg, every=20,
                                health_check=True, events=events,
                                telemetry=True)
    # segment [0, 20) twice poisoned, then it and the rest run at eta/4
    assert [c[1] for c in poison.calls] == [200.0, 100.0, 50.0, 50.0, 50.0]
    assert [c[2] for c in poison.calls] == [0, 0, 0, 20, 40]
    first, retry = poison.calls[0][0], poison.calls[1][0]
    assert torch.equal(retry.y, first.y) and torch.equal(retry.gains,
                                                         first.gains)
    assert not retry.update.any() and first.update.any()
    want = [jhealth.rollback_event(segment_start=0, step=20, eta_before=200.0,
                                   eta_after=100.0, retries_left=2),
            jhealth.rollback_event(segment_start=0, step=20, eta_before=100.0,
                                   eta_after=50.0, retries_left=1)]
    assert events == want
    assert run.cfg.learning_rate == 50.0
    assert torch.isfinite(run.state.y).all()
    assert torch.isfinite(run.telemetry).all()
    assert run.pilot is not None


def test_divergence_error_after_three_retries(prep, monkeypatch):
    cfg, jidx, jval, st = _segment_problem(prep)
    poison = _Poison(bad=100)
    monkeypatch.setattr(segments.tsne, "optimize", poison)
    events = []
    with pytest.raises(thealth.DivergenceError, match="3 sentinel retries"):
        segments.run_segments(st, jidx, jval, cfg, start_iter=20, every=20,
                              health_check=True, events=events)
    assert len(poison.calls) == 4 and len(events) == 3
    assert [e["eta_after"] for e in events] == [100.0, 50.0, 25.0]
    assert [e["retries_left"] for e in events] == [2, 1, 0]
    assert all(e["segment_start"] == 20 for e in events)
    # the sentinel's reset of the autopilot: level and history cleared
    from tsne_flink_tpu_torch.models.autopilot import pilot_collapse
    p = pilot_collapse(torch.tensor([3.0, 0.5, 12.0]))
    assert p.tolist() == [0.0, 0.0, 12.0]


def test_health_policy_matches_jax():
    cfg = ttsne.TsneConfig(learning_rate=300.0)
    assert thealth.halved_eta(cfg).learning_rate == \
        jhealth.halved_eta(jtsne.TsneConfig(learning_rate=300.0)
                           ).learning_rate
    st = convert.state_from_numpy(np.ones((4, 2)), np.ones((4, 2)),
                                  device="cpu")
    fresh = thealth.fresh_momentum(st)
    assert not fresh.update.any() and torch.equal(fresh.gains, st.gains)
    kw = dict(segment_start=40, step=10, eta_before=8.0, eta_after=4.0,
              retries_left=1)
    assert thealth.rollback_event(**kw) == jhealth.rollback_event(**kw)
    assert str(thealth.DivergenceError(40, 3)) == str(
        jhealth.DivergenceError(40, 3))


def test_estimator_segmented_path():
    x = _blobs(200, seed=4).astype(np.float32)
    est = TSNE(perplexity=8.0, n_iter=60, autopilot=True, health_check=True,
               telemetry=True, device="cpu").fit(x)
    assert est.runtime_events_ == []
    assert est.metrics_["telemetry"]["fields"] == list(ttsne.TELEMETRY_FIELDS)
    assert np.isfinite(est.metrics_["telemetry"]["trace"]).all()
    assert est.metrics_["policy"]["autopilot"]
    assert np.isfinite(est.embedding_).all()
    plain = TSNE(perplexity=8.0, n_iter=60, device="cpu").fit(x)
    # the fast path: the obs snapshot (ROADMAP A15), no loop extras, and
    # the supervisor's empty record
    assert set(plain.metrics_) == {"schema", "counters", "gauges",
                                   "histograms"}
    assert plain.runtime_events_ == [] and plain.degradations_ == []
    # the sentinel and telemetry alone keep tsne_embed's bits (no stride)
    est = TSNE(perplexity=8.0, n_iter=60, health_check=True, telemetry=True,
               device="cpu").fit(x)
    assert np.array_equal(est.embedding_, plain.embedding_)
    assert "policy" not in est.metrics_
