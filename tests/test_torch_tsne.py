"""PyTorch port, the optimizer and the whole slice vs the JAX package (f64).

* one ``optimize`` iteration from an injected state: ±1e-9 on y, update
  and gains (the golden bar for one full iteration), at the first
  iteration and at a KL-report iteration past the exaggeration phase;
* the slice end to end on the 600-point / 12-cluster problem of
  tests/data/mesh_reduce_ab.json: the port's ``prepare`` gives the JAX
  package's joint P, and ``tsne_embed`` started from the JAX init
  (``torch.Generator`` cannot reproduce ``jax.random``) tracks the JAX
  ``tsne_embed`` loss trace to rtol 1e-6 while that trajectory is
  reproducible at all, and ends within ``KL_GUARDRAIL_TOL`` of its final
  KL.
"""

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu.utils.artifacts import prepare as jax_prepare
from tsne_flink_tpu_torch import convert
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.utils.artifacts import prepare as torch_prepare

pytestmark = pytest.mark.fast

SPEC = {"n": 600, "clusters": 12, "k": 8, "perplexity": 8.0, "seed": 0,
        "iterations": 300, "row_chunk": 64}


def _blobs(n, clusters, seed):
    rng = np.random.default_rng(seed)
    per = n // clusters
    centers = rng.normal(0.0, 10.0, (clusters, 8))
    return np.concatenate([rng.normal(c, 0.5, (per, 8)) for c in centers])


@pytest.fixture(scope="module")
def problem():
    x = _blobs(SPEC["n"], SPEC["clusters"], SPEC["seed"])
    cfg = jtsne.TsneConfig(perplexity=SPEC["perplexity"],
                           iterations=SPEC["iterations"],
                           row_chunk=SPEC["row_chunk"], attraction="csr")
    prep = jax_prepare(jnp.asarray(x), neighbors=SPEC["k"],
                       knn_method="bruteforce", perplexity=cfg.perplexity)
    return x, cfg, prep


def test_config_fields_and_defaults_match():
    assert convert.config_from_jax(jtsne.TsneConfig()) == ttsne.TsneConfig()
    cfg = ttsne.TsneConfig(iterations=95)
    assert (cfg.momentum_switch, cfg.exaggeration_end, cfg.n_loss_slots) \
        == (20, 95, 9)
    assert [ttsne.loss_slot(i, 9) for i in (9, 19, 89, 94)] == [0, 1, 8, 8]


def test_update_and_center_match_jax():
    rng = np.random.default_rng(5)
    y, upd, grad = (rng.standard_normal((40, 2)) for _ in range(3))
    gains = 1.0 + rng.random((40, 2))
    cfg = jtsne.TsneConfig()
    js = jtsne._update_embedding(jtsne.TsneState(*map(jnp.asarray,
                                                      (y, upd, gains))),
                                 jnp.asarray(grad), 0.8, cfg)
    ts = ttsne._update_embedding(convert.state_from_numpy(
        y, upd, gains, device="cpu"), torch.from_numpy(grad), 0.8,
        convert.config_from_jax(cfg))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)
    valid = np.arange(40) < 33
    jc = jtsne._center(js, valid=jnp.asarray(valid))
    tc = ttsne._center(ts, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(tc.y.numpy(), np.asarray(jc.y), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("start,scale", [(0, 1e-4), (149, 5.0)])
def test_one_iteration_matches_jax(problem, start, scale):
    x, cfg, prep = problem
    rng = np.random.default_rng(11)
    n = SPEC["n"]
    y0 = rng.standard_normal((n, 2)) * scale
    upd0 = rng.standard_normal((n, 2)) * scale * 1e-2
    g0 = 1.0 + rng.random((n, 2))
    _, jcsr = jtsne._plan_layout(prep.jidx, prep.jval, cfg)
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, num_iters=1))
    jst, jloss = run(jtsne.TsneState(*map(jnp.asarray, (y0, upd0, g0))),
                     prep.jidx, prep.jval, csr=jcsr, start_iter=start)
    tcfg = convert.config_from_jax(cfg)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    _, tcsr = ttsne._plan_layout(jidx, jval, tcfg)
    tst, tloss = ttsne.optimize(
        convert.state_from_numpy(y0, upd0, g0, device="cpu"), jidx, jval,
        tcfg, csr=tcsr, start_iter=start, num_iters=1)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-9,
                               atol=1e-12)
    if start == 149:
        assert tloss[14] > 0


def test_prepare_matches_jax(problem):
    x, cfg, prep = problem
    tp = torch_prepare(torch.from_numpy(x), neighbors=SPEC["k"],
                       perplexity=cfg.perplexity, device="cpu")
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(prep.idx))
    np.testing.assert_allclose(tp.dist.numpy(), np.asarray(prep.dist),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tp.jidx.numpy(), np.asarray(prep.jidx))
    np.testing.assert_allclose(tp.jval.numpy(), np.asarray(prep.jval),
                               rtol=0, atol=1e-12)
    assert tp.label == prep.label == "split-rows"


def test_slice_end_to_end_matches_jax(problem):
    x, cfg, prep = problem
    y_j, loss_j = jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=SPEC["k"],
                                   seed=SPEC["seed"])
    loss_j = np.asarray(loss_j)
    # tsne_embed's own init draw: key(seed) -> split -> the second key
    _, ikey = jax.random.split(jax.random.key(SPEC["seed"]))
    y0 = np.asarray(jtsne.init_working_set(ikey, SPEC["n"], 2,
                                           jnp.float64).y)
    stats = {}
    y_t, loss_t = ttsne.tsne_embed(x, convert.config_from_jax(cfg),
                                   neighbors=SPEC["k"], device="cpu", y0=y0,
                                   stats=stats)
    loss_t = loss_t.numpy()
    # The early-exaggeration trajectory is chaotic: the JAX package does
    # not reproduce its own trace past iteration ~50 when its init moves
    # by one part in 1e15 (and any change of summation order moves it by
    # as much).  The port is held to rtol 1e-6 over the window in which
    # the JAX package reproduces itself to 1e-7 under that perturbation —
    # checked here — and to the KL guardrail at the end.
    window = 4  # slots 0-3: iterations 10-40
    rng = np.random.default_rng(1)
    yp = jnp.asarray(y0 * (1.0 + 1e-15 * rng.standard_normal(y0.shape)))
    _, csr = jtsne._plan_layout(prep.jidx, prep.jval, cfg)
    st = jtsne.TsneState(yp, jnp.zeros_like(yp), jnp.ones_like(yp))
    loss_p = np.asarray(jax.jit(partial(jtsne.optimize, cfg=cfg))(
        st, prep.jidx, prep.jval, csr=csr)[1])
    np.testing.assert_allclose(loss_p[:window], loss_j[:window], rtol=1e-7)
    np.testing.assert_allclose(loss_t[:window], loss_j[:window], rtol=1e-6)
    assert abs(loss_t[-1] - loss_j[-1]) <= KL_GUARDRAIL_TOL
    assert abs(loss_p[-1] - loss_j[-1]) <= KL_GUARDRAIL_TOL
    assert y_t.shape == (SPEC["n"], 2) and torch.isfinite(y_t).all()
    assert set(stats) == {"knn", "affinities", "plan", "optimize"}


def test_unported_branches_raise(problem):
    x, cfg, prep = problem
    tcfg = convert.config_from_jax(cfg)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    _, csr = ttsne._plan_layout(jidx, jval, tcfg)
    st = convert.state_from_numpy(np.zeros((SPEC["n"], 2)), device="cpu")
    cases = [({"csr": None}, tcfg, "A6"),
             ({"fused_step": False}, tcfg, "A6"),
             ({"with_health": True}, tcfg, "A10"),
             ({"axis_name": "x"}, tcfg, "A14"),
             ({}, replace(tcfg, repulsion="fft"), "A8"),
             ({}, replace(tcfg, repulsion="bh"), "A12"),
             ({}, replace(tcfg, autopilot=True), "A10")]
    for kw, c, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            ttsne.optimize(st, jidx, jval, c, **{"csr": csr, **kw},
                           num_iters=1)
    with pytest.raises(NotImplementedError, match="A6"):
        ttsne._plan_layout(jidx, jval, replace(tcfg, attraction="rows"))
