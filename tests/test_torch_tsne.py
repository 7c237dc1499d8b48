"""PyTorch port, the optimizer and the whole slice vs the JAX package (f64).

* one ``optimize`` iteration from an injected state: ±1e-9 on y, update
  and gains (the golden bar for one full iteration), at the first
  iteration and at a KL-report iteration past the exaggeration phase —
  for the fused CSR step and for the unfused step over the rows, edges,
  blocks and CSR layouts; inside the port, fused CSR == unfused CSR bit
  for bit;
* the slice end to end on the 600-point / 12-cluster problem of
  tests/data/mesh_reduce_ab.json: the port's ``prepare`` gives the JAX
  package's joint P, and ``tsne_embed`` started from the JAX init
  (``torch.Generator`` cannot reproduce ``jax.random``) tracks the JAX
  ``tsne_embed`` loss trace to rtol 1e-6 while that trajectory is
  reproducible at all, and ends within ``KL_GUARDRAIL_TOL`` of its final
  KL; the blocks assembly on the same problem, and the default
  configuration on 600 uniform 2-D points (where ``auto`` picks the rows
  layout), end within ``KL_GUARDRAIL_TOL`` of the JAX run.
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
from tsne_flink_tpu.ops import affinities as jaff
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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The optimize loops here run thousands of small ops.  Test workers
    share the host, and contending intra-op thread pools slow such ops
    by an order of magnitude or more, so torch runs one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    assert set(stats) == {"knn", "affinities", "plan", "optimize",
                          "assembly", "layout", "knn_substages"}
    assert set(stats["knn_substages"]) == {"exact_sweep"}
    assert (stats["assembly"], stats["layout"]) == ("split-rows", "csr")


def _layout_args(layout, prep, cfg):
    """The JAX optimize's layout keywords, the port's (from the same
    arrays), and the matching configs.  ``unfused-csr`` is the CSR layout
    with ``fused_step=False``."""
    jidx, jval = prep.jidx, prep.jval
    t_rows = convert.rows_from_numpy(jidx, jval, device="cpu")
    jkw, tkw = {}, {}
    if layout == "edges":
        e = jaff.assemble_edges(jidx, jval, jaff.edge_count(jval))
        jkw["edges"] = e
        tkw["edges"] = convert.edges_from_numpy(*e, device="cpu")
    elif layout == "blocks":
        jidx, jval, extra = jaff.affinity_blocks(prep.idx, prep.dist,
                                                 cfg.perplexity)
        jkw.update(edges=extra, edges_extra=True)
        *t_rows, edges = convert.blocks_from_numpy(jidx, jval, extra,
                                                   device="cpu")
        tkw.update(edges=edges, edges_extra=True)
    elif layout in ("csr", "unfused-csr"):
        _, csr = jtsne._plan_layout(jidx, jval, cfg)
        jkw["csr"] = csr
        tkw["csr"] = convert.csr_from_numpy(csr[:2], csr[2:], device="cpu")
        if layout == "unfused-csr":
            jkw["fused_step"] = tkw["fused_step"] = False
    return (jidx, jval), jkw, tuple(t_rows), tkw


def _state(start):
    rng = np.random.default_rng(11)
    n = SPEC["n"]
    scale = 1e-4 if start == 0 else 5.0
    return (rng.standard_normal((n, 2)) * scale,
            rng.standard_normal((n, 2)) * scale * 1e-2,
            1.0 + rng.random((n, 2)))


@pytest.mark.parametrize("start", [0, 149])
@pytest.mark.parametrize("layout", ["rows", "edges", "blocks",
                                    "unfused-csr"])
def test_one_unfused_iteration_matches_jax(problem, layout, start):
    """The unfused step (kernel B5's plain version + the edge part +
    grad = att − rep/Z + the vdM update) over each layout."""
    x, cfg, prep = problem
    y0, upd0, g0 = _state(start)
    (jidx, jval), jkw, (tidx, tval), tkw = _layout_args(layout, prep, cfg)
    statics = {k: jkw.pop(k) for k in ("edges_extra", "fused_step")
               if k in jkw}
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, num_iters=1, **statics))
    jst, jloss = run(jtsne.TsneState(*map(jnp.asarray, (y0, upd0, g0))),
                     jidx, jval, start_iter=start, **jkw)
    tst, tloss = ttsne.optimize(
        convert.state_from_numpy(y0, upd0, g0, device="cpu"), tidx, tval,
        convert.config_from_jax(cfg), start_iter=start, num_iters=1, **tkw)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-9,
                               atol=1e-12)
    if start == 149:
        assert tloss[14] > 0


@pytest.mark.parametrize("start", [0, 149])
def test_fused_step_equals_unfused_step(problem, start):
    """Inside the port the fused CSR step and the unfused one (forces +
    tail, grad, vdM update) give the same bits: they share the head math
    and the operand grouping."""
    x, cfg, prep = problem
    y0, upd0, g0 = _state(start)
    _, _, (tidx, tval), tkw = _layout_args("csr", prep, cfg)
    tcfg = convert.config_from_jax(cfg)
    outs = [ttsne.optimize(convert.state_from_numpy(y0, upd0, g0,
                                                    device="cpu"),
                           tidx, tval, tcfg, start_iter=start, num_iters=1,
                           fused_step=fused, **tkw)
            for fused in (None, False)]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])


def test_blocks_end_to_end_matches_jax(problem):
    x, cfg, prep = problem
    y_j, loss_j = jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=SPEC["k"],
                                   seed=SPEC["seed"],
                                   affinity_assembly="blocks")
    _, ikey = jax.random.split(jax.random.key(SPEC["seed"]))
    y0 = np.asarray(jtsne.init_working_set(ikey, SPEC["n"], 2,
                                           jnp.float64).y)
    stats = {}
    y_t, loss_t = ttsne.tsne_embed(x, convert.config_from_jax(cfg),
                                   neighbors=SPEC["k"], device="cpu", y0=y0,
                                   affinity_assembly="blocks", stats=stats)
    assert (stats["assembly"], stats["layout"]) == ("blocks", "blocks")
    assert abs(float(loss_t[-1]) - float(loss_j[-1])) <= KL_GUARDRAIL_TOL
    assert torch.isfinite(y_t).all() and float(loss_t[-1]) > 0


def test_default_config_takes_rows_and_matches_jax():
    """TsneConfig() on 600 uniform 2-D points, k = 8, perplexity 3: a
    low-hubness graph, so ``attraction="auto"`` picks the rows layout in
    both packages, and the port ends within the KL guardrail."""
    rng = np.random.default_rng(0)
    x = rng.random((600, 2))
    cfg = jtsne.TsneConfig(perplexity=3.0)
    prep = jax_prepare(jnp.asarray(x), neighbors=8, knn_method="bruteforce",
                       perplexity=cfg.perplexity)
    tp = torch_prepare(torch.from_numpy(x), neighbors=8,
                       perplexity=cfg.perplexity, device="cpu")
    assert (jaff.plan_attraction(prep.jidx, prep.jval, cfg.attraction)
            == ttsne_plan(tp, cfg) == ("rows", 0))
    y_j, loss_j = jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=8, seed=0)
    _, ikey = jax.random.split(jax.random.key(0))
    y0 = np.asarray(jtsne.init_working_set(ikey, 600, 2, jnp.float64).y)
    stats = {}
    y_t, loss_t = ttsne.tsne_embed(x, convert.config_from_jax(cfg),
                                   neighbors=8, device="cpu", y0=y0,
                                   stats=stats)
    assert (stats["assembly"], stats["layout"]) == ("split-rows", "rows")
    assert abs(float(loss_t[-1]) - float(loss_j[-1])) <= KL_GUARDRAIL_TOL
    assert torch.isfinite(y_t).all() and float(loss_t[-1]) > 0


def ttsne_plan(prep, cfg):
    from tsne_flink_tpu_torch.ops.affinities import plan_attraction
    return plan_attraction(prep.jidx, prep.jval, cfg.attraction)


def test_prepare_assemblies_match_jax(problem):
    """``prepare(assembly=...)``: sorted (default and pinned width),
    split and blocks give the JAX package's P and label."""
    x, cfg, _ = problem
    for assembly, width in (("sorted", None), ("sorted", 64),
                            ("split", None), ("blocks", None)):
        jp = jax_prepare(jnp.asarray(x), neighbors=SPEC["k"],
                         knn_method="bruteforce", perplexity=cfg.perplexity,
                         assembly=assembly, sym_width=width)
        tp = torch_prepare(torch.from_numpy(x), neighbors=SPEC["k"],
                           perplexity=cfg.perplexity, assembly=assembly,
                           sym_width=width, device="cpu")
        assert tp.label == jp.label
        np.testing.assert_array_equal(tp.jidx.numpy(), np.asarray(jp.jidx))
        np.testing.assert_allclose(tp.jval.numpy(), np.asarray(jp.jval),
                                   rtol=0, atol=1e-12)
        assert (tp.extra_edges is None) == (jp.extra_edges is None)
    with pytest.raises(ValueError, match="not defined"):
        torch_prepare(torch.from_numpy(x), neighbors=SPEC["k"],
                      perplexity=cfg.perplexity, assembly="rows",
                      device="cpu")


def test_unported_branches_raise(problem):
    """``optimize`` refuses no branch: a mesh axis (A14a) runs it as one
    shard's program, and the branches of A10 and A12 run and return the
    JAX function's tuple."""
    from tsne_flink_tpu_torch.parallel.mesh import run_shards
    x, cfg, prep = problem
    tcfg = convert.config_from_jax(cfg)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    _, csr = ttsne._plan_layout(jidx, jval, tcfg)
    st = convert.state_from_numpy(np.zeros((SPEC["n"], 2)), device="cpu")
    # a one-shard axis over all rows: the plain loop's bits
    plain = ttsne.optimize(st, jidx, jval, tcfg, csr=csr, num_iters=1)
    meshed, = run_shards(["cpu"], lambda axis: ttsne.optimize(
        st, jidx, jval, tcfg, csr=csr, axis_name=axis, num_iters=1))
    assert len(meshed) == len(plain) == 2
    np.testing.assert_array_equal(meshed[0].y.numpy(), plain[0].y.numpy())
    np.testing.assert_array_equal(meshed[1].numpy(), plain[1].numpy())
    cases = [({"with_telemetry": True}, tcfg, 3),
             ({}, replace(tcfg, repulsion_stride=2), 2),
             ({"with_health": True}, tcfg, 3),
             ({}, replace(tcfg, repulsion="bh"), 2),
             ({}, replace(tcfg, autopilot=True), 3)]
    for kw, c, width in cases:
        out = ttsne.optimize(st, jidx, jval, c, **{"csr": csr, **kw},
                             num_iters=1)
        assert len(out) == width
    # the rows layout under the autopilot, as the landmark schedule runs it
    out = ttsne.optimize(st, jidx, jval, replace(tcfg, autopilot=True),
                         num_iters=1)
    assert len(out) == 3 and out[2][0].shape == (3,)
