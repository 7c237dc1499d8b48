"""PyTorch port, kernels B5 and B4 over a row block and a ragged edge part
vs the JAX package (f64).

B5 and B4 take the whole attraction pass of a layout in one call: the row
block (the CSR head, the blocks layout's forward block, the padded rows;
none for the flat edge list) and the ragged part (``Ragged``: the CSR
tail, the blocks layout's reverse edges, the flat edge list), added as
forward + ragged.  On the CPU their plain versions are the arithmetic the
optimize loop ran before (the row block's plain kernel + the edge list's
sorted segment sum), so they meet the JAX package's layout functions
(``models/tsne._attraction_forces`` / ``_attraction_loss``) at the golden
bar, and one optimize iteration over each layout goes through them.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.ops import affinities as jaff
from tsne_flink_tpu.utils.artifacts import prepare as jax_prepare
from tsne_flink_tpu_torch import convert
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.ops import attraction_cuda as tatt

pytestmark = pytest.mark.fast

N, K, PERPLEXITY = 400, 10, 8.0


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    centers = rng.normal(0.0, 10.0, (8, 6))
    x = centers[rng.integers(0, 8, N)] + rng.normal(0.0, 0.5, (N, 6))
    cfg = jtsne.TsneConfig(perplexity=PERPLEXITY, iterations=300,
                           row_chunk=64, attraction="csr")
    prep = jax_prepare(jnp.asarray(x), neighbors=K,
                       knn_method="bruteforce", perplexity=PERPLEXITY)
    return cfg, prep


def _layout(layout, prep, cfg):
    """(JAX keywords, JAX rows, the port's row block and edge list) of one
    layout, from the same arrays; edge lists keep their padding."""
    jidx, jval = prep.jidx, prep.jval
    if layout == "edges":
        e = jaff.assemble_edges(jidx, jval, jaff.edge_count(jval))
        return (dict(edges=e), (jidx, jval), (None, None),
                convert.edges_from_numpy(*e, device="cpu"))
    if layout == "blocks":
        bidx, bval, extra = jaff.affinity_blocks(prep.idx, prep.dist,
                                                 cfg.perplexity)
        *rows, edges = convert.blocks_from_numpy(bidx, bval, extra,
                                                 device="cpu")
        return (dict(edges=extra, edges_extra=True), (bidx, bval),
                tuple(rows), edges)
    _, csr = jtsne._plan_layout(jidx, jval, cfg)
    tcsr = convert.csr_from_numpy(csr[:2], csr[2:], device="cpu")
    return dict(csr=csr), (jidx, jval), tcsr[:2], tcsr[2:]


def _y(seed, scale=5.0):
    return np.random.default_rng(seed).standard_normal((N, 2)) * scale


@pytest.mark.parametrize("layout", ["blocks", "edges", "csr"])
def test_one_call_over_both_parts_matches_jax(problem, layout):
    """B5's and B4's plain versions over a layout's row block + its edge
    list (padding included) against the JAX layout functions, f64, at
    ±1e-12."""
    cfg, prep = problem
    jkw, (jidx, jval), (fidx, fval), edges = _layout(layout, prep, cfg)
    y = _y(1)
    yt = torch.from_numpy(y)
    rag = tatt.ragged_edges(*edges, N)
    want = jtsne._attraction_forces(jnp.asarray(y), jnp.asarray(y), jidx,
                                    jval, cfg, 4.0, **jkw)
    got = tatt.attraction_forces(yt, yt, fidx, fval, 4.0, ragged=rag,
                                 row_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    z = 3.7e4
    want = jtsne._attraction_loss(jnp.asarray(y), jnp.asarray(y), jidx, jval,
                                  cfg, 1.0, z, **jkw)
    got = tatt.attraction_loss(yt, yt, fidx, fval, 1.0, torch.tensor(z),
                               ragged=rag, row_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("layout", ["blocks", "edges", "csr"])
def test_one_iteration_runs_through_the_one_call(problem, layout,
                                                 monkeypatch):
    """One f64 optimize iteration at a KL-report iteration: every force
    and KL call carries the layout's edge list as its ragged part (none
    goes to a segment sum of its own), and y, update, gains and the KL
    meet the JAX package's at ±1e-9 (the golden bar)."""
    cfg, prep = problem
    jkw, (jidx, jval), _, _ = _layout(layout, prep, cfg)
    y0 = _y(2)
    rng = np.random.default_rng(3)
    upd0 = rng.standard_normal((N, 2)) * 5e-2
    g0 = 1.0 + rng.random((N, 2))
    statics = {k: jkw.pop(k) for k in ("edges_extra",) if k in jkw}
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, num_iters=1, **statics))
    jst, jloss = run(jtsne.TsneState(*map(jnp.asarray, (y0, upd0, g0))),
                     jidx, jval, start_iter=149, **jkw)
    calls = []
    for name in ("attraction_forces", "attraction_loss",
                 "fused_step_update"):
        real = getattr(tatt, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("ragged") is not None))
            return _real(*a, **kw)
        monkeypatch.setattr(tatt, name, spy)
    for name in ("edge_forces_plain", "edge_loss_plain"):
        real = getattr(tatt, name)

        def count(*a, _real=real, _name=name, **kw):
            calls.append((_name, None))
            return _real(*a, **kw)
        monkeypatch.setattr(tatt, name, count)
    _, _, (tidx, tval), tedges = _layout(layout, prep, cfg)
    tkw = ({"csr": (tidx, tval) + tuple(tedges)} if layout == "csr" else
           {"edges": tedges, "edges_extra": layout == "blocks"})
    rows = ((tidx, tval) if layout == "blocks" else
            convert.rows_from_numpy(jidx, jval, device="cpu"))
    tst, tloss = ttsne.optimize(
        convert.state_from_numpy(y0, upd0, g0, device="cpu"), *rows,
        convert.config_from_jax(cfg), start_iter=149, num_iters=1, **tkw)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-9,
                               atol=1e-12)
    assert tloss[14] > 0
    # one forces call (on the CSR layout the fused step, which takes the
    # tail itself) and one KL call, each with the edge list, whose plain
    # sums run inside them only
    step = "fused_step_update" if layout == "csr" else "attraction_forces"
    assert sorted(calls) == sorted([(step, True),
                                    ("attraction_loss", True),
                                    ("edge_forces_plain", None),
                                    ("edge_loss_plain", None)])


def test_ragged_edges_row_pointer():
    """rowptr is the exclusive prefix of each row's edge count, rows with
    no edges included; src is kept for the plain segment sums."""
    src = torch.tensor([0, 0, 2, 2, 2, 4], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, 1, 3, 0], dtype=torch.int32)
    val = torch.ones(6)
    r = tatt.ragged_edges(src, dst, val, 6)
    assert r.rowptr.dtype == torch.int64
    assert r.rowptr.tolist() == [0, 2, 2, 5, 5, 6, 6]
    assert r.src is src and r.dst is dst and r.val is val


def test_a_call_is_its_parts_added():
    """The one call's plain version: the row block's forces + the edge
    list's, in that grouping; with no row block (None or W = 0) the edge
    list's alone, and with no edge list the row block's alone — the
    arithmetic optimize ran before, bit for bit."""
    rng = np.random.default_rng(5)
    n, w = 90, 7
    y = torch.from_numpy(rng.standard_normal((n, 2)))
    jidx = torch.from_numpy(rng.integers(0, n, (n, w)).astype(np.int32))
    jval = torch.from_numpy(rng.random((n, w)) * (rng.random((n, w)) > .2))
    src = torch.from_numpy(np.sort(rng.integers(0, n, 300)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, 300).astype(np.int32))
    val = torch.from_numpy(rng.random(300))
    rag = tatt.ragged_edges(src, dst, val, n)
    fwd = tatt.attraction_forces(y, y, jidx, jval, 4.0)
    edge = tatt.edge_forces_plain(y, y, src, dst, val, 4.0)
    assert torch.equal(tatt.attraction_forces(y, y, jidx, jval, 4.0,
                                              ragged=rag), fwd + edge)
    for none in ((None, None), (jidx[:, :0], jval[:, :0])):
        assert torch.equal(tatt.attraction_forces(y, y, *none, 4.0,
                                                  ragged=rag), edge)
    z = torch.tensor(10.0)
    lf = tatt.attraction_loss(y, y, jidx, jval, 1.0, z)
    le = tatt.edge_loss_plain(y, y, src, dst, val, 1.0, z)
    assert torch.equal(tatt.attraction_loss(y, y, jidx, jval, 1.0, z,
                                            ragged=rag), lf + le)
    assert torch.equal(tatt.attraction_loss(y, y, None, None, 1.0, z,
                                            ragged=rag), le)
