"""PyTorch port, features past 12,288 on a refining project plan, vs the
JAX package (f64, CPU).

B6 keeps the chunk row's vector in shared memory up to 12,288 features
(``ops/knn_cuda.STAGED_F_MAX``); past it the card launches B6's unstaged
form (``KERNELS["B6u"]``, ``["B6u_f64"]``), and no width is refused.  The
plain refine stages run at any F, as the JAX package's XLA path does.
Here, on the same seeded numpy inputs:

* one ``knn_refine`` round at d = 12,289 and 20,000 against the JAX
  ``knn_refine`` with its own draws injected, for sqeuclidean, euclidean
  and cosine: ids equal, distances rtol 1e-10;
* ``knn_project_refined`` at d = 12,289 against the JAX function, every
  draw of the plan (the Z-order rounds' and the refine round's) rebuilt
  from its key schedule: the same graph (euclidean ids as sets within
  runs of equal distances: XLA's CPU ``sqrt`` is one ulp off on some
  inputs);
* ``prepare`` and ``tsne_embed`` with ``knn_method="project",
  knn_refine=1`` at d = 12,289: the refine stages reach the wrappers at
  that width, ``prepare`` gives ``knn_project_refined``'s graph, and the
  KL is finite and falls after the exaggeration;
* the sharded prepare on the CPU thread mesh at D = 2 past the old limit,
  bit for bit the mesh of 1;
* the unstaged form's layouts and routes, the registry's and the
  recorder's names for it;
* the card's refine chunk and memory model: cosine's plain exact stage
  keeps its gather past the staged width, and the round's squared norms
  are summed a row block at a time.
"""

import ctypes
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hybrid_knn import (_blobs, _jax_project_draws,
                                   _jax_refine_draw, _t)
from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu.ops import knn_tiles as jtiles
from tsne_flink_tpu_torch.kernels import build as kbuild
from tsne_flink_tpu_torch.models.tsne import TsneConfig, tsne_embed
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_cuda as tkc
from tsne_flink_tpu_torch.ops import knn_tiles as ttiles
from tsne_flink_tpu_torch.utils.artifacts import prepare

pytestmark = pytest.mark.fast

#: the first width past the staged form, and a raw-count-like one
D_PAST = tkc.STAGED_F_MAX + 1
D_WIDE = 20_000
N, K = 200, 12


def _seed_graph(x, metric):
    """One narrow-band Z-order round: a seed graph far from exact."""
    return tknn.knn_project(_t(x), K, metric, 1, block=32)


@pytest.mark.parametrize("d", [D_PAST, D_WIDE])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_refine_round_past_the_staged_width_matches_jax(metric, d):
    x = _blobs(N, d, seed=d % 97)
    fd = jknn.pick_knn_filter(d)
    ke = (K + 1) // 2
    ti0, td0 = _seed_graph(x, metric)
    tiles = replace(jtiles.pick_knn_tiles(N, d, K, "cpu"), kernel="xla",
                    refine_chunk=N)
    key = jax.random.key(d % 89)
    ri, rd = jknn.knn_refine(jnp.asarray(x), jnp.asarray(ti0.numpy()),
                             jnp.asarray(td0.numpy()), metric, rounds=1,
                             key=key, filter_dims=fd, expand_k=ke,
                             tiles=tiles)
    plan = tknn._refine_plan(d, K, filter_dims=fd, expand_k=ke)
    assert plan.cascade_dims is not None  # the exact stage at F = d
    seen = []
    real = tknn.refine_final

    def final(metric_, base, *a, **kw):
        seen.append(base.shape[1])
        return real(metric_, base, *a, **kw)
    tknn.refine_final = final
    try:
        qi, qd = tknn.knn_refine(_t(x), ti0, td0, metric, rounds=1,
                                 filter_dims=fd, expand_k=ke,
                                 draws=[_jax_refine_draw(key, plan, N, K,
                                                         d)])
    finally:
        tknn.refine_final = real
    assert set(seen) == {d}
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(qd.numpy(), np.asarray(rd), rtol=1e-10,
                               atol=1e-12)
    # the round moved the graph: some row's list changed
    assert not torch.equal(qi, ti0)


def _same_up_to_ties(ti, td, ji, jd):
    """Equal distances (rtol 1e-10), and each row's ids equal as sets
    within every run of equal JAX distances."""
    np.testing.assert_allclose(td, jd, rtol=1e-10, atol=1e-12)
    for r in range(ti.shape[0]):
        start = 0
        for j in range(1, ti.shape[1] + 1):
            if j == ti.shape[1] or jd[r, j] != jd[r, start]:
                assert (set(ti[r, start:j].tolist())
                        == set(ji[r, start:j].tolist())), r
                start = j


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_project_refined_past_the_staged_width_matches_jax(monkeypatch,
                                                           metric):
    """The port's ``knn_project_refined`` (2 seed rounds + 1 cycle) at d =
    12,289, its ``draw_project`` / ``draw_refine`` returning the JAX
    plan's draws in the order both plans take them."""
    d, rounds, cycles = D_PAST, 2, 1
    x = _blobs(N, d, seed=3)
    jt = replace(jtiles.pick_knn_tiles(N, d, K, "cpu"), kernel="xla",
                 block=32, refine_chunk=N)
    tt = replace(ttiles.pick_knn_tiles(N, d, K, "cpu"), block=32,
                 refine_chunk=N)
    key = jax.random.key(21)
    ji, jd = jknn.knn_project_refined(jnp.asarray(x), K, metric, rounds,
                                      cycles, key, tiles=jt)
    fd = tknn.pick_knn_filter(d)
    plan = tknn._refine_plan(d, K, filter_dims=fd, expand_k=(K + 1) // 2)
    zpc = tknn.ZORDER_PER_CYCLE
    key, skey = jax.random.split(key)
    proj = _jax_project_draws(skey, rounds, d)
    refines = []
    for cyc in range(cycles):
        key, zkey, rkey = jax.random.split(key, 3)
        proj += _jax_project_draws(zkey, zpc, d,
                                   start_round=rounds + cyc * zpc)
        refines.append(_jax_refine_draw(rkey, plan, N, K, d))
    proj_it, ref_it = iter(proj), iter(refines)
    monkeypatch.setattr(tknn, "draw_project", lambda *a: next(proj_it))
    monkeypatch.setattr(tknn, "draw_refine", lambda *a, **kw: next(ref_it))
    ti, td = tknn.knn_project_refined(_t(x), K, metric, rounds, cycles,
                                      tiles=tt)
    assert next(proj_it, None) is None and next(ref_it, None) is None
    if metric == "euclidean":
        _same_up_to_ties(ti.numpy(), td.numpy(), np.asarray(ji),
                         np.asarray(jd))
    else:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-10,
                                   atol=1e-12)


def _refine_widths(monkeypatch):
    """Record the width of every exact stage's points."""
    seen = []
    real = tknn.refine_final

    def final(metric, base, *a, **kw):
        seen.append(base.shape[1])
        return real(metric, base, *a, **kw)
    monkeypatch.setattr(tknn, "refine_final", final)
    return seen


def test_prepare_and_embed_run_a_refining_plan_past_the_staged_width(
        monkeypatch):
    x = _blobs(N, D_PAST, seed=7)
    seen = _refine_widths(monkeypatch)
    tiles = replace(ttiles.pick_knn_tiles(N, D_PAST, K, "cpu"), block=32)
    prep = prepare(x, neighbors=K, knn_method="project", knn_refine=1,
                   perplexity=4.0, device="cpu", seed=5, knn_tiles=tiles)
    assert set(seen) == {D_PAST}
    from tsne_flink_tpu_torch.models.tsne import knn_generator
    want = tknn.knn_project_refined(
        _t(x), K, "sqeuclidean", tknn.pick_knn_rounds(N), 1,
        knn_generator(5, "cpu"), tiles=tiles)
    assert torch.equal(prep.idx, want[0]) and torch.equal(prep.dist,
                                                          want[1])
    seen.clear()
    y, losses = tsne_embed(x, TsneConfig(perplexity=4.0, iterations=200),
                           neighbors=K, knn_method="project", knn_refine=1,
                           device="cpu")
    assert set(seen) == {D_PAST}
    assert tuple(y.shape) == (N, 2) and bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(losses).all())
    after = losses[TsneConfig(iterations=200).exaggeration_end // 10 + 1:]
    assert float(after[-1]) < float(after[0])


def test_sharded_prepare_past_the_staged_width_equals_mesh_1(monkeypatch):
    """The sharded refine runs past the old limit on the thread mesh, each
    shard's exact stage at the full width: at D = 2 the kNN graph and the
    P ids are D = 1's bit for bit, P's values within 1e-12 (the plain
    exact stage's float64 sums over 12,289 features split by the chunk's
    shape on the CPU; one band block covers every point here)."""
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    n = 301
    x = _blobs(n, D_PAST, seed=9)
    seen = _refine_widths(monkeypatch)
    graphs, preps = [], []
    for d in (1, 2):
        shards = {}
        pipe = SpmdPipeline(TsneConfig(perplexity=4.0), n, D_PAST, K,
                            knn_method="project", knn_refine=1,
                            devices=["cpu"] * d,
                            on_graph=lambda axis, idx, valid: shards.update(
                                {axis.index: idx[valid]}))
        preps.append(pipe.prepare(x, seed=3))
        graphs.append(torch.cat([shards[i] for i in range(d)]))
    assert set(seen) == {D_PAST}
    assert torch.equal(graphs[0], graphs[1])
    assert torch.equal(preps[0][0], preps[1][0])
    torch.testing.assert_close(preps[0][1], preps[1][1], rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [D_PAST, 16_384, 32_738, 32_768])
def test_unstaged_layouts_and_routes(itemsize, d):
    """Past the staged width a stage takes the unstaged form: its layouts
    are the staged form's without the row's F values, and every stage of
    the auto plan runs on chip at k <= 1,024 (the staged form's row alone
    would not fit at F = 32,768 and float64); past it a stage takes the
    route its other arrays need, with the same shared memory there."""
    assert not tkc.refine_staged(d) and tkc.refine_staged(d - 1) == (
        d - 1 <= tkc.STAGED_F_MAX)
    row = (itemsize * d + 15) // 16 * 16
    for k in (1, 12, 90, 150, 300, 1024, 1500, 2048, 4096):
        for f, w, ke, keep, build, final in tknn.refine_stages(d, k):
            staged = tkc.refine_staged(f)
            assert staged == (f != d)
            kw = dict(itemsize=itemsize)
            on = tkc.refine_smem_bytes(f, w, ke, keep, k, build, final,
                                       staged=staged, **kw)
            ws = tkc.refine_ws_layout(f, w, ke, keep, k, build, final,
                                      staged=staged, **kw)
            assert on == tkc.refine_smem_bytes(f, w, ke, keep, k, build,
                                               final, **kw)
            if not staged:
                assert on == tkc.refine_smem_bytes(
                    f, w, ke, keep, k, build, final, staged=True,
                    **kw) - row
                st = tkc.refine_ws_layout(f, w, ke, keep, k, build, final,
                                          staged=True, **kw)
                assert ws == (st[0] - row, st[1])
            route = tkc.refine_route(f, w, ke, keep, k, build, final,
                                     itemsize)
            sort = 2 * k if final else keep
            fits = on <= tkc.REFINE_SMEM_MAX and sort <= tkc.REFINE_SORT_MAX
            assert route == ((0, on) if fits else (ws[1], ws[0]))
            assert route.smem <= tkc.REFINE_SMEM_MAX
            if k <= tkc.K_REG_MAX:
                assert fits, (d, k, f)
    if itemsize == 8 and d == 32_768:
        assert row > tkc.REFINE_SMEM_MAX


@pytest.mark.parametrize("itemsize", [4, 8])
def test_unstaged_scratch_is_charged_where_the_chunk_is_planned(itemsize):
    """B6u's passes share a scratch a chunk row (``Scratch`` in
    csrc/knn_cand.cu: a first stage's count and candidate ids, a double
    sum and a score a candidate), which the tile plan's workspace and the
    memory model's ``b6_workspace`` count beside the route's workspace for
    the unstaged stages alone: ~3.3 KB a row in the counts' exact stage (k
    = 90, 270 candidates), nothing up to the staged width."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import stage_terms
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    a16 = lambda b: (b + 15) // 16 * 16  # noqa: E731
    for w, ke, build in ((270, 0, False), (16, 45, True), (16, 1500, True),
                         (4500, 0, False), (7, 3, True)):
        z = w * (1 + ke) if build else w
        want = ((16 + a16(4 * z) if build else 0) + a16(8 * z)
                + a16(itemsize * z))
        assert tkc.refine_scratch_bytes(w, ke, build, itemsize) == want
    assert tkc.refine_scratch_bytes(270, 0, False, 4) == 3248
    for d, k in ((32_738, 90), (12_289, 1500), (784, 90),
                 (tkc.STAGED_F_MAX, 90)):
        stages = tknn.refine_stages(d, k)
        want = max(tkc.refine_route(f, w, ke, keep, k, build, final,
                                    itemsize).workspace
                   + (0 if tkc.refine_staged(f) else
                      tkc.refine_scratch_bytes(w, ke, build, itemsize))
                   for f, w, ke, keep, build, final in stages)
        assert ttiles.refine_workspace_bytes(d, k, itemsize=itemsize) == want
        assert (want > 0) == (not tkc.refine_staged(d) or k > tkc.K_REG_MAX)
    n, d = 68_579, 32_738
    knn = stage_terms(PlanConfig(
        n=n, d=d, k=90, backend="cuda", knn_method="project", knn_refine=7,
        dtype="float32" if itemsize == 4 else "float64"))["knn"]
    c = ttiles.pick_knn_tiles(n, d, 90, "cuda").refine_chunk
    assert knn["b6_workspace"] == c * tkc.refine_scratch_bytes(270, 0, False,
                                                              itemsize)


def test_card_chunk_leaves_out_the_gather_b6_never_makes():
    """On the card the refine chunk past the staged width is sized without
    the JAX count's exact gather (B6 reads the rows it scores): 4,096 rows
    at 68,579 x 32,738, k = 90, not the 64 that gather alone would allow;
    up to the staged width the card's chunks are the JAX count's."""
    budget = (ttiles.DEFAULT_BUDGET_BYTES["cuda"]
              * ttiles.TILE_BUDGET_FRACTION)
    for n, d, k, want in ((68_579, 32_738, 90, 4096),
                          (20_000, 32_738, 90, 4096),
                          (20_000, 32_738, 1500, 256),
                          (60_000, 784, 90, 2048),
                          (60_000, tkc.STAGED_F_MAX, 90, 128)):
        c = ttiles.pick_knn_tiles(n, d, k, "cuda").refine_chunk
        assert c == want, (n, d, k, c)
        assert ttiles.refine_chunk_bytes(c, d, k, workspace=True) <= budget
        if not tkc.refine_staged(d):
            assert ttiles.refine_chunk_bytes(2 * ttiles.MIN_REFINE_CHUNK, d,
                                             k) > budget


@pytest.mark.parametrize("d", [784, 12_288, 12_289, 32_738])
def test_cosine_chunk_counts_the_gather_of_its_plain_exact_stage(d):
    """Cosine's exact stage is the plain version on the card too, so past
    the staged width its chunk counts the [c, exact, d] gather that B6
    never makes (64 rows at 32,738 features, k = 90); up to it every
    metric's chunk is the JAX count's; and the memory model charges the
    gather for cosine alone."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import stage_terms
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    n, k = 20_000, 90
    budget = (ttiles.DEFAULT_BUDGET_BYTES["cuda"]
              * ttiles.TILE_BUDGET_FRACTION)
    c = ttiles.pick_knn_tiles(n, d, k, "cuda", metric="cosine").refine_chunk
    with_gather = ttiles.refine_chunk_bytes(c, d, k, workspace=True,
                                            metric="cosine")
    assert with_gather <= budget
    unmade = (0.0 if tkc.refine_staged(d)
              else ttiles.exact_gather_bytes(c, d, k))
    assert with_gather == ttiles.refine_chunk_bytes(
        c, d, k, workspace=True) + unmade
    sq = ttiles.pick_knn_tiles(n, d, k, "cuda").refine_chunk
    assert (c == sq) == tkc.refine_staged(d)
    if d == 32_738:
        assert c == ttiles.MIN_REFINE_CHUNK
    terms = {m: stage_terms(PlanConfig(n=n, d=d, k=k, backend="cuda",
                                       knn_method="project", knn_refine=3,
                                       metric=m))["knn"]
             for m in ("sqeuclidean", "cosine")}
    assert terms["sqeuclidean"]["exact_gather"] == 0.0
    assert terms["cosine"]["exact_gather"] == 2.0 * ttiles.exact_gather_bytes(
        c, d, k)


def test_refine_norms_are_summed_a_row_block_at_a_time(monkeypatch):
    """The refine round's squared norms make x's square a row block of
    NORM_BLOCK_VALUES values at a time, each row's sum the one-call sum's,
    and the memory model charges one block."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import stage_terms
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    x = torch.as_tensor(_blobs(300, 700, seed=3))
    whole = torch.sum(x * x, dim=1)
    assert torch.equal(tknn._sq_norms(x), whole)
    monkeypatch.setattr(tknn, "NORM_BLOCK_VALUES", 700 * 64)
    assert tknn.norm_rows(700) == 64
    assert torch.equal(tknn._sq_norms(x), whole)
    monkeypatch.undo()
    n, d = 68_579, 32_738
    knn = stage_terms(PlanConfig(n=n, d=d, k=90, backend="cuda",
                                 knn_method="project", knn_refine=7))["knn"]
    assert knn["refine_norms"] == tknn.norm_rows(d) * d * 4.0
    assert knn["refine_norms"] <= 4.0 * tknn.NORM_BLOCK_VALUES < n * d * 4.0


def test_registry_and_recorder_name_the_unstaged_form():
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    for sfx, t in (("", "f32"), ("_f64", "f64")):
        k = kbuild.KERNELS["B6u" + sfx]
        assert k.symbol == f"tsne_refine_chunk_unstaged_{t}"
        # the staged form's operands, then the scratch its passes share
        # (a pointer and its bytes a row), then the stream
        staged = kbuild.SIGNATURES[f"tsne_refine_chunk_{t}"]
        assert kbuild.SIGNATURES[k.symbol] == staged[:-1] + [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        f64 = bool(sfx)
        assert kbuild.form_id("B6", f64, D_PAST) == "B6u" + sfx
        assert kbuild.form_id("B6", f64, tkc.STAGED_F_MAX) == "B6" + sfx
    x = torch.as_tensor(_blobs(120, D_PAST, seed=2))
    with Recorder() as rec:
        tsne_embed(x, TsneConfig(perplexity=5.0, iterations=20,
                                 attraction="csr"), neighbors=15,
                   knn_method="project", knn_refine=1, device="cpu")
    # the cascade stage scores a 128-wide projection (B6_f64), the exact
    # stage the points (B6u_f64)
    assert {e["plain_of"] for e in rec.events if "plain_of" in e} == {
        "B2_f64", "B3_f64", "B4_f64", "B6_f64", "B6u_f64"}
