"""PyTorch port, the hybrid (project) kNN vs the JAX package (f64, CPU).

* Z-order keys and permutations, ``merge_rounds`` and ``_reverse_sample``
  equal to the JAX functions;
* kernel B6's plain version (``cand_sqdist_plain``) against the JAX
  package's Pallas candidate scorer in interpret mode and its XLA form;
* one ``knn_project`` call and one ``knn_refine`` round with the JAX
  package's own draws injected (reproduced here with ``jax.random`` from
  the JAX functions' key schedule), the JAX side pinned to the
  interpret-mode Pallas scorer through its tile plan: the same neighbours,
  distances to rtol 1e-10;
* refine row-chunk invariance and the compact gather, bit for bit;
* the full hybrid plan's recall against the exact graph, beside the JAX
  package's own recall on the same data;
* the policies (``pick_knn_*``, the tile plan, the FLOP model) equal to
  the JAX package's on a grid of shapes.
"""

import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu.ops import knn_tiles as jtiles
from tsne_flink_tpu.ops import zorder as jzorder
from tsne_flink_tpu.ops.knn_pallas import cand_sqdist_fused
from tsne_flink_tpu.utils import flops as jflops
from tsne_flink_tpu.utils.artifacts import resolve_knn_plan as jresolve
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_tiles as ttiles
from tsne_flink_tpu_torch.ops import zorder as tzorder
from tsne_flink_tpu_torch.ops.knn_cuda import cand_sqdist, cand_sqdist_plain
from tsne_flink_tpu_torch.utils import flops as tflops
from tsne_flink_tpu_torch.utils.artifacts import prepare as torch_prepare
from tsne_flink_tpu_torch.utils.artifacts import resolve_knn_plan

pytestmark = pytest.mark.fast


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the JAX package's Pallas kernels run in interpret mode: jax
    0.9's ``pallas_call`` takes only int ``CostEstimate`` fields and the
    package passes floats, so they are rounded while the test runs, and
    what was traced under the patch is dropped afterwards."""
    from jax.experimental import pallas as pl
    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: contending intra-op pools of parallel test workers
    slow them down, so torch runs one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n, d, clusters=8, seed=0, spread=0.6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)) * 2.0
    return centers[rng.integers(0, clusters, n)] + spread * \
        rng.standard_normal((n, d))


def _t(a):
    return torch.from_numpy(np.array(a))


def _recall(dist_approx, dist_exact, tol=1e-5):
    """scripts/measure_recall.recall_at_k: approximate distances within
    the exact k-th (ties count as hits)."""
    kth = dist_exact[:, -1][:, None] * (1 + tol) + tol
    return float((dist_approx <= kth).mean())


@pytest.mark.parametrize("m", [1, 2, 3])
def test_zorder_matches_jax(m):
    rng = np.random.default_rng(m)
    z = rng.standard_normal((777, m)) * 3.0
    z[5] = z[9]  # equal keys keep their input order
    np.testing.assert_array_equal(
        tzorder.quantize(_t(z), tzorder.BITS_FOR_DIMS[m]).numpy(),
        np.asarray(jzorder.quantize(jnp.asarray(z),
                                    jzorder.BITS_FOR_DIMS[m])))
    q = rng.integers(0, 2 ** tzorder.BITS_FOR_DIMS[m], (500, m)).astype(
        np.int32)
    np.testing.assert_array_equal(tzorder.morton_keys(_t(q)).numpy(),
                                  np.asarray(jzorder.morton_keys(
                                      jnp.asarray(q))))
    perm = tzorder.zorder_permutation(_t(z))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.asarray(
        jzorder.zorder_permutation(jnp.asarray(z))))


def test_merge_rounds_matches_jax():
    """Duplicate ids across and inside rounds, and unfilled (inf) slots
    carrying real ids beside a finite copy of the same id."""
    rng = np.random.default_rng(0)
    n, k = 200, 9
    idxs = [rng.integers(0, 40, (n, k)).astype(np.int32) for _ in range(3)]
    dists = [rng.random((n, k)) for _ in range(3)]
    dists[1][rng.random((n, k)) < 0.2] = np.inf
    dists[2][:, :3] = np.inf
    ji, jd = jknn.merge_rounds([jnp.asarray(d) for d in dists],
                               [jnp.asarray(i) for i in idxs], k)
    ti, td = tknn.merge_rounds([_t(d) for d in dists],
                               [_t(i) for i in idxs], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    one = tknn.merge_rounds([_t(dists[0])], [_t(idxs[0])], k)
    assert torch.equal(one[0], _t(idxs[0]))


def test_dedup_row_passes_are_invisible(monkeypatch):
    rng = np.random.default_rng(1)
    ci = _t(rng.integers(0, 30, (300, 20)).astype(np.int32))
    cd = _t(rng.random((300, 20)))
    whole = tknn._dedup_smallest(ci, cd, 7)
    monkeypatch.setattr(tknn, "DEDUP_ROW_CHUNK", 64)
    parts = tknn._dedup_smallest(ci, cd, 7)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1],
                                                           parts[1])


@pytest.mark.parametrize("r", [1, 4, 12])
def test_reverse_sample_matches_jax(r):
    rng = np.random.default_rng(r)
    n, k = 300, 10
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[:40] = 3  # a hub with in-degree far past r
    np.testing.assert_array_equal(
        tknn._reverse_sample(_t(idx), r).numpy(),
        np.asarray(jknn._reverse_sample(jnp.asarray(idx), r)))
    key = jax.random.key(r)
    perm = np.asarray(jax.random.permutation(key, n * k))
    np.testing.assert_array_equal(
        tknn._reverse_sample(_t(idx), r, perm=_t(perm)).numpy(),
        np.asarray(jknn._reverse_sample(jnp.asarray(idx), r, key=key)))


def _cand_problem(seed=0, n=300, f=24, c=64, z=40):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, f))
    sq = np.sum(base * base, axis=1)
    rows = rng.integers(0, n, c).astype(np.int32)
    cand = rng.integers(0, n, (c, z)).astype(np.int32)
    cand[:, :5] = cand[:, 5:10]  # in-row duplicates
    cand[0, 0] = rows[0]         # a self candidate: d² = 0 after the clamp
    return base, sq, rows, cand


def test_cand_sqdist_plain_matches_jax(pallas_interpret):
    base, sq, rows, cand = _cand_problem()
    tb, ts, tr, tc = map(_t, (base, sq, rows, cand))
    plain = cand_sqdist_plain(tb, ts, tr, tc)
    jb, js, jr, jc = map(jnp.asarray, (base, sq, rows, cand))
    interp = np.asarray(cand_sqdist_fused(jb, js, jr, jc, interpret=True))
    xla = np.asarray(jknn._cand_sqdist(jb, js, jr, jc))
    np.testing.assert_allclose(plain.numpy(), interp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(plain.numpy(), xla, rtol=0, atol=1e-12)
    assert float(plain[0, 0]) == 0.0
    # the wrapper takes the plain version on a CPU tensor; compact gather
    # gives the same bits as the direct one
    assert torch.equal(cand_sqdist(tb, ts, tr, tc), plain)
    assert torch.equal(cand_sqdist_plain(tb, ts, tr, tc, compact=True),
                       plain)


def _jax_project_draws(key, rounds, dim, m=3, start_round=0):
    """knn_project's draws, from its own key schedule."""
    m = min(dim, m)
    draws = []
    for it in range(start_round, start_round + rounds):
        key, rkey = jax.random.split(key)
        if dim > m:
            pkey, skey = jax.random.split(rkey)
            proj = _t(jax.random.normal(pkey, (dim, m), jnp.float64)
                      / jnp.sqrt(jnp.asarray(dim, jnp.float64)))
        else:
            proj, skey = None, rkey
        shift = (_t(jax.random.uniform(skey, (m,), jnp.float64))
                 if it > 0 else None)
        draws.append(tknn.ProjectDraw(proj=proj, shift=shift))
    return draws


def _jax_refine_draw(key, plan, n, k, dim):
    """One knn_refine round's draws, from its own key schedule."""
    _, gkey, vkey, fkey, ckey = jax.random.split(key, 5)
    scale = jnp.sqrt(jnp.asarray(dim, jnp.float64))

    def gauss(kk, width):
        return _t(jax.random.normal(kk, (dim, width), jnp.float64) / scale)

    return tknn.RefineDraw(
        gate=(_t(jax.random.uniform(gkey, (n, k), jnp.float64))
              if plan.s < k else None),
        rev=_t(jax.random.permutation(vkey, n * k)),
        filt=gauss(fkey, plan.filter_dims) if plan.filter_dims else None,
        casc=gauss(ckey, plan.cascade_dims) if plan.cascade_dims else None)


@pytest.mark.parametrize("metric,d", [("sqeuclidean", 40),
                                      ("cosine", 40),
                                      ("euclidean", 2)])
def test_project_matches_jax_with_its_draws(metric, d):
    x = _blobs(1500, d, seed=2)
    k, rounds = 12, 3
    key = jax.random.key(3)
    ji, jd = jknn.knn_project(jnp.asarray(x), k, metric, rounds, key)
    ti, td = tknn.knn_project(_t(x), k, metric, rounds,
                              draws=_jax_project_draws(key, rounds, d))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("metric,d,k", [
    ("sqeuclidean", 40, 12),    # no funnel: the exact stage alone
    ("sqeuclidean", 300, 12),   # JL filter + cascade + exact
    ("cosine", 300, 12),
    ("euclidean", 300, 40),     # the 95% rule skips the JL stage
])
def test_refine_round_matches_jax_with_its_draws(pallas_interpret, metric,
                                                 d, k):
    n = 300
    x = _blobs(n, d, seed=4)
    fd = jknn.pick_knn_filter(d)
    ke = (k + 1) // 2 if fd else None
    # one seed graph for both sides, far from exact (a narrow band)
    ti0, td0 = tknn.knn_project(_t(x), k, metric, 1, block=32)
    gi, gd = jnp.asarray(ti0.numpy()), jnp.asarray(td0.numpy())
    # one refine chunk (the result is chunk-invariant): fewer, wider
    # interpret-mode kernel calls
    tiles = replace(jtiles.pick_knn_tiles(n, d, k, "cpu"),
                    kernel="pallas-interpret", refine_chunk=n)
    key = jax.random.key(9)
    ri, rd = jknn.knn_refine(jnp.asarray(x), gi, gd, metric, rounds=1,
                             key=key, filter_dims=fd, expand_k=ke,
                             tiles=tiles)
    plan = tknn._refine_plan(d, k, filter_dims=fd, expand_k=ke)
    assert (plan.filter_dims is not None) == (d == 300 and k == 12)
    assert (plan.cascade_dims is not None) == (d == 300)
    qi, qd = tknn.knn_refine(_t(x), ti0, td0, metric, rounds=1,
                             filter_dims=fd, expand_k=ke,
                             draws=[_jax_refine_draw(key, plan, n, k, d)])
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(qd.numpy(), np.asarray(rd), rtol=1e-10,
                               atol=1e-12)


def test_refine_row_chunk_invariant_and_compact_gather():
    """Every refine operation is per row: the chunk size never changes a
    bit, and the compact (dedup-then-gather) scorer gives the direct
    gather's bits."""
    x = _t(_blobs(700, 300, seed=5))
    i0, d0 = tknn.knn_project(x, 15, rounds=1, block=64)  # not yet exact
    outs = []
    for chunk, dedup in ((64, False), (97, False), (700, False),
                         (64, True)):
        gen = torch.Generator().manual_seed(11)
        outs.append(tknn.knn_refine(x, i0, d0, rounds=2, generator=gen,
                                    row_chunk=chunk, filter_dims=32,
                                    expand_k=8, dedup_gather=dedup))
    for i, d in outs[1:]:
        assert torch.equal(i, outs[0][0]) and torch.equal(d, outs[0][1])
    # the refine moved the graph toward the exact one
    _, de = tknn.knn_bruteforce(x, 15)
    assert _recall(outs[0][1].numpy(), de.numpy()) > _recall(d0.numpy(),
                                                             de.numpy())


def test_full_hybrid_recall_within_jax():
    """The whole plan (3 seed rounds + 2 cycles) at 3k x 24 (an isotropic
    Gaussian: no cluster structure for the curve to follow), k = 30:
    recall >= 0.9 against the exact graph and within 0.03 of the JAX
    package's own recall on the same data."""
    x = np.random.default_rng(6).standard_normal((3000, 24))
    k = 30
    _, de = tknn.knn_bruteforce(_t(x), k)
    _, jd = jknn.knn(jnp.asarray(x), k, "project", rounds=3, refine=2,
                     key=jax.random.key(0))
    subs = {}
    ti, td = tknn.knn(_t(x), k, "project", rounds=3, refine=2,
                      generator=torch.Generator().manual_seed(0),
                      on_substage=subs.update)
    r_t = _recall(td.numpy(), de.numpy())
    r_j = _recall(np.asarray(jd), de.numpy())
    assert r_t >= 0.9, r_t
    assert abs(r_t - r_j) <= 0.03, (r_t, r_j)
    assert set(subs) == {"zorder_seed", "zorder_cycles", "merge", "refine"}
    # timing the substages changes nothing: the same generator seed gives
    # the same graph
    ui, ud = tknn.knn(_t(x), k, "project", rounds=3, refine=2,
                      generator=torch.Generator().manual_seed(0))
    assert torch.equal(ui, ti) and torch.equal(ud, td)
    # every returned distance is the exact one of its id
    xt = _t(x)
    exact = torch.sum((xt[:, None, :] - xt[ti.long()]) ** 2, dim=-1)
    np.testing.assert_allclose(td.numpy(), exact.numpy(), rtol=1e-9)


GRID = [(n, d, k) for n in (500, 6000, 20_000, 60_000, 300_000, 1_306_127)
        for d in (2, 50, 200, 784) for k in (15, 90, 150)]


def test_policies_match_jax():
    for n, d, k in GRID:
        assert tknn.pick_knn_rounds(n) == jknn.pick_knn_rounds(n)
        assert tknn.pick_knn_filter(d) == jknn.pick_knn_filter(d)
        assert tknn.pick_knn_cascade(d) == jknn.pick_knn_cascade(d)
        assert tknn.pick_knn_refine(n, d) == jknn.pick_knn_refine(n, d)
        assert tknn.pick_knn_refine(n) == jknn.pick_knn_refine(n)
        for backend in ("cpu", "tpu"):
            assert (tknn.pick_knn_method(n, d, k, backend)
                    == jknn.pick_knn_method(n, d, k, backend)), (n, d, k)
            assert (resolve_knn_plan(n, d, "auto", None, None, k=k,
                                     backend=backend)
                    == jresolve(n, d, "auto", None, None, k=k,
                                backend=backend))
        assert tflops._funnel_widths(d, k, 8) == jflops._funnel_widths(
            d, k, 8)
        for refine in (0, 3):
            assert tflops.knn_substage_flops(
                n, d, k, refine_rounds=refine) == jflops.knn_substage_flops(
                n, d, k, refine_rounds=refine)
        for method in ("bruteforce", "project"):
            assert tflops.knn_flops(n, d, k, method, refine_rounds=2) == \
                jflops.knn_flops(n, d, k, method, refine_rounds=2)
        tp = ttiles.pick_knn_tiles(n, d, k, "cpu")
        jp = jtiles.pick_knn_tiles(n, d, k, "cpu")
        assert ((tp.row_chunk, tp.block, tp.refine_chunk)
                == (jp.row_chunk, jp.block, jp.refine_chunk))
        assert tp.kernel == "plain"
        for c in (64, 1024):
            assert ttiles.refine_chunk_bytes(c, d, k) == \
                jtiles.refine_chunk_bytes(c, d, k)
        assert ttiles.project_block_bytes(1024, d, k) == \
            jtiles.project_block_bytes(1024, d, k)
    # on the card the exact sweep is B1 (no [c, N] block): auto never
    # takes partition there, and the refine chunk grows with the budget
    assert all(tknn.pick_knn_method(n, d, k, "cuda") != "partition"
               for n, d, k in GRID)
    cu = ttiles.pick_knn_tiles(1_306_127, 50, 150, "cuda")
    assert cu.kernel == "cuda" and cu.block == ttiles.MIN_BLOCK
    assert ttiles.MAX_REFINE_CHUNK < cu.refine_chunk <= \
        ttiles.MAX_REFINE_CHUNK_CUDA
    assert (ttiles.refine_chunk_bytes(cu.refine_chunk, 50, 150)
            <= ttiles.DEFAULT_BUDGET_BYTES["cuda"]
            * ttiles.TILE_BUDGET_FRACTION)
    assert ttiles.project_block_group(1024, 50, 150, "cuda") > 1


def test_refine_plan_is_the_flop_models():
    """The refine's resolved funnel widths are the ones utils/flops
    models, for the auto filter/expand policy of knn_project_refined."""
    for d in (2, 50, 200, 300, 784):
        for k in (12, 40, 90, 150):
            fd = tknn.pick_knn_filter(d)
            plan = tknn._refine_plan(d, k, filter_dims=fd,
                                     expand_k=(k + 1) // 2 if fd else None)
            cand, fdm, cdm, keep, keep2, ke = tflops._funnel_widths(d, k, 8)
            exact = (plan.keep2 if plan.cascade_dims
                     else plan.keep if plan.filter_dims else plan.n_cand)
            assert (plan.n_cand, plan.filter_dims, plan.cascade_dims, exact,
                    plan.ke) == (cand, fdm, cdm, keep2, ke)


def test_sharded_refine_is_a14():
    """The sharded refine (queue A14b, ported): over the whole set as one
    shard (x_full = x, idx_full = the graph, row_offset 0, n_valid = N)
    it gives the unsharded round's bits; its gathers and its reverse
    sample read the global arrays (tests/test_torch_spmd.py holds it to
    the JAX function on a shard)."""
    x = _t(_blobs(50, 4))
    i, d = tknn.knn_project(x, 5, rounds=1, block=16)
    plain = tknn.knn_refine(x, i, d, generator=torch.Generator()
                            .manual_seed(4))
    sharded = tknn.knn_refine(x, i, d, x_full=x, idx_full=i, row_offset=0,
                              n_valid=50, generator=torch.Generator()
                              .manual_seed(4))
    assert torch.equal(plain[0], sharded[0])
    assert torch.equal(plain[1], sharded[1])


def test_prepare_runs_the_hybrid_plan():
    x = _blobs(400, 10, seed=7)
    gen = torch.Generator().manual_seed(3)
    tp = torch_prepare(_t(x), neighbors=8, knn_method="project",
                       knn_rounds=2, knn_refine=1, generator=gen,
                       perplexity=3.0, device="cpu")
    assert set(tp.knn_substages) == {"zorder_seed", "zorder_cycles",
                                     "merge", "refine"}
    assert tp.idx.shape == (400, 8) and torch.isfinite(tp.dist).all()
    exact = torch_prepare(_t(x), neighbors=8, knn_method="partition",
                          perplexity=3.0, device="cpu")
    assert set(exact.knn_substages) == {"exact_sweep"}
    # n <= 1024: one band block sees every point, so the Z-order rounds
    # alone are exact
    assert _recall(tp.dist.numpy(), exact.dist.numpy()) == 1.0
    assert math.isclose(float(tp.jval.sum()), 1.0, rel_tol=1e-9)
