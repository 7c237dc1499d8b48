"""PyTorch port, the kernels' widened shapes vs the JAX package, and the
limits that remain.

The card's kernels take every embedding width m = 1 .. 8 (B2-B5, the JAX
package's MPAD; wider m runs in their wide forms, tests/test_torch_wide.py)
and every k (B1's deep class to 1,024, its pending class
past it; B6 on chip, or through its workspace route where a stage does
not fit).  Here their plain versions are held at those shapes against
the JAX package — its Pallas kernels in interpret mode
(``pallas_interpret``) or its XLA twins — on the same seeded numpy
inputs, the B6 route and the tile plan's workspace are held to their
formulas, ``prepare`` and ``tsne_embed`` run past k = 1,024 on every kNN
plan and past 12,288 features on a refining plan (B6's unstaged form on
the card, tests/test_torch_wide_features.py), and the one request past
the limits (m = 0) is refused before the kNN stage runs, on the CPU as on
the card.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import attraction_pallas as jatt
from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu.ops import knn_tiles as jtiles
from tsne_flink_tpu.ops.knn import knn_bruteforce as jax_knn_bruteforce
from tsne_flink_tpu.ops.knn_pallas import fused_knn as jax_fused_knn
from tsne_flink_tpu.ops.repulsion_pallas import pallas_exact_repulsion
from tsne_flink_tpu_torch import TsneConfig, tsne_embed
from tsne_flink_tpu_torch.ops import attraction_cuda as tatt
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_cuda as tkc
from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
from tsne_flink_tpu_torch.utils.artifacts import prepare

pytestmark = pytest.mark.fast

WIDTHS = [1, 4, 8]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the JAX package's Pallas kernels run in interpret mode: jax 0.9's
    ``pallas_call`` takes only int ``CostEstimate`` fields and the package
    passes floats, so they are rounded while the test runs, and what was
    traced under the patch is dropped afterwards."""
    from jax.experimental import pallas as pl
    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture(params=["pallas-interpret", "xla"])
def jax_kind(request):
    if request.param == "pallas-interpret":
        request.getfixturevalue("pallas_interpret")
    return request.param


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- B2-B5 at m = 1, 4, 8 ---------------------------------------------------

@pytest.mark.parametrize("m", WIDTHS)
def test_plain_repulsion_matches_jax_pallas_at_every_width(m):
    """B2's plain version against the Pallas kernel (interpret mode), which
    pads m to its MPAD = 8: rtol 2e-5, on a masked row shard too."""
    rng = np.random.default_rng(m)
    n = 300
    y = (rng.standard_normal((n, m)) * 3.0).astype(np.float32)
    rep0, z0 = pallas_exact_repulsion(jnp.asarray(y), interpret=True,
                                      tile=128)
    rep1, z1 = cuda_exact_repulsion(torch.from_numpy(y))
    np.testing.assert_allclose(rep1.numpy(), np.asarray(rep0), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(z1), float(z0), rtol=2e-5)
    valid = np.arange(n) < n - 40
    want = pallas_exact_repulsion(
        jnp.asarray(y[128:256]), jnp.asarray(y), row_offset=128,
        col_valid=jnp.asarray(valid), interpret=True, tile=128, row_z=True)
    got = cuda_exact_repulsion(_t(y[128:256]), _t(y), row_offset=128,
                               col_valid=_t(valid), row_z=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)


def _csr_problem(m, seed=4, n=150, w=16):
    """A CSR head [n, w], a src-sorted tail (row 0 a hub of 40 edges, the
    others 0-3) and the step's planes: rep [n, m] (Z = 37.5)."""
    rng = np.random.default_rng(seed + m)
    f32 = np.float32
    y = rng.standard_normal((n, m)).astype(f32)
    hidx = rng.integers(0, n, (n, w)).astype(np.int32)
    hval = (rng.random((n, w)) * 1e-3).astype(f32)
    hval[rng.random((n, w)) < 0.2] = 0.0
    deg = rng.integers(0, 4, n)
    deg[0] = 40
    tsrc = np.repeat(np.arange(n), deg).astype(np.int32)
    tdst = rng.integers(0, n, tsrc.shape[0]).astype(np.int32)
    tval = (rng.random(tsrc.shape[0]) * 1e-3).astype(f32)
    rep = (37.5e-3 * rng.standard_normal((n, m))).astype(f32)
    upd = (1e-2 * rng.standard_normal((n, m))).astype(f32)
    gains = (1.0 + rng.random((n, m))).astype(f32)
    return y, hidx, hval, (tsrc, tdst, tval), rep, upd, gains


@pytest.mark.parametrize("m", WIDTHS)
def test_plain_attraction_kernels_match_jax_at_every_width(jax_kind, m):
    """B3 (the CSR step over head + tail), B4 (the KL) and B5 (the
    forces): the port's index-gathering wrappers on the CPU against the
    JAX package's, f32 (the JAX step fed its own tail forces and rep/Z)."""
    from tsne_flink_tpu.models.tsne import _edge_forces
    y, hidx, hval, tail, rep, upd, gains = _csr_problem(m)
    valid = np.arange(y.shape[0]) < 140
    j = jnp.asarray
    tail_att = _edge_forces(j(y), j(y), *map(j, tail), jnp.float32(4.0))
    want = jatt.fused_step_update(
        j(y), j(y), j(hidx), j(hval), jnp.float32(4.0), tail_att,
        j(rep) / jnp.float32(37.5), j(valid), j(upd), j(gains),
        jnp.float32(0.8), eta=1000.0, min_gain=0.01, row_chunk=64,
        kernel=jax_kind)
    t = torch.from_numpy
    rag = tatt.ragged_edges(*map(t, tail), y.shape[0])
    got = tatt.fused_step_update(t(y), t(y), t(hidx), t(hval), 4.0, t(rep),
                                 torch.tensor(37.5), t(valid), t(upd),
                                 t(gains), 0.8, eta=1000.0, min_gain=0.01,
                                 ragged=rag, row_chunk=48)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    lw = np.asarray(jatt.attraction_loss(
        j(y), j(y), j(hidx), j(hval), jnp.float32(1.0), jnp.float32(2.5e3),
        row_chunk=64, kernel=jax_kind))
    lg = tatt.attraction_loss(t(y), t(y), t(hidx), t(hval), 1.0,
                              torch.tensor(2.5e3), row_chunk=48).numpy()
    np.testing.assert_allclose(lg, lw, rtol=2e-5, atol=1e-9)
    fw = np.asarray(jatt.attraction_forces(
        j(y), j(y), j(hidx), j(hval), jnp.float32(4.0), row_chunk=64,
        kernel=jax_kind))
    fg = tatt.attraction_forces(t(y), t(y), t(hidx), t(hval), 4.0,
                                row_chunk=48).numpy()
    np.testing.assert_allclose(fg, fw, rtol=2e-5,
                               atol=2e-5 * np.abs(fw).max())


# ---- B1 past k = 256 --------------------------------------------------------

def test_plain_knn_sweep_matches_jax_at_k300(pallas_interpret):
    """B1's plain sweep at k = 300, in the kernel's deep class, against the
    Pallas kernel in interpret mode (k padded to 384) and the XLA tiles."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((420, 16)).astype(np.float32)
    pi, pd = tknn.knn_bruteforce(torch.from_numpy(x), 300)
    for ji, jd in (jax_fused_knn(jnp.asarray(x), 300, "sqeuclidean",
                                 interpret=True),
                   jax_knn_bruteforce(jnp.asarray(x), 300, "sqeuclidean",
                                      kernel="xla")):
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=2e-5,
                                   atol=1e-6)


# ---- a graph against the JAX package's, ties as sets ------------------------

def _same_graph(ti, td, ji, jd, rtol):
    """Distances at ``rtol``; ids equal as sets within each run of equal
    (reference) distance, equal to ``rtol`` (two float32 sums of one
    distance may round apart, and then order a near-tie either way).  The
    reference may hold one column more than the graph: a run that crosses
    the graph's last column only has to hold the graph's part of it."""
    ti, td, ji, jd = map(np.asarray, (ti, td, ji, jd))
    k = ti.shape[1]
    np.testing.assert_allclose(td, jd[:, :k], rtol=rtol,
                               atol=1e-6 if rtol else 0)
    tol = 2.0 * rtol * np.abs(jd)
    for r in range(ji.shape[0]):
        s = 0
        while s < k:
            e = s + 1
            while e < ji.shape[1] and jd[r, e] - jd[r, e - 1] <= tol[r, e]:
                e += 1
            if e <= k:
                assert set(ti[r, s:e]) == set(ji[r, s:e]), (r, s)
            else:
                assert set(ti[r, s:k]) <= set(ji[r, s:e]), (r, s)
            s = e


# ---- the hybrid kNN past k = 512 ---------------------------------------------

def _blobs(n, d, clusters=8, seed=0, spread=0.6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)) * 2.0
    return centers[rng.integers(0, clusters, n)] + spread * \
        rng.standard_normal((n, d))


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


@pytest.mark.parametrize("d,k", [(40, 600), (300, 520)])
def test_refine_round_past_k512_matches_jax_with_its_draws(d, k):
    """One refine round at k > 512 (2k sort keys past the old 1,024; at
    d = 300 the cascade keeps 3k) with the JAX draws injected: the same
    ids, distances to rtol 1e-10 (f64)."""
    n = 800
    x = _blobs(n, d, seed=5)
    fd = jknn.pick_knn_filter(d)
    ke = (k + 1) // 2 if fd else None
    ti0, td0 = tknn.knn_project(_t(x), k, "sqeuclidean", 1, block=32)
    tiles = replace(jtiles.pick_knn_tiles(n, d, k, "cpu"), kernel="xla",
                    refine_chunk=64)
    key = jax.random.key(13)
    ri, rd = jknn.knn_refine(jnp.asarray(x), jnp.asarray(ti0.numpy()),
                             jnp.asarray(td0.numpy()), "sqeuclidean",
                             rounds=1, key=key, filter_dims=fd, expand_k=ke,
                             tiles=tiles)
    plan = tknn._refine_plan(d, k, filter_dims=fd, expand_k=ke)
    assert (plan.cascade_dims is not None) == (d == 300)
    qi, qd = tknn.knn_refine(_t(x), ti0, td0, "sqeuclidean", rounds=1,
                             filter_dims=fd, expand_k=ke, row_chunk=64,
                             draws=[_jax_refine_draw(key, plan, n, k, d)])
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(qd.numpy(), np.asarray(rd), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("d", [16, 50, 128, 200, 784, tkc.STAGED_F_MAX,
                               tkc.STAGED_F_MAX + 1, 32_768])
def test_every_k_the_kernels_take_fits_the_refine_kernel(d):
    """Every k takes a B6 route at every d (the staged form's layout up
    to STAGED_F_MAX features, the unstaged form's past it): up to k =
    1,024 every stage of the refine plan fits B6's shared memory and sort
    capacity (the on-chip route, as before); past it a stage that does
    not fit takes the workspace route, whose shared memory fits at any k
    and whose workspace is WsLayout's; and the tile plan's refine chunk
    on the card counts that workspace within the tile budget (past the
    staged width without the exact gather B6 never makes)."""
    from tsne_flink_tpu_torch.ops import knn_tiles as ttiles
    fd = tknn.pick_knn_filter(d)
    for k in (1, 90, 150, 300, 512, 513, 600, 1000, tkc.K_REG_MAX,
              tkc.K_REG_MAX + 1, 1500, 2048, 4096):
        plan = tknn._refine_plan(d, k, filter_dims=fd,
                                 expand_k=(k + 1) // 2 if fd else None)
        assert [s[4:] for s in tknn.refine_stages(d, k)][-1] == (
            plan.filter_dims is None and plan.cascade_dims is None, True)
        for f, w, ke, keep, build, final in tknn.refine_stages(d, k):
            staged = tkc.refine_staged(f)
            route = tkc.refine_route(f, w, ke, keep, k, build, final)
            smem = tkc.refine_smem_bytes(f, w, ke, keep, k, build, final,
                                         staged=staged)
            sort = 2 * k if final else keep
            fits = (smem <= tkc.REFINE_SMEM_MAX
                    and sort <= tkc.REFINE_SORT_MAX)
            if k <= tkc.K_REG_MAX:
                assert fits, (d, k, f, smem)
            assert (route.workspace == 0) == fits
            if fits:
                assert route.smem == smem
            else:
                ws_smem, row = tkc.refine_ws_layout(f, w, ke, keep, k,
                                                    build, final,
                                                    staged=staged)
                assert route == (row, ws_smem)
                assert ws_smem <= tkc.REFINE_SMEM_MAX and row % 16 == 0
        ws = ttiles.refine_workspace_bytes(d, k)
        c = ttiles.pick_knn_tiles(60_000, d, k, "cuda").refine_chunk
        # past the staged width the card's count leaves out the exact
        # gather, which B6 never makes
        unmade = (0.0 if tkc.refine_staged(d)
                  else ttiles.exact_gather_bytes(c, d, k))
        assert (ttiles.refine_chunk_bytes(c, d, k, workspace=True)
                == ttiles.refine_chunk_bytes(c, d, k) + c * ws - unmade)
        if c > ttiles.MIN_REFINE_CHUNK:
            assert (ttiles.refine_chunk_bytes(c, d, k, workspace=True)
                    <= ttiles._tile_budget("cuda", None))


# ---- the limit that remains raises before the kNN stage; the rest run ---------

@pytest.fixture
def no_knn(monkeypatch):
    """Fail the test if the kNN stage starts."""
    def refuse(*a, **kw):
        raise AssertionError("the kNN stage ran")
    monkeypatch.setattr(tknn, "knn", refuse)


@pytest.mark.parametrize("m", [0, 9])
def test_embedding_width_past_the_kernels_raises_first(request, m):
    """n_components = 0 is refused before the kNN stage; 9, past the
    register-held instances, runs (B2-B5's wide forms on the card) to a
    finite embedding."""
    x = np.random.default_rng(0).standard_normal((50, 4))
    if m == 0:
        request.getfixturevalue("no_knn")
        with pytest.raises(ValueError, match="n_components"):
            tsne_embed(x, TsneConfig(n_components=m, iterations=10),
                       neighbors=5, device="cpu")
        return
    y, losses = tsne_embed(x, TsneConfig(n_components=m, iterations=10),
                           neighbors=5, device="cpu")
    assert tuple(y.shape) == (50, m) and bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(losses).all())


@pytest.mark.parametrize("method", ["bruteforce", "partition", "project",
                                    "auto"])
def test_k_past_k_max_raises_before_the_knn_stage(method):
    """k = 1,025 (past the old 1,024 limit) is no longer refused: prepare
    runs on every kNN plan and gives the JAX package's exact graph (at N
    = 1,100 a Z-order band of 1,024 + 2k covers every column, so the
    project plan is exact too), and tsne_embed at perplexity 342 (k =
    1,026) runs to a finite embedding."""
    x = np.random.default_rng(1).standard_normal((1100, 4))
    prep = prepare(x, neighbors=tkc.K_REG_MAX + 1, knn_method=method,
                   perplexity=30.0, device="cpu", assembly="sorted")
    ji, jd = jax_knn_bruteforce(jnp.asarray(x), tkc.K_REG_MAX + 2,
                                "sqeuclidean", kernel="xla")
    _same_graph(prep.idx.numpy(), prep.dist.numpy(), ji, jd, 1e-10)
    y, losses = tsne_embed(x, TsneConfig(perplexity=342.0, iterations=10),
                           knn_method=method, device="cpu",
                           affinity_assembly="sorted")
    assert tuple(y.shape) == (1100, 2) and bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(losses).all())


def test_features_past_cand_f_max_raise_before_a_refining_plan(monkeypatch):
    """12,289 features on a refining project plan, once refused, run:
    ``prepare`` reaches the refine stages at that width and gives the
    exact graph (at N = 40 one Z-order band block covers every point),
    as it does with no refine cycle and on the exact plan."""
    d = tkc.STAGED_F_MAX + 1
    x = np.random.default_rng(3).standard_normal((40, d))
    seen = []
    real = tknn.refine_final

    def final(metric, base, *a, **kw):
        seen.append(base.shape[1])
        return real(metric, base, *a, **kw)
    monkeypatch.setattr(tknn, "refine_final", final)
    prep = prepare(x, neighbors=5, knn_method="project", knn_refine=1,
                   perplexity=2.0, device="cpu")
    assert seen and set(seen) == {d}
    ji, jd = jax_knn_bruteforce(jnp.asarray(x), 5, "sqeuclidean",
                                kernel="xla")
    _same_graph(prep.idx.numpy(), prep.dist.numpy(), ji, jd, 1e-10)
    for method, refine in (("project", 0), ("bruteforce", None)):
        other = prepare(x, neighbors=5, knn_method=method, knn_refine=refine,
                        perplexity=2.0, device="cpu")
        assert torch.equal(other.idx, prep.idx)


def test_k_is_clamped_before_the_check():
    """k past N − 1 clamps (the reference's first(k)), and no k is
    refused: k = 5,000 at N = 600 clamps to 599 on every plan, and the
    kNN stage returns the clamped N − 1 neighbours."""
    assert tknn._clamp_k(5000, 600) == 599
    assert tknn._clamp_k(5000, 5000) == 4999
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((600, 8)))
    idx, dist = tknn.knn_bruteforce(x, 5000)
    assert tuple(idx.shape) == tuple(dist.shape) == (600, 599)


@pytest.mark.parametrize("m", [1, 5, 8])
def test_embed_runs_at_every_kernel_width(m):
    """tsne_embed takes every width the kernels take (a short CPU run)."""
    x = np.random.default_rng(m).standard_normal((120, 6))
    y, losses = tsne_embed(x, TsneConfig(n_components=m, perplexity=5.0,
                                         iterations=20), device="cpu")
    assert tuple(y.shape) == (120, m)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(losses).all())
