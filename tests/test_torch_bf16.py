"""Mixed precision (``--dtype bfloat16``): the port's bf16 operands held to
the JAX package's ``set_matmul_dtype(jnp.bfloat16)`` on the CPU.

Every JAX call runs under the test-scoped ``jax_bf16`` fixture, which sets
the JAX package's process-wide operand dtype, drops what was traced before
(the setting is read at trace time) and restores both afterwards.  The
port takes the setting as an argument (``matmul_dtype=torch.bfloat16``).
Inputs come from a numpy seed and cross as numpy arrays.

* ``matmul_operands`` rounds as ``astype(jnp.bfloat16)`` (ties to even,
  subnormals, ±inf, NaN);
* ``pairwise`` against the JAX ``pairwise`` (float64, rtol 1e-12);
* B1's plain bf16 sweep against the JAX ``knn_bruteforce`` (XLA tiles) and
  the interpret-mode Pallas sweep with its ``cast_dtype``: ids equal up
  to ties, distances rtol 1e-9; the plain cross sweep against the JAX
  ring hop (``parallel/knn._fold_tile``);
* ``knn_project`` / ``knn_refine`` with the JAX functions' draws injected
  (the refine's JL filter and cascade projections rounded, its scores
  not, as on the TPU route): the same graph, rtol 1e-10;
* the estimator: bf16 within 0.08 KL of float32 on the same blobs with a
  float32 embedding (``tests/test_cli.py``'s quality pin), and within
  ``KL_GUARDRAIL_TOL`` of the JAX estimator's bf16 fit; the CLI's
  ``--dtype bfloat16`` within it of the JAX CLI's program
  (``tests/jax_cli_twin.py``);
* the artifact keys: a bf16 prepare never serves a float32 run, nor the
  reverse, and a float32 key keeps its form.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_cli_twin as twin
from test_torch_hybrid_knn import _jax_project_draws, _jax_refine_draw
from tsne_flink_tpu.models.api import TSNE as JaxTSNE
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu.ops import knn_tiles as jtiles
from tsne_flink_tpu.ops import metrics as jmetrics
from tsne_flink_tpu.ops.knn_pallas import fused_knn as jax_fused_knn
from tsne_flink_tpu.parallel.knn import _fold_tile
from tsne_flink_tpu_torch import TSNE
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import metrics as tmetrics
from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final, fused_knn,
                                               knn_cross_plain)
from tsne_flink_tpu_torch.utils import artifacts as art
from tsne_flink_tpu_torch.utils import cli as tcli

pytestmark = pytest.mark.fast

BF = torch.bfloat16


@pytest.fixture
def jax_bf16():
    """The JAX package's bf16 operand setting for one test."""
    prev = jmetrics.matmul_dtype()
    jax.clear_caches()
    jmetrics.set_matmul_dtype(jnp.bfloat16)
    yield
    jmetrics.set_matmul_dtype(prev)
    jax.clear_caches()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Let the JAX package's Pallas kernels run in interpret mode: jax
    0.9's ``pallas_call`` takes only int ``CostEstimate`` fields and the
    package passes floats, so they are rounded while the test runs."""
    from jax.experimental import pallas as pl
    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Test workers share the host; many small ops run far slower with
    contending intra-op thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(n, d, clusters=8, seed=0, spread=0.6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)) * 2.0
    return centers[rng.integers(0, clusters, n)] + spread * \
        rng.standard_normal((n, d))


# ---- the operand policy ----------------------------------------------------

def test_matmul_operands_round_as_jax(jax_bf16):
    rng = np.random.default_rng(0)
    halfway = ((rng.integers(0, 2 ** 31, 4096).astype(np.uint32)
                & 0x7FFF0000) | 0x8000)              # exact bf16 ties
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                        9.2e-41, 1.17e-38, 3.4e38, -3.4e38, 1.4e-45],
                       np.float32)
    v = np.concatenate([rng.standard_normal(20_000).astype(np.float32),
                        halfway.view(np.float32),
                        -halfway.view(np.float32), special])
    a, b = tmetrics.matmul_operands(_t(v), _t(v[::-1].copy()), BF)
    ja, jb = jmetrics.matmul_operands(jnp.asarray(v), jnp.asarray(v[::-1]))
    for got, want in ((a, ja), (b, jb)):
        assert got.dtype == torch.float32
        want = np.asarray(want.astype(jnp.float32))
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
        np.testing.assert_array_equal(got.numpy()[~nan].view(np.uint32),
                                      want[~nan].view(np.uint32))
    # float64 operands of normal magnitude round through float32, as the
    # JAX package rounds them
    ties = halfway.view(np.float32)
    d = np.concatenate([rng.standard_normal(20_000) * 1e3,
                        ties[np.isfinite(ties)].astype(np.float64)])
    d = d[np.abs(d) > 1e-30]
    got = tmetrics.matmul_operands(_t(d), _t(d), BF)[0]
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.asarray(d).astype(jnp.bfloat16).astype(jnp.float64)))
    # no operand dtype: unchanged
    x = _t(v)
    assert tmetrics.matmul_operands(x, x)[0] is x
    with pytest.raises(ValueError, match="not supported"):
        tmetrics.matmul_operands(x, x, torch.float16)


def test_default_operand_dtype_is_the_tpus_alone():
    assert tmetrics.default_matmul_dtype("cuda") is None
    assert tmetrics.default_matmul_dtype("cpu") is None
    assert tmetrics.default_matmul_dtype("tpu") is BF
    assert tmetrics.default_matmul_dtype("tpu", torch.float64) is None
    assert jmetrics.default_matmul_dtype("cpu") is None
    assert tmetrics.resolve_matmul_dtype("bfloat16") == ("float32", BF)
    assert tmetrics.resolve_matmul_dtype("float64") == ("float64", None)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_pairwise_matches_jax(jax_bf16, metric):
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((70, 33)), rng.standard_normal((50, 33))
    got = tmetrics.pairwise(metric, _t(a), _t(b), BF)
    want = np.asarray(jmetrics.pairwise(metric, jnp.asarray(a),
                                        jnp.asarray(b)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # the rounding is felt: float32-accurate operands give another answer
    full = tmetrics.pairwise(metric, _t(a), _t(b))
    assert float(torch.max(torch.abs(full - got))) > 1e-4


# ---- B1's plain bf16 sweep, the ring hop ------------------------------------

N, D, K = 300, 16, 10


def _same_graph_up_to_ties(ti, td, ji, jd, rtol):
    ji, jd = np.asarray(ji), np.asarray(jd)
    np.testing.assert_allclose(td.numpy(), jd, rtol=rtol, atol=1e-12)
    diff = ti.numpy() != ji
    # an id may differ only inside a run of equal distances
    for r, c in zip(*np.nonzero(diff)):
        assert np.isclose(jd[r, c], jd[r], rtol=rtol).sum() > 1, (r, c)
    assert diff.mean() < 0.01


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_b1_plain_bf16_matches_jax(jax_bf16, pallas_interpret, metric):
    """Against the TPU route, the Pallas sweep (interpret mode), and for
    the norm-trick metrics the XLA tiles too.  Cosine's XLA tile rounds
    the raw rows and divides by their norms, where the Pallas kernel (and
    B1) rounds the L2-normalised rows: the port takes the kernel's form."""
    x = np.random.default_rng(2).standard_normal((N, D))
    ti, td = fused_knn(_t(x), K, metric, matmul_dtype=BF)
    assert ti.dtype == torch.int32 and td.dtype == torch.float64
    if metric != "cosine":
        xla = jknn.knn_bruteforce(jnp.asarray(x), K, metric, row_chunk=64,
                                  kernel="xla")
        _same_graph_up_to_ties(ti, td, *xla, rtol=1e-9)
    interp = jax_fused_knn(jnp.asarray(x), K, metric, interpret=True)
    _same_graph_up_to_ties(ti, td, *interp, rtol=1e-9)
    # the rounded operands change the graph's distances
    _, full = fused_knn(_t(x), K, metric)
    assert float(torch.max(torch.abs(full - td))) > 1e-6


def test_b1_cross_plain_matches_the_jax_ring_hop(jax_bf16):
    """One hop of the ring: a row block against a column block with
    global ids, padding columns and the row's own id masked."""
    x = np.random.default_rng(3).standard_normal((2 * 96, D))
    rows, cols = x[:96], x[96:]
    n_global = 180                      # the last 12 columns are padding
    def ids(a, b):
        return jnp.arange(a, b, dtype=jnp.int32)

    ji_r = ids(96, 192)                 # the rows are the second block
    best = (jnp.full((96, K), jnp.inf), jnp.zeros((96, K), jnp.int32))
    jd, ji = _fold_tile(best, jnp.asarray(cols), jnp.asarray(rows), ji_r,
                        ids(0, 96), n_global, K, "sqeuclidean", 32)
    td, ti = knn_cross_plain(_t(cols), _t(rows), K, False, 96, 0, n_global,
                             matmul_dtype=BF)
    ti, td = _fused_final(td, ti, "sqeuclidean")
    _same_graph_up_to_ties(ti, td, ji, jd, rtol=1e-9)
    # the port's hop is its single sweep's rows (the same rounded sums)
    jd2, ji2 = _fold_tile(best, jnp.asarray(rows), jnp.asarray(cols),
                          ids(0, 96), ids(96, 192), n_global, K,
                          "sqeuclidean", 32)
    td2, ti2 = knn_cross_plain(_t(rows), _t(cols), K, False, 0, 96,
                               n_global, matmul_dtype=BF)
    ti2, td2 = _fused_final(td2, ti2, "sqeuclidean")
    _same_graph_up_to_ties(ti2, td2, ji2, jd2, rtol=1e-9)
    assert int(ti2.max()) < n_global


# ---- the hybrid plan with the JAX draws --------------------------------------

@pytest.mark.parametrize("metric,d", [("sqeuclidean", 40), ("cosine", 40)])
def test_project_matches_jax_with_its_draws(jax_bf16, metric, d):
    x = _blobs(1500, d, seed=2)
    k, rounds = 12, 3
    key = jax.random.key(3)
    ji, jd = jknn.knn_project(jnp.asarray(x), k, metric, rounds, key)
    ti, td = tknn.knn_project(_t(x), k, metric, rounds,
                              draws=_jax_project_draws(key, rounds, d),
                              matmul_dtype=BF)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_refine_round_matches_jax_with_its_draws(jax_bf16, pallas_interpret,
                                                 metric):
    """JL filter + cascade + exact stage at d = 300: the projections take
    bf16 operands on both sides, the scores (the TPU route's Pallas
    scorer, B6's plain stages here) do not."""
    n, d, k = 300, 300, 12
    x = _blobs(n, d, seed=4)
    fd = jknn.pick_knn_filter(d)
    ke = (k + 1) // 2
    ti0, td0 = tknn.knn_project(_t(x), k, metric, 1, block=32,
                                matmul_dtype=BF)
    gi, gd = jnp.asarray(ti0.numpy()), jnp.asarray(td0.numpy())
    tiles = replace(jtiles.pick_knn_tiles(n, d, k, "cpu"),
                    kernel="pallas-interpret", refine_chunk=n)
    key = jax.random.key(9)
    ri, rd = jknn.knn_refine(jnp.asarray(x), gi, gd, metric, rounds=1,
                             key=key, filter_dims=fd, expand_k=ke,
                             tiles=tiles)
    plan = tknn._refine_plan(d, k, filter_dims=fd, expand_k=ke)
    assert plan.filter_dims and plan.cascade_dims
    qi, qd = tknn.knn_refine(_t(x), ti0, td0, metric, rounds=1,
                             filter_dims=fd, expand_k=ke,
                             draws=[_jax_refine_draw(key, plan, n, k, d)],
                             matmul_dtype=BF)
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(qd.numpy(), np.asarray(rd), rtol=1e-10,
                               atol=1e-12)


# ---- the estimator and the CLI -------------------------------------------------

def _quality_blobs():
    """``tests/test_cli.py::test_bf16_mixed_precision_quality``'s data."""
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(6, 24)) * 6.0
    return (centers[rng.integers(0, 6, 360)]
            + rng.normal(size=(360, 24))).astype(np.float32)


def test_bf16_fit_quality_and_the_jax_estimator(jax_bf16):
    x = _quality_blobs()
    kl = {}
    for dtype in (None, "bfloat16"):
        est = TSNE(perplexity=12.0, n_iter=250, repulsion="exact",
                   random_state=3, dtype=dtype, device="cpu").fit(x)
        kl[dtype] = est.kl_divergence_
        assert np.isfinite(est.embedding_).all()
        assert est.embedding_.dtype == np.float32
    assert abs(kl["bfloat16"] - kl[None]) < 0.08, kl
    ref = JaxTSNE(perplexity=12.0, n_iter=250, repulsion="exact",
                  random_state=3, dtype="bfloat16").fit(x)
    assert abs(ref.kl_divergence_ - kl["bfloat16"]) <= KL_GUARDRAIL_TOL


def test_cli_bf16_within_guardrail_of_the_jax_cli(jax_bf16, tmp_path):
    x = _blobs(600, 8, clusters=12, seed=0, spread=0.5) * 5.0
    coo = tmp_path / "in.csv"
    with open(coo, "w") as f:
        f.writelines(f"{i},{j},{float(x[i, j])!r}\n" for i in range(600)
                     for j in range(8))
    out = tmp_path / "o.csv"
    assert tcli.main(["--input", str(coo), "--output", str(out),
                      "--dimension", "8", "--knnMethod", "bruteforce",
                      "--perplexity", "8", "--noCache", "--loss",
                      str(out) + ".loss", "--dtype", "bfloat16"],
                     device="cpu") == 0
    loss = np.loadtxt(str(out) + ".loss", delimiter=",")
    _, loss_j = twin.embed_file(str(coo), 8, knn_method="bruteforce",
                                perplexity=8.0)
    assert abs(loss[-1, 1] - float(loss_j[-1])) <= KL_GUARDRAIL_TOL


# ---- the artifact keys -----------------------------------------------------

def test_cache_keys_name_the_operand_dtype(tmp_path):
    x = _blobs(200, 8, seed=6).astype(np.float32)
    kw = dict(neighbors=12, knn_method="bruteforce", perplexity=4.0,
              device="cpu")
    f32 = art.prepare_fingerprints(x, **kw)
    assert f32 == art.prepare_fingerprints(x, **kw, matmul_dtype=None)
    b16 = art.prepare_fingerprints(x, **kw, matmul_dtype=BF)
    assert b16[0] != f32[0] and b16[1] != f32[1]
    # a warm float32 cache serves no bf16 prepare, nor the reverse
    cache = art.ArtifactCache(str(tmp_path))
    cold = art.prepare(x, cache=cache, **kw)
    warm = art.prepare(x, cache=cache, **kw)
    other = art.prepare(x, cache=cache, matmul_dtype=BF, **kw)
    again = art.prepare(x, cache=cache, matmul_dtype=BF, **kw)
    assert (cold.knn_cache, warm.knn_cache) == ("cold", "warm")
    assert (other.knn_cache, other.affinity_cache) == ("cold", "cold")
    assert again.knn_cache == "warm"
    assert torch.equal(again.idx, other.idx)
    # the multi-controller pipeline's key too
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline

    def fp(dtype):
        return SpmdPipeline(TsneConfig(perplexity=4.0), 200, 8, 12,
                            artifact_cache=cache, devices=["cpu"],
                            matmul_dtype=dtype)._artifact_fp(x, 0)
    assert fp(None) != fp(BF)
