"""PyTorch port, FFT repulsion vs the JAX package (f64, CPU).

* ``fft_repulsion``'s forces and Z at rtol 1e-9 against the JAX
  function, m = 2 and 3, with a row shard and a validity mask; the
  geometry and the Lagrange weights equal;
* the error bounds of ``tests/test_fft.py`` against the port's exact
  repulsion;
* one ``optimize`` iteration with ``repulsion="fft"`` at ±1e-9 (the fused
  CSR step and the unfused rows step), with the geometry built once per
  run;
* the large-N slice end to end at a small size: the hybrid kNN with FFT
  repulsion, from the JAX init, ends within ``KL_GUARDRAIL_TOL`` of the
  JAX package's run, and reproduces its own bits.
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
from tsne_flink_tpu.ops import repulsion_fft as jfft
from tsne_flink_tpu.utils.artifacts import prepare as jax_prepare
from tsne_flink_tpu_torch import convert
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.ops import repulsion_fft as tfft
from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: contending intra-op pools of parallel test workers
    slow them down, so torch runs one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def embedding(n=400, m=2, seed=0, scale=10.0):
    """tests/test_fft.py's clustered embedding, as numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(5, m)) * scale
    return centers[rng.integers(0, 5, n)] + rng.normal(size=(n, m))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,grid", [(2, 128), (3, 32)])
def test_fft_repulsion_matches_jax(m, grid):
    y = embedding(600, m, seed=m)
    valid = np.arange(600) < 571
    for off, rows in ((0, 600), (150, 200)):
        yl = y[off:off + rows]
        jr, jz = jfft.fft_repulsion(jnp.asarray(yl), jnp.asarray(y),
                                    grid=grid, row_offset=off,
                                    col_valid=jnp.asarray(valid))
        tr, tz = tfft.fft_repulsion(_t(yl), _t(y), grid=grid,
                                    row_offset=off, col_valid=_t(valid))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(jr)).max())
        np.testing.assert_allclose(float(tz), float(jz), rtol=1e-9)
        assert tz.dim() == 0
    # no mask, no shard: the hoisted geometry gives the same bits as one
    # built inside the call
    geom = tfft.fft_geometry(m, grid, torch.float64)
    a = tfft.fft_repulsion(_t(y), grid=grid)
    b = tfft.fft_repulsion(_t(y), geom=geom)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("m", [2, 3])
def test_geometry_and_weights_match_jax(m):
    g = 16
    np.testing.assert_array_equal(
        tfft.fft_geometry(m, g, torch.float64).rho2.numpy(),
        np.asarray(jfft.fft_geometry(m, g, jnp.float64).rho2))
    t = np.random.default_rng(0).random((50, m))
    for p in (2, 3, 4):
        np.testing.assert_allclose(
            tfft._lagrange_weights(_t(t), p).numpy(),
            np.asarray(jfft._lagrange_weights(jnp.asarray(t), p)),
            rtol=0, atol=1e-15)
    assert tfft.DEFAULT_GRID == jfft.DEFAULT_GRID
    with pytest.raises(ValueError, match="2 or 3"):
        tfft.fft_geometry(4)


@pytest.mark.parametrize("m,grid,tol", [(2, 256, 2e-3), (2, 512, 5e-4),
                                        (3, 64, 2e-2)])
def test_fft_converges_to_exact(m, grid, tol):
    """tests/test_fft.py:18-27's bounds, against the port's exact sum."""
    y = _t(embedding(300, m, seed=1))
    rep_f, z_f = tfft.fft_repulsion(y, grid=grid)
    rep_e, z_e = exact_repulsion(y)
    assert abs(float(z_f) - float(z_e)) / float(z_e) < tol
    err = float((rep_f - rep_e).abs().max() / rep_e.abs().max())
    assert err < tol, f"m={m} grid={grid}: rel force error {err}"


def test_fft_wide_embedding_adaptive_spacing():
    """tests/test_fft.py:30-38: span ~200 units at the default grid."""
    y = _t(embedding(500, 2, seed=2, scale=40.0))
    rep_f, z_f = tfft.fft_repulsion(y)
    rep_e, z_e = exact_repulsion(y)
    assert abs(float(z_f) - float(z_e)) / float(z_e) < 1e-3
    assert float((rep_f - rep_e).abs().max() / rep_e.abs().max()) < 1e-3


def _blobs(n, clusters, seed):
    rng = np.random.default_rng(seed)
    per = n // clusters
    centers = rng.normal(0.0, 10.0, (clusters, 8))
    return np.concatenate([rng.normal(c, 0.5, (per, 8)) for c in centers])


@pytest.fixture(scope="module")
def problem():
    x = _blobs(600, 12, 0)
    cfg = jtsne.TsneConfig(perplexity=8.0, iterations=300, row_chunk=64,
                           repulsion="fft", fft_grid=64, attraction="csr")
    prep = jax_prepare(jnp.asarray(x), neighbors=8, knn_method="bruteforce",
                       perplexity=cfg.perplexity)
    return x, cfg, prep


@pytest.mark.parametrize("start", [0, 149])
@pytest.mark.parametrize("layout", ["csr", "rows"])
def test_one_fft_iteration_matches_jax(problem, monkeypatch, layout, start):
    x, cfg, prep = problem
    cfg = replace(cfg, attraction=layout)
    rng = np.random.default_rng(11)
    n = x.shape[0]
    scale = 1e-4 if start == 0 else 5.0  # 149: a KL-report iteration
    y0 = rng.standard_normal((n, 2)) * scale
    upd0 = rng.standard_normal((n, 2)) * scale * 1e-2
    g0 = 1.0 + rng.random((n, 2))
    _, jcsr = jtsne._plan_layout(prep.jidx, prep.jval, cfg)
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, num_iters=1))
    jst, jloss = run(jtsne.TsneState(*map(jnp.asarray, (y0, upd0, g0))),
                     prep.jidx, prep.jval, csr=jcsr, start_iter=start)
    tcfg = convert.config_from_jax(cfg)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    edges, tcsr = ttsne._plan_layout(jidx, jval, tcfg)
    assert edges is None and (tcsr is not None) == (layout == "csr")
    built = []
    real = tfft.fft_geometry
    monkeypatch.setattr(tfft, "fft_geometry",
                        lambda *a, **kw: built.append(1) or real(*a, **kw))
    tst, tloss = ttsne.optimize(
        convert.state_from_numpy(y0, upd0, g0, device="cpu"), jidx, jval,
        tcfg, csr=tcsr, start_iter=start, num_iters=1)
    assert built == [1]  # the lattice is built once per optimize run
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-9,
                               atol=1e-12)
    if start == 149:
        assert tloss[14] > 0


def test_large_n_path_end_to_end(problem):
    """tsne_embed with the hybrid kNN and FFT repulsion: N = 600 fits one
    band block, so the Z-order rounds give the exact graph and the run
    optimizes the JAX package's P; from the JAX init it ends within the
    KL guardrail of the JAX run, and reruns give the same bits."""
    x, cfg, prep = problem
    y_j, loss_j = jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=8, seed=0)
    _, ikey = jax.random.split(jax.random.key(0))
    y0 = np.asarray(jtsne.init_working_set(ikey, x.shape[0], 2,
                                           jnp.float64).y)
    tcfg = convert.config_from_jax(cfg)
    runs = []
    for _ in range(2):
        stats = {}
        runs.append(ttsne.tsne_embed(x, tcfg, neighbors=8,
                                     knn_method="project", knn_refine=1,
                                     device="cpu", y0=y0, stats=stats))
    (y_t, loss_t), (y_u, loss_u) = runs
    assert set(stats["knn_substages"]) == {"zorder_seed", "zorder_cycles",
                                           "merge", "refine"}
    assert torch.equal(y_t, y_u) and torch.equal(loss_t, loss_u)
    assert torch.isfinite(y_t).all()
    assert float(loss_t[-1]) < float(loss_t[cfg.exaggeration_end // 10])
    assert abs(float(loss_t[-1]) - float(loss_j[-1])) <= KL_GUARDRAIL_TOL
