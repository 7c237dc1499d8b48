"""PyTorch port, exact kNN (kernel B1's plain version) vs the JAX package,
and the kNN dispatch.

The port runs on the CPU, where ``fused_knn`` takes the plain sweep.  The
JAX side runs the Pallas kernel in interpret mode (``fused_knn(...,
interpret=True)``) and its XLA tile path (``knn_bruteforce(kernel=
"xla")``).  Inputs come from a numpy seed and cross as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops.knn import knn_bruteforce as jax_knn_bruteforce
from tsne_flink_tpu.ops.knn_pallas import fused_knn as jax_fused_knn
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final, fused_knn,
                                               knn_sweep_plain)

pytestmark = pytest.mark.fast

N, D, K = 300, 16, 10


def _points(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, D)).astype(np.float32)


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


def _check_same_graph(x, metric, ji, jd):
    pi, pd = tknn.knn_bruteforce(torch.from_numpy(x), K, metric)
    # tie-free random input: the same neighbours in the same order
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=2e-5,
                               atol=1e-6)
    assert pi.dtype == torch.int32


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_plain_matches_jax_pallas_interpret(metric, pallas_interpret):
    x = _points()
    _check_same_graph(x, metric,
                      *jax_fused_knn(jnp.asarray(x), K, metric,
                                     interpret=True))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_plain_matches_jax_xla(metric):
    x = _points()
    _check_same_graph(x, metric,
                      *jax_knn_bruteforce(jnp.asarray(x), K, metric,
                                          row_chunk=64, kernel="xla"))


# the 9 collinear points (i,i,i,i) and their expected k=2 (i, j,
# sqeuclidean) triples, as in tests/test_golden_reference.py:37-43
# (TsneHelpersTestSuite.scala:331-348)
KNN_INPUT = np.arange(9, dtype=np.float64)[:, None] * np.ones((1, 4))
KNN_RESULTS = [
    (0, 1, 4.0), (0, 2, 16.0), (1, 2, 4.0), (1, 0, 4.0), (2, 3, 4.0),
    (2, 1, 4.0), (3, 4, 4.0), (3, 2, 4.0), (4, 5, 4.0), (4, 3, 4.0),
    (5, 6, 4.0), (5, 4, 4.0), (6, 7, 4.0), (6, 5, 4.0), (7, 8, 4.0),
    (7, 6, 4.0), (8, 7, 4.0), (8, 6, 16.0),
]


def test_line_golden():
    idx, dist = tknn.knn(torch.from_numpy(KNN_INPUT), 2, "bruteforce")
    got = {(i, int(idx[i, a]), float(dist[i, a]))
           for i in range(9) for a in range(2)}
    assert got == set(KNN_RESULTS)


def test_ties_go_to_the_lowest_column():
    """Equal distances order by column, as lax.top_k does."""
    x = torch.tensor([[0.0], [1.0], [-1.0], [2.0], [-2.0], [3.0]],
                     dtype=torch.float64)
    idx, dist = fused_knn(x, 4)
    assert idx[0].tolist() == [1, 2, 3, 4]
    assert dist[0].tolist() == [1.0, 1.0, 4.0, 4.0]


def test_final_orders_an_unordered_list():
    """_fused_final sorts the kernel's unordered k-lists by (d, column)."""
    x = torch.from_numpy(_points(1)).double()
    d, i = knn_sweep_plain(x, K, cosine=False)
    perm = torch.randperm(K, generator=torch.Generator().manual_seed(0))
    fi, fd = _fused_final(d[:, perm], i[:, perm], "euclidean")
    np.testing.assert_array_equal(fi.numpy(), i.numpy())
    np.testing.assert_allclose(fd.numpy(), np.sqrt(d.numpy()), rtol=1e-15)


def test_k_clamps_and_unported_methods_raise():
    """k clamps to N - 1; every method of the dispatch runs (partition is
    the bruteforce graph exactly, project and auto give [N, k] graphs);
    an unknown method raises."""
    x = torch.from_numpy(_points()[:5])
    idx, _ = tknn.knn(x, 10, "bruteforce")
    assert idx.shape == (5, 4)
    xs = torch.from_numpy(_points())
    bi, bd = tknn.knn(xs, K, "bruteforce")
    pi, pd = tknn.knn(xs, K, "partition")
    assert torch.equal(pi, bi) and torch.equal(pd, bd)
    for method in ("project", "auto"):
        mi, md = tknn.knn(xs, K, method)
        assert mi.shape == (N, K) and mi.dtype == torch.int32
        assert torch.isfinite(md).all()
    with pytest.raises(ValueError):
        tknn.knn(x, 3, "nope")
