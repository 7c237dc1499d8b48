"""PyTorch port, affinities and the CSR layout vs the JAX package (f64).

Both sides get the same kNN graph (the JAX exact sweep's), as numpy
arrays; the β bisection and the split assembly must agree to ±1e-12 and
every integer layout array exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import affinities as jaff
from tsne_flink_tpu.ops import attraction_pallas as jatt
from tsne_flink_tpu.ops.knn import knn_bruteforce as jax_knn_bruteforce
from tsne_flink_tpu_torch.ops import affinities as taff
from tsne_flink_tpu_torch.ops import attraction_cuda as tatt

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(7)
    centers = rng.normal(0.0, 4.0, (5, 6))
    x = np.concatenate([rng.normal(c, 1.0, (80, 6)) for c in centers])
    # a hub: one point every cluster lists among its neighbours
    x = np.concatenate([x, centers.mean(0, keepdims=True)])
    idx, dist = jax_knn_bruteforce(jnp.asarray(x), 12, row_chunk=128,
                                   kernel="xla")
    return np.asarray(idx), np.asarray(dist)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pairwise_affinities(graph):
    idx, dist = graph
    dist = dist.copy()
    dist[3, -2:] = np.inf  # padded entries: excluded, p = 0
    want = np.asarray(jaff.pairwise_affinities(jnp.asarray(dist), 5.0))
    got = taff.pairwise_affinities(_t(dist), 5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert (got[3, -2:] == 0).all()


def test_reverse_merge_and_split_width(graph):
    idx, dist = graph
    p = np.asarray(jaff.pairwise_affinities(jnp.asarray(dist), 5.0))
    want_w, want_rev = jaff.split_width(jnp.asarray(idx), jnp.asarray(p),
                                        return_rev=True)
    got_w, got_rev = taff.split_width(_t(idx), _t(p), return_rev=True)
    assert got_w == int(want_w)
    np.testing.assert_array_equal(got_rev.numpy(), np.asarray(want_rev))
    np.testing.assert_array_equal(
        taff.reverse_merge(_t(idx), _t(p), row_chunk=64).numpy(),
        np.asarray(want_rev))


def test_affinity_auto_same_rows(graph):
    idx, dist = graph
    ji, jv, extra, label = jaff.affinity_auto(jnp.asarray(idx),
                                              jnp.asarray(dist), 5.0)
    ti, tv, textra, tlabel = taff.affinity_auto(_t(idx), _t(dist), 5.0)
    assert (label, extra, tlabel, textra) == ("split-rows", None,
                                              "split-rows", None)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-12)
    assert ti.dtype == torch.int32
    # rows over the byte bound: the blocks branch (held in detail by
    # tests/test_torch_layouts.py)
    assert taff.affinity_auto(_t(idx), _t(dist), 5.0,
                              rows_bytes_max=1)[3] == "blocks"


@pytest.mark.parametrize("mode", ["auto", "csr", "rows", "edges"])
def test_plan_attraction(graph, mode):
    idx, dist = graph
    ji, jv, _, _ = jaff.affinity_auto(jnp.asarray(idx), jnp.asarray(dist),
                                      5.0)
    assert (taff.plan_attraction(_t(ji), _t(jv), mode)
            == jaff.plan_attraction(ji, jv, mode))


@pytest.mark.parametrize("width", [8, 64])
def test_build_csr_identical(graph, width):
    idx, dist = graph
    ji, jv, _, _ = jaff.affinity_auto(jnp.asarray(idx), jnp.asarray(dist),
                                      5.0)
    e_pad = jaff.edge_count(jv)
    assert taff.edge_count(_t(jv)) == e_pad
    n, s = ji.shape
    assert (tatt.pick_csr_width(e_pad, n, s)
            == jatt.pick_csr_width(e_pad, n, s))
    (jh, jhv), jtail = jatt.build_csr(ji, jv, width)
    (th, thv), ttail = tatt.build_csr(_t(ji), _t(jv), width)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(thv.numpy(), np.asarray(jhv))
    for a, b in zip(ttail, jtail):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if width == 8:
        assert int((ttail[2] > 0).sum()) > 0, "the hub must overflow"
