"""PyTorch port, the P assemblies and attraction layouts vs the JAX package.

Both sides get the same kNN graph and conditional P as numpy arrays: the
sorted assembly (``assemble_rows``, ``symmetrized_width``,
``joint_distribution``), ``affinity_pipeline`` with the split builder's
self-heal, the blocks layout (``symmetrize_split_blocks``,
``affinity_blocks``, ``affinity_auto``'s blocks branch) and the edge
layout (``assemble_edges``, ``plan_edges``, ``plan_attraction``).
Integer arrays must be identical, values within ±1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import affinities as jaff
from tsne_flink_tpu.ops.knn import knn_bruteforce as jax_knn_bruteforce
from tsne_flink_tpu_torch.ops import affinities as taff

pytestmark = pytest.mark.fast

K = 12
PERPLEXITY = 5.0


@pytest.fixture(scope="module")
def graph():
    """Five clusters and a hub every cluster lists: (idx, dist, p_cond)."""
    rng = np.random.default_rng(7)
    centers = rng.normal(0.0, 4.0, (5, 6))
    x = np.concatenate([rng.normal(c, 1.0, (80, 6)) for c in centers])
    x = np.concatenate([x, centers.mean(0, keepdims=True)])
    idx, dist = jax_knn_bruteforce(jnp.asarray(x), K, row_chunk=128,
                                   kernel="xla")
    p = jaff.pairwise_affinities(dist, PERPLEXITY)
    return np.asarray(idx), np.asarray(dist), np.asarray(p)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_rows(got, want):
    """(jidx, jval) pairs: indices identical, values within ±1e-12."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-12)
    assert got[0].dtype == torch.int32


def test_symmetrized_width(graph):
    idx, _, p = graph
    want = int(jaff.symmetrized_width(jnp.asarray(idx), jnp.asarray(p)))
    assert taff.symmetrized_width(_t(idx), _t(p)) == want


@pytest.mark.parametrize("width", [None, 64, 16])
def test_sorted_joint_distribution(graph, width):
    """The default width, a wide one, and one that truncates the hub row:
    the same rows, drop count, lossless width and true degrees."""
    idx, _, p = graph
    kw = dict(sym_width=width, return_dropped=True, return_needed=True,
              return_row_deg=True)
    ji, jv, dropped, needed, deg = jaff.joint_distribution(
        jnp.asarray(idx), jnp.asarray(p), **kw)
    ti, tv, t_dropped, t_needed, t_deg = taff.joint_distribution(
        _t(idx), _t(p), **kw)
    _same_rows((ti, tv), (ji, jv))
    assert (t_dropped, t_needed) == (int(dropped), int(needed))
    np.testing.assert_array_equal(t_deg.numpy(), np.asarray(deg))
    if width == 16:
        assert t_dropped > 0, "the hub row must overflow width 16"


@pytest.mark.parametrize("width", [None, 8])
def test_assemble_rows_merges_and_truncates(width):
    """Arbitrary COO input: runs of up to four equal (i, j) entries in
    random order, invalid entries (ii == n_rows), rows wider than 8."""
    rng = np.random.default_rng(3)
    n, e = 30, 400
    ii = rng.integers(0, n + 1, e).astype(np.int32)      # n = invalid
    jj = rng.integers(0, n, e).astype(np.int32)
    rep = rng.integers(0, e, 60)
    ii = np.concatenate([ii, ii[rep], ii[rep[:20]]])
    jj = np.concatenate([jj, jj[rep], jj[rep[:20]]])
    vv = rng.random(ii.shape[0])
    kw = dict(return_dropped=True, return_needed=True, return_row_deg=True)
    want = jaff.assemble_rows(jnp.asarray(ii), jnp.asarray(jj),
                              jnp.asarray(vv), n, width, **kw)
    got = taff.assemble_rows(_t(ii), _t(jj), _t(vv), n, width, **kw)
    _same_rows(got[:2], want[:2])
    assert got[2:4] == (int(want[2]), int(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    if width == 8:
        assert got[2] > 0


def test_affinity_pipeline_sorted(graph):
    idx, dist, _ = graph
    for width in (None, 64):
        want = jaff.affinity_pipeline(jnp.asarray(idx), jnp.asarray(dist),
                                      PERPLEXITY, width, assembly="sorted")
        got = taff.affinity_pipeline(_t(idx), _t(dist), PERPLEXITY, width)
        _same_rows(got, want)


def test_affinity_pipeline_split_self_heals(graph, capsys):
    """An explicit width too narrow for the split layout: both packages
    say so and rebuild at the split layout's exact width."""
    idx, dist, _ = graph
    width = K + 8
    want = jaff.affinity_pipeline(jnp.asarray(idx), jnp.asarray(dist),
                                  PERPLEXITY, width, assembly="split")
    jax_err = capsys.readouterr().err
    got = taff.affinity_pipeline(_t(idx), _t(dist), PERPLEXITY, width,
                                 assembly="split")
    torch_err = capsys.readouterr().err
    _same_rows(got, want)
    assert got[0].shape[1] > width
    assert "rerunning at its exact width" in jax_err
    assert "rerunning at its exact width" in torch_err
    exact = jaff.affinity_pipeline(jnp.asarray(idx), jnp.asarray(dist),
                                   PERPLEXITY, assembly="split")
    _same_rows(taff.affinity_pipeline(_t(idx), _t(dist), PERPLEXITY,
                                      assembly="split"), exact)
    with pytest.raises(ValueError, match="affinity_blocks"):
        taff.affinity_pipeline(_t(idx), _t(dist), PERPLEXITY,
                               assembly="blocks")


def _same_blocks(got, want):
    fwd, rsrc, rdst, rval = got
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(rsrc.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(rdst.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(rval.numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-12)
    assert rsrc.dtype == rdst.dtype == torch.int32


def test_symmetrize_split_blocks(graph):
    idx, _, p = graph
    want = jaff.symmetrize_split_blocks(jnp.asarray(idx), jnp.asarray(p))
    got = taff.symmetrize_split_blocks(_t(idx), _t(p))
    _same_blocks(got, want)
    fwd, rsrc, _, rval = got
    assert bool(torch.all(rsrc[1:] >= rsrc[:-1])), "src must ascend"
    assert abs(float(fwd.sum() + rval.sum()) - 1.0) < 1e-12
    assert int((rval > 0).sum()) > 0


def test_affinity_blocks_and_auto_blocks_branch(graph):
    idx, dist, _ = graph
    ji, jv, (rs, rd, rv) = jaff.affinity_blocks(jnp.asarray(idx),
                                                jnp.asarray(dist),
                                                PERPLEXITY)
    ti, tv, (ts, td, tw) = taff.affinity_blocks(_t(idx), _t(dist),
                                                PERPLEXITY)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _same_blocks((tv, ts, td, tw), (jv, rs, rd, rv))
    # forced by a byte bound below the rows' size
    ja = jaff.affinity_auto(jnp.asarray(idx), jnp.asarray(dist), PERPLEXITY,
                            rows_bytes_max=1024)
    ta = taff.affinity_auto(_t(idx), _t(dist), PERPLEXITY,
                            rows_bytes_max=1024)
    assert ta[3] == ja[3] == "blocks"
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
    _same_blocks((ta[1], *ta[2]), (ja[1], *ja[2]))


@pytest.fixture(scope="module")
def rows(graph):
    idx, dist, _ = graph
    ji, jv, _, _ = jaff.affinity_auto(jnp.asarray(idx), jnp.asarray(dist),
                                      PERPLEXITY)
    return np.asarray(ji), np.asarray(jv)


@pytest.mark.parametrize("short", [False, True])
def test_assemble_edges(rows, short):
    """At the padded edge count, and at one too short for the entries
    (the overflow is dropped on both sides)."""
    ji, jv = rows
    e_pad = jaff.edge_count(jnp.asarray(jv))
    if short:
        e_pad = int((jv > 0).sum()) - 100
    want = jaff.assemble_edges(jnp.asarray(ji), jnp.asarray(jv), e_pad)
    got = taff.assemble_edges(_t(ji), _t(jv), e_pad)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == got[1].dtype == torch.int32


def test_assemble_edges_refuses_int32_slot_overflow():
    big = torch.zeros(1, 1).expand(2 ** 16, 2 ** 15)  # no storage behind it
    with pytest.raises(ValueError, match="2\\^31"):
        taff.assemble_edges(big.to(torch.int32), big, 1024)
    assert taff.plan_edges(big.to(torch.int32), big, "auto") == (False, 0)


@pytest.mark.parametrize("mode", ["auto", "rows", "edges", "csr"])
def test_plan_edges_and_plan_attraction(rows, mode):
    ji, jv = rows
    assert (taff.plan_edges(_t(ji), _t(jv), mode)
            == jaff.plan_edges(jnp.asarray(ji), jnp.asarray(jv), mode))
    assert (taff.plan_attraction(_t(ji), _t(jv), mode)
            == jaff.plan_attraction(jnp.asarray(ji), jnp.asarray(jv), mode))
    with pytest.raises(ValueError, match="not defined"):
        taff.plan_edges(_t(ji), _t(jv), "blocks")
