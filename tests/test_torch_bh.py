"""PyTorch port, Barnes-Hut repulsion vs the JAX package (f64, CPU).

* ``build_tree``: the per-level counts equal the JAX function's, the sums
  agree to ±1e-12, with and without a validity mask;
* ``bh_repulsion`` against the JAX function at rtol 1e-9: N = 300 and
  2,000, m = 2 and 3, θ = 0, 0.25 and 0.5, both gates, on a masked row
  shard (``row_offset``, ``col_valid``, ``row_z``) and on the whole set,
  and with frontier 8 (overflow); the row chunk changes no bit;
* θ = 0 on singleton leaves equals the port's exact repulsion, rtol 1e-9;
* the error bars of ``tests/test_bh.py`` against the exact sum, and the
  flink gate no worse than ``tests/oracle.py``'s reference quadtree;
* a lattice embedding (tied distances everywhere) under frontier
  overflow selects the JAX function's cells: the same forces and Z.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import repulsion_bh as jbh
from tsne_flink_tpu_torch.ops import repulsion_bh as tbh
from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

pytestmark = pytest.mark.fast

#: m = 3 trees at the default depth hold 8^9 cells; the parity cases cut
#: the depth so that both packages build them in a few MB
LEVELS_3D = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: contending intra-op pools of parallel test workers
    slow them down, so torch runs one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def embedding(n, m, seed=0, scale=10.0, clusters=5):
    """Clustered points, as tests/test_bh.py draws them (numpy f64)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, m)) * scale
    return centers[rng.integers(0, clusters, n)] + rng.normal(size=(n, m))


def _close(t, j, rtol=1e-9):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-300))


@pytest.mark.parametrize("m,levels", [(2, 5), (3, 4)])
def test_build_tree_matches_jax(m, levels):
    y = embedding(500, m, seed=m)
    valid = np.arange(500) % 7 != 3
    for mask in (None, valid):
        jc, js, jlo, jside, jleaf = jbh.build_tree(
            jnp.asarray(y), levels,
            None if mask is None else jnp.asarray(mask))
        tc, ts, tlo, tside, tleaf = tbh.build_tree(
            torch.from_numpy(y), levels,
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
        assert float(tside) == float(jside)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        for l in range(levels + 1):
            np.testing.assert_array_equal(tc[l].numpy(), np.asarray(jc[l]))
            np.testing.assert_allclose(ts[l].numpy(), np.asarray(js[l]),
                                       rtol=0, atol=1e-12)


CASES = [(n, m, theta, gate) for n in (300, 2000) for m in (2, 3)
         for theta in (0.0, 0.25, 0.5) for gate in ("vdm", "flink")]


@pytest.mark.parametrize("n,m,theta,gate", CASES,
                         ids=[f"n{n}-m{m}-t{t}-{g}" for n, m, t, g in CASES])
def test_bh_repulsion_matches_jax(n, m, theta, gate):
    y = embedding(n, m, seed=n + m)
    levels = LEVELS_3D if m == 3 else None
    valid = np.arange(n) < n - 11
    off, rows = n // 4, n // 3
    kw = dict(theta=theta, gate=gate, levels=levels)
    jr, jz = jbh.bh_repulsion(jnp.asarray(y[off:off + rows]), jnp.asarray(y),
                              row_offset=off, col_valid=jnp.asarray(valid),
                              row_z=True, **kw)
    tr, tz = tbh.bh_repulsion(torch.from_numpy(y[off:off + rows]),
                              torch.from_numpy(y), row_offset=off,
                              col_valid=torch.from_numpy(valid), row_z=True,
                              **kw)
    _close(tr, jr)
    _close(tz, jz)
    assert tz.shape == (rows,)
    # the whole set, Z summed
    jr, jz = jbh.bh_repulsion(jnp.asarray(y), **kw)
    tr, tz = tbh.bh_repulsion(torch.from_numpy(y), **kw)
    _close(tr, jr)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-9)
    assert tz.dim() == 0


@pytest.mark.parametrize("m", [2, 3])
def test_frontier_overflow_and_chunks_match_jax(m):
    y = embedding(2000, m, seed=7)
    kw = dict(theta=0.5, frontier=8,
              levels=LEVELS_3D if m == 3 else None)
    jr, jz = jbh.bh_repulsion(jnp.asarray(y), **kw)
    tr, tz = tbh.bh_repulsion(torch.from_numpy(y), **kw)
    _close(tr, jr)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-9)
    # per-row math and one fixed Z sum: the chunking moves no bit
    cr, cz = tbh.bh_repulsion(torch.from_numpy(y), row_chunk=97, **kw)
    assert torch.equal(cr, tr) and torch.equal(cz, tz)


@pytest.mark.parametrize("m", [2, 3])
def test_theta_zero_equals_exact(m):
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.uniform(0, 10, size=(70, m)))
    levels = 10 if m == 2 else 7
    counts = tbh.build_tree(y, levels)[0]
    assert float(counts[levels].max()) == 1.0, "leaves must be singletons"
    rep_b, z_b = tbh.bh_repulsion(y, theta=0.0, levels=levels, frontier=128)
    rep_e, z_e = exact_repulsion(y)
    np.testing.assert_allclose(float(z_b), float(z_e), rtol=1e-9)
    np.testing.assert_allclose(rep_b.numpy(), rep_e.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_error_bars_of_the_jax_tests():
    """tests/test_bh.py:50-59: vdm gate, 300 clustered points."""
    y = torch.from_numpy(embedding(300, 2, seed=2, clusters=4))
    rep_e, z_e = exact_repulsion(y)
    denom = float(torch.abs(rep_e).max())
    for theta, tol in ((0.2, 0.02), (0.5, 0.02)):
        rep_b, z_b = tbh.bh_repulsion(y, theta=theta)
        assert abs(float(z_b - z_e)) / float(z_e) < 0.01
        err = float(torch.abs(rep_b - rep_e).max()) / denom
        assert err < tol, f"theta={theta}: rel force error {err:.4f}"


def test_flink_gate_no_worse_than_reference_quadtree():
    import oracle
    y = embedding(300, 2, seed=2, clusters=4)
    rep_e, z_e = exact_repulsion(torch.from_numpy(y))
    denom = float(torch.abs(rep_e).max())
    rep_ref, z_ref = oracle.bh_repulsion_ref(y, 0.25)
    rep_g, z_g = tbh.bh_repulsion(torch.from_numpy(y), theta=0.25,
                                  gate="flink")
    err_ref = np.abs(rep_ref - rep_e.numpy()).max() / denom
    err_g = float(torch.abs(rep_g - rep_e).max()) / denom
    assert err_g <= err_ref
    assert abs(float(z_g - z_e)) <= abs(z_ref - float(z_e))


@pytest.mark.parametrize("m,side", [(2, 24), (3, 8)])
def test_lattice_ties_select_the_jax_cells(m, side):
    """Integer lattice points: the children's distances tie in whole
    classes, so a frontier of 8 cuts through ties at every level; only
    the lowest-index-first order of ``lax.top_k`` gives the JAX forces."""
    axes = np.meshgrid(*[np.arange(side, dtype=np.float64)] * m,
                       indexing="ij")
    y = np.stack([a.reshape(-1) for a in axes], axis=1)
    kw = dict(theta=0.5, frontier=8, levels=5 if m == 2 else 4)
    jr, jz = jbh.bh_repulsion(jnp.asarray(y), **kw)
    tr, tz = tbh.bh_repulsion(torch.from_numpy(y), **kw)
    _close(tr, jr, rtol=1e-12)
    np.testing.assert_allclose(float(tz), float(jz), rtol=1e-12)


def test_defaults_match_jax():
    for n in (10, 2000, 60_000, 1_306_127):
        for m in (2, 3):
            assert tbh.default_levels(n, m) == jbh.default_levels(n, m)
            for theta in (0.0, 0.1, 0.25, 0.5, 0.8):
                assert (tbh.default_frontier(n, m, None, theta)
                        == jbh.default_frontier(n, m, None, theta))
    assert tbh.MAX_LEVELS == jbh.MAX_LEVELS
    assert tbh.MEM_LEVELS == jbh.MEM_LEVELS
    with pytest.raises(ValueError, match="gate"):
        tbh.bh_repulsion(torch.zeros((4, 2)), gate="other")
    with pytest.raises(ValueError, match="2 or 3"):
        tbh.bh_repulsion(torch.zeros((4, 4)))
