"""PyTorch port, exact repulsion (kernel B2's plain version) vs the JAX
package's Pallas kernel in interpret mode, in the style of
tests/test_pallas.py: f32 inputs from a numpy seed, rtol 2e-5 (the bar the
JAX package holds its own Pallas kernel to)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops.repulsion_pallas import pallas_exact_repulsion
from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("n,m", [(97, 2), (530, 2), (257, 3)])
def test_matches_jax_pallas(n, m):
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((n, m)) * 3.0).astype(np.float32)
    rep0, z0 = pallas_exact_repulsion(jnp.asarray(y), interpret=True,
                                      tile=128)
    rep1, z1 = cuda_exact_repulsion(torch.from_numpy(y))
    np.testing.assert_allclose(rep1.numpy(), np.asarray(rep0), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(z1), float(z0), rtol=2e-5)


def test_sharded_rows_and_validity_mask():
    """Row shards with ``row_offset`` + padded points masked by
    ``col_valid``, per-row Z (``row_z``) against the JAX kernel's."""
    rng = np.random.default_rng(1)
    n, m, n_pad = 200, 2, 256
    y_full = np.concatenate([rng.standard_normal((n, m)),
                             np.zeros((n_pad - n, m))]).astype(np.float32)
    valid = np.arange(n_pad) < n
    yt, vt = torch.from_numpy(y_full), torch.from_numpy(valid)
    for off in range(0, n_pad, 128):
        want_rep, want_z = pallas_exact_repulsion(
            jnp.asarray(y_full[off:off + 128]), jnp.asarray(y_full),
            row_offset=off, col_valid=jnp.asarray(valid), interpret=True,
            tile=128, row_z=True)
        rep, z = cuda_exact_repulsion(yt[off:off + 128], yt, row_offset=off,
                                      col_valid=vt, row_z=True)
        np.testing.assert_allclose(rep.numpy(), np.asarray(want_rep),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(z.numpy(), np.asarray(want_z), rtol=2e-5,
                                   atol=1e-6)
        if off >= n:
            assert np.abs(rep.numpy()).max() == 0.0  # padded rows: nothing


def test_chunking_does_not_change_the_result():
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.standard_normal((300, 2)))
    a = exact_repulsion(y, row_chunk=64, row_z=True)
    b = exact_repulsion(y, row_chunk=1000, row_z=True)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


@pytest.mark.parametrize("sms", [1, 132])
def test_column_splits_fill_the_card_and_cover_the_columns(sms):
    """B2's second grid dimension: enough blocks for two waves where the
    columns allow it, never a range narrower than one staged tile, and
    the ranges cover every column exactly once."""
    from tsne_flink_tpu_torch.ops import repulsion_cuda as rc
    for nloc, nfull in ((60_000, 60_000), (2000, 2000), (100, 100),
                        (20_011, 20_011), (1_306_127, 1_306_127),
                        (2472, 9472)):
        s = rc.column_splits(nloc, nfull, sms, 2, False)
        tiles = -(-nfull // rc.COLS_PER_TILE)
        assert 1 <= s <= tiles
        blocks = -(-nloc // rc.ROWS_PER_BLOCK) * s
        assert blocks >= min(rc.WAVES * sms * rc.BLOCKS_PER_SM,
                             -(-nloc // rc.ROWS_PER_BLOCK) * tiles)
        span = -(-nfull // s)
        assert (s - 1) * span < nfull <= s * span
    assert rc.column_splits(60_000, 60_000, 132, 2, False) == 36
