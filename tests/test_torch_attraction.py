"""PyTorch port, the fused CSR step (B3) and KL pass (B4) vs the JAX package.

On the CPU the port's wrappers run their plain versions.  The JAX side
runs its Pallas kernels in interpret mode (``_run_fused``/``_run_loss``,
``fused_step_update(kernel="pallas-interpret")``) and its XLA twins.  The
inputs are those of
tests/test_fused_step.py::test_fused_interpret_pallas_matches_xla_twin:
tie-free, so the gains ladder must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.ops import attraction_pallas as jatt
from tsne_flink_tpu_torch.ops import attraction_cuda as tatt

pytestmark = pytest.mark.fast


def _inputs():
    rng = np.random.default_rng(3)
    c, w, m = 24, 32, 2
    f32 = np.float32
    yc = rng.standard_normal((c, m)).astype(f32)
    yj = rng.standard_normal((c, w, m)).astype(f32)
    val = rng.random((c, w)).astype(f32)
    val[:, -5:] = 0.0                       # padding lanes contribute zero
    tail = (0.1 * rng.standard_normal((c, m))).astype(f32)
    repz = (0.1 * rng.standard_normal((c, m))).astype(f32)
    mask = np.ones((c,), f32)
    mask[-3:] = 0.0                         # padded rows
    upd = (0.01 * rng.standard_normal((c, m))).astype(f32)
    gains = (1.0 + rng.random((c, m))).astype(f32)
    return yc, yj, val, tail, repz, mask, upd, gains


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


def _jax_fused(kind, ins):
    args = (*map(jnp.asarray, ins), jnp.float32(4.0), jnp.float32(0.5),
            200.0, 0.01)
    if kind == "pallas-interpret":
        return jatt._run_fused(*args, interpret=True)
    return jatt._xla_fused(*args)


def _jax_loss(kind, yc, yj, val):
    args = (jnp.asarray(yc), jnp.asarray(yj), jnp.asarray(val),
            jnp.float32(4.0), jnp.float32(37.5))
    if kind == "pallas-interpret":
        return jatt._run_loss(*args, interpret=True)
    return jatt._xla_loss(*args)


@pytest.fixture(params=["pallas-interpret", "xla"])
def jax_kind(request):
    if request.param == "pallas-interpret":
        request.getfixturevalue("pallas_interpret")
    return request.param


def test_fused_tile_matches_jax(jax_kind):
    ins = _inputs()
    want = _jax_fused(jax_kind, ins)
    got = tatt._plain_fused(*map(torch.from_numpy, ins), 4.0, 0.5, 200.0,
                            0.01)
    y_j, u_j, g_j, q_j = map(np.asarray, want)
    y_t, u_t, g_t, q_t = (t.numpy() for t in got)
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(u_t, u_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(q_t, q_j, rtol=1e-4, atol=1e-6)
    # padded rows: zero grad -> pure momentum decay
    np.testing.assert_allclose(u_t[-3:], 0.5 * ins[6][-3:], rtol=1e-6, atol=0)


def test_loss_tile_matches_jax(jax_kind):
    yc, yj, val = _inputs()[:3]
    want = np.asarray(_jax_loss(jax_kind, yc, yj, val))
    got = tatt._plain_loss(torch.from_numpy(yc), torch.from_numpy(yj),
                           torch.from_numpy(val), 4.0,
                           torch.tensor(37.5)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def _csr_problem(seed=4, n=150, w=16, m=2):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    y = rng.standard_normal((n, m)).astype(f32)
    hidx = rng.integers(0, n, (n, w)).astype(np.int32)
    hval = (rng.random((n, w)) * 1e-3).astype(f32)
    hval[rng.random((n, w)) < 0.2] = 0.0
    tail = (1e-3 * rng.standard_normal((n, m))).astype(f32)
    repz = (1e-3 * rng.standard_normal((n, m))).astype(f32)
    upd = (1e-2 * rng.standard_normal((n, m))).astype(f32)
    gains = (1.0 + rng.random((n, m))).astype(f32)
    return y, hidx, hval, tail, repz, upd, gains


def test_index_gathering_step_matches_jax_fused_step_update(jax_kind):
    """The port's wrapper gathers y_full[hidx] itself; the JAX wrapper
    gathers outside its kernel.  Same step, row-chunked differently."""
    y, hidx, hval, tail, repz, upd, gains = _csr_problem()
    valid = np.arange(y.shape[0]) < 140
    want = jatt.fused_step_update(
        jnp.asarray(y), jnp.asarray(y), jnp.asarray(hidx), jnp.asarray(hval),
        jnp.float32(4.0), jnp.asarray(tail), jnp.asarray(repz),
        jnp.asarray(valid), jnp.asarray(upd), jnp.asarray(gains),
        jnp.float32(0.8), eta=1000.0, min_gain=0.01, row_chunk=64,
        kernel=jax_kind)
    t = torch.from_numpy
    got = tatt.fused_step_update(t(y), t(y), t(hidx), t(hval), 4.0, t(tail),
                                 t(repz), t(valid), t(upd), t(gains), 0.8,
                                 eta=1000.0, min_gain=0.01, row_chunk=48)
    y_j, u_j, g_j, q_j = map(np.asarray, want)
    np.testing.assert_array_equal(got[2].numpy(), g_j)
    np.testing.assert_allclose(got[0].numpy(), y_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), u_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), q_j, rtol=1e-4, atol=1e-9)


def test_index_gathering_loss_matches_jax_attraction_loss(jax_kind):
    y, hidx, hval = _csr_problem()[:3]
    want = np.asarray(jatt.attraction_loss(
        jnp.asarray(y), jnp.asarray(y), jnp.asarray(hidx), jnp.asarray(hval),
        jnp.float32(1.0), jnp.float32(2.5e3), row_chunk=64, kernel=jax_kind))
    t = torch.from_numpy
    got = tatt.attraction_loss(t(y), t(y), t(hidx), t(hval), 1.0,
                               torch.tensor(2.5e3), row_chunk=48).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-9)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    y, hidx, hval = map(torch.from_numpy, _csr_problem()[:3])
    with pytest.raises(ValueError, match="CUDA"):
        tatt._check_cuda("B3", y, y, hidx, hval)
