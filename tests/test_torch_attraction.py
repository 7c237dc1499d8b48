"""PyTorch port, the fused CSR step (B3), KL pass (B4) and forces (B5) vs
the JAX package.

On the CPU the port's wrappers run their plain versions.  The JAX side
runs its Pallas kernels in interpret mode (``_run_fused``/``_run_loss``/
``_run_forces``, the wrappers with ``kernel="pallas-interpret"``) and its
XLA twins.  The inputs are those of
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
    """A CSR head [n, w], a src-sorted tail (row 0 a hub of 40 edges, the
    others 0-3) and the step's planes: rep [n, m] and Z = 37.5."""
    rng = np.random.default_rng(seed)
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


def _jax_step_planes(y, tail, rep, z=37.5, exag=4.0):
    """The JAX step's precomputed operands: the tail's forces
    (``models/tsne._edge_forces``) and rep / Z."""
    from tsne_flink_tpu.models.tsne import _edge_forces
    j = jnp.asarray
    tail_att = _edge_forces(j(y), j(y), *map(j, tail), jnp.asarray(
        exag, y.dtype))
    return tail_att, j(rep) / jnp.asarray(z, rep.dtype)


def test_index_gathering_step_matches_jax_fused_step_update(jax_kind):
    """The port's wrapper gathers y_full[hidx] itself and computes the
    tail's forces and rep / Z inside the step; the JAX wrapper takes them
    precomputed and gathers outside its kernel.  Same step, row-chunked
    differently."""
    y, hidx, hval, tail, rep, upd, gains = _csr_problem()
    valid = np.arange(y.shape[0]) < 140
    tail_att, repz = _jax_step_planes(y, tail, rep)
    want = jatt.fused_step_update(
        jnp.asarray(y), jnp.asarray(y), jnp.asarray(hidx), jnp.asarray(hval),
        jnp.float32(4.0), tail_att, repz,
        jnp.asarray(valid), jnp.asarray(upd), jnp.asarray(gains),
        jnp.float32(0.8), eta=1000.0, min_gain=0.01, row_chunk=64,
        kernel=jax_kind)
    t = torch.from_numpy
    rag = tatt.ragged_edges(*map(t, tail), y.shape[0])
    got = tatt.fused_step_update(t(y), t(y), t(hidx), t(hval), 4.0, t(rep),
                                 torch.tensor(37.5), t(valid), t(upd),
                                 t(gains), 0.8, eta=1000.0, min_gain=0.01,
                                 ragged=rag, row_chunk=48)
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


def _jax_forces(kind, yc, yj, val):
    args = (jnp.asarray(yc), jnp.asarray(yj), jnp.asarray(val),
            jnp.float32(4.0))
    if kind == "pallas-interpret":
        return jatt._run_forces(*args, interpret=True)
    return jatt._xla_forces(*args)


def test_forces_tile_matches_jax(jax_kind):
    """B5's plain version in f32 against the Pallas kernel (interpret
    mode) and the XLA twin: rtol 2e-5, the bar of tests/test_pallas.py."""
    yc, yj, val = _inputs()[:3]
    want = np.asarray(_jax_forces(jax_kind, yc, yj, val))
    got = tatt._plain_forces(*map(torch.from_numpy, (yc, yj, val)),
                             4.0).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


def test_forces_f64_match_xla_twin():
    yc, yj, val = (a.astype(np.float64) for a in _inputs()[:3])
    want = np.asarray(jatt._xla_forces(jnp.asarray(yc), jnp.asarray(yj),
                                       jnp.asarray(val), 4.0))
    got = tatt._plain_forces(*map(torch.from_numpy, (yc, yj, val)), 4.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("w", [16, 600])
def test_index_gathering_forces_match_jax_attraction_forces(jax_kind, w):
    """The port's wrapper gathers y_full[jidx] itself.  At W = 600 the JAX
    wrapper hands the Pallas kind to XLA (its VMEM bound); the port's
    kernel takes every width."""
    y, hidx, hval = _csr_problem(w=w)[:3]
    want = np.asarray(jatt.attraction_forces(
        jnp.asarray(y), jnp.asarray(y), jnp.asarray(hidx), jnp.asarray(hval),
        jnp.float32(4.0), row_chunk=64, kernel=jax_kind))
    t = torch.from_numpy
    got = tatt.attraction_forces(t(y), t(y), t(hidx), t(hval), 4.0,
                                 row_chunk=48).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())


def test_fused_head_is_the_forces():
    """The plain fused step runs the plain forces' head and tail math: its
    gradient is (forces over head + tail) − rep/Z bit for bit."""
    y, hidx, hval, tail, rep, upd, gains = _csr_problem()
    y, hidx, hval, rep, upd, gains = map(torch.from_numpy,
                                         (y, hidx, hval, rep, upd, gains))
    rag = tatt.ragged_edges(*map(torch.from_numpy, tail), y.shape[0])
    z = torch.tensor(37.5)
    att = tatt.attraction_forces(y, y, hidx, hval, 4.0, ragged=rag,
                                 row_chunk=48)
    _, _, _, gsq = tatt.fused_step_update(y, y, hidx, hval, 4.0, rep, z,
                                          None, upd, gains, 0.8, eta=1000.0,
                                          min_gain=0.01, ragged=rag,
                                          row_chunk=48)
    grad = att - rep / z
    assert torch.equal(gsq, torch.sum(grad * grad, dim=1))


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    y, hidx, hval = map(torch.from_numpy, _csr_problem()[:3])
    for kid in ("B3", "B4", "B5"):
        with pytest.raises(ValueError, match="CUDA"):
            tatt._check_cuda(kid, y, y, hidx, hval)
