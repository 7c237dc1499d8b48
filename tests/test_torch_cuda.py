"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (sm_90a), so they
carry the ``cuda`` marker and skip elsewhere.  They import nothing of
JAX, so the card's machine runs them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The main-path shapes are checked by chip_smoke.py; these cover the edges:
tiny and ragged N, k = N - 1, exact ties, every metric, m = 3, row
shards with validity masks, B5 from one slot to wide rows, B5 as the
fused step's head, and launch counting.
"""

import numpy as np
import pytest
import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.ops import attraction_cuda as att
from tsne_flink_tpu_torch.ops.knn import cosine_zbase
from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final, knn_sweep_cuda,
                                               knn_sweep_plain)
from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

pytestmark = [pytest.mark.fast, pytest.mark.cuda]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,f,k", [(5, 3, 4), (70, 16, 9), (200, 50, 90),
                                   (1000, 33, 17)])
def test_knn_exact_ties_match_plain(dev, n, f, k):
    """Small-integer points: every distance is exact in f32, so kernel and
    plain must agree bit for bit, ties broken by the lowest column."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 3, (n, f)).astype(np.float32))
    x = x.to(dev)
    ik, dk = _fused_final(*knn_sweep_cuda(x, k, False), "sqeuclidean")
    ip, dp = _fused_final(*knn_sweep_plain(x, k, False), "sqeuclidean")
    assert torch.equal(dk, dp)
    assert torch.equal(ik, ip)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_knn_metrics_match_plain(dev, metric):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((777, 40)).astype(np.float32))
    base = cosine_zbase(x.to(dev)) if metric == "cosine" else x.to(dev)
    cos = metric == "cosine"
    ik, dk = _fused_final(*knn_sweep_cuda(base, 25, cos), metric)
    ip, dp = _fused_final(*knn_sweep_plain(base, 25, cos), metric)
    assert float((ik == ip).float().mean()) >= 0.999
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,m", [(97, 2), (530, 2), (257, 3)])
def test_repulsion_matches_plain(dev, n, m):
    rng = np.random.default_rng(0)
    y = torch.from_numpy((rng.standard_normal((n, m)) * 3).astype(
        np.float32)).to(dev)
    rk, zk = cuda_exact_repulsion(y)
    rp, zp = exact_repulsion(y)
    torch.testing.assert_close(rk, rp, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(zk, zp, rtol=2e-5, atol=0)


def test_repulsion_shards_and_validity(dev):
    rng = np.random.default_rng(1)
    n, n_pad = 200, 256
    y = np.zeros((n_pad, 2), np.float32)
    y[:n] = rng.standard_normal((n, 2))
    y = torch.from_numpy(y).to(dev)
    valid = torch.arange(n_pad, device=dev) < n
    for off in range(0, n_pad, 96):
        shard = y[off:off + 96].contiguous()
        rk, zk = cuda_exact_repulsion(shard, y, row_offset=off,
                                      col_valid=valid, row_z=True)
        rp, zp = exact_repulsion(shard, y, row_offset=off, col_valid=valid,
                                 row_z=True)
        torch.testing.assert_close(rk, rp, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(zk, zp, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("m", [2, 3])
def test_fused_step_and_loss_match_plain(dev, m):
    rng = np.random.default_rng(m)
    n, w = 300, 40

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    y = t(rng.standard_normal((n, m)))
    hidx = t(rng.integers(0, n, (n, w)), np.int32)
    hval = rng.random((n, w)) * 1e-3
    hval[rng.random((n, w)) < 0.3] = 0.0
    hval = t(hval)
    tail = t(1e-3 * rng.standard_normal((n, m)))
    repz = t(1e-3 * rng.standard_normal((n, m)))
    upd = t(1e-2 * rng.standard_normal((n, m)))
    gains = t(1.0 + rng.random((n, m)))
    valid = torch.arange(n, device=dev) < n - 7
    args = (y, y, hidx, hval, 4.0, tail, repz, valid, upd, gains, 0.5)
    kw = dict(eta=200.0, min_gain=0.01)
    ok = att.fused_step_update(*args, **kw)
    op = att.fused_step_plain(*args, **kw)
    assert torch.equal(ok[2], op[2])
    for a, b in zip(ok[:2], op[:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ok[3], op[3], rtol=1e-4, atol=1e-12)
    z = torch.tensor(123.0, device=dev)
    lk = att.attraction_loss(y, y, hidx, hval, 4.0, z)
    lp = att.attraction_loss_plain(y, y, hidx, hval, 4.0, z)
    # a row's KL terms take both signs and partly cancel: the absolute
    # part of the bar scales with the largest row, as in chip_smoke.py
    torch.testing.assert_close(lk, lp, rtol=2e-5,
                               atol=2e-5 * float(lp.abs().max()))


def _rows(dev, n, w, m, seed):
    rng = np.random.default_rng(seed)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    y = t(rng.standard_normal((n, m)) * 3)
    jidx = t(rng.integers(0, n, (n, w)), np.int32)
    jval = rng.random((n, w)) * 1e-3
    jval[rng.random((n, w)) < 0.3] = 0.0
    return y, jidx, t(jval)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("w", [1, 40, 3466])
def test_forces_match_plain_at_any_width(dev, m, w):
    """B5 takes every width: one slot, a CSR-head width, and the width of
    a hub-heavy graph's [N, S] rows (~110 slots per lane)."""
    y, jidx, jval = _rows(dev, 300, w, m, w + m)
    ak = att.attraction_forces(y, y, jidx, jval, 4.0)
    ap = att.attraction_forces_plain(y, y, jidx, jval, 4.0)
    torch.testing.assert_close(ak, ap, rtol=2e-5,
                               atol=2e-5 * float(ap.abs().max()))
    # a shard of rows against the full embedding
    ak = att.attraction_forces(y[100:200], y, jidx[100:200], jval[100:200],
                               1.0)
    ap = att.attraction_forces_plain(y[100:200], y, jidx[100:200],
                                     jval[100:200], 1.0)
    torch.testing.assert_close(ak, ap, rtol=2e-5,
                               atol=2e-5 * float(ap.abs().max()))


def test_forces_are_the_fused_steps_head(dev):
    """The unfused step from B5's forces against B3 on tie-free inputs:
    the gains ladder agrees exactly, y and update to rtol 1e-4."""
    y, hidx, hval = _rows(dev, 500, 64, 2, 9)
    forces = att.attraction_forces(y, y, hidx, hval, 4.0)
    rng = np.random.default_rng(10)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], y.shape).astype(
        np.float32)).to(dev)
    repz = 1e-3 * torch.randn(y.shape, device=dev)
    mag = forces.abs() + 1e-3 * forces.abs().max()
    tail = repz - forces + sign * mag  # every grad is ±(|att| + margin)
    upd = 1e-2 * torch.randn(y.shape, device=dev)
    gains = 1.0 + torch.rand(y.shape, device=dev)
    yk, uk, gk, _ = att.fused_step_update(y, y, hidx, hval, 4.0, tail, repz,
                                          None, upd, gains, 0.8, eta=200.0,
                                          min_gain=0.01)
    grad = (forces + tail) - repz
    same = (grad > 0.0) == (upd > 0.0)
    g = torch.clamp(torch.where(same, gains * 0.8, gains + 0.2), min=0.01)
    u = 0.8 * upd - 200.0 * g * grad
    assert torch.equal(gk, g)
    torch.testing.assert_close(uk, u, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(yk, y + u, rtol=1e-4, atol=1e-6)


def test_forces_wrapper_refuses_what_b5_does_not_take(dev):
    y, jidx, jval = _rows(dev, 50, 8, 2, 0)
    before = KERNELS["B5"].launches
    att.attraction_forces(y, y, jidx, jval, 1.0)
    att.attraction_forces(y.cpu(), y.cpu(), jidx.cpu(), jval.cpu(), 1.0)
    assert KERNELS["B5"].launches == before + 1
    for bad in (dict(y_local=y.double(), y_full=y.double()),
                dict(jidx=jidx.long()), dict(jval=jval[:, :4])):
        kw = dict(y_local=y, y_full=y, jidx=jidx, jval=jval, exag=1.0)
        kw.update(bad)
        with pytest.raises(ValueError, match="B5"):
            att.attraction_forces(**kw)
    assert KERNELS["B5"].launches == before + 1


def test_launches_count_kernel_launches_only(dev):
    y = torch.randn(64, 2, device=dev)
    before = KERNELS["B2"].launches
    cuda_exact_repulsion(y)
    cuda_exact_repulsion(y.cpu())  # the plain version: not a launch
    assert KERNELS["B2"].launches == before + 1
    with pytest.raises(TypeError):
        cuda_exact_repulsion(y.double())  # no fallback on a CUDA tensor
