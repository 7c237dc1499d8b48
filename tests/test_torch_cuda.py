"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (sm_90a), so they
carry the ``cuda`` marker and skip elsewhere.  They import nothing of
JAX, so the card's machine runs them without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The main-path shapes are checked by chip_smoke.py; these cover the edges:
tiny and ragged N, k = N - 1, exact ties, every metric, B1 at the large
run's width (F = 50 padded to 64, k = 150), at k = 256, 300 and 1,024
(its deep class) and past it (its pending class: k = 1,025, 2,048 and N
- 1, exact ties bit for bit, every form and the ring) against the
float64 graph, every embedding width
m = 1 .. 8 in B2-B5, row shards with validity masks, B2 below one tile
and at ragged N, two launches bit-identical, B5 from one slot to wide
rows, B5 and B4 over a row block and a ragged edge part (a hub row, a
row with no edges, the last row owning padding; no row block at all),
B3's one launch over head + tail bit for bit the unfused step (at every
m, with a mask, without a head block) and in any visit order,
``build_csr`` on the card equal to the CPU build, the fused CSR loop
launching B3 alone, the optimize loop on every layout without a segment
sum, B6's fused refine stages at every width
class and at k = 600 and 1,024 (exact ties bit-equal to the plain
stages; rows with fewer candidates than a stage keeps), the kNN methods
launching B1 and B6 on CUDA tensors, FFT repulsion on the card, the
wrappers refusing what the kernels do not take, launch counting, and the
batch job on the card: a checkpoint round trip, a fat-checkpoint resume
through the CLI with no kNN launch, and a warm artifact cache; and the
approximation policies: Barnes-Hut on CUDA tensors (bit for bit across
calls, ties included; within the error bars), a stride launching B2
only at its refreshes, the autopilot reading the host once a report
boundary, the sentinel's flag and telemetry on the card; and serving:
B2 with 256 query rows past a 60,000-row base against its plain version
(two launches bit for bit, a mask refused), the query loop launching B5
and B2 once an iteration a bucket and giving the same bits across batch
splits, and the daemon's answers equal to direct transforms; and a
fleet of two replica processes over one spool, one killed, answering bit
for bit as this process does; and the multi-controller job's kernels:
B1's cross sweep (the ring's hop) against its plain version and the ring
on the test mesh equal to the single sweep bit for bit, B6 with
``n_valid`` against its plain version, and a shard of two gloo processes
on the one card equal to the mesh-1 rows; B1's bf16-operand form against
its plain version (float64), its ring and a shard equal to its single
sweep bit for bit; and the float64 forms: B1_f64 against its plain
version (within 1e-12 of |d| + ‖a‖² + ‖b‖², ids equal outside ties; exact
ties bit for bit), its ring and a shard equal to its single sweep bit for
bit, B2_f64-B5_f64 at every m against their plain versions (rtol 1e-12,
gains equal), B3_f64's one launch the unfused float64 step bit for bit,
mesh 2 equal to mesh 1 at float64, float64 through the estimator (with
transform), the CLI and a fleet job on the card; B6_f64 in every B6 test
above (within 1e-12 of |d²| + ‖a‖² + ‖b‖², ids equal outside ties, kept
sets equal outside ties at the cut), a shard's rows of B6 and B6_f64 the
single launch's bit for bit, mixed dtypes refused with no launch, and
float64 with a refining kNN plan running through B6_f64 (``prepare``,
the estimator, the CLI's project line) with no float32 form; and the
wide forms (m > 8): B2w-B5w and their float64 forms against their plain
versions at m = 9 .. 256 (one and several force chunks), two launches
bit for bit, a B2w shard at the canonical split count the mesh-1 rows
bit for bit at m = 16, B3w the unfused step's bits, ``tsne_embed``
launching the wide forms alone, and the test mesh of 2 equal to the
mesh of 1 at m = 16; and B6's unstaged form past 12,288 features
(B6u, B6u_f64): the exact stage at F = 12,289, 16,384 and 32,768 on chip
(k = 90) and a first exact stage on the workspace route (k = 1,500)
against their plain versions (float32 also against float64: within twice
the plain float32 version's error, no id off outside that bar), forced
at staged widths the staged form's bits, forced forms refusing the
widths they do not take, the route mirror at those widths, and a
two-process project job at 12,289 features equal to the in-process job
bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.kernels.build import reset_launches
from tsne_flink_tpu_torch.ops import attraction_cuda as att
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops.knn import cosine_zbase
from tsne_flink_tpu_torch.ops.knn_cuda import (ROUTE_LAUNCHES, K_REG_MAX,
                                               _fused_final,
                                               cand_exact_plain, cand_sqdist,
                                               cand_sqdist_plain, knn_config,
                                               knn_sweep_cuda,
                                               knn_sweep_plain, refine_final,
                                               refine_final_plain,
                                               refine_keep,
                                               refine_keep_plain, tf32_split)
from tsne_flink_tpu_torch.ops.repulsion_fft import fft_repulsion
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
                                   (1000, 33, 17), (1300, 16, 1100),
                                   (2100, 12, 2048), (1100, 8, 1099)])
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


def _blobs(n, f, seed):
    """bench.make_data's MNIST-like blobs: 10 centres in [0, 1], noise
    0.15, clipped to [0, 1]: dense clusters with many near-ties."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, f)).astype(np.float32)
    x = centers[rng.integers(0, 10, n)] + 0.15 * rng.standard_normal(
        (n, f)).astype(np.float32)
    return np.clip(x, 0.0, 1.0)


def _cells(n, f, seed):
    """chip_smoke.make_cells' stand-in for the 1.3M cells' 50 principal
    components: Zipf-sized types in a 10-D latent, lifted with a decaying
    per-dim scale."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 31)
    labels = rng.choice(30, n, p=p / p.sum())
    z = 4.0 * rng.standard_normal((30, 10))[labels] + rng.standard_normal(
        (n, 10))
    scale = np.exp(-np.arange(f) / 12.0)
    lift = rng.standard_normal((10, f)) * scale
    x = z @ lift + 0.05 * scale * rng.standard_normal((n, f))
    return x.astype(np.float32)


def _set_agreement(a, b):
    """Mean over rows of |a_i ∩ b_i| / k for two [N, k] id lists."""
    hits = (a[:, :, None] == b[:, None, :]).any(dim=2)
    return float(hits.float().mean())


def _b1_gates(x, k, metric):
    """B1's bars against the float64 graph and its plain version: index
    agreement >= 0.999 with the float64 graph and >= the plain version's
    own; against plain, distances rtol 1e-4 and neighbour sets >= 0.999."""
    cos = metric == "cosine"
    base = cosine_zbase(x) if cos else x
    ik, dk = _fused_final(*knn_sweep_cuda(base, k, cos), metric)
    ip, dp = _fused_final(*knn_sweep_plain(base, k, cos), metric)
    i64, _ = _fused_final(*knn_sweep_plain(base.double(), k, cos), metric)
    agree_k = float((ik == i64).float().mean())
    agree_p = float((ip == i64).float().mean())
    assert agree_k >= 0.999 and agree_k >= agree_p, (agree_k, agree_p)
    torch.testing.assert_close(dk, dp, rtol=1e-4,
                               atol=1e-4 * float(dp.abs().max()))
    assert _set_agreement(ik, ip) >= 0.999
    return ik, dk


def _b1_pending_gates(x, k, metric):
    """B1's bar in its pending class (k > 1,024), the smoke's ``[bigk]``
    bar: against its plain version run in float64 on the same points,
    each distance within 1e-5 of the norm trick's terms |d| + ‖a‖² +
    ‖b‖² (3xTF32 drops lo·lo, ~2^-22 of a product) and the ids equal
    outside ties (a slot whose float64 distance lies within that
    tolerance of a neighbouring slot's, the (k+1)-th included); two
    launches bit for bit."""
    cos = metric == "cosine"
    base = cosine_zbase(x) if cos else x
    raw = knn_sweep_cuda(base, k, cos)
    again = knn_sweep_cuda(base, k, cos)
    assert torch.equal(raw[0], again[0]) and torch.equal(raw[1], again[1])
    ik, dk = _fused_final(*raw, "sqeuclidean")
    b64 = base.double()
    kk = min(k + 1, x.shape[0] - 1)
    dp, ip = knn_sweep_plain(b64, kk, cos)
    r = torch.sum(b64 * b64, dim=1)
    tol = 1e-5 * (dp.abs() + r[:, None] + r[ip.long()])
    assert bool(((dk.double() - dp[:, :k]).abs() <= tol[:, :k]).all())
    gap = dp[:, 1:] - dp[:, :-1]
    tied = torch.zeros_like(ik, dtype=torch.bool)
    tied[:, :gap.shape[1]] |= gap[:, :k] <= tol[:, :gap.shape[1]]
    tied[:, 1:] |= gap[:, :k - 1] <= tol[:, 1:k]
    assert int((~((ik.long() == ip[:, :k].long()) | tied)).sum()) == 0


@pytest.mark.parametrize("data,n,f,k,metric", [
    ("blobs", 3000, 784, K_REG_MAX + 1, "sqeuclidean"),
    ("cells", 3000, 50, 2048, "sqeuclidean"),
    ("blobs", 2000, 784, 1500, "cosine"),
    ("blobs", 1300, 100, 1299, "euclidean"),     # k = N - 1
])
def test_knn_pending_class_meets_its_bars(dev, data, n, f, k, metric):
    x = torch.from_numpy((_cells if data == "cells" else _blobs)(n, f, k))
    _b1_pending_gates(x.to(dev), k, metric)


@pytest.mark.parametrize("data,n,f,k,metric", [
    ("cells", 6000, 50, 150, "sqeuclidean"),    # the large run's width
    ("blobs", 3000, 784, 256, "sqeuclidean"),   # the 1-buffer class
    ("cells", 4000, 50, 300, "sqeuclidean"),    # the deep class
    ("blobs", 3000, 784, K_REG_MAX, "sqeuclidean"),  # the deep class's top
    ("blobs", 2500, 784, 140, "euclidean"),      # the 2-stage class
    ("blobs", 2000, 784, 90, "cosine"),
    ("blobs", 1111, 100, 33, "sqeuclidean"),     # N, F off every tile edge
])
def test_knn_meets_its_bars_against_float64(dev, data, n, f, k, metric):
    x = torch.from_numpy((_cells if data == "cells" else _blobs)(n, f, k))
    _b1_gates(x.to(dev), k, metric)


def test_knn_distances_are_the_three_pass_split_products(dev):
    """The kernel's distances are the 3xTF32 products of tf32_split's
    parts (emulated in float64) to within 1e-5 of the distance scale."""
    x = torch.from_numpy(_blobs(1200, 784, 2)).to(dev)
    dk, ik = knn_sweep_cuda(x, 90, False)
    x64 = x.double()
    hi, lo = (p.double() for p in tf32_split(x))
    n2 = torch.sum(x64 * x64, dim=1)
    d3 = torch.clamp(n2[:, None] + n2[None, :]
                     - 2.0 * (lo @ hi.T + hi @ lo.T + hi @ hi.T), min=0)
    want = torch.gather(d3, 1, ik.long())
    scale = float(d3.max())
    assert float(torch.max(torch.abs(dk.double() - want))) <= 1e-5 * scale


def test_knn_configs_fit_and_launches_repeat_bitwise(dev):
    """Each k class's (rows, stages, buffers) fit the block's shared
    memory, and two launches give the same bits, in every class."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    configs = {k: knn_config(k) for k in (1, 90, 128, 129, 150, 160, 161,
                                          256, 257, 600, K_REG_MAX,
                                          K_REG_MAX + 1, 4096, 50_000)}
    assert configs[90][:3] == (64, 3, 2) and configs[150][:3] == (64, 2, 2)
    assert configs[256][:3] == (64, 2, 1)
    assert configs[257][:3] == (16, 3, 2)
    assert configs[K_REG_MAX][:3] == (16, 3, 2)
    assert all(c[4] == 0 for k, c in configs.items() if k <= K_REG_MAX)
    assert all(c[:3] == (16, 3, 2) and c[4] == 1024
               for k, c in configs.items() if k > K_REG_MAX)
    assert all(smem <= limit for _, _, _, smem, _ in configs.values())
    x = torch.from_numpy(_blobs(1500, 784, 1)).to(dev)
    for k in (90, 700, 1400):
        a = knn_sweep_cuda(x, k, False)
        b = knn_sweep_cuda(x, k, False)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_knn_refuses_k_past_its_deep_class(dev):
    """Past the deep class B1 refuses nothing: k = 1,025 launches its
    pending class once, which gives the plain sweep's graph bit for bit
    on exact distances; k past N - 1 is still refused, with no launch."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 4, (1500, 64)).astype(
        np.float32)).to(dev)
    before = KERNELS["B1"].launches
    pending = ROUTE_LAUNCHES.get("B1 pending", 0)
    raw = knn_sweep_cuda(x, K_REG_MAX + 1, False)
    assert KERNELS["B1"].launches == before + 1
    assert ROUTE_LAUNCHES["B1 pending"] == pending + 1
    ik, dk = _fused_final(*raw, "sqeuclidean")
    ip, dp = _fused_final(*knn_sweep_plain(x, K_REG_MAX + 1, False),
                          "sqeuclidean")
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    with pytest.raises(ValueError, match="B1"):
        knn_sweep_cuda(x, 1500, False)
    assert KERNELS["B1"].launches == before + 1


@pytest.mark.parametrize("n,m", [(97, 2), (530, 2), (257, 3), (97, 1),
                                 (530, 4), (257, 5), (300, 8)])
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


def _close_scaled(a, b, rtol=2e-5):
    """rtol with an absolute part of rtol·max|b|, as chip_smoke.py holds
    B2: a sum over N columns cancels to well below its terms."""
    torch.testing.assert_close(a, b, rtol=rtol,
                               atol=rtol * float(b.abs().max()))


@pytest.mark.parametrize("n,m", [(100, 2), (100, 3), (3001, 2),
                                 (20_011, 3), (20_011, 2), (3001, 1),
                                 (20_011, 4), (3001, 7), (20_011, 8)])
def test_repulsion_below_a_tile_and_ragged(dev, n, m):
    """N below one 512-row block; N off every multiple of the block's
    rows and of the column splits (20,011 rows take S > 1)."""
    rng = np.random.default_rng(n + m)
    y = torch.from_numpy((rng.standard_normal((n, m)) * 20.0).astype(
        np.float32)).to(dev)
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True)
    _close_scaled(rk, rp)
    _close_scaled(zk, zp)
    assert abs(float(zk.sum()) - float(zp.sum())) <= 2e-5 * float(zp.sum())


def test_repulsion_shards_validity_and_bitwise_repeat(dev):
    """Row shards at a row_offset with a column mask, m = 3, at a size
    that splits the columns; two launches give the same bits."""
    rng = np.random.default_rng(7)
    n, n_pad = 9000, 9472
    y = np.zeros((n_pad, 3), np.float32)
    y[:n] = rng.standard_normal((n, 3)) * 10.0
    y = torch.from_numpy(y).to(dev)
    valid = torch.arange(n_pad, device=dev) < n
    for off in (0, 3001, 7000):
        shard = y[off:off + 2472].contiguous()
        rk, zk = cuda_exact_repulsion(shard, y, row_offset=off,
                                      col_valid=valid, row_z=True)
        rp, zp = exact_repulsion(shard, y, row_offset=off, col_valid=valid,
                                 row_z=True)
        _close_scaled(rk, rp)
        _close_scaled(zk, zp)
        again = cuda_exact_repulsion(shard, y, row_offset=off,
                                     col_valid=valid, row_z=True)
        assert torch.equal(again[0], rk) and torch.equal(again[1], zk)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 6, 8])
def test_fused_step_and_loss_match_plain(dev, m):
    """B3 over a head block and a ragged tail (a hub row, an empty row,
    padding), with a padded-row mask, against its plain version; B4 over
    the head."""
    y, hidx, hval, rag = _ragged_problem(dev, 300, 40, m, 50 + m)
    n = y.shape[0]
    rng = np.random.default_rng(m)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    rep = t(0.1 * rng.standard_normal((n, m)))
    z = torch.tensor(123.0, device=dev)
    upd = t(1e-2 * rng.standard_normal((n, m)))
    gains = t(1.0 + rng.random((n, m)))
    valid = torch.arange(n, device=dev) < n - 7
    args = (y, y, hidx, hval, 4.0, rep, z, valid, upd, gains, 0.5)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
    ok = att.fused_step_update(*args, **kw)
    op = att.fused_step_plain(*args, **kw)
    assert torch.equal(ok[2], op[2])
    for a, b in zip(ok[:2], op[:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ok[3], op[3], rtol=1e-4, atol=1e-12)
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


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
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


def _unfused_step(y, forces, rep, z, upd, gains, momentum, eta, valid=None):
    """The unfused step in PyTorch: grad = forces − rep / z (masked), then
    the vdM update (models/tsne._update_embedding's operations)."""
    grad = forces - rep / z
    if valid is not None:
        grad = grad * valid[:, None].to(grad.dtype)
    same = (grad > 0.0) == (upd > 0.0)
    g = torch.clamp(torch.where(same, gains * 0.8, gains + 0.2), min=0.01)
    u = momentum * upd - eta * g * grad
    return y + u, u, g


def test_forces_are_the_fused_steps_head(dev):
    """B3 over a head block alone against B5's forces over it and the
    unfused step in PyTorch: the same bits."""
    y, hidx, hval = _rows(dev, 500, 64, 2, 9)
    forces = att.attraction_forces(y, y, hidx, hval, 4.0)
    rep = 1e-1 * torch.randn(y.shape, device=dev)
    z = torch.tensor(37.0, device=dev)
    upd = 1e-2 * torch.randn(y.shape, device=dev)
    gains = 1.0 + torch.rand(y.shape, device=dev)
    yk, uk, gk, _ = att.fused_step_update(y, y, hidx, hval, 4.0, rep, z,
                                          None, upd, gains, 0.8, eta=200.0,
                                          min_gain=0.01)
    want = _unfused_step(y, forces, rep, z, upd, gains, 0.8, 200.0)
    for got, w in zip((yk, uk, gk), want):
        assert torch.equal(got, w)


def test_forces_wrapper_refuses_what_b5_does_not_take(dev):
    y, jidx, jval = _rows(dev, 50, 8, 2, 0)
    _, _, _, rag = _ragged_problem(dev, 50, 8, 2, 0)
    before = KERNELS["B5"].launches
    att.attraction_forces(y, y, jidx, jval, 1.0)
    att.attraction_forces(y.cpu(), y.cpu(), jidx.cpu(), jval.cpu(), 1.0)
    assert KERNELS["B5"].launches == before + 1
    y0 = torch.zeros((50, 0), device=dev)
    for bad in (dict(y_local=y.double(), y_full=y.double()),
                dict(jidx=jidx.long()), dict(jval=jval[:, :4]),
                dict(y_local=y0, y_full=y0),
                dict(ragged=rag._replace(rowptr=rag.rowptr.int())),
                dict(ragged=rag._replace(dst=rag.dst.long())),
                dict(ragged=rag._replace(rowptr=rag.rowptr[:-1]))):
        kw = dict(y_local=y, y_full=y, jidx=jidx, jval=jval, exag=1.0)
        kw.update(bad)
        with pytest.raises(ValueError, match="B5"):
            att.attraction_forces(**kw)
    with pytest.raises(ValueError, match="B4"):
        att.attraction_loss(y0, y0, jidx, jval, 1.0, 1.0)
    with pytest.raises(ValueError, match="B3"):
        att.fused_step_update(y0, y0, jidx, jval, 1.0, y0, 1.0, None, y0, y0,
                              0.5, eta=1.0, min_gain=0.01)
    planes = (y, torch.tensor(1.0, device=dev), None, y, y, 0.5)
    for bad in (dict(order=torch.arange(50, device=dev)),
                dict(order=torch.arange(49, device=dev, dtype=torch.int32)),
                dict(ragged=rag._replace(dst=rag.dst.long()))):
        with pytest.raises(ValueError, match="B3"):
            att.fused_step_update(y, y, jidx, jval, 1.0, *planes, eta=1.0,
                                  min_gain=0.01, **bad)
    with pytest.raises(ValueError, match="B2"):
        cuda_exact_repulsion(y0)
    with pytest.raises(ValueError, match="B2"):
        cuda_exact_repulsion(y, torch.zeros((50, 3), device=dev))
    assert KERNELS["B5"].launches == before + 1


def _ragged_problem(dev, n, w, m, seed):
    """y [n, m], a row block [n, w] (30% padding; None when w = 0) and a
    src-sorted edge list in its Ragged form: row 0 a hub of 3,000 edges,
    row 1 with none, the others 0-11, then 700 padding edges (value 0)
    owned by the last row."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    y = t(rng.standard_normal((n, m)) * 3)
    jidx = jval = None
    if w:
        jidx = t(rng.integers(0, n, (n, w)), np.int32)
        v = rng.random((n, w)) * 1e-3
        v[rng.random((n, w)) < 0.3] = 0.0
        jval = t(v)
    deg = rng.integers(0, 12, n)
    deg[0], deg[1] = 3000, 0
    src = np.concatenate([np.repeat(np.arange(n), deg), np.full(700, n - 1)])
    dst = np.concatenate([rng.integers(0, n, int(deg.sum())),
                          np.zeros(700, np.int64)])
    val = np.concatenate([rng.random(int(deg.sum())) * 1e-3, np.zeros(700)])
    rag = att.ragged_edges(t(src, np.int32), t(dst, np.int32), t(val), n)
    return y, jidx, jval, rag


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("w", [0, 90, 150])
def test_forces_and_loss_with_a_ragged_part_match_plain(dev, m, w):
    """B5 and B4 over a row block and a ragged edge part in one launch
    (the blocks layout, a CSR head + tail) or over the edges alone (the
    edges layout, w = 0), against forward + ragged in plain PyTorch; two
    launches bit-identical; the hub row, the row with no edges and the
    last row with its padding among them."""
    y, jidx, jval, rag = _ragged_problem(dev, 700, w, m, 10 * m + w)
    ak = att.attraction_forces(y, y, jidx, jval, 4.0, ragged=rag)
    ap = att.attraction_forces_plain(y, y, jidx, jval, 4.0, ragged=rag)
    _close_scaled(ak, ap)
    assert torch.equal(ak, att.attraction_forces(y, y, jidx, jval, 4.0,
                                                 ragged=rag))
    z = torch.tensor(321.0, device=dev)
    lk = att.attraction_loss(y, y, jidx, jval, 1.0, z, ragged=rag)
    lp = att.attraction_loss_plain(y, y, jidx, jval, 1.0, z, ragged=rag)
    _close_scaled(lk, lp)
    assert abs(float(lk.sum()) - float(lp.sum())) <= 2e-5 * float(
        lp.abs().sum())
    assert torch.equal(lk, att.attraction_loss(y, y, jidx, jval, 1.0, z,
                                               ragged=rag))
    # a shard of rows against the full embedding, with its own segments
    sl = slice(300, 500)
    sub = att.ragged_edges(*(a[int(rag.rowptr[300]):int(rag.rowptr[500])]
                             for a in (rag.src - 300, rag.dst, rag.val)),
                           200)
    blk = (None, None) if jidx is None else (jidx[sl], jval[sl])
    _close_scaled(att.attraction_forces(y[sl], y, *blk, 1.0, ragged=sub),
                  att.attraction_forces_plain(y[sl], y, *blk, 1.0,
                                              ragged=sub))


def test_forces_with_a_ragged_part_are_the_sum_of_its_parts(dev):
    """One launch over head + tail gives the bits of the head's launch
    plus the tail's, added in f32: the unfused CSR step and the fused one
    (B3, which walks the head and then the tail) see the same forces."""
    y, jidx, jval, rag = _ragged_problem(dev, 900, 64, 2, 3)
    both = att.attraction_forces(y, y, jidx, jval, 4.0, ragged=rag)
    head = att.attraction_forces(y, y, jidx, jval, 4.0)
    tail = att.attraction_forces(y, y, None, None, 4.0, ragged=rag)
    assert torch.equal(both, head + tail)
    z = torch.tensor(55.0, device=dev)
    assert torch.equal(
        att.attraction_loss(y, y, jidx, jval, 1.0, z, ragged=rag),
        att.attraction_loss(y, y, jidx, jval, 1.0, z)
        + att.attraction_loss(y, y, None, None, 1.0, z, ragged=rag))


def test_fused_csr_step_with_its_b5_tail_equals_the_unfused_step(dev):
    """B3 over the head and the tail in one launch against B5 over head +
    tail and the vdM update in PyTorch: the same bits."""
    y, hidx, hval, rag = _ragged_problem(dev, 900, 64, 2, 4)
    forces = att.attraction_forces(y, y, hidx, hval, 4.0, ragged=rag)
    rep = 1e-1 * torch.randn(y.shape, device=dev)
    z = torch.tensor(3.7, device=dev)
    upd = 1e-2 * torch.randn(y.shape, device=dev)
    gains = 1.0 + torch.rand(y.shape, device=dev)
    yk, uk, gk, _ = att.fused_step_update(y, y, hidx, hval, 4.0, rep, z,
                                          None, upd, gains, 0.8, eta=200.0,
                                          min_gain=0.01, ragged=rag)
    want = _unfused_step(y, forces, rep, z, upd, gains, 0.8, 200.0)
    for got, w in zip((yk, uk, gk), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_one_launch_equals_the_unfused_step_bit_for_bit(dev, m, masked):
    """B3's one launch over a CSR head and tail (row 0 a hub of 3,000
    tail edges, row 1 with none, the last row owning padding) against B5
    over head + tail, att − rep/Z and the vdM update: the same bits, at
    every m; and with the tail alone (W = 0), as B5 selects its instance."""
    y, hidx, hval, rag = _ragged_problem(dev, 700, 48, m, 70 + m)
    n = y.shape[0]
    rep = 1e-1 * torch.randn(y.shape, device=dev)
    z = torch.tensor(1.0 + 0.37 * m, device=dev)
    upd = 1e-2 * torch.randn(y.shape, device=dev)
    gains = 1.0 + torch.rand(y.shape, device=dev)
    valid = (torch.arange(n, device=dev) % 9 != 4) if masked else None
    for blk in ((hidx, hval), (None, None)):
        got = att.fused_step_update(y, y, *blk, 4.0, rep, z, valid, upd,
                                    gains, 0.5, eta=200.0, min_gain=0.01,
                                    ragged=rag)
        forces = att.attraction_forces(y, y, *blk, 4.0, ragged=rag)
        want = _unfused_step(y, forces, rep, z, upd, gains, 0.5, 200.0,
                             valid)
        for a, b in zip(got[:3], want):
            assert torch.equal(a, b)


def test_visit_order_moves_no_bit_on_the_card(dev):
    """B3 with its rows visited hubs first (and in a random order) gives
    the bits of the launch in index order."""
    y, hidx, hval, rag = _ragged_problem(dev, 2000, 64, 2, 12)
    rep = 1e-1 * torch.randn(y.shape, device=dev)
    z = torch.tensor(5.0, device=dev)
    upd = 1e-2 * torch.randn(y.shape, device=dev)
    gains = 1.0 + torch.rand(y.shape, device=dev)
    args = (y, y, hidx, hval, 4.0, rep, z, None, upd, gains, 0.8)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
    base = att.fused_step_update(*args, **kw)
    shuffled = torch.randperm(y.shape[0], device=dev).to(torch.int32)
    for order in (att.visit_order(rag), shuffled):
        for a, b in zip(att.fused_step_update(*args, order=order, **kw),
                        base):
            assert torch.equal(a, b)


@pytest.mark.parametrize("width", [8, 16, 48, 64])
def test_build_csr_on_the_card_equals_the_cpu_build(dev, width):
    """``build_csr`` on CUDA tensors gives the CPU build's arrays: the same
    head, the same padded tail, the same order within each row."""
    rng = np.random.default_rng(width)
    n, s = 3000, 48
    jidx = torch.from_numpy(rng.integers(0, n, (n, s)).astype(np.int32))
    v = rng.random((n, s)).astype(np.float32)
    v[rng.random((n, s)) < 0.6] = 0.0
    v[::50, :] = np.where(v[::50, :] > 0, v[::50, :], 1e-3)  # hubs
    v[7] = 0.0  # a row with no entry
    jval = torch.from_numpy(v)
    cpu = att.build_csr(jidx, jval, width)
    card = att.build_csr(jidx.to(dev), jval.to(dev), width)
    for a, b in zip(card[0] + card[1], cpu[0] + cpu[1]):
        assert a.is_cuda and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


def test_fused_csr_optimize_launches_b3_alone(dev):
    """A fused CSR optimize is one B3 launch an iteration (no B5), B4
    every tenth, B2 every iteration."""
    from tsne_flink_tpu_torch.models.tsne import (TsneConfig,
                                                  _plan_layout,
                                                  init_working_set,
                                                  optimize)
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    x = _blobs(1200, 32, 3)
    prep = prepare(x, neighbors=30, perplexity=10.0, device=dev)
    cfg = TsneConfig(perplexity=10.0, iterations=30, attraction="csr")
    _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    st = init_working_set(None, 1200, 2, torch.float32, dev,
                          y0=np.random.default_rng(1).standard_normal(
                              (1200, 2)) * 1e-2)
    reset_launches()
    st, _ = optimize(st, prep.jidx, prep.jval, cfg, csr=csr)
    assert bool(torch.isfinite(st.y).all())
    assert KERNELS["B3"].launches == 30
    assert KERNELS["B5"].launches == 0
    assert KERNELS["B4"].launches == 3
    assert KERNELS["B2"].launches == 30


@pytest.mark.parametrize("layout", ["csr", "rows", "edges", "blocks"])
def test_optimize_runs_each_layout_without_a_segment_sum(dev, layout,
                                                         monkeypatch):
    """A short optimize on every layout launches B5 (B3 on the fused CSR
    layout) each iteration and B4 every tenth, calls no
    torch.segment_reduce on a CUDA tensor, and
    reports the KL its plain run on the CPU reports (rtol 1e-3, at
    iterations 10 and 20)."""
    from tsne_flink_tpu_torch.models.tsne import (TsneConfig,
                                                  _plan_layout,
                                                  init_working_set,
                                                  optimize)
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    real = torch.segment_reduce

    def refuse(data, *a, **kw):
        assert not data.is_cuda, "segment_reduce on a CUDA tensor"
        return real(data, *a, **kw)

    x = _blobs(1500, 32, 5)
    ends = {}
    for d in ("cpu", dev):
        prep = prepare(x, neighbors=30, perplexity=10.0,
                       assembly="blocks" if layout == "blocks" else "auto",
                       device=d)
        cfg = TsneConfig(perplexity=10.0, iterations=20,
                         attraction="auto" if layout == "blocks" else layout)
        if layout == "blocks":
            edges, csr = prep.extra_edges, None
        else:
            edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
        st = init_working_set(None, 1500, 2, torch.float32, d,
                              y0=np.random.default_rng(0).standard_normal(
                                  (1500, 2)) * 1e-2)
        monkeypatch.setattr(torch, "segment_reduce", refuse)
        reset_launches()
        st, losses = optimize(st, prep.jidx, prep.jval, cfg, edges=edges,
                              edges_extra=layout == "blocks", csr=csr)
        monkeypatch.setattr(torch, "segment_reduce", real)
        assert bool(torch.isfinite(st.y).all())
        ends[str(d)] = losses.cpu()
        if d != "cpu":
            assert KERNELS["B5"].launches == (0 if layout == "csr" else 20)
            assert KERNELS["B4"].launches == 2
            assert KERNELS["B3"].launches == (20 if layout == "csr" else 0)
    torch.testing.assert_close(ends["cuda"], ends["cpu"], rtol=1e-3, atol=0)


def test_launches_count_kernel_launches_only(dev):
    y = torch.randn(64, 2, device=dev)
    before = KERNELS["B2"].launches
    cuda_exact_repulsion(y)
    cuda_exact_repulsion(y.cpu())  # the plain version: not a launch
    assert KERNELS["B2"].launches == before + 1
    before64 = KERNELS["B2_f64"].launches
    cuda_exact_repulsion(y.double())  # float64: its own form, counted so
    assert KERNELS["B2"].launches == before + 1
    assert KERNELS["B2_f64"].launches == before64 + 1
    with pytest.raises(TypeError):
        cuda_exact_repulsion(y.half())  # no fallback on a CUDA tensor


def _refine_problem(dev, n, f, k, c, seed, lattice=False,
                    dtype=torch.float32):
    """Points (of ``dtype``), their squared norms, a graph [n, k] of
    distinct non-self ids with the formula's distances ordered by (d, id),
    and the gateways [c, 16] of rows 0 .. c-1: random ids, one repeated,
    and the row itself (as the caller's gateway dedup leaves it)."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 3, (n, f)) if lattice else rng.random((n, f)))
    x = torch.from_numpy(x).to(dev, dtype)
    sq = torch.sum(x * x, dim=1)
    ids = np.stack([(i + 1 + rng.choice(n - 1, k, replace=False)) % n
                    for i in range(n)]).astype(np.int32)
    graph = torch.from_numpy(ids).to(dev)
    rows = torch.arange(n, device=dev)
    dist = cand_sqdist_plain(x, sq, rows, graph)
    by_id = torch.argsort(graph, dim=1, stable=True)
    graph, dist = torch.gather(graph, 1, by_id), torch.gather(dist, 1, by_id)
    by_d = torch.argsort(dist, dim=1, stable=True)
    graph = torch.gather(graph, 1, by_d).contiguous()
    dist = torch.gather(dist, 1, by_d).contiguous()
    gates = torch.from_numpy(rng.integers(0, n, (c, 16)).astype(
        np.int32)).to(dev)
    gates[:, 1] = gates[:, 2]
    gates[:, 0] = rows[:c].to(torch.int32)
    return x, sq, graph, dist, gates


def _valid_ids(ids, bad=None):
    return torch.where(bad, -1, ids) if bad is not None else ids


#: B1_f64's bar, which B6_f64 is held to: 1e-12 of |d| + ‖a‖² + ‖b‖²
F64_RTOL = 1e-12


#: every form of B6: staged and unstaged, float32 and float64
B6_FORMS = ("B6", "B6_f64", "B6u", "B6u_f64")


def _b6_form(base):
    """The B6 form a stage on ``base`` launches: B6_f64 on float64 values,
    the unstaged form (B6u, B6u_f64) past 12,288 features."""
    from tsne_flink_tpu_torch.kernels.build import form_id
    return form_id("B6", base.dtype == torch.float64, base.shape[1])


def _f64_tol(sq, rows, ids, d2):
    """B1_f64's bar: 1e-12 of |d²| + ‖a‖² + ‖b‖² for each (row, id)."""
    safe = torch.where(ids >= 0, ids, rows[:, None]).long()
    return F64_RTOL * (d2.abs() + sq[rows][:, None] + sq[safe])


def _off_outside_ties(got, want, wd, tol):
    """Slots whose ids differ where the plain distance has no neighbour
    within ``tol`` (a tie may order either way)."""
    gap = (wd[:, 1:] - wd[:, :-1]).abs()
    tied = torch.zeros_like(got, dtype=torch.bool)
    tied[:, :-1] |= gap <= tol[:, :-1]
    tied[:, 1:] |= gap <= tol[:, 1:]
    return int((~((got == want) | tied)).sum())


def _hold_final(args, kw, exact, kid=None):
    """Kernel vs plain on one exact stage: bit-equal where every value is
    exact (lattice data), else the smoke's bars (float32: rtol 2e-5, sets
    >= 0.999; float64: each distance within 1e-12 of |d²| + ‖a‖² + ‖b‖²,
    squared for euclidean, and the ids equal outside ties).  ``kid``
    (None: the form F takes) is the form the launches count under."""
    metric, base, sq, row0, _, old_i, old_d = args
    kid = kid or _b6_form(base)
    before = {k: KERNELS[k].launches for k in B6_FORMS}
    gi, gd = refine_final(*args, **kw)
    again = refine_final(*args, **kw)
    assert KERNELS[kid].launches == before[kid] + 2
    assert sum(KERNELS[k].launches - v for k, v in before.items()) == 2
    wi, wd = refine_final_plain(*args, **kw)
    assert gd.dtype == base.dtype and gi.dtype == torch.int32
    assert torch.equal(gi, again[0]) and torch.equal(gd, again[1])
    if exact:
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        return
    rows = torch.arange(row0, row0 + gi.shape[0], device=gi.device)
    formula = cand_exact_plain(metric, base, sq, rows, gi)
    if base.dtype == torch.float64:
        sqr = 2 if metric == "euclidean" else 1
        tol = _f64_tol(sq, rows, gi, formula ** sqr)
        assert bool(((gd ** sqr - formula ** sqr).abs() <= tol).all())
        wtol = _f64_tol(sq, rows, wi, wd ** sqr)
        assert _off_outside_ties(gi, wi, wd ** sqr, wtol) == 0
    else:
        torch.testing.assert_close(gd, formula, rtol=2e-5,
                                   atol=2e-5 * float(formula.max()))
        torch.testing.assert_close(gd[:, -1], wd[:, -1], rtol=2e-5,
                                   atol=2e-5 * float(wd.max()))
        assert _set_agreement(gi.long(), wi.long()) >= 0.999
    assert not bool((gi == rows[:, None]).any())
    same = gd[:, 1:] == gd[:, :-1]
    assert bool(((gd[:, 1:] > gd[:, :-1]) | (same & (gi[:, 1:] > gi[:, :-1])))
                .all())


def _hold_keep(args, kw, exact, kid=None):
    """Kernel vs plain on one keep stage: the same ids on exact values;
    else each row keeps as many, and the kept sets agree >= 0.999
    (float32) or exactly outside ties at the cut (float64: an id in one
    set alone scores within 1e-12 of |s| + ‖a‖² + ‖b‖² of the plain
    stage's last kept score).  ``kid`` as :func:`_hold_final`'s."""
    base, sq, row0, _, keep = args
    kid = kid or _b6_form(base)
    before = KERNELS[kid].launches
    gi, none = refine_keep(*args, **kw)
    assert none is None and gi.dtype == torch.int32
    assert torch.equal(gi, refine_keep(*args, **kw)[0])
    assert KERNELS[kid].launches == before + 2
    wi = _valid_ids(*refine_keep_plain(*args, **kw)).to(torch.int32)
    if exact:
        assert torch.equal(gi, wi)
        return gi
    kept = (wi >= 0).sum(dim=1)
    assert torch.equal((gi >= 0).sum(dim=1), kept)
    hits = (gi[:, :, None] == wi[:, None, :]).any(dim=2) & (gi >= 0)
    if base.dtype == torch.float32:
        assert float(hits.sum()) / float((gi >= 0).sum()) >= 0.999
        return gi
    rows = torch.arange(row0, row0 + gi.shape[0], device=gi.device)
    back = (wi[:, :, None] == gi[:, None, :]).any(dim=2) & (wi >= 0)
    sw = cand_sqdist_plain(base, sq, rows, torch.where(wi >= 0, wi,
                                                       rows[:, None]))
    cut = torch.gather(sw, 1, torch.clamp(kept - 1, min=0)[:, None])
    for ids, hit in ((gi, hits), (wi, back)):
        alone = (ids >= 0) & ~hit
        s = cand_sqdist_plain(base, sq, rows, torch.where(ids >= 0, ids,
                                                          rows[:, None]))
        tol = _f64_tol(sq, rows, ids, cut.expand_as(s))
        assert bool(((s - cut).abs() <= tol)[alone].all())
    return gi


@pytest.mark.parametrize("f,k,metric,lattice", [
    (50, 150, "sqeuclidean", False),  # the cells' shape class
    (3, 12, "euclidean", False),
    (63, 40, "sqeuclidean", False),   # the last thread-per-candidate F
    (64, 40, "euclidean", False),     # the first warp-per-candidate F
    (16, 20, "sqeuclidean", True),    # exact ties, by id
    (16, 20, "euclidean", True),      # ties after the sqrt
    (50, 600, "sqeuclidean", False),  # past k = 512: 2k = 1,200 sort keys
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_first_exact_stage_matches_plain(dev, f, k, metric, lattice,
                                                dtype):
    """A chunk whose first stage is the exact one (no funnel): candidates
    built from the gateways, deduped, scored, the k best merged (B6, or
    B6_f64 at float64)."""
    x, sq, graph, dist, gates = _refine_problem(dev, 3000, f, k, 300, f,
                                                lattice, dtype)
    if metric == "euclidean":
        dist = torch.sqrt(dist)
    for row0 in (0, 2700):
        args = (metric, x, sq, row0, gates, graph[row0:row0 + 300],
                dist[row0:row0 + 300])
        _hold_final(args, dict(graph=graph, ke=k), lattice)


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_keep_then_exact_stage_matches_plain(dev, lattice, dtype):
    """The blobs' funnel: a cascade keep stage (F = 128, the first stage)
    and the exact stage (F = 784) on its list."""
    n, k, ke = 2000, 90, 45
    x, sq, graph, dist, gates = _refine_problem(dev, n, 784, k, 200, 7,
                                                lattice, dtype)
    proj = (x[:, :128] * 2.0).contiguous()
    psq = torch.sum(proj * proj, dim=1)
    kept = _hold_keep((proj, psq, 0, gates, 270), dict(graph=graph, ke=ke),
                      lattice)
    _hold_final(("sqeuclidean", x, sq, 0, kept, graph[:200], dist[:200]),
                {}, lattice)


@pytest.mark.parametrize("keep", [3 * K_REG_MAX, 5 * K_REG_MAX])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_funnel_at_the_deep_k_matches_plain(dev, keep, dtype):
    """k = 1,024 on a funnel: a first keep stage keeping the cascade's 3k
    (F = 128) or the JL stage's 5k (8,192 sort keys; B6_f64's 16-byte
    keys fill its shared memory there), then the exact stage merging 2k
    keys (F = 784); every stage on chip."""
    n, k, ke = 2000, K_REG_MAX, K_REG_MAX // 2
    x, sq, graph, dist, gates = _refine_problem(dev, n, 784, k, 64, 12,
                                                dtype=dtype)
    proj = (x[:, :128] * 2.0).contiguous()
    psq = torch.sum(proj * proj, dim=1)
    kept = _hold_keep((proj, psq, 0, gates, keep), dict(graph=graph, ke=ke),
                      False)
    _hold_final(("sqeuclidean", x, sq, 0, kept, graph[:64], dist[:64]), {},
                False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_edge_chunks_match_plain(dev, dtype):
    """Every gateway one id, and a row whose gateways are all itself: rows
    with fewer unique candidates than the stage keeps (-1 after them) and
    than k."""
    n, k, ke = 2000, 90, 45
    x, sq, graph, dist, gates = _refine_problem(dev, n, 128, k, 64, 8,
                                                dtype=dtype)
    one = torch.full_like(gates, int(gates[0, 3]))
    short = gates.clone()
    short[5] = 5
    for g in (one, short):
        kept = _hold_keep((x, sq, 0, g, 270), dict(graph=graph, ke=ke),
                          False)
        assert bool((kept < 0).any())
        _hold_final(("euclidean", x, sq, 0, kept, graph[:64],
                     torch.sqrt(dist[:64])), {}, False)
        _hold_final(("sqeuclidean", x, sq, 0, g, graph[:64], dist[:64]),
                    dict(graph=graph, ke=ke), False)


def test_refine_wrapper_refuses_what_b6_does_not_take(dev):
    x, sq, graph, dist, gates = _refine_problem(dev, 200, 8, 6, 4, 9)
    ok = dict(base=x, sq=sq, row0=0, cand=gates, keep=20)
    before = KERNELS["B6"].launches
    refine_keep(x.cpu(), sq.cpu(), 0, gates.cpu(), 20, graph=graph.cpu(),
                ke=6)  # the plain version
    for bad in (dict(cand=gates.long()), dict(base=x.double()),
                dict(cand=gates.t()), dict(row0=199)):
        kw = dict(ok)
        kw.update(bad)
        with pytest.raises(ValueError, match="B6"):
            refine_keep(kw["base"], kw["sq"], kw["row0"], kw["cand"],
                        kw["keep"], graph=graph, ke=6)
    with pytest.raises(ValueError, match="B6"):
        refine_keep(x, sq, 0, gates, 20, graph=graph, ke=7)
    with pytest.raises(ValueError, match="B6"):
        refine_final("sqeuclidean", x, sq, 0, gates, graph[:4].long(),
                     dist[:4], graph=graph, ke=6)
    with pytest.raises(ValueError, match="CPU"):
        cand_sqdist(x, sq, torch.arange(4, device=dev), gates)
    with pytest.raises(ValueError, match="B6"):
        refine_keep(x, sq, 0, gates, 0, graph=graph, ke=6)
    assert KERNELS["B6"].launches == before


def _route_count(kind):
    return ROUTE_LAUNCHES.get(kind, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_workspace_route_matches_plain(dev, dtype):
    """Stages that do not fit on chip take B6's workspace route: a first
    exact stage of 16 gateways x (1 + 1,500) candidates at k = 1,500 (its
    hash set past the block), with n_valid; a first keep stage keeping
    5k = 10,240 at k = 2,048 (its sort past 8,192) and the exact stage
    after it; each against its plain version at the B6 bars, two launches
    bit for bit, counted under the route; and the route the kernel library
    decides equals refine_route's mirror."""
    from tsne_flink_tpu_torch.ops.knn_cuda import (refine_route,
                                                   refine_route_kernel)
    isz = torch.empty(0, dtype=dtype).element_size()
    kind = f"{_b6_form_name(dtype)} workspace"
    n, k = 2100, 1500
    x, sq, graph, dist, gates = _refine_problem(dev, n, 8, k, 48, 11,
                                                dtype=dtype)
    assert refine_route(8, 16, k, 0, k, True, True, isz).workspace > 0
    before = _route_count(kind)
    for n_valid in (None, n - 40):
        _hold_final(("sqeuclidean", x, sq, 0, gates, graph[:48], dist[:48]),
                    dict(graph=graph, ke=k, n_valid=n_valid), False)
    assert _route_count(kind) == before + 4
    n, k = 2400, 2048
    x, sq, graph, dist, gates = _refine_problem(dev, n, 64, k, 32, 12,
                                                dtype=dtype)
    proj = (x[:, :32] * 2.0).contiguous()
    psq = torch.sum(proj * proj, dim=1)
    assert refine_route(32, 16, k // 2, 5 * k, k, True, False,
                        isz).workspace > 0
    kept = _hold_keep((proj, psq, 0, gates, 5 * k), dict(graph=graph,
                                                         ke=k // 2), False)
    _hold_final(("euclidean", x, sq, 0, kept, graph[:32],
                 torch.sqrt(dist[:32])), {}, False)
    for args in ((8, 16, 1500, 0, 1500, True, True),
                 (32, 16, 1024, 10240, 2048, True, False),
                 (200, 10240, 0, 0, 2048, False, True),
                 (784, 16, 750, 4500, 1500, True, False),
                 (50, 16, 1024, 0, 1024, True, True),
                 (12288, 16, 90, 0, 90, True, True),
                 # past the staged width: the unstaged form's layouts
                 (12289, 270, 0, 0, 90, False, True),
                 (16384, 16, 1500, 0, 1500, True, True),
                 (32768, 270, 0, 0, 90, False, True),
                 (32768, 4500, 0, 0, 1500, False, True),
                 (32768, 8400, 0, 0, 2800, False, True),
                 (32768, 16, 45, 720, 90, True, False)):
        assert (refine_route_kernel(*args, itemsize=isz)
                == refine_route(*args, itemsize=isz)), args
    # either form forced at a width the other takes by default
    for args in ((784, 270, 0, 0, 90, False, True),
                 (64, 16, 1500, 0, 1500, True, True),
                 (12288, 16, 90, 0, 90, True, True)):
        assert (refine_route_kernel(*args, itemsize=isz, staged=False)
                == refine_route(*args, itemsize=isz, staged=False)), args


def _b6_form_name(dtype):
    return "B6_f64" if dtype == torch.float64 else "B6"


def test_refine_wrapper_refuses_mixed_dtypes(dev):
    """B6's wrapper casts nothing: float64 points with float32 norms or
    old distances (or the reverse) raise before any launch of either
    form, and a bf16 operand is no form's."""
    x, sq, graph, dist, gates = _refine_problem(dev, 200, 8, 6, 4, 9)
    x64, sq64, dist64 = x.double(), sq.double(), dist.double()
    before = (KERNELS["B6"].launches, KERNELS["B6_f64"].launches)
    for base, norms in ((x64, sq), (x, sq64)):
        with pytest.raises(ValueError, match="B6"):
            refine_keep(base, norms, 0, gates, 20, graph=graph, ke=6)
    for base, norms, old_d in ((x64, sq64, dist[:4]), (x, sq, dist64[:4]),
                               (x64, sq, dist64[:4])):
        with pytest.raises(ValueError, match="B6"):
            refine_final("sqeuclidean", base, norms, 0, gates, graph[:4],
                         old_d, graph=graph, ke=6)
    with pytest.raises(TypeError, match="float32 or float64"):
        refine_keep(x.bfloat16(), sq.bfloat16(), 0, gates, 20, graph=graph,
                    ke=6)
    assert (KERNELS["B6"].launches, KERNELS["B6_f64"].launches) == before


# ---- B6's unstaged form (features past 12,288) ------------------------------

#: widths past the staged form held (B6u, B6u_f64): the first, a power
#: of two and one past it, the raw gene counts' width (32,738) and 32,768;
#: all but the powers of two end in a partial slab
UNSTAGED_FS = (12_289, 16_384, 16_385, 32_738, 32_768)


def _wide_problem(dev, n, f, k, seed, dtype):
    """Uniform points [n, f] of ``dtype``, their squared norms and a graph
    [n, k] of distinct non-self ids (no distances: the callers take the
    old lists of their chunk rows from it)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n, f), dtype=np.float32)).to(dev,
                                                                  dtype)
    sq = torch.sum(x * x, dim=1)
    ids = np.stack([(i + 1 + rng.choice(n - 1, k, replace=False)) % n
                    for i in range(n)]).astype(np.int32)
    return x, sq, torch.from_numpy(ids).to(dev)


def _old_lists(metric, x, sq, row0, ids):
    """Rows row0 ..'s lists ``ids`` with the formula's distances, ordered
    by (distance, id)."""
    rows = torch.arange(row0, row0 + ids.shape[0], device=x.device)
    d = cand_exact_plain(metric, x, sq, rows, ids)
    by_id = torch.argsort(ids, dim=1, stable=True)
    ids, d = torch.gather(ids, 1, by_id), torch.gather(d, 1, by_id)
    by_d = torch.argsort(d, dim=1, stable=True)
    return (torch.gather(ids, 1, by_d).contiguous(),
            torch.gather(d, 1, by_d).contiguous())


def _hold_unstaged(args, kw):
    """B6u / B6u_f64 on one exact stage against its plain version: the
    B6 bars (``_hold_final``: float64 within 1e-12 of |d²| + ‖a‖² + ‖b‖²
    and ids equal outside ties; float32 rtol 2e-5 of the plain formula),
    and at float32 the error of d² against a float64 evaluation within
    twice the plain float32 version's own, with no id off outside pairs
    whose distances differ by less than that bar."""
    metric, base = args[0], args[1]
    assert _b6_form(base) == ("B6u_f64" if base.dtype == torch.float64
                              else "B6u")
    _hold_final(args, kw, False)
    if base.dtype == torch.float64:
        return
    sqr = 2 if metric == "euclidean" else 1
    gi, gd = refine_final(*args, **kw)
    wi, wd = refine_final_plain(*args, **kw)
    x64 = base.double()
    s64 = torch.sum(x64 * x64, dim=1)
    row0 = args[3]
    rows = torch.arange(row0, row0 + gi.shape[0], device=gi.device)
    old_i, old_d = args[5], args[6].double()

    def err(ids, d):
        # each id at the smaller of its old and its new distance, in float64
        new = cand_exact_plain(metric, x64, s64, rows, ids)
        hit = ids[:, :, None] == old_i[:, None, :]
        old = torch.where(hit, old_d[:, None, :], math.inf).amin(dim=2)
        return float((d.double() ** sqr
                      - torch.minimum(new, old) ** sqr).abs().max())
    e_k, e_p = err(gi, gd), err(wi, wd)
    assert e_k <= 2.0 * e_p, (e_k, e_p)
    off = int(((gi != wi) & ((gd.double() ** sqr - wd.double() ** sqr).abs()
                             > 2.0 * e_p)).sum())
    assert off == 0


@pytest.mark.parametrize("f", UNSTAGED_FS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unstaged_exact_stage_matches_plain_on_chip(dev, f, dtype):
    """The funnel's exact stage past the staged width (a list of 3k = 270
    candidates a row, k = 90, some -1): B6u / B6u_f64 on chip against
    their plain versions, sqeuclidean and euclidean, counted under the
    unstaged form's route."""
    from tsne_flink_tpu_torch.ops.knn_cuda import refine_route
    n, k, c, row0 = 2000, 90, 32, 1500
    x, sq, graph = _wide_problem(dev, n, f, 3 * k, f % 101, dtype)
    cand = graph[row0:row0 + c].clone()
    cand[::5, 250:] = -1
    kid = _b6_form(x)
    assert refine_route(f, 3 * k, 0, 0, k, False, True,
                        x.element_size()).workspace == 0
    before = _route_count(f"{kid} chip")
    for metric in ("sqeuclidean", "euclidean"):
        old_i, old_d = _old_lists(metric, x, sq, row0,
                                  graph[row0:row0 + c, ::3].contiguous())
        _hold_unstaged((metric, x, sq, row0, cand, old_i, old_d), {})
    # _hold_final launches twice, the float32 error check once more
    per = 2 if dtype == torch.float64 else 3
    assert _route_count(f"{kid} chip") == before + 2 * per


@pytest.mark.parametrize("f", UNSTAGED_FS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unstaged_first_exact_stage_matches_plain_on_its_workspace(dev, f,
                                                                    dtype):
    """A first exact stage of 16 gateways x (1 + 1,500) candidates at k =
    1,500 past the staged width: its hash set is past the block, so B6u /
    B6u_f64 take the workspace route, with n_valid; against their plain
    versions (two rows: the plain stage gathers [c, 24,016, F])."""
    from tsne_flink_tpu_torch.ops.knn_cuda import refine_route
    n, k, c = 2000, 1500, 2
    x, sq, graph = _wide_problem(dev, n, f, k, f % 103, dtype)
    gates = torch.from_numpy(np.random.default_rng(f).integers(
        0, n, (c, 16)).astype(np.int32)).to(dev)
    gates[:, 0] = torch.arange(c, device=dev, dtype=torch.int32)
    kid = _b6_form(x)
    assert refine_route(f, 16, k, 0, k, True, True,
                        x.element_size()).workspace > 0
    before = _route_count(f"{kid} workspace")
    old_i, old_d = _old_lists("sqeuclidean", x, sq, 0, graph[:c])
    for n_valid in (None, n - 40):
        _hold_unstaged(("sqeuclidean", x, sq, 0, gates, old_i, old_d),
                       dict(graph=graph, ke=k, n_valid=n_valid))
    per = 2 if dtype == torch.float64 else 3
    assert _route_count(f"{kid} workspace") == before + 2 * per


def _same_outside_ties(base, sq, row0, got, want, sqr=1):
    """Slot by slot, ``got``'s ids are ``want``'s, but where the two ids'
    formula distances (squared: ``sqr`` 2 for euclidean lists) lie within
    the B6 bar of each other: a tie the two forms' sums may order either
    way (float32: 2e-5 of the largest; float64: 1e-12 of |d²| + ‖a‖² +
    ‖b‖²)."""
    rows = torch.arange(row0, row0 + got.shape[0], device=got.device)
    sg = cand_sqdist_plain(base, sq, rows, torch.where(got >= 0, got,
                                                       rows[:, None]))
    sw = cand_sqdist_plain(base, sq, rows, torch.where(want >= 0, want,
                                                       rows[:, None]))
    if base.dtype == torch.float64:
        tol = _f64_tol(sq, rows, want, sw)
    else:
        tol = torch.full_like(sw, 2e-5 * float(sw.abs().max()))
    differ = (got != want) & (got >= 0) & (want >= 0)
    assert torch.equal(got >= 0, want >= 0)
    assert bool(((sg - sw).abs() <= tol)[differ].all())
    return int(differ.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unstaged_form_forced_at_a_staged_width_gives_its_bits(dev, dtype,
                                                               monkeypatch):
    """The unstaged form forced at F <= 12,288, on the staged form's own
    stages — a first keep stage (F = 128), the exact stage after it (F =
    784) and at F = 12,288, on chip; a first exact stage at k = 1,500 (F =
    64) on the workspace route with n_valid: each against its plain
    version at the B6 bars, two launches bit for bit, counted under the
    unstaged form, and its ids the staged form's outside ties.  Its sums
    run over F in slabs, so its scores are not the staged form's bits."""
    from tsne_flink_tpu_torch.ops import knn_cuda as tkc
    uid = "B6u" + ("_f64" if dtype == torch.float64 else "")

    def staged(*args, **kw):
        out = tkc._refine_launch(*args, staged=True, **kw)
        return out if isinstance(out, tuple) else (out,)

    n, k, ke = 2000, 90, 45
    x, sq, graph, dist, gates = _refine_problem(dev, n, 784, k, 200, 7,
                                                dtype=dtype)
    proj = (x[:, :128] * 2.0).contiguous()
    psq = torch.sum(proj * proj, dim=1)
    s_keep = staged(proj, psq, 0, gates, graph, ke, keep=270)[0]
    s_fin = staged(x, sq, 0, s_keep, None, 0, old=(graph[:200], dist[:200]))
    w, wsq, wg = _wide_problem(dev, 600, 12_288, 270, 5, dtype)
    w_old = _old_lists("euclidean", w, wsq, 0, wg[:64, ::3].contiguous())
    s_w = staged(w, wsq, 0, wg[:64], None, 0, old=w_old, euclid=True)
    b, bsq, bgraph, bdist, bgates = _refine_problem(dev, 2100, 64, 1500, 48,
                                                    11, dtype=dtype)
    s_b = staged(b, bsq, 0, bgates, bgraph, 1500,
                 old=(bgraph[:48], bdist[:48]), n_valid=2060)
    monkeypatch.setattr(tkc, "refine_staged", lambda f: False)
    kept = _hold_keep((proj, psq, 0, gates, 270), dict(graph=graph, ke=ke),
                      False, kid=uid)
    _same_outside_ties(proj, psq, 0, kept, s_keep)
    _hold_final(("sqeuclidean", x, sq, 0, s_keep, graph[:200], dist[:200]),
                {}, False, kid=uid)
    gi = tkc._refine_launch(x, sq, 0, s_keep, None, 0,
                            old=(graph[:200], dist[:200]), staged=False)[0]
    _same_outside_ties(x, sq, 0, gi, s_fin[0])
    _hold_final(("euclidean", w, wsq, 0, wg[:64], *w_old), {}, False,
                kid=uid)
    gi = tkc._refine_launch(w, wsq, 0, wg[:64], None, 0, old=w_old,
                            euclid=True, staged=False)[0]
    _same_outside_ties(w, wsq, 0, gi, s_w[0])
    _hold_final(("sqeuclidean", b, bsq, 0, bgates, bgraph[:48], bdist[:48]),
                dict(graph=bgraph, ke=1500, n_valid=2060), False, kid=uid)
    gi = tkc._refine_launch(b, bsq, 0, bgates, bgraph, 1500,
                            old=(bgraph[:48], bdist[:48]), n_valid=2060,
                            staged=False)[0]
    _same_outside_ties(b, bsq, 0, gi, s_b[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unstaged_rows_past_2_31_over_f_match_plain(dev, dtype):
    """An exact-stage chunk at F = 32,738 whose rows lie past 2^31 / F
    (their element offsets pass int32), its candidates below and past it:
    B6u / B6u_f64 against their plain versions."""
    f, k, c = 32_738, 90, 32
    row0 = 2 ** 31 // f + 3
    n = row0 + c + 64
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    x = torch.rand((n, f), generator=g, device=dev, dtype=dtype)
    sq = torch.sum(x * x, dim=1)
    rows = torch.arange(row0, row0 + c, device=dev)
    offs = torch.randperm(n - 1, generator=g, device=dev)[:3 * k] + 1
    cand = ((rows[:, None] + offs[None, :]) % n).to(torch.int32)
    old_i, old_d = _old_lists("sqeuclidean", x, sq, row0,
                              cand[:, :3 * k:3].contiguous())
    cand[::5, 250:] = -1
    assert int(row0) * f >= 2 ** 31
    _hold_unstaged(("sqeuclidean", x, sq, row0, cand.contiguous(), old_i,
                    old_d), {})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unstaged_rows_keep_their_bits_in_any_chunk(dev, dtype):
    """A row's outputs are the same bits whether its chunk holds 64 rows
    or 4,096 (B6u's score pass walks the same slabs in the same order for
    every pair): the exact stage on a list at F = 16,385 and a first exact
    stage from gateways at F = 12,289."""
    from tsne_flink_tpu_torch.ops.knn_cuda import _refine_launch
    c, k = 4096, 90
    x, sq, graph = _wide_problem(dev, 4200, 16_385, 3 * k, 17, dtype)
    cand = graph[:c].clone()
    cand[::7, 200:] = -1
    olds = [_old_lists("euclidean", x, sq, r0,
                       graph[r0:r0 + 256, ::3].contiguous())
            for r0 in range(0, c, 256)]
    old = tuple(torch.cat([o[j] for o in olds]) for j in (0, 1))
    full = _refine_launch(x, sq, 0, cand, None, 0, old=old, euclid=True)
    for r0 in range(0, c, 64):
        part = _refine_launch(x, sq, r0, cand[r0:r0 + 64].contiguous(),
                              None, 0, old=(old[0][r0:r0 + 64].contiguous(),
                                            old[1][r0:r0 + 64].contiguous()),
                              euclid=True)
        assert torch.equal(part[0], full[0][r0:r0 + 64])
        assert torch.equal(part[1], full[1][r0:r0 + 64])
    del x, sq, graph, cand, olds, old, full
    x, sq, graph = _wide_problem(dev, 4200, 12_289, k, 18, dtype)
    gates = torch.from_numpy(np.random.default_rng(18).integers(
        0, 4200, (c, 16)).astype(np.int32)).to(dev)
    gates[:, 0] = torch.arange(c, device=dev, dtype=torch.int32)
    dist = torch.full((c, k), math.inf, device=dev, dtype=dtype)
    ids = torch.full((c, k), -1, device=dev, dtype=torch.int32)
    full = _refine_launch(x, sq, 0, gates, graph, k // 2, old=(ids, dist))
    for r0 in range(0, c, 64):
        part = _refine_launch(x, sq, r0, gates[r0:r0 + 64].contiguous(),
                              graph, k // 2,
                              old=(ids[r0:r0 + 64].contiguous(),
                                   dist[r0:r0 + 64].contiguous()))
        assert torch.equal(part[0], full[0][r0:r0 + 64])
        assert torch.equal(part[1], full[1][r0:r0 + 64])


def test_unstaged_wrapper_refuses_what_its_form_does_not_take(dev):
    """Forced forms refuse widths they do not take (the staged form past
    12,288, the unstaged one below 64) with no launch."""
    from tsne_flink_tpu_torch.ops.knn_cuda import _refine_launch
    x, sq, graph, dist, gates = _refine_problem(dev, 200, 8, 6, 4, 9)
    before = {k: KERNELS[k].launches for k in B6_FORMS}
    with pytest.raises(ValueError, match="B6"):
        _refine_launch(x, sq, 0, gates, graph, 6, keep=20, staged=False)
    w, wsq, wg = _wide_problem(dev, 64, 12_289, 8, 3, torch.float32)
    with pytest.raises(ValueError, match="B6"):
        _refine_launch(w, wsq, 0, wg[:4], None, 0, keep=4, staged=True)
    assert {k: KERNELS[k].launches for k in B6_FORMS} == before


def test_two_processes_run_project_past_the_staged_width(dev, tmp_path):
    """Two gloo ranks on the one card run a refining project job at 12,289
    features (B6u on each rank's shard, B6 on the cascade) and give the
    in-process job's embedding on the test mesh of 2 bit for bit."""
    import os
    import socket
    import subprocess
    import sys
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    n, d = 2001, 12_289
    rng = np.random.default_rng(4)
    centers = rng.normal(0.0, 1.0, (12, d))
    x = (centers[rng.integers(0, 12, n)]
         + rng.normal(0.0, 0.3, (n, d))).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    kw = dict(knn_method="project", knn_refine=1)
    before = KERNELS["B6u"].launches
    y1, _ = SpmdPipeline(TsneConfig(perplexity=10.0, iterations=60), n, d,
                         30, devices=["cuda:0"] * 2, **kw)(
        torch.from_numpy(x))
    assert KERNELS["B6u"].launches > before
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    code = f"""
import numpy as np, torch, sys
from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.parallel.mesh import distributed_init
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
r = int(sys.argv[1])
distributed_init("127.0.0.1:{port}", 2, r, timeout_s=300)
x = torch.from_numpy(np.load(r"{tmp_path / 'x.npy'}"))
pipe = SpmdPipeline(TsneConfig(perplexity=10.0, iterations=60), {n}, {d},
                    30, knn_method="project", knn_refine=1)
y, _ = pipe(x)
assert KERNELS["B6u"].launches > 0 and KERNELS["B6"].launches > 0
np.save(r"{tmp_path}/y%d.npy" % r, y.cpu().numpy())
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              cwd=root) for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"y{r}.npy"),
                              y1.cpu().numpy())


def test_cosine_project_past_the_staged_width_fits_its_chunk(dev):
    """Cosine's exact stage is the plain version on the card too, which
    gathers its candidates' vectors: at 20,000 x 32,738 (k = 90) the tile
    plan's chunk counts that [c, 270, F] gather and fits the tile budget,
    and a refining project run completes there (B6 on the cascade, no
    B6u), its peak within the card, the embedding finite."""
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.ops import knn_tiles as ttiles
    n, d, k = 20_000, 32_738, 90
    budget = (ttiles.DEFAULT_BUDGET_BYTES["cuda"]
              * ttiles.TILE_BUDGET_FRACTION)
    c = ttiles.pick_knn_tiles(n, d, k, "cuda", metric="cosine").refine_chunk
    assert c == ttiles.MIN_REFINE_CHUNK
    assert ttiles.refine_chunk_bytes(c, d, k, workspace=True,
                                     metric="cosine") <= budget
    g = torch.Generator(device=dev).manual_seed(5)
    centers = torch.rand((12, d), generator=g, device=dev)
    lab = torch.randint(0, 12, (n,), generator=g, device=dev)
    x = centers[lab]
    x += 0.3 * torch.rand((n, d), generator=g, device=dev)
    del centers
    before = {kk: KERNELS[kk].launches for kk in ("B6", "B6u")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    y, losses = tsne_embed(x, TsneConfig(perplexity=30.0, iterations=60,
                                         metric="cosine"),
                           knn_method="project", knn_refine=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert KERNELS["B6"].launches > before["B6"]
    assert KERNELS["B6u"].launches == before["B6u"]
    assert peak < torch.cuda.get_device_properties(0).total_memory
    assert y.shape == (n, 2) and bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(torch.as_tensor(losses)).all())


def _recall(dist_approx, dist_exact, tol=1e-5):
    kth = dist_exact[:, -1:] * (1 + tol) + tol
    return float((dist_approx <= kth).double().mean())


def test_knn_methods_launch_b1_and_b6(dev):
    """partition is B1's exact graph; project's refine rounds score their
    candidates with B6 and reach the exact graph's neighbourhood."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3000, 40)).astype(
        np.float32)).to(dev)
    reset_launches()
    bi, bd = tknn.knn(x, 20, "bruteforce")
    pi, pd = tknn.knn(x, 20, "partition")
    assert KERNELS["B1"].launches == 2 and KERNELS["B6"].launches == 0
    assert torch.equal(pi, bi) and torch.equal(pd, bd)
    gen = torch.Generator(device=dev).manual_seed(0)
    hi, hd = tknn.knn(x, 20, "project", rounds=2, refine=2, generator=gen)
    assert KERNELS["B1"].launches == 2 and KERNELS["B6"].launches >= 2
    assert hi.is_cuda and hi.dtype == torch.int32
    assert _recall(hd, bd) >= 0.9
    gen = torch.Generator(device=dev).manual_seed(0)
    again = tknn.knn(x, 20, "project", rounds=2, refine=2, generator=gen)
    assert torch.equal(again[0], hi) and torch.equal(again[1], hd)


def test_fft_repulsion_on_the_card(dev):
    """The sorted-segment-sum spread gives the same bits every call, and
    the card's forces and Z agree with an f64 CPU run."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((20_000, 2)) * 20.0
    yc = torch.from_numpy(y.astype(np.float32)).to(dev)
    r1, z1 = fft_repulsion(yc, grid=512)
    r2, z2 = fft_repulsion(yc, grid=512)
    assert torch.equal(r1, r2) and torch.equal(z1, z2)
    rr, zr = fft_repulsion(torch.from_numpy(y.astype(np.float32)).double(),
                           grid=512)
    torch.testing.assert_close(r1.double().cpu(), rr, rtol=1e-3,
                               atol=1e-3 * float(rr.abs().max()))
    assert abs(float(z1) - float(zr)) <= 1e-4 * float(zr)


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """save takes card tensors, load returns numpy, state_from_numpy puts
    the same bits back on the card."""
    from tsne_flink_tpu_torch.convert import state_from_numpy
    from tsne_flink_tpu_torch.models.tsne import TsneState
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    g = torch.Generator(device=dev).manual_seed(0)
    st = TsneState(*(torch.randn((5000, 2), generator=g, device=dev)
                     for _ in range(3)))
    losses = torch.rand(30, generator=g, device=dev)
    path = str(tmp_path / "c.npz")
    ckpt.save(path, st, 120, losses, prepare={"label": "split-rows"})
    got, nxt, ls = ckpt.load(path)
    back = state_from_numpy(got.y, got.update, got.gains, device=dev)
    assert nxt == 120 and ckpt.load_prepare(path) == {"label": "split-rows"}
    for a, b in zip(back, st):
        assert a.is_cuda and torch.equal(a, b)
    assert torch.equal(torch.from_numpy(ls).to(dev), losses)


def _coo_file(path, x):
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                f.write(f"{i},{j},{float(x[i, j])!r}\n")


def test_cli_fat_resume_on_the_card(dev, tmp_path):
    """The CLI on the card: a fat-checkpoint resume launches no kNN kernel
    and gives the uninterrupted run's bytes; float64 on a refining kNN
    plan runs its refine cycles through B6_f64, no float32 form."""
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.utils.cli import main
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1500, 12)) + 6.0 * rng.integers(0, 4, (1500, 1))
    _coo_file(tmp_path / "in.csv", x)

    def argv(out, *extra):
        return ["--input", str(tmp_path / "in.csv"), "--output",
                str(tmp_path / out), "--loss", str(tmp_path / (out + ".l")),
                "--dimension", "12", "--knnMethod", "bruteforce",
                "--perplexity", "10", "--iterations", "120", "--noCache",
                *extra]

    ck = str(tmp_path / "c.npz")
    assert main(argv("u.csv", "--checkpoint", ck, "--checkpointEvery", "50",
                     "--fatCheckpoint")) == 0
    reset_launches()
    assert main(argv("r.csv", "--resume", ck + ".1")) == 0
    counts = launches()
    assert counts["B1"] == 0 and counts["B6"] == 0 and counts["B2"] == 20
    assert ((tmp_path / "r.csv").read_bytes()
            == (tmp_path / "u.csv").read_bytes())
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    chunks = -(-1500 // pick_knn_tiles(1500, 12, 30, "cuda").refine_chunk)
    reset_launches()
    assert main(argv("d.csv", "--dtype", "float64", "--knnMethod",
                     "project", "--knnRefine", "2")) == 0
    counts = launches()
    assert counts["B6_f64"] == 2 * chunks
    assert all(v == 0 for k, v in counts.items() if not k.endswith("_f64"))
    assert (tmp_path / "d.csv").exists()


def test_cache_warm_hit_on_the_card(dev, tmp_path):
    """A warm artifact cache launches no kNN kernel and gives the cold
    run's bits."""
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.utils.artifacts import ArtifactCache
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((9000, 24)) + 5.0 * rng.integers(0, 6, (9000, 1))
         ).astype(np.float32)
    cfg = TsneConfig(perplexity=10.0, iterations=60)
    runs = []
    for _ in range(2):
        reset_launches()
        stats = {}
        y, losses = tsne_embed(x, cfg, knn_method="project", seed=1,
                               artifact_cache=ArtifactCache(str(tmp_path)),
                               stats=stats)
        runs.append((y, losses, launches()))
    (y0, l0, c0), (y1, l1, c1) = runs
    assert c0["B6"] > 0 and c1["B6"] == 0 and c1["B1"] == 0
    assert torch.equal(y0, y1) and torch.equal(l0, l1)


def test_bh_repulsion_on_the_card(dev):
    """Barnes-Hut on CUDA tensors: two calls bit for bit (the sorted
    segment-sum tree, the stable frontier), on the card's device, within
    the vdm bars of the exact sum, and close to an f64 CPU run (the same
    frontier decisions but for f32 rounding at a gate's edge)."""
    from tsne_flink_tpu_torch.ops.repulsion_bh import bh_repulsion
    rng = np.random.default_rng(8)
    centers = rng.standard_normal((10, 2)) * 30.0
    y = centers[rng.integers(0, 10, 20_000)] + rng.standard_normal((20_000,
                                                                   2))
    yc = torch.from_numpy(y.astype(np.float32)).to(dev)
    r1, z1 = bh_repulsion(yc, theta=0.5)
    r2, z2 = bh_repulsion(yc, theta=0.5)
    assert r1.is_cuda and z1.is_cuda
    assert torch.equal(r1, r2) and torch.equal(z1, z2)
    re, ze = cuda_exact_repulsion(yc)
    den = float(torch.linalg.norm(re, dim=1).max())
    assert float(torch.linalg.norm(r1 - re, dim=1).max()) / den < 3e-2
    assert abs(float(z1 - ze)) / float(ze) < 1e-2
    rc, zc = bh_repulsion(yc.double().cpu(), theta=0.5)
    assert abs(float(z1) - float(zc)) <= 1e-3 * float(zc)
    # a lattice: ties everywhere under frontier overflow, still one answer
    g = np.stack(np.meshgrid(np.arange(64.0), np.arange(64.0)), -1)
    lat = torch.from_numpy(g.reshape(-1, 2).astype(np.float32)).to(dev)
    a = bh_repulsion(lat, theta=0.5, frontier=8)
    b = bh_repulsion(lat, theta=0.5, frontier=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # m = 3, shard + mask
    y3 = torch.from_numpy(rng.standard_normal((3000, 3)).astype(np.float32)
                          ).to(dev) * 5.0
    valid = torch.arange(3000, device=dev) < 2990
    r3, z3 = bh_repulsion(y3[100:400], y3, theta=0.25, levels=7,
                          row_offset=100, col_valid=valid, row_z=True)
    e3, f3 = cuda_exact_repulsion(y3[100:400], y3, row_offset=100,
                                  col_valid=valid, row_z=True)
    assert z3.shape == (300,)
    den = float(torch.linalg.norm(e3, dim=1).max())
    assert float(torch.linalg.norm(r3 - e3, dim=1).max()) / den < 3e-2


def test_policies_on_the_card(dev):
    """The stride, the autopilot and the sentinel on CUDA tensors: the
    controller's level is read once a report boundary, the sentinel's flag
    and the telemetry trace stay on the card, a stride launches B2 only at
    its refreshes, and two autopilot runs give the same bits."""
    from dataclasses import replace

    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.models import autopilot as ap
    from tsne_flink_tpu_torch.models.tsne import (_plan_layout,
                                                  init_working_set, optimize)
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4000, 16)) + 5.0 * rng.integers(0, 5, (4000, 1))
         ).astype(np.float32)
    cfg = TsneConfig(perplexity=10.0, iterations=100)
    prep = prepare(torch.from_numpy(x).to(dev), neighbors=30,
                   perplexity=10.0, device=dev)
    edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    st = init_working_set(gen, 4000, 2, torch.float32, dev)
    reset_launches()
    optimize(st, prep.jidx, prep.jval, replace(cfg, repulsion_stride=4),
             edges=edges, csr=csr)
    assert launches()["B2"] == 25
    runs = []
    for _ in range(2):
        ap.reset_host_reads()
        out = optimize(st, prep.jidx, prep.jval, replace(cfg, autopilot=True),
                       edges=edges, csr=csr, with_health=True,
                       with_telemetry=True)
        assert ap.host_reads() == 9
        runs.append(out)
    (s0, l0, t0, p0, ok0), (s1, l1, t1, p1, ok1) = runs
    assert ok0.is_cuda and t0.is_cuda and p0[0].is_cuda and bool(ok0)
    assert torch.equal(s0.y, s1.y) and torch.equal(p0[1], p1[1])
    assert torch.isfinite(t0).all()


# ---- serving: B2 with its rows past the base, the query loop, the daemon ---

@pytest.mark.parametrize("m", [2, 3])
def test_repulsion_rows_past_the_base_match_plain(dev, m):
    """The serving call (C2): 256 query rows numbered past a 60,000-row
    base (row_offset = N, row_z), no pair masked; two launches bit for
    bit."""
    rng = np.random.default_rng(m)
    yb = torch.from_numpy((rng.standard_normal((60_000, m)) * 20.0).astype(
        np.float32)).to(dev)
    yq = torch.from_numpy((rng.standard_normal((256, m)) * 20.0).astype(
        np.float32)).to(dev)
    rk, zk = cuda_exact_repulsion(yq, yb, row_offset=60_000, row_z=True)
    rp, zp = exact_repulsion(yq, yb, row_offset=60_000, row_z=True)
    _close_scaled(rk, rp)
    _close_scaled(zk, zp)
    again = cuda_exact_repulsion(yq, yb, row_offset=60_000, row_z=True)
    assert torch.equal(again[0], rk) and torch.equal(again[1], zk)
    valid = torch.ones(60_000, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="col_valid has no entry"):
        cuda_exact_repulsion(yq, yb, row_offset=60_000, col_valid=valid)


def _serve_model(dev, repulsion, n=3000, d=16):
    from tsne_flink_tpu_torch.serve.model import PlanConfig, from_arrays
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((n, d)) + 5.0 * rng.integers(0, 5, (n, 1))
         ).astype(np.float32)
    y = (rng.standard_normal((n, 2)) * 10.0).astype(np.float32)
    return from_arrays(x, y, PlanConfig(n=n, d=d, k=30, backend="cuda",
                                        repulsion=repulsion),
                       perplexity=10.0, device=dev)


@pytest.mark.parametrize("repulsion", ["exact", "fft"])
def test_transform_on_the_card(dev, repulsion):
    """The query loop launches B5 (and B2 on the exact path) once an
    iteration a bucket; one batch equals its splits bit for bit; a few
    iterations stay near the float64 CPU transform of the same model."""
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.serve.model import from_arrays
    from tsne_flink_tpu_torch.serve.transform import (dispatch_bucket,
                                                      transform)
    model = _serve_model(dev, repulsion)
    assert model.repulsion == repulsion and model.y.is_cuda
    assert model.y.data_ptr() % 16 == 0
    rng = np.random.default_rng(5)
    q = (model.x[:128].cpu().numpy()
         + rng.standard_normal((128, 16)).astype(np.float32))
    reset_launches()
    whole = transform(model, q, bucket=32, iters=20)
    got = {k: v for k, v in launches().items() if v}
    assert got == ({"B2": 80, "B5": 80} if repulsion == "exact"
                   else {"B5": 80})
    for step in (32, 8):
        parts = np.concatenate([transform(model, q[s:s + step], bucket=32,
                                          iters=20)
                                for s in range(0, 128, step)])
        assert np.array_equal(parts, whole)
    out = dispatch_bucket(model, q[:32], bucket=32, iters=20)
    assert out.is_cuda and np.array_equal(out.cpu().numpy(), whole[:32])
    ref = from_arrays(model.x.cpu().numpy().astype(np.float64),
                      model.y.cpu().numpy().astype(np.float64), model.plan,
                      perplexity=10.0, device="cpu")
    few = transform(model, q, bucket=32, iters=3)
    want = transform(ref, q.astype(np.float64), bucket=32, iters=3)
    np.testing.assert_allclose(few, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def test_daemon_on_the_card(dev, tmp_path):
    from tsne_flink_tpu_torch.serve.daemon import (ServeDaemon, read_result,
                                                   submit)
    from tsne_flink_tpu_torch.serve.transform import transform
    model = _serve_model(dev, "exact")
    rng = np.random.default_rng(6)
    reqs = {f"r{i}": rng.standard_normal((rows, 16)).astype(np.float32)
            for i, rows in enumerate((5, 32, 70))}
    for rid, q in reqs.items():
        submit(str(tmp_path), q, rid)
    d = ServeDaemon(model, str(tmp_path), bucket=32, iters=10, tick_s=0.001,
                    sched="on", idle_exit_s=0.05)
    summary = d.serve_forever(max_ticks=50)
    assert summary["served"] == 3
    assert summary["admission"]["budget_bytes"] == torch.cuda \
        .get_device_properties(dev).total_memory
    for rid, q in reqs.items():
        assert np.array_equal(read_result(str(tmp_path), rid),
                              transform(model, q, bucket=32, iters=10))


# ---- the runtime and observability layers (A15) ----------------------------

def _blob_points(n=3000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(6, d)).astype(np.float32) * 4
    return c[rng.integers(0, 6, n)] + rng.normal(size=(n, d)).astype(
        np.float32)


#: 40,000 hub-heavy blobs (chip_smoke.make_data's recipe at 40k rows):
#: split rows wide enough that their [N, S] planes dwarf the blocks layout
_HUB_BLOBS = """
rng = np.random.default_rng(0)
centers = rng.random((10, 784)).astype(np.float32)
x = centers[rng.integers(0, 10, 40_000)] + 0.15 * rng.standard_normal(
    (40_000, 784)).astype(np.float32)
"""


def test_memory_model_bounds_a_hub_heavy_run(dev):
    """chip_smoke's [runtime] 1 at 40,000 points: the model's allocated
    terms, at the kNN graph's width bound the supervisor read (what the
    fleet re-admits a job at), within [1, 2]x the run's measured
    allocated peak; the rows the run built are no wider than the bound."""
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.analysis.audit.hbm import (allocated_peak,
                                                         charged_plans,
                                                         plan_hbm_report,
                                                         stage_terms)
    from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
                                                         run_plan_from_fit,
                                                         supervised_embed)
    scope = {"np": np}
    exec(_HUB_BLOBS, scope)
    x = scope["x"]
    cfg = TsneConfig(perplexity=30.0, iterations=30, repulsion="exact")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    widths = []
    from tsne_flink_tpu_torch.utils import artifacts
    real = artifacts.prepare

    def recorded(*a, **kw):
        out = real(*a, **kw)
        widths.append(int(out.jidx.shape[1]))
        return out
    artifacts.prepare = recorded
    plan = run_plan_from_fit(40_000, 784, 90, cfg, "auto", "bruteforce")
    sup = Supervisor(plan)
    try:
        run = supervised_embed(x, cfg, supervisor=sup, neighbors=90,
                               seed=0)
    finally:
        artifacts.prepare = real
    torch.cuda.synchronize()
    got = torch.cuda.max_memory_allocated() - base
    at = type(plan)(**{**plan.as_dict(), "sym_width": sup.width_bound})
    charged = max(charged_plans(at),
                  key=lambda p: plan_hbm_report(p)["peak_hbm_est"])
    pred = max(allocated_peak(t) for t in stage_terms(charged).values())
    assert widths[0] <= sup.width_bound, (widths, sup.width_bound)
    assert got <= pred <= 2 * got, (got, pred, widths, sup.width_bound)
    assert torch.isfinite(run.state.y).all()


_OOM_CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from tsne_flink_tpu_torch import TsneConfig
from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
    run_plan_from_fit, supervised_embed)
torch.cuda.set_per_process_memory_fraction(
    float(sys.argv[2]) / torch.cuda.get_device_properties(0).total_memory)
""" + _HUB_BLOBS + r"""
cfg = TsneConfig(perplexity=30.0, iterations=30, repulsion="exact")
sup = Supervisor(run_plan_from_fit(40_000, 784, 90, cfg, "auto",
                                   "bruteforce"), max_retries=2)
run = supervised_embed(x, cfg, supervisor=sup, neighbors=90,
                       affinity_assembly=sys.argv[3], seed=0)
np.save(sys.argv[4], run.state.y.cpu().numpy())
print(json.dumps({"degradations": sup.degradations,
                  "events": [e["type"] for e in sup.events]}))
"""


def test_real_oom_is_recovered_by_the_ladder(dev, tmp_path):
    """chip_smoke's [runtime] 2 at 40,000 points: the split rows' [N, S]
    planes run out of memory for real under an allocator capped at 3
    GiB; the ladder takes the blocks rung, and the result equals an
    uncapped run given blocks from the start."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "y.npy")
    got = subprocess.run([sys.executable, "-c", _OOM_CHILD, root,
                          str(3 << 30), "auto", out],
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    rec = json.loads(got.stdout.strip().splitlines()[-1])
    assert [d["action"] for d in rec["degradations"]] == ["assembly-blocks"]
    ref = str(tmp_path / "ref.npy")
    got = subprocess.run([sys.executable, "-c", _OOM_CHILD, root,
                          str(60 << 30), "blocks", ref],
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    assert np.array_equal(np.load(out), np.load(ref))


def test_tracing_changes_no_bit_and_no_launch(dev, tmp_path):
    """chip_smoke's [runtime] 5 at 3,000 points: --trace/--metricsOut/
    --profile leave the output bytes and the launch counts as they are."""
    import json
    import os
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.utils.cli import main
    x = _blob_points()
    coo = tmp_path / "in.csv"
    coo.write_text("".join(f"{i},{j},{float(x[i, j])!r}\n"
                           for i in range(x.shape[0])
                           for j in range(x.shape[1])))
    counts = []
    for tag, extra in (("plain", []),
                       ("traced", ["--trace", str(tmp_path / "t.json"),
                                   "--metricsOut", str(tmp_path / "m.json"),
                                   "--profile", str(tmp_path / "prof")])):
        reset_launches()
        main(["--input", str(coo), "--output", str(tmp_path / f"{tag}.csv"),
              "--loss", str(tmp_path / f"{tag}.loss"), "--dimension", "64",
              "--knnMethod", "bruteforce", "--perplexity", "10",
              "--iterations", "60", "--noCache", *extra])
        torch.cuda.synchronize()
        counts.append(launches())
    assert counts[0] == counts[1] and counts[0]["B1"] == 1
    assert ((tmp_path / "plain.csv").read_bytes()
            == (tmp_path / "traced.csv").read_bytes())
    names = {e["name"] for e in json.load(open(tmp_path / "t.json"))[
        "traceEvents"]}
    assert {"prepare.knn", "prepare.affinities", "optimize.segment"} <= names
    assert os.listdir(tmp_path / "prof")


# ---- replicated serving (A13b) ----------------------------------------------

def test_serve_fleet_on_the_card(dev, tmp_path):
    """Two ``--serve`` replica processes on the card over one spool, one
    of them killed at its first request's boundary: every request gets
    exactly one terminal, bit for bit this process's transform; each
    replica's record carries its measured memory and its charge, and its
    buckets launch B5 and B2 once an iteration."""
    import json
    import os
    from tsne_flink_tpu_torch.models.tsne import TsneState
    from tsne_flink_tpu_torch.runtime.fleet import (ServeFleetSpec,
                                                    run_serve_fleet)
    from tsne_flink_tpu_torch.serve.daemon import read_result, submit
    from tsne_flink_tpu_torch.serve.model import PlanConfig, load_frozen
    from tsne_flink_tpu_torch.serve.transform import transform
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    y = torch.from_numpy(rng.standard_normal((2000, 2)).astype(np.float32))
    ckpt.save(str(tmp_path / "m.npz"), TsneState(
        y=y, update=torch.zeros_like(y), gains=torch.ones_like(y)), 10,
        np.asarray([0.5]))
    np.save(tmp_path / "x.npy", x)
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    reqs = {f"r{i}": rng.standard_normal((rows, 16)).astype(np.float32)
            for i, rows in enumerate((5, 32, 70, 9))}
    for rid, q in reqs.items():
        submit(spool, q, rid)
    rec = run_serve_fleet(ServeFleetSpec(
        name="card", spool=spool, workdir=str(tmp_path / "work"),
        serve={"model": str(tmp_path / "m.npz"),
               "input": str(tmp_path / "x.npy"), "perplexity": 5.0,
               "neighbors": 15, "repulsion": "exact", "bucket": 32,
               "iters": 10, "tick_s": 0.001, "idle_exit_s": 0.5},
        replicas=2, stale_ms=30000.0, run_s=300.0, backoff_base=0.05,
        # whichever replica claims first is killed at its first request's
        # boundary (a plan fires on a replica's first attempt only): with
        # one replica's plan, the other could claim every request
        fault_plans={"0": "kill@serve:seg0", "1": "kill@serve:seg0"}))
    assert rec["deadline_hit"] is False and rec["relaunches"] >= 1
    model = load_frozen(str(tmp_path / "m.npz"), x, PlanConfig(
        n=2000, d=16, k=15, backend="cuda", repulsion="exact"),
        perplexity=5.0)
    for rid, q in reqs.items():
        assert np.array_equal(read_result(spool, rid),
                              transform(model, q, bucket=32, iters=10))
    names = sorted(os.listdir(spool))
    assert names == sorted(f"{rid}{s}" for rid in reqs
                           for s in (".lat.json", ".res.npz"))
    for name, sub in rec["replica_records"].items():
        assert sub["status"] == "ok", json.dumps(sub)[:2000]
        mem, adm = sub["memory"], sub["admission"]
        assert 0 < mem["peak_allocated"] <= mem["peak_reserved"]
        assert adm["charged_bytes"] > adm["peak_bytes"]   # the process
        if sub["batches"]:
            assert sub["launches"]["B5"] == 10 * sub["batches"]
            assert sub["launches"]["B2"] == 10 * sub["batches"]


@pytest.mark.parametrize("n,d", [(60_000, 8), (20_003, 2), (60_001, 4),
                                 (1_001, 8)])
def test_repulsion_canonical_splits_on_a_shard_are_mesh_1_bits(dev, n, d):
    """B2 on one shard of a D-wide mesh, with the column splits of the
    quantum-wide local size, gives the same rows' bits as the mesh-1
    launch over all rows with that split count (a masked padded tail
    included); the shard's own split count would not."""
    from tsne_flink_tpu_torch.parallel.mesh import (PAD_QUANTUM,
                                                    padded_rows_for)
    npad = padded_rows_for(n, d)
    rng = np.random.default_rng(n)
    y = torch.from_numpy(rng.standard_normal((npad, 2)).astype(np.float32)
                         * 20).to(dev)
    valid = torch.arange(npad, device=dev) < n
    split_rows = npad // PAD_QUANTUM
    rep1, z1 = cuda_exact_repulsion(y, y, col_valid=valid, row_z=True,
                                    split_rows=split_rows)
    nl = npad // d
    for r in (0, d - 1):
        rows = slice(r * nl, (r + 1) * nl)
        rep, z = cuda_exact_repulsion(y[rows].contiguous(), y,
                                      row_offset=r * nl, col_valid=valid,
                                      row_z=True, split_rows=split_rows)
        assert torch.equal(rep, rep1[rows]) and torch.equal(z, z1[rows])


def test_mesh_on_the_test_mesh_equals_mesh_1(dev):
    """The sharded optimizer with 1, 2 and 4 shards on the card (the test
    mesh: the one card listed once a shard): the CSR, rows and blocks
    layouts give mesh 1's bits, and each shard launches its kernels."""
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, init_working_set
    from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    rng = np.random.default_rng(0)
    centers = rng.normal(0.0, 10.0, (12, 16))
    x = torch.from_numpy((centers[rng.integers(0, 12, 3001)]
                          + rng.normal(0.0, 0.5, (3001, 16)))
                         .astype(np.float32)).to(dev)
    for assembly, attraction in (("sorted", "csr"), ("sorted", "rows"),
                                 ("blocks", "auto")):
        prep = prepare(x, neighbors=30, knn_method="bruteforce",
                       perplexity=10.0, assembly=assembly, device=dev)
        cfg = TsneConfig(perplexity=10.0, iterations=60,
                         attraction=attraction)
        gen = torch.Generator(device=dev).manual_seed(0)
        st0 = init_working_set(gen, 3001, 2, torch.float32, dev)
        outs = {}
        for d in (1, 2, 4):
            reset_launches()
            st, losses = ShardedOptimizer(cfg, 3001, devices=[dev] * d)(
                st0, prep.jidx, prep.jval, extra_edges=prep.extra_edges)
            got = launches()
            outs[d] = (st.y.cpu().numpy(), losses.cpu().numpy())
            assert got["B2"] == 60 * d and got["B4"] == 6 * d
        for d in (2, 4):
            np.testing.assert_array_equal(outs[d][0], outs[1][0])
            np.testing.assert_array_equal(outs[d][1], outs[1][1])


# ---- the multi-controller job ------------------------------------------------

def _ring_on_the_card(x, d, k, metric, matmul_dtype=None):
    from tsne_flink_tpu_torch.parallel.knn import ring_knn
    from tsne_flink_tpu_torch.parallel.mesh import (padded_rows_for,
                                                    run_shards)
    n = x.shape[0]
    npad = padded_rows_for(n, d)
    xp = torch.nn.functional.pad(x, (0, 0, 0, npad - n))
    nl = npad // d
    outs = run_shards([x.device] * d, lambda ax: ring_knn(
        xp[ax.index * nl:(ax.index + 1) * nl], k, n, metric, axis=ax,
        matmul_dtype=matmul_dtype))
    return (torch.cat([o[0] for o in outs])[:n],
            torch.cat([o[1] for o in outs])[:n])


@pytest.mark.parametrize("n,f,k,metric", [(3001, 50, 90, "sqeuclidean"),
                                          (2000, 784, 30, "sqeuclidean"),
                                          (1500, 20, 150, "cosine"),
                                          (800, 16, 300, "euclidean"),
                                          (2400, 50, 1100, "sqeuclidean")])
def test_knn_cross_sweep_matches_plain_and_the_ring_the_single_sweep(
        dev, n, f, k, metric):
    """B1's cross sweep on a row block against column blocks (padding
    columns and self masked by global id) against its plain version, and
    the ring over 2 and 4 shards of the card giving ``fused_knn``'s graph
    bit for bit, B1 launched once a hop."""
    from tsne_flink_tpu_torch.ops.knn_cuda import (fused_knn,
                                                   knn_cross_cuda,
                                                   knn_cross_plain)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)
                         ).to(dev)
    base = cosine_zbase(x) if metric == "cosine" else x
    cos = metric == "cosine"
    n_global = n - 7
    rows = base[100:700].contiguous()
    for c0, c1 in ((0, 600), (600, n), (300, 900)):
        cols = base[c0:c1].contiguous()
        kd, ki = knn_cross_cuda(rows, cols, k, cos, 100, c0, n_global)
        pd, pi = knn_cross_plain(rows, cols, k, cos, 100, c0, n_global)
        ki, kd = _fused_final(kd, ki, "sqeuclidean")
        held = ki >= 0
        assert torch.equal(held, pi >= 0)
        assert not bool(((ki >= n_global) | (ki == torch.arange(
            100, 700, device=dev)[:, None])).any())
        assert _set_agreement(ki.long(), pi.long()) >= 0.999
        torch.testing.assert_close(kd[held], pd[held], rtol=1e-4,
                                   atol=1e-4 * float(pd[held].max()))
    want_i, want_d = fused_knn(x, k, metric)
    for d in (2, 4):
        before = KERNELS["B1"].launches
        gi, gd = _ring_on_the_card(x, d, k, metric)
        assert KERNELS["B1"].launches == before + d * d
        assert torch.equal(gi, want_i) and torch.equal(gd, want_d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_n_valid_matches_plain(dev, dtype):
    """B6's first stage drops candidates at or past n_valid (a mesh's
    padding rows): every list id below it, against its plain version."""
    x, sq, graph, dist, gates = _refine_problem(dev, 3000, 50, 40, 300, 5,
                                                dtype=dtype)
    n_valid = 2900
    for row0 in (0, 2500):
        args = ("sqeuclidean", x, sq, row0, gates, graph[row0:row0 + 300],
                dist[row0:row0 + 300])
        kw = dict(graph=graph, ke=40, n_valid=n_valid)
        _hold_final(args, kw, False)
        gi, _ = refine_final(*args, **kw)
        old = graph[row0:row0 + 300]
        # a new id never crosses n_valid; old entries past it stay
        assert not bool(((gi >= n_valid) & ~(gi[:, :, None] == old[:, None, :])
                         .any(dim=2)).any())
        keep_i = _hold_keep((x, sq, row0, gates, 200), kw, False)
        assert not bool((keep_i >= n_valid).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_refine_shard_rows_equal_the_single_launch(dev, dtype):
    """A shard's launch (its rows' row0 into the gathered base, the
    mesh's n_valid) gives the same rows of one launch over every row bit
    for bit, on a first keep stage and a first exact stage (ROADMAP
    "Sharded launches"; B6_f64 at float64)."""
    x, sq, graph, dist, gates = _refine_problem(dev, 3000, 50, 40, 600, 5,
                                                dtype=dtype)
    kw = dict(graph=graph, ke=40, n_valid=2950)
    whole_k = refine_keep(x, sq, 0, gates, 200, **kw)[0]
    whole_f = refine_final("sqeuclidean", x, sq, 0, gates, graph[:600],
                           dist[:600], **kw)
    for r0, r1 in ((0, 256), (256, 600)):
        part_k = refine_keep(x, sq, r0, gates[r0:r1].contiguous(), 200,
                             **kw)[0]
        part_f = refine_final("sqeuclidean", x, sq, r0,
                              gates[r0:r1].contiguous(), graph[r0:r1],
                              dist[r0:r1], **kw)
        assert torch.equal(part_k, whole_k[r0:r1])
        assert torch.equal(part_f[0], whole_f[0][r0:r1])
        assert torch.equal(part_f[1], whole_f[1][r0:r1])


def test_two_processes_on_the_card_equal_mesh_1(dev, tmp_path):
    """Two gloo ranks on the one card (CUDA tensors staged through host
    memory): the multi-controller job's embedding equals the in-process
    job at mesh 1 bit for bit, the ring launching B1 twice a rank."""
    import socket
    import subprocess
    import sys
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    rng = np.random.default_rng(2)
    centers = rng.normal(0.0, 10.0, (12, 16))
    x = (centers[rng.integers(0, 12, 2001)]
         + rng.normal(0.0, 0.5, (2001, 16))).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    cfg = TsneConfig(perplexity=10.0, iterations=60)
    y1, _ = SpmdPipeline(cfg, 2001, 16, 30, n_devices=1)(torch.from_numpy(x))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    code = f"""
import numpy as np, torch
from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.parallel.mesh import distributed_init
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
import sys
r = int(sys.argv[1])
distributed_init("127.0.0.1:{port}", 2, r, timeout_s=120)
x = torch.from_numpy(np.load(r"{tmp_path / 'x.npy'}"))
pipe = SpmdPipeline(TsneConfig(perplexity=10.0, iterations=60), 2001, 16, 30)
assert pipe.axis.backend == "gloo" and pipe.axis.staged
y, _ = pipe(x)
assert KERNELS["B1"].launches == 2
np.save(r"{tmp_path}/y%d.npy" % r, y.cpu().numpy())
"""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              cwd=root) for r in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"y{r}.npy"),
                              y1.cpu().numpy())


# ---- B1's bf16-operand form (mixed precision, --dtype bfloat16) ------------

@pytest.mark.parametrize("n,f,k,data", [(4096, 784, 90, "blobs"),
                                        (4096, 50, 150, "cells"),
                                        (700, 33, 17, "blobs"),
                                        (300, 16, 299, "blobs"),
                                        (2500, 784, 1025, "blobs"),
                                        (2500, 50, 2048, "cells"),
                                        (1200, 16, 1199, "blobs")])
def test_knn_bf16_matches_plain(dev, n, f, k, data):
    """B1's bf16 form against its plain version run on float64 copies of
    the same points (the rounded operands' products exact there):
    distances within rtol 1e-5 of each plus 1e-5 of the largest, ids equal
    outside ties, two launches bit-identical, one launch counted a sweep
    under its own name and none under the 3xTF32 form's."""
    bf = torch.bfloat16
    src = _blobs(n, f, 2) if data == "blobs" else _cells(n, f, 2)
    x = torch.from_numpy(src).to(dev)
    before = (KERNELS["B1"].launches, KERNELS["B1_bf16"].launches)
    raw = knn_sweep_cuda(x, k, False, bf)
    again = knn_sweep_cuda(x, k, False, bf)
    assert (KERNELS["B1"].launches, KERNELS["B1_bf16"].launches) == (
        before[0], before[1] + 2)
    assert torch.equal(raw[0], again[0]) and torch.equal(raw[1], again[1])
    ik, dk = _fused_final(*raw, "sqeuclidean")
    kk = min(k + 1, n - 1)
    dp, ip = knn_sweep_plain(x.double(), kk, False, matmul_dtype=bf)
    tol = 1e-5 * (dp.abs() + dp[:, :k].abs().max())
    assert bool(((dk.double() - dp[:, :k]).abs() <= tol[:, :k]).all())
    gap = dp[:, 1:] - dp[:, :-1]
    tied = torch.zeros_like(ik, dtype=torch.bool)
    tied[:, :gap.shape[1]] |= gap[:, :k] <= tol[:, :gap.shape[1]]
    tied[:, 1:] |= gap[:, :k - 1] <= tol[:, 1:k]
    assert bool(((ik.long() == ip[:, :k].long()) | tied).all())


def test_knn_bf16_cross_equals_single_and_a_shard_the_mesh_1_rows(dev):
    """The bf16 ring at D = 2 and 4 on the test mesh gives the bf16
    single sweep's graph bit for bit (one K-loop order for both sweeps),
    and a shard's cross sweep against every column gives the mesh-1 rows
    bit for bit."""
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn, knn_cross
    bf = torch.bfloat16
    x = torch.from_numpy(_blobs(3001, 784, 3)).to(dev)
    want_i, want_d = fused_knn(x, 30, matmul_dtype=bf)
    for d in (2, 4):
        before = KERNELS["B1_bf16"].launches
        gi, gd = _ring_on_the_card(x, d, 30, "sqeuclidean", bf)
        assert KERNELS["B1_bf16"].launches == before + d * d
        assert torch.equal(gi, want_i) and torch.equal(gd, want_d)
    rows = x[1000:2000].contiguous()
    si, sd = knn_cross(rows, x, 30, False, 1000, 0, 3001, matmul_dtype=bf)
    assert torch.equal(si, want_i[1000:2000])
    assert torch.equal(sd, want_d[1000:2000])


# ---- the float64 forms of B1-B5 ---------------------------------------------

def _f64(*ts):
    """float64 copies of the float tensors among ``ts`` (others as they
    are; None stays None)."""
    return tuple(t.double() if t is not None and t.is_floating_point()
                 else t for t in ts)


def _b1_f64_gate(x, k, metric):
    """B1's float64 form against its plain version on the same float64
    points: each distance within 1e-12 of |d| + ‖a‖² + ‖b‖², ids equal
    outside ties (within that tolerance of a neighbour's distance)."""
    cos = metric == "cosine"
    base = cosine_zbase(x) if cos else x
    ik, dk = _fused_final(*knn_sweep_cuda(base, k, cos), "sqeuclidean")
    n = base.shape[0]
    kk = min(k + 1, n - 1)
    dp, ip = knn_sweep_plain(base, kk, cos)
    nrm = torch.sum(base * base, dim=1)
    scale = dp.abs() + nrm[:, None] + torch.gather(
        nrm, 0, ip.long().reshape(-1)).reshape(ip.shape)
    tol = 1e-12 * scale
    assert dk.dtype == torch.float64
    assert bool(((dk - dp[:, :k]).abs() <= tol[:, :k]).all())
    gap = dp[:, 1:] - dp[:, :-1]
    tied = torch.zeros_like(ik, dtype=torch.bool)
    tied[:, :gap.shape[1]] |= gap[:, :k] <= tol[:, :gap.shape[1]]
    tied[:, 1:] |= gap[:, :k - 1] <= tol[:, 1:k]
    assert bool(((ik.long() == ip[:, :k].long()) | tied).all())
    return ik, dk


@pytest.mark.parametrize("data,n,f,k,metric", [
    ("blobs", 3001, 784, 90, "sqeuclidean"),
    ("cells", 4096, 50, 150, "sqeuclidean"),
    ("blobs", 2000, 784, 300, "sqeuclidean"),   # the k <= 1,024 registers
    ("blobs", 1500, 784, K_REG_MAX, "sqeuclidean"),
    ("blobs", 1500, 784, K_REG_MAX + 1, "sqeuclidean"),  # pending class
    ("cells", 2200, 50, 2048, "sqeuclidean"),
    ("cells", 1100, 16, 1099, "sqeuclidean"),  # k = N - 1, pending class
    ("blobs", 1111, 100, 33, "euclidean"),     # N, F off every tile edge
    ("blobs", 2000, 784, 90, "cosine"),
    ("cells", 300, 16, 299, "sqeuclidean"),    # k = N - 1
])
def test_knn_f64_matches_plain(dev, data, n, f, k, metric):
    """B1_f64 against its plain version at float64, one launch a sweep
    under its own name (none under the float32 forms'), two launches bit
    for bit."""
    src = (_cells if data == "cells" else _blobs)(n, f, k)
    x = torch.from_numpy(src.astype(np.float64)).to(dev)
    before = {name: KERNELS[name].launches for name in
              ("B1", "B1_bf16", "B1_f64")}
    ik, dk = _b1_f64_gate(x, k, metric)
    again = knn_sweep_cuda(x, k, False) if metric != "cosine" else None
    got = {name: KERNELS[name].launches - before[name] for name in before}
    assert got == {"B1": 0, "B1_bf16": 0,
                   "B1_f64": 1 if again is None else 2}
    if again is not None:
        raw = knn_sweep_cuda(x, k, False)
        assert torch.equal(raw[0], again[0]) and torch.equal(raw[1],
                                                             again[1])


@pytest.mark.parametrize("n,f,k", [(5, 3, 4), (70, 16, 9), (200, 50, 90),
                                   (1000, 33, 17), (1300, 16, 1100),
                                   (2100, 12, 2048)])
def test_knn_f64_exact_ties_match_plain(dev, n, f, k):
    """Small-integer points: every distance is exact in float64, so the
    float64 form and its plain version agree bit for bit, ties broken by
    the lowest column."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 3, (n, f)).astype(np.float64))
    x = x.to(dev)
    ik, dk = _fused_final(*knn_sweep_cuda(x, k, False), "sqeuclidean")
    ip, dp = _fused_final(*knn_sweep_plain(x, k, False), "sqeuclidean")
    assert torch.equal(dk, dp) and torch.equal(ik, ip)


def test_knn_f64_ring_and_a_shard_equal_the_single_sweep(dev):
    """The float64 ring at D = 2 and 4 on the test mesh gives the float64
    single sweep's graph bit for bit (one K-loop order for both sweeps),
    D launches a shard of B1_f64, and a shard's cross sweep against every
    column gives the mesh-1 rows bit for bit."""
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn, knn_cross
    x = torch.from_numpy(_blobs(3001, 784, 3).astype(np.float64)).to(dev)
    want_i, want_d = fused_knn(x, 30)
    for d in (2, 4):
        before = KERNELS["B1_f64"].launches
        gi, gd = _ring_on_the_card(x, d, 30, "sqeuclidean")
        assert KERNELS["B1_f64"].launches == before + d * d
        assert torch.equal(gi, want_i) and torch.equal(gd, want_d)
    rows = x[1000:2000].contiguous()
    si, sd = knn_cross(rows, x, 30, False, 1000, 0, 3001)
    assert torch.equal(si, want_i[1000:2000])
    assert torch.equal(sd, want_d[1000:2000])


@pytest.mark.parametrize("form", ["bf16", "f64"])
def test_knn_ring_past_k1024_equals_the_single_sweep(dev, form):
    """The bf16 and float64 rings at D = 2 and 4 on the test mesh at k =
    1,100 (the pending class; a hop of 600 columns holds fewer than k):
    the form's single sweep's graph bit for bit, D launches a shard, and a
    shard's cross sweep against every column the mesh-1 rows."""
    from tsne_flink_tpu_torch.ops.knn_cuda import fused_knn, knn_cross
    src = _blobs(2400, 64, 4)
    x = torch.from_numpy(src.astype(np.float64) if form == "f64"
                         else src).to(dev)
    mdt = torch.bfloat16 if form == "bf16" else None
    kid = "B1_bf16" if form == "bf16" else "B1_f64"
    want_i, want_d = fused_knn(x, 1100, matmul_dtype=mdt)
    for d in (2, 4):
        before = KERNELS[kid].launches
        gi, gd = _ring_on_the_card(x, d, 1100, "sqeuclidean", mdt)
        assert KERNELS[kid].launches == before + d * d
        assert torch.equal(gi, want_i) and torch.equal(gd, want_d)
    si, sd = knn_cross(x[600:1200].contiguous(), x, 1100, False, 600, 0,
                       2400, matmul_dtype=mdt)
    assert torch.equal(si, want_i[600:1200])
    assert torch.equal(sd, want_d[600:1200])


def test_knn_f64_refuses_mixed_operands(dev):
    x = torch.from_numpy(_blobs(500, 64, 1).astype(np.float64)).to(dev)
    with pytest.raises(TypeError, match="float64"):
        knn_sweep_cuda(x, 10, False, torch.bfloat16)
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_cross_cuda
    with pytest.raises(TypeError, match="one dtype"):
        knn_cross_cuda(x, x.float(), 10, False, 0, 0, 500)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_repulsion_f64_matches_plain(dev, m):
    """B2_f64 against its plain version at rtol 1e-12 (of each value plus
    the largest: a sum over N columns cancels), at N off every block and
    split edge, on shards with a validity mask and on serving rows past
    the base; two launches bit for bit; B2 (float32) not launched."""
    rng = np.random.default_rng(m)
    y = torch.from_numpy(rng.standard_normal((20_011, m)) * 20.0).to(dev)
    before = (KERNELS["B2"].launches, KERNELS["B2_f64"].launches)
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True)
    assert rk.dtype == torch.float64
    _close_scaled(rk, rp, 1e-12)
    _close_scaled(zk, zp, 1e-12)
    again = cuda_exact_repulsion(y, row_z=True)
    assert torch.equal(again[0], rk) and torch.equal(again[1], zk)
    assert (KERNELS["B2"].launches, KERNELS["B2_f64"].launches) == (
        before[0], before[1] + 2)
    valid = torch.arange(20_011, device=dev) < 19_000
    for off in (0, 7001):
        shard = y[off:off + 4000].contiguous()
        rk, zk = cuda_exact_repulsion(shard, y, row_offset=off,
                                      col_valid=valid, row_z=True)
        rp, zp = exact_repulsion(shard, y, row_offset=off, col_valid=valid,
                                 row_z=True)
        _close_scaled(rk, rp, 1e-12)
        _close_scaled(zk, zp, 1e-12)
    yq = y[:256] + 0.5
    rk, zk = cuda_exact_repulsion(yq, y, row_offset=20_011, row_z=True)
    rp, zp = exact_repulsion(yq, y, row_offset=20_011, row_z=True)
    _close_scaled(rk, rp, 1e-12)
    _close_scaled(zk, zp, 1e-12)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_attraction_f64_matches_plain(dev, m):
    """B3_f64 over a head block and a ragged tail (a hub row, an empty
    row, padding) with a mask against its plain version (gains exactly
    equal; y, update, ‖grad‖² rtol 1e-12), B4_f64 and B5_f64 over the
    head and the ragged part (rtol 1e-12 of each plus the largest), and
    only the float64 forms launched."""
    y, hidx, hval, rag = _ragged_problem(dev, 300, 40, m, 50 + m)
    y, hval = _f64(y, hval)
    rag = att.Ragged(rag.rowptr, rag.src, rag.dst, rag.val.double())
    n = y.shape[0]
    rng = np.random.default_rng(m)
    rep = torch.from_numpy(0.1 * rng.standard_normal((n, m))).to(dev)
    z = torch.tensor(123.0, dtype=torch.float64, device=dev)
    upd = torch.from_numpy(1e-2 * rng.standard_normal((n, m))).to(dev)
    gains = torch.from_numpy(1.0 + rng.random((n, m))).to(dev)
    valid = torch.arange(n, device=dev) < n - 7
    args = (y, y, hidx, hval, 4.0, rep, z, valid, upd, gains, 0.5)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
    reset_launches()
    ok = att.fused_step_update(*args, **kw)
    op = att.fused_step_plain(*args, **kw)
    assert torch.equal(ok[2], op[2])
    for a, b in zip((ok[0], ok[1], ok[3]), (op[0], op[1], op[3])):
        assert a.dtype == torch.float64
        _close_scaled(a, b, 1e-12)
    for blk in ((hidx, hval), (None, None)):
        fk = att.attraction_forces(y, y, *blk, 4.0, ragged=rag)
        fp = att.attraction_forces_plain(y, y, *blk, 4.0, ragged=rag)
        _close_scaled(fk, fp, 1e-12)
        lk = att.attraction_loss(y, y, *blk, 4.0, z, ragged=rag)
        lp = att.attraction_loss_plain(y, y, *blk, 4.0, z, ragged=rag)
        _close_scaled(lk, lp, 1e-12)
    from tsne_flink_tpu_torch.kernels.build import launches
    got = {k: v for k, v in launches().items() if v}
    assert got == {"B3_f64": 1, "B4_f64": 2, "B5_f64": 2}


@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_one_launch_f64_equals_the_unfused_step_bit_for_bit(dev, m, masked):
    """B3_f64's one launch over a CSR head and tail against B5_f64 over
    head + tail, att − rep/Z and the vdM update in PyTorch at float64:
    the same bits, with a head block and without (W = 0)."""
    y, hidx, hval, rag = _ragged_problem(dev, 700, 48, m, 70 + m)
    y, hval = _f64(y, hval)
    rag = att.Ragged(rag.rowptr, rag.src, rag.dst, rag.val.double())
    n = y.shape[0]
    gen = torch.Generator(device=dev).manual_seed(m)
    rep = 1e-1 * torch.randn(y.shape, device=dev, dtype=torch.float64,
                             generator=gen)
    z = torch.tensor(1.0 + 0.37 * m, dtype=torch.float64, device=dev)
    upd = 1e-2 * torch.randn(y.shape, device=dev, dtype=torch.float64,
                             generator=gen)
    gains = 1.0 + torch.rand(y.shape, device=dev, dtype=torch.float64,
                             generator=gen)
    valid = (torch.arange(n, device=dev) % 9 != 4) if masked else None
    for blk in ((hidx, hval), (None, None)):
        got = att.fused_step_update(y, y, *blk, 4.0, rep, z, valid, upd,
                                    gains, 0.5, eta=200.0, min_gain=0.01,
                                    ragged=rag)
        forces = att.attraction_forces(y, y, *blk, 4.0, ragged=rag)
        want = _unfused_step(y, forces, rep, z, upd, gains, 0.5, 200.0,
                             valid)
        for a, b in zip(got[:3], want):
            assert torch.equal(a, b)


def test_attraction_f64_refuses_mixed_dtypes(dev):
    y, hidx, hval, _ = _ragged_problem(dev, 100, 8, 2, 1)
    with pytest.raises(ValueError, match="B5 kernel"):
        att.attraction_forces(y.double(), y.double(), hidx, hval, 4.0)
    with pytest.raises(TypeError, match="one dtype"):
        cuda_exact_repulsion(y.double(), y)


def _f64_blobs(dev, n=3001, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (12, d))
    return (centers[rng.integers(0, 12, n)]
            + rng.normal(0.0, 0.5, (n, d))), rng.integers(0, 12, n)


def test_mesh_f64_equals_mesh_1(dev):
    """The sharded optimizer at float64 with 2 shards on the card (the
    test mesh) gives mesh 1's bits on the CSR and rows layouts, each
    shard launching the float64 forms."""
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, init_working_set
    from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    x = torch.from_numpy(_f64_blobs(dev)[0]).to(dev)
    for attraction in ("csr", "rows"):
        prep = prepare(x, neighbors=30, knn_method="bruteforce",
                       perplexity=10.0, device=dev)
        assert prep.jval.dtype == torch.float64
        cfg = TsneConfig(perplexity=10.0, iterations=60,
                         attraction=attraction)
        gen = torch.Generator(device=dev).manual_seed(0)
        st0 = init_working_set(gen, 3001, 2, torch.float64, dev)
        outs = {}
        for d in (1, 2):
            reset_launches()
            st, losses = ShardedOptimizer(cfg, 3001, devices=[dev] * d)(
                st0, prep.jidx, prep.jval, extra_edges=prep.extra_edges)
            got = launches()
            outs[d] = (st.y.cpu().numpy(), losses.cpu().numpy())
            assert got["B2_f64"] == 60 * d and got["B4_f64"] == 6 * d
            assert got["B2"] == got["B3"] == got["B4"] == got["B5"] == 0
        np.testing.assert_array_equal(outs[2][0], outs[1][0])
        np.testing.assert_array_equal(outs[2][1], outs[1][1])


def test_float64_runs_on_the_card(dev, tmp_path):
    """float64 runs on the card through B1-B5's float64 forms: the
    estimator's fit (only the float64 forms launched) and its
    transform() on a float64 frozen model, the CLI's bruteforce line, and
    a fleet job spec with x64."""
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.runtime.fleet import JobSpec, run_job
    from tsne_flink_tpu_torch.utils import cli as tcli
    x, _ = _f64_blobs(dev, n=1500)
    reset_launches()
    est = TSNE(dtype="float64", knn_method="bruteforce", perplexity=10.0,
               n_iter=60, random_state=0).fit(x)
    got = {k: v for k, v in launches().items() if v}
    assert set(got) <= {"B1_f64", "B2_f64", "B3_f64", "B4_f64", "B5_f64"}
    assert got["B1_f64"] == 1 and got["B2_f64"] == 60
    assert got.get("B3_f64", 0) + got.get("B5_f64", 0) == 60
    assert est.embedding_.dtype == np.float64
    assert np.isfinite(est.kl_divergence_)
    assert est.frozen_model().x.dtype == torch.float64
    q = est.transform(x[:40] + 0.01)
    assert q.shape == (40, 2) and np.isfinite(q).all()
    path = tmp_path / "in.csv"
    with open(path, "w") as fh:
        for i in range(600):
            for j in range(x.shape[1]):
                fh.write(f"{i},{j},{float(x[i, j])!r}\n")
    reset_launches()
    assert tcli.main(["--input", str(path), "--output",
                      str(tmp_path / "o.csv"), "--dimension", "16",
                      "--knnMethod", "bruteforce", "--perplexity", "8",
                      "--iterations", "50", "--dtype", "float64",
                      "--noCache"]) == 0
    assert launches()["B1_f64"] == 1 and launches()["B1"] == 0
    np.save(tmp_path / "x.npy", x[:800])
    reset_launches()
    rec = run_job(JobSpec(name="f64", input=str(tmp_path / "x.npy"),
                          iterations=40, perplexity=8, x64=True))
    assert rec["status"] == "ok", rec
    assert launches()["B2_f64"] == 40 and launches()["B2"] == 0


def _no_float32_form(counts):
    return all(v == 0 for k, v in counts.items() if not k.endswith("_f64"))


def test_float64_project_runs_on_the_card(dev, tmp_path):
    """A float64 run on the card whose kNN plan refines runs through
    B6_f64 (the plan a float64 run was refused on before B6 had its
    float64 form): ``prepare`` with the auto refine cycles and
    ``TSNE(dtype="float64", knn_method="project").fit``, each launching
    B6_f64 one stage a chunk a cycle and no float32 form."""
    from tsne_flink_tpu_torch import TSNE
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    x = torch.from_numpy(_f64_blobs(dev, n=9000)[0]).to(dev)
    cycles = tknn.pick_knn_refine(9000, 16)
    chunks = -(-9000 // pick_knn_tiles(9000, 16, 30, "cuda").refine_chunk)
    reset_launches()
    prep = prepare(x, neighbors=30, knn_method="project", perplexity=10.0,
                   device=dev)
    got = launches()
    assert cycles > 0 and got["B6_f64"] == cycles * chunks
    assert _no_float32_form(got)
    assert prep.dist.dtype == prep.jval.dtype == torch.float64
    assert bool(torch.isfinite(prep.dist).all())
    reset_launches()
    est = TSNE(dtype="float64", knn_method="project", perplexity=10.0,
               n_iter=30, random_state=0).fit(x.cpu().numpy())
    got = launches()
    assert got["B6_f64"] == cycles * chunks and _no_float32_form(got)
    assert est.embedding_.dtype == np.float64
    assert np.isfinite(est.kl_divergence_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_project_past_k1024_runs_b6_on_its_workspace_route(dev, dtype):
    """``prepare`` with a refining ``project`` plan at k = 1,200 on 4,000
    cells x 50: each chunk's first (exact) stage proposes 16·1,201
    candidates a row, past the block's shared memory, so every B6 launch
    takes the workspace route; no B1 launch; the graph within the exact
    one's k-th distance for >= 0.9 of its slots."""
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.ops.knn_cuda import (fused_knn,
                                                   reset_route_launches)
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    x = torch.from_numpy(_cells(4000, 50, 8)).to(dev, dtype)
    form = "B6_f64" if dtype == torch.float64 else "B6"
    reset_launches()
    reset_route_launches()
    prep = prepare(x, neighbors=1200, knn_method="project", knn_refine=1,
                   perplexity=100.0, device=dev)
    got = launches()
    assert got[form] > 0 and got["B1"] == got["B1_f64"] == 0
    assert ROUTE_LAUNCHES == {f"{form} workspace": got[form]}
    _, dist_e = fused_knn(x, 1200)
    kth = dist_e[:, -1:] * (1 + 1e-5) + 1e-5
    assert float((prep.dist <= kth).double().mean()) >= 0.9


# ---- the wide forms (m > 8): B2w-B5w and their float64 forms ----------------

def _wide_rtol(dtype):
    """The bars of the wide forms against their plain versions: as the
    m <= 8 instances' (rtol 2e-5, the fused step's y 1e-4; 1e-12 at
    float64), with an absolute part of rtol·max."""
    return (2e-5, 1e-4) if dtype == torch.float32 else (1e-12, 1e-12)


def _wide_id(base, dtype):
    return base + "w" + ("_f64" if dtype == torch.float64 else "")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(97, 9), (530, 16), (3001, 17),
                                 (20_011, 33), (300, 64), (700, 130),
                                 (257, 256)])
def test_wide_repulsion_matches_plain(dev, n, m, dtype):
    """B2w past m = 8: against its plain version (N below a block, ragged
    N, S > 1, one and several force chunks), two launches bit for bit,
    counted under the wide form alone."""
    rng = np.random.default_rng(n + m)
    y = torch.from_numpy(rng.standard_normal((n, m)) * 10.0).to(dev, dtype)
    kid = _wide_id("B2", dtype)
    before = {k: KERNELS[k].launches for k in (kid, "B2", "B2_f64")}
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True, row_chunk=max(64, 16384 // m))
    rtol = _wide_rtol(dtype)[0]
    _close_scaled(rk, rp, rtol)
    _close_scaled(zk, zp, rtol)
    again = cuda_exact_repulsion(y, row_z=True)
    assert torch.equal(again[0], rk) and torch.equal(again[1], zk)
    got = {k: KERNELS[k].launches - v for k, v in before.items()}
    assert got == {kid: 2, "B2": 0, "B2_f64": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [16, 64])
def test_wide_repulsion_far_from_the_origin_holds_to_float64(dev, m, dtype):
    """B2w on rows far from the origin (y = 1e3 + 10·N(0, 1)): against a
    float64 evaluation its force and Z err at most twice the plain float32
    version's own (it forms each difference y_i − y_j from the
    coordinates, as the plain version does; the norm trick would cancel
    here), and it holds to the plain version at rtol 2e-5 of the max.
    B2w_f64 there (past m = 16 its force in product form, which cancels
    ~100x at these rows) holds to its plain version at 1e-12 of the max,
    two launches bit for bit."""
    rng = np.random.default_rng(1000 + m)
    n = 6007
    y = torch.from_numpy(1e3 + 10.0 * rng.standard_normal((n, m))).to(
        dev, dtype)
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    chunk = max(64, 16384 // m)
    rp, zp = exact_repulsion(y, row_z=True, row_chunk=chunk)
    if dtype == torch.float64:
        _close_scaled(rk, rp, _wide_rtol(dtype)[0])
        _close_scaled(zk, zp, _wide_rtol(dtype)[0])
        again = cuda_exact_repulsion(y, row_z=True)
        assert torch.equal(again[0], rk) and torch.equal(again[1], zk)
        return
    r64, z64 = exact_repulsion(y.double(), row_z=True, row_chunk=chunk)
    for got, plain, want in ((rk, rp, r64), (zk, zp, z64)):
        ek = float((got.double() - want).abs().max())
        ep = float((plain.double() - want).abs().max())
        assert ek <= 2.0 * ep, (m, ek, ep)
        _close_scaled(got, plain, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_repulsion_shard_is_the_mesh_1_rows(dev, dtype):
    """At m = 16 a row shard with a column mask, at the canonical split
    count, gives the rows of the launch over all of them bit for bit, and
    holds to its plain version."""
    rng = np.random.default_rng(16)
    n, n_pad = 9000, 9472
    y = torch.zeros((n_pad, 16), dtype=dtype)
    y[:n] = torch.from_numpy(rng.standard_normal((n, 16)) * 10.0)
    y = y.to(dev)
    valid = torch.arange(n_pad, device=dev) < n
    canon = n_pad // 8
    full = cuda_exact_repulsion(y, col_valid=valid, row_z=True,
                                split_rows=canon)
    rtol = _wide_rtol(dtype)[0]
    for off, rows in ((0, 1184), (3001, 2472), (7000, 2472)):
        shard = y[off:off + rows].contiguous()
        got = cuda_exact_repulsion(shard, y, row_offset=off, col_valid=valid,
                                   row_z=True, split_rows=canon)
        assert torch.equal(got[0], full[0][off:off + rows])
        assert torch.equal(got[1], full[1][off:off + rows])
        want = exact_repulsion(shard, y, row_offset=off, col_valid=valid,
                               row_z=True)
        _close_scaled(got[0], want[0], rtol)
        _close_scaled(got[1], want[1], rtol)


def _wide_ragged(dev, n, w, m, seed, dtype):
    y, jidx, jval, rag = _ragged_problem(dev, n, w, m, seed)
    y = y.to(dtype)
    jval = None if jval is None else jval.to(dtype)
    return y, jidx, jval, rag._replace(val=rag.val.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [9, 16, 31, 64, 100, 129, 300])
@pytest.mark.parametrize("w", [0, 90])
def test_wide_forces_and_loss_match_plain(dev, m, w, dtype):
    """B5w and B4w over a row block and a ragged edge part (a hub row of
    3,000 edges, a row with none, the last row owning padding), or the
    edges alone, against their plain versions; two launches bit for bit;
    a shard of rows against the full embedding; one launch over both
    parts the head's plus the tail's, bit for bit."""
    y, jidx, jval, rag = _wide_ragged(dev, 700, w, m, 10 * m + w, dtype)
    rtol = _wide_rtol(dtype)[0]
    ak = att.attraction_forces(y, y, jidx, jval, 4.0, ragged=rag)
    ap = att.attraction_forces_plain(y, y, jidx, jval, 4.0, ragged=rag)
    _close_scaled(ak, ap, rtol)
    assert torch.equal(ak, att.attraction_forces(y, y, jidx, jval, 4.0,
                                                 ragged=rag))
    z = torch.tensor(321.0, device=dev, dtype=dtype)
    lk = att.attraction_loss(y, y, jidx, jval, 1.0, z, ragged=rag)
    lp = att.attraction_loss_plain(y, y, jidx, jval, 1.0, z, ragged=rag)
    _close_scaled(lk, lp, rtol)
    assert torch.equal(lk, att.attraction_loss(y, y, jidx, jval, 1.0, z,
                                               ragged=rag))
    if w:
        head = att.attraction_forces(y, y, jidx, jval, 4.0)
        tail = att.attraction_forces(y, y, None, None, 4.0, ragged=rag)
        assert torch.equal(ak, head + tail)
    sl = slice(300, 500)
    sub = att.ragged_edges(*(a[int(rag.rowptr[300]):int(rag.rowptr[500])]
                             for a in (rag.src - 300, rag.dst, rag.val)),
                           200)
    blk = (None, None) if jidx is None else (jidx[sl], jval[sl])
    _close_scaled(att.attraction_forces(y[sl], y, *blk, 1.0, ragged=sub),
                  att.attraction_forces_plain(y[sl], y, *blk, 1.0,
                                              ragged=sub), rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [9, 16, 64, 129, 300])
def test_wide_fused_step_is_the_unfused_step(dev, m, dtype):
    """B3w's one launch over a CSR head and tail, with a mask: the unfused
    step (B5w over head + tail, att − rep/Z, the vdM update) bit for bit,
    with the head and without it, in index order and hubs first; against
    its plain version on tie-free inputs (gains equal, y and update and
    ‖grad‖² within the bar)."""
    y, hidx, hval, rag = _wide_ragged(dev, 700, 48, m, 70 + m, dtype)
    n = y.shape[0]
    rng = np.random.default_rng(m)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)
    rep = t(1e-1 * rng.standard_normal((n, m)))
    z = torch.tensor(1.0 + 0.37 * m, device=dev, dtype=dtype)
    upd = t(1e-2 * rng.standard_normal((n, m)))
    gains = t(1.0 + rng.random((n, m)))
    valid = torch.arange(n, device=dev) % 9 != 4
    for blk in ((hidx, hval), (None, None)):
        forces = att.attraction_forces(y, y, *blk, 4.0, ragged=rag)
        want = _unfused_step(y, forces, rep, z, upd, gains, 0.5, 200.0,
                             valid)
        for order in (None, att.visit_order(rag)):
            got = att.fused_step_update(y, y, *blk, 4.0, rep, z, valid, upd,
                                        gains, 0.5, eta=200.0,
                                        min_gain=0.01, ragged=rag,
                                        order=order)
            for a, b in zip(got[:3], want):
                assert torch.equal(a, b)
    # tie-free: every grad at ±(|att| + a margin)
    forces = att.attraction_forces(y, y, hidx, hval, 4.0, ragged=rag)
    sign = t(rng.choice([-1.0, 1.0], (n, m)))
    rep = (forces - sign * (forces.abs() + 1e-3 * forces.abs().max()))
    one = torch.ones((), device=dev, dtype=dtype)
    args = (y, y, hidx, hval, 4.0, rep.contiguous(), one, valid, upd, gains,
            0.8)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag)
    ok = att.fused_step_update(*args, **kw)
    op = att.fused_step_plain(*args, **kw)
    assert torch.equal(ok[2], op[2])
    rtol = _wide_rtol(dtype)[1]
    for a, b in zip(ok[:2] + ok[3:], op[:2] + op[3:]):
        _close_scaled(a, b, rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [16, 64])
def test_wide_slot_walk_at_the_ragged_extremes(dev, m, dtype):
    """B5w and B3w where their slot walk is most uneven: a CSR head [n, 64]
    (30% padding) whose row 2 is all padding, and a tail whose row 0 is a
    hub of 3,500 edges while rows 1 and 2 have none (row 2 has no slot at
    all).  B5w against its plain version, row 2's force exactly 0; B3w,
    hubs first, the unfused step bit for bit; two launches of each bit
    for bit."""
    rng = np.random.default_rng(3500 + m)
    n, w = 900, 64

    def t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a)).to(dev, dt)
    y = t(3.0 * rng.standard_normal((n, m)))
    hidx = t(rng.integers(0, n, (n, w)), torch.int32)
    v = rng.random((n, w)) * 1e-3
    v[rng.random((n, w)) < 0.3] = 0.0
    v[2] = 0.0
    hval = t(v)
    deg = rng.integers(0, 12, n)
    deg[0], deg[1], deg[2] = 3500, 0, 0
    rag = att.ragged_edges(t(np.repeat(np.arange(n), deg), torch.int32),
                           t(rng.integers(0, n, int(deg.sum())), torch.int32),
                           t(rng.random(int(deg.sum())) * 1e-3), n)
    fk = att.attraction_forces(y, y, hidx, hval, 4.0, ragged=rag)
    assert torch.equal(fk, att.attraction_forces(y, y, hidx, hval, 4.0,
                                                 ragged=rag))
    _close_scaled(fk, att.attraction_forces_plain(y, y, hidx, hval, 4.0,
                                                  ragged=rag),
                  _wide_rtol(dtype)[0])
    assert not bool(fk[2].any())
    rep = t(1e-1 * rng.standard_normal((n, m)))
    z = torch.tensor(1.0 + 0.37 * m, device=dev, dtype=dtype)
    upd = t(1e-2 * rng.standard_normal((n, m)))
    gains = t(1.0 + rng.random((n, m)))
    args = (y, y, hidx, hval, 4.0, rep, z, None, upd, gains, 0.5)
    kw = dict(eta=200.0, min_gain=0.01, ragged=rag,
              order=att.visit_order(rag))
    got = att.fused_step_update(*args, **kw)
    for a, b in zip(got[:3], _unfused_step(y, fk, rep, z, upd, gains, 0.5,
                                           200.0)):
        assert torch.equal(a, b)
    for a, b in zip(got, att.fused_step_update(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_embed_launches_the_wide_forms(dev, dtype):
    """``tsne_embed`` at n_components 12 on the card: B2w, the step's
    kernel (B3w or B5w) and B4w, each under its dtype's name, and no
    register-held instance; a finite embedding, falling KL."""
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches
    x = _cells(2000, 20, 5).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    reset_launches()
    y, losses = tsne_embed(x, TsneConfig(n_components=12, perplexity=10.0,
                                         iterations=120), device=dev)
    got = {k: v for k, v in launches().items() if v}
    sfx = "_f64" if dtype == torch.float64 else ""
    step = "B3w" if got.get("B3w" + sfx) else "B5w"
    assert got == {"B1" + sfx: 1, "B2w" + sfx: 120, step + sfx: 120,
                   "B4w" + sfx: 12}
    assert tuple(y.shape) == (2000, 12) and bool(torch.isfinite(y).all())
    assert float(losses[-1]) < float(losses[10])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", [9, 16, 100])
def test_wide_widths_run_through_each_route(dev, tmp_path, m, dtype):
    """n_components 9, 16 (one force chunk) and 100 (several chunks) at
    each dtype through ``tsne_embed``, ``TSNE(n_components=m).fit`` and
    the CLI's ``--nComponents m``: a finite embedding of m columns, and
    only the dtype's wide forms (with B1) launched."""
    from tsne_flink_tpu_torch import TSNE, TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches
    from tsne_flink_tpu_torch.utils import cli as tcli
    sfx = "_f64" if dtype == "float64" else ""
    allowed = {"B1" + sfx} | {f"B{i}w{sfx}" for i in (2, 3, 4, 5)}
    x = _cells(600, 12, 4).astype(dtype)

    def wide_only():
        got = {k: v for k, v in launches().items() if v}
        assert set(got) <= allowed and got["B2w" + sfx] > 0, got

    reset_launches()
    y, losses = tsne_embed(x, TsneConfig(n_components=m, perplexity=8.0,
                                         iterations=40), device=dev)
    assert tuple(y.shape) == (600, m) and bool(torch.isfinite(y).all())
    wide_only()
    reset_launches()
    est = TSNE(n_components=m, perplexity=8.0, n_iter=40, random_state=0,
               dtype=dtype).fit(x)
    assert est.embedding_.shape == (600, m)
    assert np.isfinite(est.embedding_).all()
    wide_only()
    path, out = tmp_path / "in.csv", tmp_path / "o.csv"
    with open(path, "w") as fh:
        fh.writelines(f"{i},{j},{float(x[i, j])!r}\n"
                      for i in range(x.shape[0]) for j in range(x.shape[1]))
    reset_launches()
    assert tcli.main(["--input", str(path), "--output", str(out),
                      "--dimension", str(x.shape[1]), "--knnMethod",
                      "bruteforce", "--perplexity", "8", "--iterations",
                      "40", "--nComponents", str(m), "--dtype", dtype,
                      "--noCache"]) == 0
    rows = np.loadtxt(out, delimiter=",", ndmin=2)
    assert rows.shape == (600, m + 1) and np.isfinite(rows).all()
    wide_only()


def test_wide_geometry_mirrors_the_kernels(dev):
    """The wide forms' geometry the Python side mirrors for the memory
    model (M_NARROW, B2w's rows a block and the dims its force takes at
    once, B3w-B5w's dims a chunk and chunks) equals what the kernel
    library states, at every m = 1 .. 520 and both dtypes."""
    from tsne_flink_tpu_torch.kernels.build import M_NARROW
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops import repulsion_cuda as rc
    for m in range(1, 521):
        for f64 in (False, True):
            assert att.kernel_wide_config(m, f64) == (
                M_NARROW, att.wide_dims(f64), att.wide_chunks(m, f64))
            assert rc.kernel_wide_config(m, f64) == (
                M_NARROW, rc.wide_rows(m, f64), rc.wide_chunk(m, f64))


def test_wide_mesh_equals_mesh_1(dev):
    """``TSNE(n_components=16)`` on the test mesh of 2 gives the mesh of
    1's bits on the card (B2w's canonical splits, B3w's per-row sums)."""
    from tsne_flink_tpu_torch import TSNE
    x = _cells(3000, 20, 6)
    kw = dict(n_components=16, perplexity=10.0, n_iter=60, random_state=0)
    y1 = TSNE(mesh=["cuda:0"], **kw).fit_transform(x)
    y2 = TSNE(mesh=["cuda:0"] * 2, **kw).fit_transform(x)
    assert y1.shape == (3000, 16) and np.isfinite(y1).all()
    np.testing.assert_array_equal(y2, y1)
