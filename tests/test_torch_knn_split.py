"""Kernel B1's "3xTF32" arithmetic, checked on the CPU.

B1 computes its distance tiles on the tensor cores from a TF32 split of
the points, ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(``ops/knn_cuda.tf32_split``), as lo·hiᵀ + hi·loᵀ + hi·hiᵀ.  No card runs
here, so the product is emulated in float64 on the TF32-rounded parts, on
the MNIST-like blobs of ``bench.make_data``, and held against the float64
graph: it must agree with it at least as well as the FP32 plain sweep
does, and a single TF32 pass must not (the reason for three passes).
"""

import numpy as np
import pytest
import torch

from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final, knn_sweep_plain,
                                               norm_pairs, tf32_split)

pytestmark = pytest.mark.fast

N = 2000


def _make_data(n, d, classes=10, seed=0):
    """bench.py's make_data: 10-class blobs in [0, 1] with noise 0.15."""
    rng = np.random.default_rng(seed)
    centers = rng.random((classes, d)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    x = centers[labels] + 0.15 * rng.standard_normal((n, d)).astype(
        np.float32)
    return np.clip(x, 0.0, 1.0)


def _graph(d, k):
    """Each row's k smallest by (distance, column), the self excluded."""
    d = d.clone()
    d.fill_diagonal_(float("inf"))
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def _sqdist(products, x64):
    """|a|² + |b|² − 2g in float64, clamped at 0, with g the sum of the
    given float64 products."""
    n2 = torch.sum(x64 * x64, dim=1)
    return torch.clamp(n2[:, None] + n2[None, :] - 2.0 * sum(products), min=0)


def test_split_parts_are_exact_tf32_and_sum_to_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(5000) * 10.0 ** rng.integers(-6, 6, 5000),
        [0.0, -0.0, 1.0, -1.0, 1.5]]).astype(np.float32))
    hi, lo = tf32_split(x)
    assert hi.dtype == lo.dtype == torch.float32
    low_bits = (1 << 13) - 1
    assert int((hi.view(torch.int32) & low_bits).abs().sum()) == 0
    assert int((lo.view(torch.int32) & low_bits).abs().sum()) == 0
    x64 = x.double()
    resid = torch.abs(x64 - hi.double() - lo.double())
    assert bool((resid <= 2.0 ** -21 * torch.abs(x64)).all())
    # rounding to nearest: hi is within half a TF32 step of x
    assert bool((torch.abs(x64 - hi.double())
                 <= 2.0 ** -11 * torch.abs(x64)).all())


def test_norm_pairs_carry_the_float64_norms():
    x = torch.from_numpy(_make_data(300, 784))
    pairs = norm_pairs(x)
    want = torch.sum(x.double() ** 2, dim=1)
    got = pairs[:300, 0].double() + pairs[:300, 1].double()
    assert pairs.shape == (301, 2) and pairs.dtype == torch.float32
    assert not bool(pairs[300].any())
    assert float(torch.max(torch.abs(got - want) / want)) < 1e-13


@pytest.mark.parametrize("f", [784, 50])
def test_three_tf32_passes_beat_fp32_one_pass_does_not(f):
    x = torch.from_numpy(_make_data(N, f))
    x64 = x.double()
    d64 = _sqdist([x64 @ x64.T], x64)
    hi, lo = (p.double() for p in tf32_split(x))
    d3 = _sqdist([lo @ hi.T, hi @ lo.T, hi @ hi.T], x64)
    d1 = _sqdist([hi @ hi.T], x64)
    scale = float(d64.max())
    assert float(torch.max(torch.abs(d3 - d64))) <= 1e-5 * scale
    for k in (90, 256):
        ref = _graph(d64, k)
        three = float((_graph(d3, k) == ref).double().mean())
        one = float((_graph(d1, k) == ref).double().mean())
        plain, _ = _fused_final(*knn_sweep_plain(x, k, False), "sqeuclidean")
        fp32 = float((plain.long() == ref).double().mean())
        assert three >= 0.999, (k, three)
        assert three >= fp32, (k, three, fp32)
        assert one < 0.99, (k, one)
