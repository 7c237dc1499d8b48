"""The port's estimator and kNN autotune against the JAX package's.

* ``TSNE``'s keyword arguments are the JAX estimator's, with the same
  defaults, plus ``device`` and ``fault_plan``; ``aot_cache`` runs;
* ``fit`` equals the port's ``tsne_embed`` bit for bit and ends within
  ``KL_GUARDRAIL_TOL`` of the JAX estimator; ``transform`` raises before
  a fit and serves after one; ``dtype="bfloat16"`` (mixed precision) fits
  with float32 state, as ``tsne_embed`` under bf16 operands, bit for
  bit;
* ``autotune_knn_tiles`` returns a refine chunk from its candidates, and
  the refine result is bit-identical at every candidate chunk (the port's
  form of ``test_refine_row_chunk_invariant``).
"""

import inspect

import numpy as np
import pytest
import torch

from tsne_flink_tpu.models.api import TSNE as JaxTSNE
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu_torch import TSNE, TsneConfig, tsne_embed
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_tiles

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Test workers share the host; many small ops run far slower with
    contending intra-op thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n=600, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (12, d))
    return centers[rng.integers(0, 12, n)] + rng.normal(0.0, 0.5, (n, d))


def test_kwargs_are_the_jax_estimators_plus_device():
    port = inspect.signature(TSNE.__init__).parameters
    ref = inspect.signature(JaxTSNE.__init__).parameters
    # fault_plan: the JAX estimator reads its plan from the environment
    assert list(port) == list(ref) + ["device", "fault_plan"]
    for name, p in ref.items():
        assert port[name].default == p.default, name
        assert port[name].kind == p.kind, name
    assert port["device"].default is None
    assert port["fault_plan"].default is None


@pytest.mark.parametrize("aot_cache", [True, False])
def test_aot_cache_runs(aot_cache):
    from tsne_flink_tpu_torch.kernels.build import cache_enabled
    x = _blobs(300).astype(np.float32)
    est = TSNE(perplexity=8.0, n_iter=30, aot_cache=aot_cache,
               device="cpu").fit(x)
    ref = TSNE(perplexity=8.0, n_iter=30, device="cpu").fit(x)
    np.testing.assert_array_equal(est.embedding_, ref.embedding_)
    assert cache_enabled() is None  # the fit restored the setting


@pytest.mark.parametrize("method", ["bruteforce", "project"])
def test_fit_is_tsne_embed(method):
    x = _blobs().astype(np.float32)
    est = TSNE(perplexity=8.0, n_iter=150, knn_method=method,
               random_state=3, device="cpu").fit(x)
    y, losses = tsne_embed(x, TsneConfig(perplexity=8.0, iterations=150),
                           knn_method=method, seed=3, device="cpu")
    np.testing.assert_array_equal(est.embedding_, y.numpy())
    np.testing.assert_array_equal(est.kl_trace_, losses.numpy())
    assert est.kl_divergence_ == float(losses[-1])
    assert est.embedding_.dtype == np.float32
    np.testing.assert_array_equal(
        TSNE(perplexity=8.0, n_iter=150, knn_method=method, random_state=3,
             device="cpu").fit_transform(x), est.embedding_)


def test_fit_within_guardrail_of_jax_and_keeps_f64_on_cpu():
    x = _blobs()
    est = TSNE(perplexity=8.0, device="cpu").fit(x)
    assert est.embedding_.dtype == np.float64
    ref = JaxTSNE(perplexity=8.0).fit(x)
    assert abs(est.kl_divergence_ - ref.kl_divergence_) <= KL_GUARDRAIL_TOL


def test_cache_dir_warm_fit_bit_identical(tmp_path, monkeypatch):
    x = _blobs(300).astype(np.float32)
    kw = dict(perplexity=8.0, n_iter=40, knn_method="project",
              cache_dir=str(tmp_path), device="cpu")
    cold = TSNE(**kw).fit(x).embedding_
    assert sorted(p.name.split("-")[0] for p in tmp_path.iterdir()) == [
        "affinity", "knn"]

    def boom(*a, **k):
        raise AssertionError("the kNN stage ran on a warm cache")

    monkeypatch.setattr(tknn, "knn", boom)
    np.testing.assert_array_equal(TSNE(**kw).fit(x).embedding_, cold)


@pytest.mark.parametrize("method", ["bruteforce", "project"])
def test_bfloat16_fits_with_float32_state(method):
    """``dtype="bfloat16"`` runs on the CPU: a float32 embedding (from a
    float64 input), ``tsne_embed``'s under bf16 operands bit for bit."""
    x = _blobs(300)
    est = TSNE(perplexity=8.0, n_iter=60, knn_method=method, random_state=3,
               dtype="bfloat16", device="cpu").fit(x)
    assert est.embedding_.dtype == np.float32
    y, _ = tsne_embed(x.astype(np.float32),
                      TsneConfig(perplexity=8.0, iterations=60),
                      knn_method=method, seed=3, device="cpu",
                      matmul_dtype=torch.bfloat16)
    np.testing.assert_array_equal(est.embedding_, y.numpy())


@pytest.mark.parametrize("kw,width", [
    ({"spmd": True}, 1), ({"devices": 2}, 2), ({"mesh": 1}, 1),
    ({"mesh": 2, "mesh_reduce": "psum"}, 2)],
    ids=["spmd", "devices", "mesh", "mesh_reduce"])
def test_mesh_kwargs_run(monkeypatch, kw, width):
    """The mesh keywords (ported): the fit's optimize stage runs on a
    point mesh of CPU shards of the asked width and reduction."""
    import warnings

    from tsne_flink_tpu_torch.parallel import mesh as tmesh
    seen = []
    real = tmesh.ShardedOptimizer.segment

    def segment(self, *a, **k):
        seen.append((self.n_devices, self.mesh_reduce))
        return real(self, *a, **k)

    monkeypatch.setattr(tmesh.ShardedOptimizer, "segment", segment)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        est = TSNE(device="cpu", perplexity=5.0, n_iter=30,
                   knn_method="bruteforce", **kw)
    y = est.fit_transform(_blobs(120, 6))
    assert y.shape == (120, 2) and np.isfinite(y).all()
    assert set(seen) == {(width, kw.get("mesh_reduce", "canonical"))}


@pytest.mark.parametrize("kw", [{"sym_mode": "alltoall"}, {"sym_slack": 4},
                                {"sym_strict": True}],
                         ids=["sym_mode", "sym_slack", "sym_strict"])
def test_sym_kwargs_run(kw):
    """The symmetrization keywords (ported): a fit outside a
    multi-controller job takes them and keeps its single-controller bits,
    as the JAX estimator does (they shape ``spmd=True`` under a process
    group: tests/test_torch_multiprocess.py)."""
    x = _blobs(120, 6)
    base = dict(device="cpu", perplexity=5.0, n_iter=30,
                knn_method="bruteforce")
    y = TSNE(**base, **kw).fit_transform(x)
    assert np.array_equal(y, TSNE(**base).fit_transform(x))


def test_auto_bh_and_transform_refused(monkeypatch):
    """An explicit theta past EXACT_N_MAX runs Barnes-Hut (A12 is
    ported); transform is refused only before a fit (A13 is ported), and
    its query loop runs no Barnes-Hut."""
    from tsne_flink_tpu_torch.ops import repulsion_bh
    from tsne_flink_tpu_torch.utils import cli
    monkeypatch.setattr(cli, "EXACT_N_MAX", {"cpu": 10})
    calls = []
    real = repulsion_bh.bh_repulsion

    def counted(*a, **k):
        calls.append(k["theta"])
        return real(*a, **k)

    monkeypatch.setattr(repulsion_bh, "bh_repulsion", counted)
    est = TSNE(theta=0.5, n_iter=20, perplexity=5.0, device="cpu")
    x = _blobs(40)
    est.fit(x)
    assert calls == [0.5] * 20 and np.isfinite(est.embedding_).all()
    unfitted = TSNE(device="cpu")
    for call in (lambda: unfitted.transform(_blobs(5)),
                 unfitted.frozen_model):
        with pytest.raises(RuntimeError, match="fit"):
            call()
    # the frozen model serves exact repulsion (bh is demoted for queries)
    assert est.frozen_model().repulsion == "exact"
    yq = est.transform(x[:8], bucket=8, iters=20)
    assert yq.shape == (8, 2) and np.isfinite(yq).all()
    assert calls == [0.5] * 20  # no Barnes-Hut call on the query path
    with pytest.raises(ValueError, match="not defined"):
        TSNE(attraction="diagonal")


def test_autotune_picks_a_candidate_and_refine_is_chunk_invariant():
    n, d, k = 2_200, 16, 12
    x = torch.from_numpy(_blobs(n, d, seed=5).astype(np.float32))
    plan = knn_tiles.pick_knn_tiles(n, d, k, "cpu")
    tuned = knn_tiles.autotune_knn_tiles(x, k, plan=plan)
    cands = {plan.refine_chunk, max(knn_tiles.MIN_REFINE_CHUNK,
                                    plan.refine_chunk // 2),
             min(knn_tiles.MAX_REFINE_CHUNK, plan.refine_chunk * 2)}
    assert tuned.refine_chunk in cands and len(cands) > 1
    assert tuned.source == "autotune" and plan.source == "model"
    assert (tuned.block, tuned.row_chunk) == (plan.block, plan.row_chunk)
    assert tuned.as_record()["refine_chunk"] == tuned.refine_chunk
    idx, dist = tknn.knn_project(x, k, rounds=1)
    outs = []
    for c in sorted(cands):
        gen = torch.Generator()
        gen.manual_seed(2)
        outs.append(tknn.knn_refine(x, idx, dist, rounds=2, generator=gen,
                                    row_chunk=c, filter_dims=8,
                                    expand_k=(k + 1) // 2))
    for i, dd in outs[1:]:
        assert torch.equal(i, outs[0][0]) and torch.equal(dd, outs[0][1])
    # a slice too small to probe keeps the model's plan
    small = knn_tiles.autotune_knn_tiles(x[:1000], k, plan=plan)
    assert small == plan
