"""PyTorch port past k = 1,024 against the JAX package, on the CPU.

On the card B1 takes every k past its deep class through its pending
class (the k-lists in the outputs, merged through a pending area a row),
and B6 a stage that does not fit on chip through its workspace route
(``ops/knn_cuda.refine_route``); ``tests/test_torch_cuda.py`` holds those
to their plain versions there.  Here the plain versions and the paths
around them are held to the JAX package, which takes any k: B1's plain
sweep at k = 1,100 and 2,048 against the XLA tiles and at k = 1,100
against the Pallas kernel in interpret mode, the ring at D = 2 against
the single sweep, one refine round at k = 1,100 with the JAX draws
injected, ``tsne_embed`` at perplexity 400 on the exact and the project
plan (final KL within ``KL_GUARDRAIL_TOL``), and the memory model's
large-k terms (B1_f64's pending pairs, B6's chunk workspace) against
their formulas at k = 1,500 and 4,096.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu.ops import knn as jknn
from tsne_flink_tpu.ops import knn_tiles as jtiles
from tsne_flink_tpu.ops.knn import knn_bruteforce as jax_knn_bruteforce
from tsne_flink_tpu.ops.knn_pallas import fused_knn as jax_fused_knn
from tsne_flink_tpu_torch import convert, tsne_embed
from tsne_flink_tpu_torch.analysis.audit import hbm as thbm
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_cuda as tkc
from tsne_flink_tpu_torch.ops import knn_tiles as ttiles
from tests.test_torch_widths import (_blobs, _jax_refine_draw,  # noqa: F401
                                     _same_graph, _t, pallas_interpret)

pytestmark = pytest.mark.fast


# ---- B1 past k = 1,024 (its pending class) ------------------------------------

@pytest.mark.parametrize("k", [1100, 2048])
def test_plain_knn_sweep_matches_jax_past_k1024(k):
    """B1's plain sweep at k past the deep class (the kernel's pending
    class) against the JAX package's XLA tiles, which take any k (one
    column more, for the ties at the cut)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2100, 16)).astype(np.float32)
    pi, pd = tknn.knn_bruteforce(torch.from_numpy(x), k)
    ji, jd = jax_knn_bruteforce(jnp.asarray(x), k + 1, "sqeuclidean",
                                kernel="xla")
    _same_graph(pi.numpy(), pd.numpy(), ji, jd, 2e-5)


def test_plain_knn_sweep_matches_jax_pallas_past_k1024(pallas_interpret):
    """The same at k = 1,100 against the Pallas kernel in interpret mode
    (k padded to 1,152; its merge loop has no cap), the reference one
    column wider so that a near-tie at the cut may go either way."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    pi, pd = tknn.knn_bruteforce(torch.from_numpy(x), 1100)
    ji, jd = jax_fused_knn(jnp.asarray(x), 1101, "sqeuclidean",
                           interpret=True)
    _same_graph(pi.numpy(), pd.numpy(), ji, jd, 2e-5)


def test_ring_past_k1024_equals_the_single_sweep():
    """The ring at D = 2 (B1's cross sweep, plain here) at k = 1,100: hops
    of 650 columns hold fewer than k, and the merge by (distance, id)
    fills the rest; it gives D = 1's graph bit for bit and the single
    sweep's (f64: distances to 1e-12, ids as sets within ties)."""
    from tsne_flink_tpu_torch.parallel.knn import ring_knn
    from tsne_flink_tpu_torch.parallel.mesh import run_shards
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1300, 12)))

    def ring(d):
        nl = 1300 // d
        outs = run_shards(["cpu"] * d, lambda ax: ring_knn(
            x[ax.index * nl:(ax.index + 1) * nl], 1100, 1300, axis=ax))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    (ri, rd), (r1i, r1d) = ring(2), ring(1)
    assert torch.equal(ri, r1i) and torch.equal(rd, r1d)
    si, sd = tknn.knn_bruteforce(x, 1101)
    _same_graph(ri.numpy(), rd.numpy(), si.numpy(), sd.numpy(), 1e-12)


def test_refine_round_past_k1024_matches_jax_with_its_draws():
    """One refine round at k = 1,100 (no filter at d = 16: the exact first
    stage proposes 16·1,101 candidates, which B6 holds on chip at float32
    and B6_f64 in its workspace) with the JAX draws injected: the same
    ids, distances to rtol 1e-10 (f64)."""
    n, d, k = 1150, 16, 1100
    x = _blobs(n, d, seed=6)
    ti0, td0 = tknn.knn_project(_t(x), k, "sqeuclidean", 1, block=32)
    tiles = replace(jtiles.pick_knn_tiles(n, d, k, "cpu"), kernel="xla",
                    refine_chunk=64)
    key = jax.random.key(17)
    ri, rd = jknn.knn_refine(jnp.asarray(x), jnp.asarray(ti0.numpy()),
                             jnp.asarray(td0.numpy()), "sqeuclidean",
                             rounds=1, key=key, tiles=tiles)
    plan = tknn._refine_plan(d, k)
    qi, qd = tknn.knn_refine(_t(x), ti0, td0, "sqeuclidean", rounds=1,
                             row_chunk=64,
                             draws=[_jax_refine_draw(key, plan, n, k, d)])
    np.testing.assert_array_equal(qi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(qd.numpy(), np.asarray(rd), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["bruteforce", "project"])
def test_embed_past_k1024_matches_jax(method):
    """tsne_embed at N = 2,500, perplexity 400 (k = 1,200), on the exact
    plan and the project plan (at this N a band of 1,024 + 2k covers every
    column: no refine cycle, the exact graph), from the JAX run's initial
    y: final KL within KL_GUARDRAIL_TOL of the JAX package's."""
    x = _blobs(2500, 10, seed=9)
    cfg = jtsne.TsneConfig(perplexity=400.0, iterations=20, row_chunk=256)
    y_j, loss_j = jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=1200,
                                   knn_method=method, seed=0)
    _, ikey = jax.random.split(jax.random.key(0))
    y0 = np.asarray(jtsne.init_working_set(ikey, 2500, 2, jnp.float64).y)
    y_t, loss_t = tsne_embed(x, convert.config_from_jax(cfg),
                             neighbors=1200, knn_method=method,
                             device="cpu", y0=y0, affinity_assembly="sorted")
    assert bool(torch.isfinite(y_t).all())
    assert abs(float(loss_t[-1]) - float(np.asarray(loss_j)[-1])) <= \
        KL_GUARDRAIL_TOL


# ---- the memory model's large-k terms --------------------------------------

@pytest.mark.parametrize("k", [1500, 4096])
def test_memory_model_charges_the_large_k_scratch(k):
    """B1_f64's pending pairs (12 bytes a slot, 1,024 a row, in device
    memory; the float32 form's live in shared memory) and B6's chunk
    workspace (the tile plan's refine chunk times the largest stage's
    workspace a row) enter the kNN stage's peak on the card; below k =
    1,024 both terms are 0."""
    n = 60_000
    for dtype, isz in (("float32", 4), ("float64", 8)):
        exact = thbm.stage_terms(PlanConfig(
            n=n, d=784, k=k, backend="cuda", dtype=dtype,
            knn_method="bruteforce"))["knn"]
        pend = 12.0 * n * 1024 if dtype == "float64" else 0.0
        assert exact["b1_pending"] == pend
        assert exact["peak"] >= (exact["input"] + exact["graph"]
                                 + exact["b1_norms"] + pend)
        proj = thbm.stage_terms(PlanConfig(
            n=n, d=50, k=k, backend="cuda", dtype=dtype,
            knn_method="project", knn_refine=2))["knn"]
        c = ttiles.pick_knn_tiles(n, 50, k, "cuda").refine_chunk
        ws = ttiles.refine_workspace_bytes(50, k, itemsize=isz)
        # the first (exact) stage at d = 50: WsLayout's bytes a row
        zcap = 16 * (1 + k)
        key = 8 if isz == 4 else 16
        a16 = lambda b: (b + 15) // 16 * 16  # noqa: E731
        row = (a16(4 * zcap) + a16(4 * k) + a16(isz * k)
               + a16(max(8 * zcap, 2 * a16(key * 2 * k) + isz * zcap)))
        assert ws == row > 0
        assert proj["b6_workspace"] == c * ws
        assert proj["refine_chunk"] == (2 * c * (128 + k * (4.0 + isz))
                                        + c * ws)
    small = thbm.stage_terms(PlanConfig(n=n, d=50, k=1024, backend="cuda",
                                        knn_method="project",
                                        knn_refine=2))["knn"]
    assert small["b6_workspace"] == 0.0
