"""float64 on the card: what the CPU can hold of it.

The kernels' float64 forms run on the card only (``tests/test_torch_cuda
.py`` holds them there).  Here:

* no plan is refused for its dtype, its k or its width: every plan
  resolves on every device and method; every stage of every refine plan
  at k <= 1,024 fits the shared memory of B6 and of its float64 form
  (``ops/knn_cuda.refine_smem_bytes`` at 4- and 8-byte values, the
  layout of ``csrc/knn_cand.cu``; past 12,288 features the unstaged
  form's, which holds no row vector), and past it a stage that does not
  takes the workspace route (``ops/knn_cuda.refine_route``) at both
  widths;
* a float64 ``project`` run (``prepare``, and the sharded prepare on a
  mesh of 2) reaches the refine stages' wrappers with float64 values and
  gets float64 distances back;
* the frozen model's dtype (``serve/model.frozen_dtype``): float64 on the
  card when the caller asks for it, float32 otherwise, the features' own
  on the CPU;
* ``KERNELS`` names the six float64 forms by their C symbols, and each
  symbol has a signature with float64 scalars where the float32 form has
  float32 ones (the pointers are untyped: B6_f64's float64 base, norms
  and distances pass where B6's float32 ones do);
* the memory model at ``PlanConfig(dtype="float64")`` on ``cuda``: every
  term it shares with the JAX model, save those the card overrides,
  equals the JAX model's (rtol 1e-12), and B1's port term is one float64
  product, with no (hi, lo) pair or bf16 scratch;
* graftcheck's recorder names the float64 forms for a float64 run (and
  the float32 forms for a float32 one), B6_f64 on a refining plan;
* the wrappers' dtype dispatch: graftlint's dtype-drift is clean on the
  port's tree with the one blessed helper (``ops/metrics.kernel_float64``)
  and the dtype audit's float64 scan still flags a float64 value in a
  float32 run.

The float64 slice's parity with the JAX package is held where it was:
``tests/test_torch_tsne.py``, ``test_torch_api.py`` and
``test_torch_serve.py`` run the port at float64 against it on the CPU,
and ``tests/test_torch_hybrid_knn.py`` holds the float64 plain refine
round and project kNN to the JAX package with its own draws.
"""

import math

import numpy as np
import pytest
import torch

from tsne_flink_tpu.analysis.audit import hbm as jhbm
from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu_torch.analysis.audit import hbm as thbm
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.kernels import build as kbuild
from tsne_flink_tpu_torch.ops import knn as tknn
from tsne_flink_tpu_torch.ops import knn_cuda as tkc
from tsne_flink_tpu_torch.ops.metrics import kernel_float64
from tsne_flink_tpu_torch.serve.model import frozen_dtype

pytestmark = pytest.mark.fast

F64_FORMS = {"B1_f64": "tsne_knn_f64", "B2_f64": "tsne_repulsion_f64",
             "B3_f64": "tsne_fused_step_f64",
             "B4_f64": "tsne_attraction_loss_f64",
             "B5_f64": "tsne_attraction_forces_f64",
             "B6_f64": "tsne_refine_chunk_f64"}


def _refine_stages(d: int, k: int):
    """The B6 launches of one refine chunk of the auto plan at (d, k), as
    ``ops/knn.knn_refine`` makes them: (f, w, ke, keep, build, final)."""
    fd = tknn.pick_knn_filter(d)
    plan = tknn._refine_plan(d, k, filter_dims=fd,
                             expand_k=(k + 1) // 2 if fd else None)
    widths = ([(plan.filter_dims, plan.keep)] if plan.filter_dims else [])
    widths += [(plan.cascade_dims, plan.keep2)] if plan.cascade_dims else []
    out, w = [], 2 * plan.s
    for i, (f, keep) in enumerate(widths + [(d, 0)]):
        build, final = i == 0, i == len(widths)
        if not final:
            keep = min(keep, w * (1 + plan.ke) if build else w)
        out.append((f, w, plan.ke if build else 0, keep, build, final))
        w = keep
    return out


def _fits(d: int, k: int, itemsize: int) -> list:
    """The stages of the plan at (d, k) past B6's shared memory or sort
    capacity at values of ``itemsize`` bytes (none, when it fits): the
    stages that take the workspace route, each checked to take it (and
    its block's shared memory to fit there)."""
    bad = []
    assert _refine_stages(d, k) == tknn.refine_stages(d, k)
    for f, w, ke, keep, build, final in _refine_stages(d, k):
        need = tkc.refine_smem_bytes(f, w, ke, keep, k, build, final,
                                     itemsize, tkc.refine_staged(f))
        sort = 2 * k if final else keep
        route = tkc.refine_route(f, w, ke, keep, k, build, final, itemsize)
        if need > tkc.REFINE_SMEM_MAX or sort > tkc.REFINE_SORT_MAX:
            bad.append((d, k, f, build, final, need))
            assert route.workspace > 0
            assert route.smem <= tkc.REFINE_SMEM_MAX
        else:
            assert route == (0, need)
    return bad


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,refine", [("project", 3), ("project", 0),
                                           ("bruteforce", None),
                                           ("partition", None)])
def test_refusal_helper(device, dtype, method, refine):
    """No plan is refused for its dtype, its k or its width on any
    device: each case resolves to its method at the deep class's widest k
    and past it, at d up to and past the staged width; a refining plan's
    every stage fits B6's shared memory at the dtype's width (B6_f64's at
    float64; the unstaged forms' past 12,288 features) up to k = 1,024,
    and past it takes a route."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    for d in (50, 200, 784, tkc.STAGED_F_MAX, tkc.STAGED_F_MAX + 1,
              32_768):
        for k in (tkc.K_REG_MAX, 1500, 4096):
            got = tknn.resolve_knn_plan(2_000_000, d, method, None, refine,
                                        k=k, backend=device)
            assert got[0] == method and (refine is None or got[2] == refine)
        if method == "project" and refine:
            assert _fits(d, tkc.K_REG_MAX, itemsize) == []
            assert _fits(d, 90, itemsize) == []
            _fits(d, 4096, itemsize)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [1, 50, 128, 129, 256, 257, 784,
                               tkc.STAGED_F_MAX, tkc.STAGED_F_MAX + 1,
                               32_768])
def test_every_admitted_refine_plan_fits_both_forms(itemsize, d):
    """Every k up to 1,024 at the widest d of each funnel shape (no filter
    up to 128, the JL filter to 256, filter or cascade + exact past it):
    each stage of the chunk fits the block's shared memory at 4- and
    8-byte values, on chip; past it (k = 1,025 .. 4,096 in steps) each
    stage takes the route its fit decides."""
    bad = [b for k in range(1, tkc.K_REG_MAX + 1)
           for b in _fits(d, k, itemsize)]
    assert bad == []
    for k in range(tkc.K_REG_MAX + 1, 4097, 97):
        _fits(d, k, itemsize)


def test_float64_layout_keeps_the_old_list_in_the_ids():
    """B6_f64's layout: 8-byte values and 16-byte keys, the exact stage's
    old list inside the candidate ids' array; B6's float32 layout is the
    one it had (the old list after the gateways)."""
    f, w, ke, k = 50, 16, 150, 150
    f32 = tkc.refine_smem_bytes(f, w, ke, 0, k, True, True)
    f64 = tkc.refine_smem_bytes(f, w, ke, 0, k, True, True, 8)
    zcap, sortcap = w * (1 + ke), 512
    assert f32 == (208 + 4 * zcap + 1024 + 32 + 64 + 608 + 608
                   + max(8 * zcap, 8 * sortcap + 4 * zcap))
    assert f64 == (400 + 4 * zcap + 1024 + 32 + 64
                   + 16 * sortcap + 8 * zcap)
    # a list narrower than the old list's 12 bytes a slot widens the ids
    assert (tkc.refine_smem_bytes(8, 4, 0, 0, 150, False, True, 8)
            == 64 + 608 + 1200 + 1024 + 32 + 16 * 512 + 32)


def test_prepare_refuses_before_the_knn_stage(monkeypatch):
    """A float64 ``project`` run with refine cycles is no longer refused:
    ``prepare`` runs its refine stages, each wrapper called with float64
    values (the card's B6_f64 operands: points or projections, norms, old
    distances), and the graph's distances come back float64."""
    from tsne_flink_tpu_torch.utils import artifacts
    seen = []
    real = {"keep": tknn.refine_keep, "final": tknn.refine_final}

    def keep(base, sq, *a, **kw):
        seen.append(("keep", base.dtype, sq.dtype))
        return real["keep"](base, sq, *a, **kw)

    def final(metric, base, cache, row0, cand, old_i, old_d, **kw):
        seen.append(("final", base.dtype, cache.dtype, old_d.dtype))
        out = real["final"](metric, base, cache, row0, cand, old_i, old_d,
                            **kw)
        seen.append(("out", out[1].dtype))
        return out
    monkeypatch.setattr(tknn, "refine_keep", keep)
    monkeypatch.setattr(tknn, "refine_final", final)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((700, 140)))
    prep = artifacts.prepare(x, neighbors=15, knn_method="project",
                             knn_refine=1, perplexity=5.0, device="cpu")
    assert {s[0] for s in seen} == {"keep", "final", "out"}
    assert all(set(s[1:]) == {torch.float64} for s in seen)
    assert prep.dist.dtype == torch.float64


def test_sharded_prepare_refuses_before_any_shard(monkeypatch):
    """The sharded prepare at float64 with a refining ``project`` plan
    runs its refine on every shard (no refusal): each shard's exact stage
    gets the gathered float64 points with ``n_valid``, and returns float64
    distances."""
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    seen = []
    real = tknn.refine_final

    def final(metric, base, cache, row0, cand, old_i, old_d, **kw):
        out = real(metric, base, cache, row0, cand, old_i, old_d, **kw)
        seen.append((base.dtype, old_d.dtype, out[1].dtype, kw["n_valid"],
                     row0))
        return out
    monkeypatch.setattr(tknn, "refine_final", final)
    n = 301
    pipe = SpmdPipeline(TsneConfig(perplexity=5.0), n, 8, 15,
                        knn_method="project", knn_refine=1,
                        devices=["cpu"] * 2)
    pipe._prepared(np.random.default_rng(1).standard_normal((n, 8)), 0,
                   None)
    assert seen and all(s[:3] == (torch.float64,) * 3 for s in seen)
    assert {s[3] for s in seen} == {n}
    assert {s[4] for s in seen} >= {0, pipe.n_padded // 2}


@pytest.mark.parametrize("device,asked,want", [
    ("cuda", torch.float64, torch.float64),
    ("cuda", None, torch.float32),
    ("cuda", torch.float32, torch.float32),
    ("cpu", torch.float64, None),
    ("cpu", None, None),
])
def test_frozen_model_dtype(device, asked, want):
    assert frozen_dtype(device, asked) is want


def test_frozen_model_keeps_the_features_dtype_on_the_cpu():
    from tsne_flink_tpu_torch.serve.model import from_arrays
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((50, 4)), rng.standard_normal((50, 2))
    plan = PlanConfig(n=50, d=4, k=8, backend="cpu")
    for asked in (None, torch.float64):
        m = from_arrays(x, y, plan, perplexity=3.0, device="cpu",
                        dtype=asked)
        assert m.x.dtype == m.y.dtype == torch.float64
    m = from_arrays(x.astype(np.float32), y, plan, perplexity=3.0,
                    device="cpu")
    assert m.x.dtype == m.y.dtype == torch.float32


def test_kernels_name_the_float64_forms():
    for kid, symbol in F64_FORMS.items():
        k = kbuild.KERNELS[kid]
        assert (k.symbol, k.kid) == (symbol, kid)
        f32 = symbol.replace("_f64", "_f32")
        sig, sig32 = kbuild.SIGNATURES[symbol], kbuild.SIGNATURES[f32]
        assert len(sig) == len(sig32)
        assert [t is kbuild._D for t in sig] == [t is kbuild._F
                                                 for t in sig32]
    assert kbuild.SIGNATURES["tsne_knn_cross_f64"] == kbuild.SIGNATURES[
        "tsne_knn_cross_f32"]
    assert set(kbuild.launches()) >= set(F64_FORMS)


def test_kernel_float64_dispatch():
    assert kernel_float64(torch.zeros(2, dtype=torch.float64))
    assert not kernel_float64(torch.float32)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernel_float64(torch.zeros(2, dtype=torch.bfloat16))


#: JAX keys the card's terms replace by what its kernels hold (the
#: transform's ``model``: the frozen model holds no [N, k] graph)
CARD_OVERRIDES = {"peak", "exact_tile", "repulsion_tile", "resident",
                  "refine", "model"}


@pytest.mark.parametrize("kw", [
    dict(n=60_000, d=784, k=90, knn_method="bruteforce", repulsion="exact",
         attraction="csr"),
    dict(n=60_000, d=784, k=90, knn_method="bruteforce", repulsion="fft",
         assembly="blocks"),
    dict(n=2_500, d=50, k=90, knn_method="bruteforce", repulsion="exact",
         serve_queries=256),
])
def test_memory_model_at_float64_on_the_card(kw):
    plan = PlanConfig(backend="cuda", dtype="float64", **kw)
    jplan = JPlan(backend="cuda", dtype="float64", **kw)
    assert plan.itemsize == 8
    got = thbm.stage_terms(plan)
    jax = {"knn": jhbm._knn_stage, "affinities": jhbm._affinity_stage,
           "optimize": jhbm._optimize_stage,
           "transform": jhbm._transform_stage}
    for stage, terms in got.items():
        want = jax[stage](jplan)
        assert set(want) <= set(terms), stage
        for name, v in want.items():
            if name in CARD_OVERRIDES or isinstance(v, str):
                continue
            assert math.isclose(terms[name], v, rel_tol=1e-12), (stage,
                                                                 name)
    knn = got["knn"]
    n, d = kw["n"], kw["d"]
    assert knn["b1_norms"] == n * d * 8  # norms_f64's one product
    assert "b1_operands" not in knn and knn["exact_tile"] == 0.0
    f32 = thbm.stage_terms(PlanConfig(backend="cuda", **kw))["knn"]
    assert f32["b1_norms"] == 2 * n * d * 8  # norm_pairs' copy + square


def _recorded_steps(dtype, **kw):
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, tsne_embed
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((120, 6)), dtype=dtype)
    cfg = TsneConfig(perplexity=5.0, iterations=20, repulsion="exact",
                     attraction="csr")
    with Recorder() as rec:
        tsne_embed(x, cfg, neighbors=15, device="cpu", **kw)
    return {e["plain_of"] for e in rec.events if "plain_of" in e}


def test_recorder_names_the_float64_forms():
    assert _recorded_steps(torch.float64) == {"B1_f64", "B2_f64", "B3_f64",
                                              "B4_f64"}
    assert _recorded_steps(torch.float32) == {"B1", "B2", "B3", "B4"}


def test_recorder_names_b6_f64_on_a_refining_plan():
    """A float64 ``project`` plan with a refine cycle: its refine stages
    are B6_f64's (the exact stage's plain version takes the metric's name
    first, then the float64 points), a float32 one's B6's."""
    kw = dict(knn_method="project", knn_refine=1)
    assert _recorded_steps(torch.float64, **kw) == {"B2_f64", "B3_f64",
                                                    "B4_f64", "B6_f64"}
    assert _recorded_steps(torch.float32, **kw) == {"B2", "B3", "B4", "B6"}


def test_dtype_drift_clean_with_the_one_blessed_helper():
    import os
    from tsne_flink_tpu_torch.analysis import core as tcore
    pkg = os.path.dirname(os.path.dirname(kbuild.__file__))
    found, n = tcore.run([pkg], rules=["dtype-drift"])
    assert n > 50 and found == [], [f.format() for f in found]


def test_dtype_audit_still_flags_float64_in_a_float32_run():
    """The f64 scan: a float64 op recorded inside a float32 contract's run
    is a finding unless it is a blessed site (B1's norm pairs)."""
    from tsne_flink_tpu_torch.analysis.audit import dtype as tdtype
    ev = {"kind": "aten", "name": "aten.mul", "out": [[[3], "float64"]],
          "frames": [("tsne_flink_tpu_torch/ops/knn_cuda.py", 1,
                      "knn_sweep_cuda")]}
    found = tdtype.scan_events([ev], "ops.knn_cuda.knn_sweep_cuda",
                               "tsne_flink_tpu_torch/ops/knn_cuda.py")
    assert found and "float64" in found[0].message
    ev["frames"] = [("tsne_flink_tpu_torch/ops/knn_cuda.py", 1,
                     "norm_pairs")]
    assert not tdtype.scan_events([ev], "ops.knn_cuda.knn_sweep_cuda",
                                  "tsne_flink_tpu_torch/ops/knn_cuda.py")
