"""float64 on the card: what the CPU can hold of it.

The kernels' float64 forms run on the card only (``tests/test_torch_cuda
.py`` holds them there).  Here:

* the one refusal left (``ops/knn.check_float64_plan``): float64 with a
  refining kNN plan on ``cuda`` raises naming ROADMAP §C and B6, before
  the kNN stage; nothing is refused on the CPU, nor on the card without a
  refine, nor at float32;
* the frozen model's dtype (``serve/model.frozen_dtype``): float64 on the
  card when the caller asks for it, float32 otherwise, the features' own
  on the CPU;
* ``KERNELS`` names the five float64 forms by their C symbols, and each
  symbol has a signature with float64 scalars where the float32 form has
  float32 ones;
* the memory model at ``PlanConfig(dtype="float64")`` on ``cuda``: every
  term it shares with the JAX model, save those the card overrides,
  equals the JAX model's (rtol 1e-12), and B1's port term is one float64
  product, with no (hi, lo) pair or bf16 scratch;
* graftcheck's recorder names the float64 forms for a float64 run (and
  the float32 forms for a float32 one);
* the wrappers' dtype dispatch: graftlint's dtype-drift is clean on the
  port's tree with the one blessed helper (``ops/metrics.kernel_float64``)
  and the dtype audit's float64 scan still flags a float64 value in a
  float32 run.

The float64 slice's parity with the JAX package is held where it was:
``tests/test_torch_tsne.py``, ``test_torch_api.py`` and
``test_torch_serve.py`` run the port at float64 against it on the CPU.
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
from tsne_flink_tpu_torch.ops.knn import check_float64_plan
from tsne_flink_tpu_torch.ops.metrics import kernel_float64
from tsne_flink_tpu_torch.serve.model import frozen_dtype

pytestmark = pytest.mark.fast

F64_FORMS = {"B1_f64": "tsne_knn_f64", "B2_f64": "tsne_repulsion_f64",
             "B3_f64": "tsne_fused_step_f64",
             "B4_f64": "tsne_attraction_loss_f64",
             "B5_f64": "tsne_attraction_forces_f64"}


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,refine", [("project", 3), ("project", 0),
                                           ("bruteforce", None),
                                           ("partition", None)])
def test_refusal_helper(device, dtype, method, refine):
    refused = (device == "cuda" and dtype == torch.float64
               and method == "project" and bool(refine))
    if refused:
        with pytest.raises(NotImplementedError, match=r"B6.*§C"):
            check_float64_plan(device, dtype, method, refine)
    else:
        check_float64_plan(device, dtype, method, refine)


def test_prepare_refuses_before_the_knn_stage(monkeypatch):
    """``prepare`` asks the helper with the RESOLVED plan (``auto`` and a
    None refine count through their policies), before any kNN work."""
    from tsne_flink_tpu_torch.ops import knn as tknn
    from tsne_flink_tpu_torch.utils import artifacts
    seen = []
    monkeypatch.setattr(tknn, "check_float64_plan",
                        lambda *a: seen.append(a))

    def no_knn(*a, **kw):
        raise AssertionError("the kNN stage ran")
    x = torch.zeros((9000, 8), dtype=torch.float64)
    monkeypatch.setattr(tknn, "knn", lambda *a, **kw: no_knn())
    with pytest.raises(AssertionError, match="kNN stage"):
        artifacts.prepare(x, neighbors=30, knn_method="project",
                          perplexity=10.0, device="cpu")
    assert seen == [("cpu", torch.float64, "project",
                     tknn.pick_knn_refine(9000, 8))]
    assert seen[0][3] > 0   # a card would refuse this plan


def test_sharded_prepare_refuses_before_any_shard():
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    pipe = SpmdPipeline(TsneConfig(perplexity=10.0), 9000, 8, 30,
                        knn_method="project", devices=["cpu"] * 2)
    pipe.devices = [torch.device("cuda")] * 2  # as a card mesh reports
    with pytest.raises(NotImplementedError, match="B6"):
        pipe._prepared(np.zeros((9000, 8)), 0, None)


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


def _recorded_steps(dtype):
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, tsne_embed
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((120, 6)), dtype=dtype)
    cfg = TsneConfig(perplexity=5.0, iterations=20, repulsion="exact",
                     attraction="csr")
    with Recorder() as rec:
        tsne_embed(x, cfg, neighbors=15, device="cpu")
    return {e["plain_of"] for e in rec.events if "plain_of" in e}


def test_recorder_names_the_float64_forms():
    assert _recorded_steps(torch.float64) == {"B1_f64", "B2_f64", "B3_f64",
                                              "B4_f64"}
    assert _recorded_steps(torch.float32) == {"B1", "B2", "B3", "B4"}


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
