"""PyTorch port, the memory model vs the JAX package (CPU).

* at ``backend="cpu"`` every term of the JAX report equals the port's
  (rtol 1e-12) on a grid of plans (N, d, k, m, method, assembly,
  attraction, repulsion, serving rows), save the stage peaks, which also
  take the port's own terms; every term the JAX report lacks is one of
  the listed port terms (PERF.md's table);
* ``transform_peak`` / ``transform_peak_bytes`` and ``residency_report``
  equal JAX's plus the query kNN's ``query_sort`` term, exactly;
* at ``backend="cuda"``: B1 and B2 hold no JAX tile, B6 no gather chunk,
  every stage carries the libraries' workspaces, the allocator's
  rounding and reserve and the CUDA context, and the blocks rung predicts less than the rows
  it replaces;
* the serve daemon's gate: on the card a model is charged its transform
  peak with the allocator's reserve and the process its CUDA context,
  once (a replica is a process of its own); on the CPU the peaks alone,
  the JAX gate's decisions;
* the charge (``charged_plans`` / ``charged_peak_bytes``): the widest rows
  a run may build, capped by ``auto``'s byte gate with the blocks layout
  beside them past it, never below the report at any width up to the
  plan's; ``width_bound`` of a kNN graph is at least the width every
  assembly builds from it.
"""

import itertools
import math

import pytest

from tsne_flink_tpu.analysis.audit import hbm as jhbm
from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu_torch.analysis.audit import hbm as thbm
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig

pytestmark = pytest.mark.fast

#: the port's own terms, by stage (PERF.md: "The memory model's port-only
#: terms"), and the card's
PORT_TERMS = {
    "knn": {"b1_norms", "reverse_sample", "band_group", "refine_chunk"},
    "affinities": {"reverse_merge_gather", "edge_parts", "row_planes"},
    "optimize": {"plan_count"},
    "transform": {"query_sort"},
}
CARD_TERMS = {"allocator_reserve", "cuda_context", "library_workspaces",
              "allocator_rounding"}

GRID = [dict(n=n, d=d, k=k, knn_method=meth, assembly=asm,
             attraction=att, repulsion=rep)
        for (n, d, k), meth, asm, att, rep in itertools.product(
            [(3000, 784, 90), (1_306_127, 50, 150)],
            ["bruteforce", "project"], ["auto", "sorted", "blocks"],
            ["auto", "csr", "edges"], ["auto", "exact", "bh", "fft"])]
GRID += [dict(n=n, d=50, k=30, n_components=3, repulsion=rep,
              knn_method="project")
         for n in (5000, 200_000) for rep in ("auto", "exact", "bh")]
GRID += [dict(n=60_000, d=784, k=90, sym_width=3474, knn_method="auto",
              attraction="rows", repulsion="exact"),
         dict(n=60_000, d=784, k=90, autopilot=True, repulsion="fft",
              fft_grid=256, knn_method="precomputed"),
         dict(n=60_000, d=784, k=90, serve_queries=256, repulsion="exact"),
         dict(n=1_306_127, d=50, k=150, serve_queries=256,
              repulsion="fft", knn_method="project")]

JAX_STAGES = {"knn": jhbm._knn_stage, "affinities": jhbm._affinity_stage,
              "optimize": jhbm._optimize_stage,
              "transform": jhbm._transform_stage}


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_cpu_report_is_jax_term_by_term(kw):
    plan, jplan = PlanConfig(backend="cpu", **kw), JPlan(backend="cpu", **kw)
    got = thbm.stage_terms(plan)
    assert set(got) == ({"knn", "affinities", "optimize"}
                        | ({"transform"} if plan.serve_queries else set()))
    for stage, terms in got.items():
        want = JAX_STAGES[stage](jplan)
        extra = set(terms) - set(want)
        assert extra <= PORT_TERMS[stage], (stage, extra)
        assert set(want) <= set(terms)
        for name, v in want.items():
            if name == "peak":
                continue
            if isinstance(v, str):
                # the exact kNN's kernel label names the route: the port's
                # plain version (CPU) where JAX names its XLA tiles
                if name != "kernel":
                    assert terms[name] == v, (stage, name)
                continue
            assert _close(terms[name], v), (stage, name, terms[name], v)
        assert terms["peak"] >= want["peak"] * (1 - 1e-12)
        if not extra:
            assert _close(terms["peak"], want["peak"]), stage
    assert plan.resolved_repulsion() == jplan.resolved_repulsion()
    assert plan.resolved_assembly() == jplan.resolved_assembly()


@pytest.mark.parametrize("n,d,k,rep,b", [
    (3000, 50, 30, "exact", 256), (3000, 50, 30, "fft", 64),
    (60_000, 784, 90, "exact", 256), (1_306_127, 50, 150, "fft", 256),
    (500, 8, 12, "exact", 8)])
def test_transform_peak_is_jax_plus_the_query_sort(n, d, k, rep, b):
    plan = PlanConfig(n=n, d=d, k=k, backend="cpu", repulsion=rep,
                      serve_queries=b)
    jplan = JPlan(n=n, d=d, k=k, backend="cpu", repulsion=rep,
                  serve_queries=b)
    terms = thbm.transform_terms(plan)
    assert terms["query_sort"] > 0
    assert thbm.transform_peak_bytes(plan) == int(
        jhbm._transform_stage(jplan)["peak"] + terms["query_sort"])
    two = [plan, PlanConfig(n=n // 2, d=d, k=k, backend="cpu",
                            repulsion=rep, serve_queries=b)]
    jtwo = [jplan, JPlan(n=n // 2, d=d, k=k, backend="cpu", repulsion=rep,
                         serve_queries=b)]
    got, want = thbm.residency_report(two), jhbm.residency_report(jtwo)
    sorts = [thbm.transform_terms(p)["query_sort"] for p in two]
    assert got["models"] == want["models"] == 2
    assert got["resident_bytes"] == want["resident_bytes"]
    assert got["transient_bytes"] == int(want["transient_bytes"]
                                         + max(sorts))
    assert abs(got["conservative_sum_bytes"]
               - (want["conservative_sum_bytes"] + sum(sorts))) <= 1


def test_query_sort_reckoning():
    """The pairwise phase (four [c, N] tiles) or the sort phase (the tile,
    values, int64 indices, the card's scratch), beyond the JAX model's
    two tiles."""
    c, n = 256, 60_000
    assert thbm._query_sort_bytes(c, n, 4, "cpu") == c * n * 8
    # the card's full sort of all segments: two int2 arrays, keys out,
    # cub's alternate keys and int2 values
    assert thbm._query_sort_bytes(c, n, 4, "cuda") == c * n * 40
    # one segment at a time past a million keys: O(N) scratch
    big = 1_306_127
    assert thbm._query_sort_bytes(c, big, 4, "cuda") == (
        c * big * 8 + big * 20)
    # short rows sort in place
    assert thbm._query_sort_bytes(c, 4096, 4, "cuda") == c * 4096 * 8


def test_cuda_terms():
    full = PlanConfig(n=60_000, d=784, k=90, backend="cuda",
                      knn_method="bruteforce", repulsion="exact",
                      attraction="csr", sym_width=3474)
    st = thbm.stage_terms(full)
    knn = st["knn"]
    assert knn["exact_tile"] == 0.0
    assert knn["b1_norms"] == 2 * 60_000 * 784 * 8
    assert st["optimize"]["repulsion_tile"] < 60_000 * 2 * 3 * 4 * 200
    for terms in st.values():
        assert CARD_TERMS <= set(terms)
        assert terms["cuda_context"] == thbm.CUDA_CONTEXT_BYTES
        assert terms["library_workspaces"] == thbm.LIBRARY_WORKSPACE_BYTES
        assert terms["allocator_rounding"] == thbm.ALLOCATOR_ROUNDING_BYTES
        alloc = thbm.allocated_peak(terms)
        assert _close(terms["allocator_reserve"],
                      thbm.ALLOCATOR_RESERVE_FRACTION * alloc)
    rep = thbm.plan_hbm_report(full)
    assert rep["peak_hbm_est"] == int(max(t["peak"] for t in st.values()))
    # B6 runs the refine chunk in shared memory: the JAX gathers are gone
    large = PlanConfig(n=1_306_127, d=50, k=150, backend="cuda",
                       knn_method="project", repulsion="fft")
    cpu = thbm.stage_terms(PlanConfig(**{**large.as_dict(),
                                         "backend": "cpu"}))
    assert (thbm.stage_terms(large)["knn"]["refine"]
            < cpu["knn"]["refine"])
    # the blocks rung frees the [N, S] rows' planes
    blocks = PlanConfig(**{**full.as_dict(), "assembly": "blocks"})
    assert (thbm.plan_hbm_report(blocks)["peak_hbm_est"]
            < rep["peak_hbm_est"])


def test_serving_plan_on_the_card_holds_no_graph_nor_b2_tile():
    plan = PlanConfig(n=60_000, d=784, k=90, backend="cuda",
                      repulsion="exact", serve_queries=256)
    cpu = thbm.transform_terms(PlanConfig(**{**plan.as_dict(),
                                             "backend": "cpu"}))
    got = thbm.transform_terms(plan)
    assert got["repulsion_tile"] == 0.0
    assert got["model"] == cpu["model"] - 60_000 * 90 * 8
    assert "cuda_context" not in got  # the daemon's, charged once
    rep = thbm.residency_report([plan, plan])
    assert rep["peak_bytes"] == int(
        thbm.CUDA_CONTEXT_BYTES + (1 + thbm.ALLOCATOR_RESERVE_FRACTION)
        * (rep["resident_bytes"] + 2 * rep["transient_bytes"]))


# ---- the serve daemon's gate -------------------------------------------------

@pytest.mark.parametrize("n,d,k,rep", [(60_000, 784, 90, "exact"),
                                       (1_306_127, 50, 150, "fft"),
                                       (500, 8, 12, "exact")])
def test_serving_gate_charges_the_process_once_on_the_card(n, d, k, rep):
    """On the card the gate charges each model's transform peak grown by
    the allocator's reserve and, once a process, the CUDA context: a
    replica's charge is residency_report's conservative sum.  On the CPU
    it charges the peaks alone, the JAX gate's terms."""
    from tsne_flink_tpu.runtime.admission import \
        decide_residency as jdecide
    from tsne_flink_tpu_torch.runtime.admission import (ADMIT, QUEUE,
                                                        decide_residency)
    plans = {be: [PlanConfig(n=n_i, d=d, k=k, backend=be, repulsion=rep,
                             serve_queries=256, name=f"m{i}")
                  for i, n_i in enumerate((n, n // 2))]
             for be in ("cpu", "cuda")}
    peaks = {be: [thbm.transform_peak_bytes(p) for p in ps]
             for be, ps in plans.items()}
    card = peaks["cuda"]
    grow = 1 + thbm.ALLOCATOR_RESERVE_FRACTION
    assert thbm.serving_process_bytes("cuda") == thbm.CUDA_CONTEXT_BYTES
    assert thbm.serving_process_bytes("cpu") == 0
    charged = [thbm.serving_charge(p, "cuda") for p in card]
    assert charged == [int(grow * p) for p in card]
    conservative = thbm.residency_report(plans["cuda"])[
        "conservative_sum_bytes"]
    total = sum(charged) + thbm.serving_process_bytes("cuda")
    assert abs(total - conservative) <= len(card)
    # the context is charged once: a budget that fits the models with
    # their reserve but not the context refuses the second model
    first = {"m0": charged[0]}
    budget = charged[0] + charged[1]
    assert decide_residency(first, "m1", charged[1], budget).action == ADMIT
    d2 = decide_residency(first, "m1", charged[1], budget,
                          process_bytes=thbm.serving_process_bytes("cuda"))
    assert d2.action == QUEUE and d2.predicted_peak == total
    # the CPU gate: the peaks themselves, and the JAX decision
    cpu = peaks["cpu"]
    assert [thbm.serving_charge(p, "cpu") for p in cpu] == cpu
    for budget in (sum(cpu) - 1, sum(cpu)):
        got = decide_residency({"m0": cpu[0]}, "m1", cpu[1], budget,
                               process_bytes=thbm.serving_process_bytes(
                                   "cpu"))
        want = jdecide({"m0": cpu[0]}, "m1", cpu[1], budget)
        assert got.as_dict() == want.as_dict()
        assert _close(got.predicted_peak, want.predicted_peak)


def test_serving_daemon_gate_on_the_cpu_is_the_jax_gate(tmp_path):
    """A CPU daemon charges its model's transform peak alone (``charged``
    equals the peak) and refuses a second model exactly where the JAX
    arithmetic does."""
    import numpy as np

    from tsne_flink_tpu_torch.serve.daemon import ServeDaemon
    from tsne_flink_tpu_torch.serve.model import from_arrays
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((80, 5)), rng.standard_normal((80, 2))
    models = [from_arrays(x, y + i, PlanConfig(n=80, d=5, k=10,
                                               backend="cpu",
                                               repulsion="exact"),
                          perplexity=3.0, device="cpu") for i in range(2)]
    peak = models[0].transform_peak(16)
    d = ServeDaemon(models[0], str(tmp_path), bucket=16,
                    budget_bytes=2 * peak - 1)
    assert d.admission["charged_bytes"] == d.admission["peak_bytes"] == peak
    assert d.load_model(models[1], warm=False)["action"] == "queue"
    d = ServeDaemon(models[0], str(tmp_path), bucket=16,
                    budget_bytes=2 * peak)
    assert d.load_model(models[1], warm=False)["action"] == "admit"
    assert d.summary()["residency"]["charged_sum"] == 2 * peak


# ---- the charge: the widest rows a run may build ---------------------------

CHARGE_PLANS = [dict(n=60_000, d=784, k=90, knn_method="bruteforce"),
                dict(n=60_000, d=784, k=90, knn_method="project",
                     repulsion="exact", attraction="csr"),
                dict(n=1_306_127, d=50, k=150, knn_method="project",
                     repulsion="fft"),
                dict(n=3000, d=64, k=30, knn_method="bruteforce"),
                dict(n=3000, d=64, k=30, assembly="sorted"),
                dict(n=3000, d=64, k=30, assembly="blocks")]


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("kw", CHARGE_PLANS, ids=str)
def test_charge_covers_every_width_the_run_may_build(kw, backend):
    from tsne_flink_tpu_torch.ops.affinities import (ROWS_BYTES_MAX,
                                                     row_width_bound)
    plan = PlanConfig(backend=backend, **kw)
    n, k = plan.n, plan.k
    cap = ROWS_BYTES_MAX // (n * (4 + plan.itemsize))
    got = [(p.assembly, p.sym_width) for p in thbm.charged_plans(plan)]
    if plan.assembly == "blocks":
        assert got == [("blocks", None)]
    elif plan.assembly == "sorted":
        assert got == [("sorted", row_width_bound(k, n))]
    else:
        widest = min(row_width_bound(k, n), cap)
        assert got[0] == ("auto", widest)
        assert (("blocks", None) in got) == (row_width_bound(k, n) > cap)
    unknown = thbm.charged_peak_bytes(plan)
    for width in (8 * ((2 * k + 7) // 8), 4 * k + 8, 3474):
        if width > row_width_bound(k, n):
            continue  # no graph of n points reaches it
        at = PlanConfig(**{**plan.as_dict(), "sym_width": width})
        charged = thbm.charged_peak_bytes(at)
        assert unknown >= charged
        # a bound charges at least what the run builds at that width, and
        # the layout ``auto`` picks there
        want = thbm.plan_hbm_report(at)["peak_hbm_est"]
        assert charged >= want or at.resolved_assembly() == "blocks"
        if plan.assembly == "auto" and width <= cap:
            assert charged == want


@pytest.mark.parametrize("n,k,hubs", [(400, 10, 0), (400, 10, 3),
                                      (1500, 30, 1), (1500, 30, 40)])
def test_width_bound_covers_every_assembly(n, k, hubs):
    import torch

    from tsne_flink_tpu_torch.ops import affinities as aff
    g = torch.Generator().manual_seed(n + k + hubs)
    scores = torch.rand(n, n, generator=g)
    scores[:, :hubs] -= 1.0          # every row lists the hubs first
    scores.fill_diagonal_(math.inf)
    idx = torch.argsort(scores, dim=1)[:, :k].to(torch.int32)
    dist = torch.sort(torch.rand(n, k, generator=g), dim=1).values
    p = aff.pairwise_affinities(dist, 5.0)
    bound = aff.width_bound(idx)
    assert bound >= aff.split_width(idx, p)
    assert bound >= aff.symmetrized_width(idx, p)
    jidx, _ = aff.joint_distribution_split(idx, p)
    assert bound >= jidx.shape[1]
    in_deg = int(torch.bincount(idx.reshape(-1).long(), minlength=n).max())
    assert bound == aff.row_width_bound(k, in_deg)
