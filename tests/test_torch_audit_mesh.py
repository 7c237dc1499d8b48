"""The port's sharding and comms audits on the CPU's thread mesh.

* sharding is clean at mesh 2 and 4 (the optimizer's CSR and blocks + FFT
  variants, the in-process pipeline) and flags its seeded fixtures — a
  shard with one collective more, shards gathering different shapes — at
  their lines, without hanging;
* the comms model's per-iteration payload at mesh 2 and 4 equals the JAX
  ``plan_comms_report``'s (the JAX mesh program under ``jax_mesh``, ROADMAP
  §C) but for the listed differences, each with its reason; the psum mode
  collapses the reduction slice; an unblessed N-scaling gather is flagged.
"""

from collections import Counter

import jax
import pytest

from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu_torch.analysis.audit import cases, comms, sharding
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.analysis.audit.record import Recorder
from tsne_flink_tpu_torch.parallel.mesh import run_shards
from torch_audit_helpers import fixture, run_guarded, violations

pytestmark = pytest.mark.fast


# ---- sharding-contract ------------------------------------------------------

def test_sharding_clean_on_the_thread_mesh():
    found, report = run_guarded(
        lambda: sharding.audit_sharding("cpu", processes=False), 300.0)
    assert found == [], [f.format() for f in found]
    assert {run["per_shard"] > 0 for run in report["runs"].values()} == {
        True}


@pytest.mark.parametrize("func", ["extra_collective", "shape_mismatch"])
def test_sharding_flags_the_seeded_fixture_without_hanging(func):
    fx = fixture("fx_sharding")
    found, _ = run_guarded(lambda: sharding.check_run(
        lambda: run_shards(["cpu"] * 2, getattr(fx, func)), 2, func))
    assert found
    assert {f.line for f in found} == violations("fx_sharding", func)
    clean, _ = sharding.check_run(
        lambda: run_shards(["cpu"] * 2, fx.matched), 2, "matched")
    assert clean == []


# ---- comms-audit ------------------------------------------------------------

#: the JAX per-iteration payload beyond the port's plain iteration, as
#: (primitive, JAX issuing function) -> reason
JAX_ONLY_PER_ITERATION = {
    ("all_gather", "_mesh_sum"):
        "the KL's per-row partials: the JAX loop computes the loss under a "
        "lax.cond inside every iteration's body, which its walker counts "
        "per iteration; the port sums it at report iterations only",
    ("psum", "_psum"):
        "the valid-row count: the JAX loop psums it every iteration; the "
        "port once a segment, before the loop (_mesh_count)",
}


@pytest.fixture
def jax_mesh(monkeypatch):
    """The JAX mesh program with ``shard_map``'s varying-axes check off
    (jax 0.9 refuses the package's program with it on; ROADMAP §C)."""
    import tsne_flink_tpu.utils.compat as compat

    def shard_map(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    monkeypatch.setattr(compat, "shard_map", shard_map)
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("mesh", [2, 4])
def test_comms_per_iteration_bytes_are_the_jax_models(mesh, jax_mesh):
    from tsne_flink_tpu.analysis.audit import comms as jcomms
    kw = dict(n=cases.N, d=cases.D, k=cases.K, backend="cpu",
              repulsion="exact", mesh=mesh)
    want = jcomms.plan_comms_report(JPlan(**kw))
    got = comms.plan_comms_report(PlanConfig(**kw))
    jrows = Counter((r["primitive"], r["payload_bytes"])
                    for r in want["collectives"] if r["per_iteration"])
    extra = Counter()
    for prim, func in JAX_ONLY_PER_ITERATION:
        row = next(r for r in want["collectives"] if r["per_iteration"]
                   and (r["primitive"], r["func"]) == (prim, func))
        extra[(prim, row["payload_bytes"])] += 1
    plain = min(r["iteration"] for r in got["collectives"]
                if r["per_iteration"])
    trows = Counter((r["primitive"], r["payload_bytes"])
                    for r in got["collectives"] if r["iteration"] == plain)
    assert jrows - extra == trows
    assert (sum(r["payload_bytes"] for r in want["collectives"]
                if r["per_iteration"])
            - sum(p * c for (_, p), c in extra.items())
            == got["per_iter_payload_bytes"])
    assert got["per_segment_bytes"] > 0 and got["per_iter_seconds"] > 0


def test_comms_psum_mode_collapses_the_reduce_slice_and_flags_fixture():
    pair = comms.plan_mode_pair(PlanConfig(n=60_000, d=784, k=90,
                                           backend="cpu", mesh=4))
    assert pair["reduce_bytes_collapse"] > 1000
    fx = fixture("fx_comms")
    with Recorder() as rec:
        run_shards(["cpu"] * 2, fx.gather_rows)
        run_shards(["cpu"] * 2, fx.scalar_psum)
    rows = comms.collect_rows(rec.events, 64, 2)
    found = comms.scan_rows(rows, "fx")
    assert {f.line for f in found} == violations("fx_comms")
    assert comms.link_seconds(10**9, "gloo") is None
