"""The single-controller point mesh (``tsne_flink_tpu_torch/parallel/mesh``)
against the JAX package's ``parallel/mesh`` and against itself.

* ``MeshPlan``, the padding and the host planning (``attraction_plan``,
  ``_build_csr``'s per-shard tail, ``_build_edges``,
  ``_shard_reverse_block``, ``_pad_inputs``) equal the JAX class's on the
  same inputs (these need no trace);
* the port's mesh D equals its mesh 1 bit for bit, D in {2, 4, 8}, in
  every arm (exact rows, the fused and the unfused CSR step, edges,
  blocks, FFT, Barnes-Hut, the sentinel, telemetry, the autopilot) at
  every segment boundary (JAX ``tests/test_mesh.py``);
* the port's mesh 8 against the JAX ``ShardedOptimizer`` on its 8-device
  CPU mesh in f64 (y atol 1e-9, gains 1e-12, as JAX
  ``tests/test_parallel.py``) and against ``tests/oracle.run``.  Under
  jax 0.9 the JAX mesh program does not trace with ``shard_map``'s
  varying-axes check on; the ``jax_mesh`` fixture turns it off for the
  test (``check_vma=False``, by patching ``tsne_flink_tpu.utils.compat
  .shard_map``) and drops what was traced afterwards.  The JAX CSR mesh
  program drifts from its own mesh 1 (ROADMAP §C), so it is held by
  tolerance like every arm;
* ``mesh_reduce="psum"`` within 0.05 KL of canonical, an exception in one
  shard ending the run, the estimator, the OOM ladder and the sentinel's
  rollback on a meshed pipeline, and the fat checkpoint across widths.
"""

import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.ops.affinities import (affinity_blocks,
                                           joint_distribution,
                                           pairwise_affinities)
from tsne_flink_tpu.ops.knn import knn_bruteforce
from tsne_flink_tpu.parallel import mesh as jmesh
from tsne_flink_tpu_torch import TSNE, convert
from tsne_flink_tpu_torch.models.tsne import TsneConfig
from tsne_flink_tpu_torch.parallel import mesh as tmesh
from tsne_flink_tpu_torch.runtime import faults

pytestmark = pytest.mark.fast

N = 45  # not a multiple of 8: the last shard is padded and masked


@pytest.fixture
def jax_mesh(monkeypatch):
    """The JAX mesh program with ``shard_map``'s varying-axes check off
    (jax 0.9 refuses the package's program with it on); what was traced
    under the patch is dropped afterwards."""
    import tsne_flink_tpu.utils.compat as compat

    def shard_map(f, *, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    monkeypatch.setattr(compat, "shard_map", shard_map)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _problem(n=N, seed=0, k=8, perplexity=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 6)) * 4.0
    x = centers[rng.integers(0, 3, n)] + rng.normal(size=(n, 6))
    idx, dist = knn_bruteforce(jnp.asarray(x), k)
    p = pairwise_affinities(dist, perplexity)
    jidx, jval = joint_distribution(idx, p)
    y0 = rng.normal(size=(n, 2)) * 1e-4
    return x, y0, idx, dist, np.asarray(jidx), np.asarray(jval)


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _t(a):
    return torch.from_numpy(np.array(a))


def _state(y0, upd=None, gains=None):
    return convert.state_from_numpy(y0, upd, gains, device="cpu")


# ---- MeshPlan / padding / make_mesh ------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4, 8, 3, 24])
def test_mesh_plan_matches_jax(d):
    for n in (1, 7, 45, 48, 100, 10_000, 59_999, 60_001):
        assert tmesh.padded_rows_for(n, d) == jmesh.padded_rows_for(n, d)
        tp, jp = tmesh.MeshPlan(devices=d), jmesh.MeshPlan(devices=d)
        assert (tp.n_padded(n), tp.n_local(n)) == (jp.n_padded(n),
                                                   jp.n_local(n))
    assert tmesh.MeshPlan(devices=d).as_record() == \
        jmesh.MeshPlan(devices=d).as_record()
    assert (tmesh.AXIS, tmesh.PAD_QUANTUM) == (jmesh.AXIS, jmesh.PAD_QUANTUM)


def test_make_mesh_widths_and_the_visible_count(monkeypatch):
    assert tmesh.make_mesh(4, "cpu") == [torch.device("cpu")] * 4
    assert tmesh.make_mesh(None, "cpu") == [torch.device("cpu")]
    assert tmesh.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    # one visible card: --mesh 2 raises, naming the count, and a device
    # list may repeat it (the test mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 is visible"):
        tmesh.make_mesh(2, None)
    assert tmesh.make_mesh(1, None) == [torch.device("cuda", 0)]
    assert tmesh.make_mesh(["cuda:0"] * 3) == [torch.device("cuda", 0)] * 3
    assert tmesh.MeshPlan().n_devices() == 1


# ---- host planning against the JAX class ------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["auto", "rows", "csr", "edges"])
def test_host_planning_matches_jax(problem, mode, d):
    _, y0, _, _, jidx, jval = problem
    jo = jmesh.ShardedOptimizer(jtsne.TsneConfig(attraction=mode,
                                                 row_chunk=16), N,
                                n_devices=d)
    to = tmesh.ShardedOptimizer(TsneConfig(attraction=mode, row_chunk=16),
                                N, d, device="cpu")
    assert (to.n_padded, to.n_local) == (jo.n_padded, jo.n_local)
    assert to.cfg.row_chunk == jo.cfg.row_chunk
    assert to.attraction_plan(_t(jidx), _t(jval)) == \
        jo.attraction_plan(jnp.asarray(jidx), jnp.asarray(jval))
    # the JAX class builds from the padded rows its __call__ hands it
    npad = jo.n_padded - N
    jp = (jmesh.pad_rows(jnp.asarray(jidx), npad),
          jmesh.pad_rows(jnp.asarray(jval), npad))
    want = jo._build_csr(*jp)
    got = to._build_csr(_t(jidx), _t(jval))
    assert (got is None) == (want is None)
    for a, b in zip(got or (), want or ()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jo._build_edges(*jp)
    got = to._build_edges(_t(jidx), _t(jval))
    assert (got is None) == (want is None)
    for a, b in zip(got or (), want or ()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    st = jtsne.TsneState(jnp.asarray(y0), jnp.zeros((N, 2)),
                         jnp.ones((N, 2)))
    want = jo._pad_inputs(st, jnp.asarray(jidx), jnp.asarray(jval))
    got = to._pad_inputs(_state(y0), _t(jidx), _t(jval))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def blocks(problem):
    _, y0, idx, dist, _, _ = problem
    return tuple(map(np.asarray, jax.tree_util.tree_leaves(
        affinity_blocks(idx, dist, 4.0))))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_shard_reverse_block_matches_jax(blocks, d):
    jidx, jval, *extra = blocks
    jo = jmesh.ShardedOptimizer(jtsne.TsneConfig(), N, n_devices=d)
    to = tmesh.ShardedOptimizer(TsneConfig(), N, d, device="cpu")
    want = jo._shard_reverse_block(extra)
    got = to._shard_reverse_block(tuple(map(_t, extra)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert to.blocks_plan(_t(jidx), tuple(map(_t, extra))) == \
        jo.blocks_plan(jnp.asarray(jidx), extra)


# ---- mesh D == mesh 1, bit for bit ---------------------------------------------

ARMS = {
    "rows": ({"attraction": "rows"}, {}),
    "csr-fused": ({"attraction": "csr"}, {}),
    "csr-unfused": ({"attraction": "csr"}, {"fused_step": False}),
    "edges": ({"attraction": "edges"}, {}),
    "blocks": ({}, {}),
    "fft": ({"repulsion": "fft", "fft_grid": 32, "attraction": "csr",
             "learning_rate": 200.0}, {}),
    "bh": ({"repulsion": "bh"}, {}),
    "health": ({"attraction": "csr"}, {"health_check": True}),
    "telemetry": ({"attraction": "rows"}, {"telemetry": True}),
    "autopilot": ({"autopilot": True, "attraction": "csr"},
                  {"telemetry": True}),
}
_RUNS: dict = {}


def _mesh_run(problem, blocks, arm, d):
    key = (arm, d)
    if key not in _RUNS:
        cfg_kw, call_kw = ARMS[arm]
        call_kw = dict(call_kw)
        fused = call_kw.pop("fused_step", None)
        _, y0, _, _, jidx, jval = problem
        extra = None
        if arm == "blocks":
            jidx, jval, *extra = blocks
            extra = tuple(map(_t, extra))
        cfg = TsneConfig(iterations=30, row_chunk=8,
                         **{"repulsion": "exact", **cfg_kw})
        opt = tmesh.ShardedOptimizer(cfg, N, d, device="cpu",
                                     fused_step=fused)
        bounds = {}
        st, losses = opt(_state(y0), _t(jidx), _t(jval), extra_edges=extra,
                         checkpoint_every=10,
                         checkpoint_cb=lambda s, it, ls: bounds.update(
                             {it: (s.y.numpy().copy(), ls.numpy().copy())}),
                         **call_kw)
        _RUNS[key] = (opt.layout, bounds, st, losses.numpy(),
                      opt.telemetry_, opt.pilot_)
    return _RUNS[key]


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("arm", list(ARMS))
def test_mesh_d_equals_mesh_1_bit_for_bit(problem, blocks, arm, d):
    lay1, b1, st1, l1, t1, p1 = _mesh_run(problem, blocks, arm, 1)
    lay, b, st, losses, tel, pil = _mesh_run(problem, blocks, arm, d)
    want_layout = {"blocks": "blocks", "edges": "edges", "rows": "rows",
                   "bh": "rows", "telemetry": "rows"}.get(arm, "csr")
    assert lay == lay1 == want_layout
    assert set(b) == set(b1) == {10, 20}
    for it in b1:
        np.testing.assert_array_equal(b[it][0], b1[it][0], err_msg=str(it))
        np.testing.assert_array_equal(b[it][1], b1[it][1], err_msg=str(it))
    for a, w in zip(st, st1):
        np.testing.assert_array_equal(a.numpy(), w.numpy())
    np.testing.assert_array_equal(losses, l1)
    assert np.isfinite(st.y.numpy()).all() and losses[-1] > 0
    if t1 is not None:
        np.testing.assert_array_equal(tel, t1)
    if p1 is not None:
        for a, w in zip(pil, p1):
            np.testing.assert_array_equal(a, w)


def test_center_input_on_a_mesh_matches_jax(problem):
    """``center_input`` over 4 shards of the padded rows (each shard its
    rows and mask) equals the one-shard call and the JAX function."""
    from tsne_flink_tpu_torch.models import tsne as ttsne
    x = problem[0]
    npad = tmesh.padded_rows_for(N, 4)
    xp = np.concatenate([x, np.zeros((npad - N, x.shape[1]))])
    valid = np.arange(npad) < N
    want = np.asarray(jtsne.center_input(jnp.asarray(xp), valid=jnp.asarray(
        valid)))
    nl = npad // 4
    parts = tmesh.run_shards(["cpu"] * 4, lambda ax: ttsne.center_input(
        _t(xp[ax.index * nl:(ax.index + 1) * nl]), ax,
        _t(valid[ax.index * nl:(ax.index + 1) * nl])))
    got = torch.cat(parts).numpy()
    one, = tmesh.run_shards(["cpu"], lambda ax: ttsne.center_input(
        _t(xp), ax, _t(valid)))
    np.testing.assert_array_equal(got, one.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_host_reads_one_a_shard_a_boundary(problem):
    """Under the autopilot each shard reads the replicated stride level
    once a report boundary: D reads a boundary, none in between."""
    from tsne_flink_tpu_torch.models import autopilot as ap
    _, y0, _, _, jidx, jval = problem
    cfg = TsneConfig(iterations=30, row_chunk=8, autopilot=True)
    reads = {}
    for d in (1, 4):
        ap.reset_host_reads()
        tmesh.ShardedOptimizer(cfg, N, d, device="cpu")(
            _state(y0), _t(jidx), _t(jval))
        reads[d] = ap.host_reads()
    assert reads[1] == 30 // 10 - 1  # the boundaries before the last
    assert reads[4] == 4 * reads[1]


# ---- against the JAX ShardedOptimizer and the oracle ------------------------

@pytest.mark.parametrize("arm", ["rows", "csr", "edges", "blocks", "bh",
                                 "autopilot", "health"])
def test_mesh_8_matches_jax_sharded_optimizer(problem, blocks, jax_mesh,
                                              arm):
    _, y0, _, _, jidx, jval = problem
    extra = None
    if arm == "blocks":
        jidx, jval, *extra = blocks
    cfg_kw = {"rows": {"attraction": "rows"}, "csr": {"attraction": "csr"},
              "edges": {"attraction": "edges"}, "blocks": {},
              "bh": {"repulsion": "bh"}, "autopilot": {"autopilot": True},
              "health": {}}[arm]
    jcfg = jtsne.TsneConfig(iterations=8, row_chunk=16,
                            **{"repulsion": "exact", **cfg_kw})
    kw = {"health_check": True} if arm == "health" else {}
    js = jtsne.TsneState(jnp.asarray(y0), jnp.zeros((N, 2)),
                         jnp.ones((N, 2)))
    jst, jl = jmesh.ShardedOptimizer(jcfg, N, n_devices=8)(
        js, jnp.asarray(jidx), jnp.asarray(jval), extra_edges=extra, **kw)
    tst, tl = tmesh.ShardedOptimizer(
        convert.config_from_jax(jcfg), N, 8, device="cpu")(
        _state(y0), _t(jidx), _t(jval),
        extra_edges=None if extra is None else tuple(map(_t, extra)), **kw)
    np.testing.assert_allclose(tst.y.numpy(), np.asarray(jst.y), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tst.gains.numpy(), np.asarray(jst.gains),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9,
                               atol=1e-12)


def test_mesh_8_fft_matches_jax(problem, jax_mesh):
    """FFT repulsion by iterations from a spread-out state (the early
    trajectory from a 1e-4 init amplifies the FFT's rounding): the grid
    is built from the gathered y on every shard."""
    _, _, _, _, jidx, jval = problem
    rng = np.random.default_rng(1)
    y = rng.standard_normal((N, 2)) * 5.0
    upd = rng.standard_normal((N, 2)) * 5e-2
    gains = 1.0 + rng.random((N, 2))
    jcfg = jtsne.TsneConfig(iterations=152, row_chunk=16, repulsion="fft",
                            fft_grid=32, attraction="rows")
    js = jtsne.TsneState(*map(jnp.asarray, (y, upd, gains)))
    jst, jl = jmesh.ShardedOptimizer(jcfg, N, n_devices=8)(
        js, jnp.asarray(jidx), jnp.asarray(jval), start_iter=149)
    tst, tl = tmesh.ShardedOptimizer(convert.config_from_jax(jcfg), N, 8,
                                     device="cpu")(
        _state(y, upd, gains), _t(jidx), _t(jval), start_iter=149)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(tl.numpy()[14], float(jl[14]), rtol=1e-9)


def test_mesh_8_matches_oracle_trajectory():
    rng = np.random.default_rng(3)
    n, k = 33, 6
    centers = rng.normal(size=(3, 5)) * 4.0
    x = centers[rng.integers(0, 3, n)] + rng.normal(size=(n, 5))
    idx, dist = knn_bruteforce(jnp.asarray(x), k)
    p = pairwise_affinities(dist, 4.0)
    jidx, jval = joint_distribution(idx, p)
    pm = oracle.joint_dense(np.asarray(idx), np.asarray(p))
    y0 = rng.normal(size=(n, 2)) * 1e-4
    cfg = TsneConfig(iterations=10, repulsion="exact", row_chunk=8)
    st, losses = tmesh.ShardedOptimizer(cfg, n, 8, device="cpu")(
        _state(y0), _t(jidx), _t(jval))
    want_y, want_losses = oracle.run(pm, y0, 10)
    np.testing.assert_allclose(st.y.numpy(), want_y, atol=1e-8)
    np.testing.assert_allclose(float(losses[0]), want_losses[10],
                               rtol=1e-9)


# ---- psum, faults, the estimator, the runtime ---------------------------------

def test_psum_within_the_guardrail_of_canonical():
    """The JAX package's A/B problem (tests/data/mesh_reduce_ab.json: 600
    points in 12 tight clusters, 300 iterations, float32, mesh 4): psum
    ends within KL_GUARDRAIL_TOL of canonical and is not bit-identical to
    it; canonical mesh 4 is mesh 1's bits."""
    from tsne_flink_tpu_torch.models.autopilot import KL_GUARDRAIL_TOL
    rng = np.random.default_rng(0)
    centers = rng.normal(0.0, 10.0, (12, 8))
    x = np.concatenate([rng.normal(c, 0.5, (50, 8)) for c in centers])
    idx, dist = knn_bruteforce(jnp.asarray(x, jnp.float32), 8)
    jidx, jval = joint_distribution(idx, pairwise_affinities(dist, 8.0))
    y0 = (rng.normal(size=(600, 2)) * 1e-4).astype(np.float32)
    cfg = TsneConfig(iterations=300, repulsion="exact", row_chunk=64)
    out = {}
    for mode, d in (("canonical", 4), ("psum", 4), ("canonical", 1)):
        st, losses = tmesh.ShardedOptimizer(cfg, 600, d, device="cpu",
                                            mesh_reduce=mode)(
            _state(y0), _t(jidx), _t(jval))
        out[mode, d] = (float(losses[-1]), st.y.numpy())
    (kl_c, y_c), (kl_p, y_p) = out["canonical", 4], out["psum", 4]
    assert abs(kl_p - kl_c) <= KL_GUARDRAIL_TOL, (kl_p, kl_c)
    assert not np.array_equal(y_p, y_c)
    np.testing.assert_array_equal(out["canonical", 1][1], y_c)


class _ShardFault(RuntimeError):
    pass


@pytest.mark.parametrize("when", [0, 7])
def test_an_exception_in_one_shard_ends_the_run(problem, monkeypatch, when):
    """Shard 2 raises at its ``when``-th gather: every other shard leaves
    the barrier and the caller gets shard 2's exception — well inside the
    test's own time limit."""
    _, y0, _, _, jidx, jval = problem
    calls = {}
    real = tmesh.MeshAxis.all_gather

    def gather(self, x):
        if self.index == 2:
            calls[2] = calls.get(2, 0) + 1
            if calls[2] > when:
                raise _ShardFault("shard 2 failed")
        return real(self, x)

    monkeypatch.setattr(tmesh.MeshAxis, "all_gather", gather)
    opt = tmesh.ShardedOptimizer(TsneConfig(iterations=20, row_chunk=8), N,
                                 4, device="cpu")
    err = []

    def run():
        try:
            opt(_state(y0), _t(jidx), _t(jval))
        except BaseException as e:  # noqa: BLE001 — inspected below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "a shard hung"
    assert len(err) == 1 and isinstance(err[0], _ShardFault)
    assert not [th for th in threading.enumerate()
                if th.name.startswith("mesh-shard-")]


def _blobs(n=52, d=8, seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)) * 5.0
    return centers[rng.integers(0, 3, n)] + rng.normal(size=(n, d))


_EST = dict(perplexity=5.0, n_iter=40, random_state=4,
            knn_method="bruteforce", repulsion="exact", device="cpu",
            dtype="float64")


def test_estimator_mesh_2_equals_mesh_1():
    x = _blobs()
    y1 = TSNE(mesh=1, **_EST).fit_transform(x)
    y2 = TSNE(mesh=2, **_EST).fit_transform(x)
    y4 = TSNE(mesh=["cpu"] * 4, **_EST).fit_transform(x)
    np.testing.assert_array_equal(y2, y1)
    np.testing.assert_array_equal(y4, y1)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        est = TSNE(spmd=True, devices=2, **_EST)
    np.testing.assert_array_equal(est.fit_transform(x), y1)


def test_oom_ladder_on_meshed_pipeline():
    """A device OOM in optimize's first segment on a 4-wide mesh takes the
    single-device path's ladder step (repulsion demoted), the run
    resumes and ends, and the ladder's plan carries the width."""
    from tsne_flink_tpu_torch.runtime.supervisor import (Supervisor,
                                                         run_plan_from_fit,
                                                         supervised_embed)
    x = torch.from_numpy(_blobs(60, 6, 0))
    cfg = TsneConfig(iterations=40, perplexity=5.0, repulsion="exact",
                     row_chunk=8)
    faults.activate("oom@optimize:seg1")
    try:
        sup = Supervisor(run_plan_from_fit(60, 6, 15, cfg, "auto",
                                           "bruteforce", mesh=4,
                                           backend="cpu"),
                         max_retries=2, on_oom="ladder")
        run = supervised_embed(x, cfg, supervisor=sup, neighbors=15, seed=0,
                               device="cpu", mesh=4)
    finally:
        faults.activate(None)
    assert np.isfinite(run.state.y.numpy()).all()
    assert any(e["type"] == "oom" for e in sup.events)
    assert [d["action"] for d in sup.degradations] == ["repulsion-demote"]
    assert sup.ladder.plan.mesh == 4
    assert run.cfg.repulsion != "exact"


def test_divergence_rollback_on_meshed_pipeline(problem):
    """A poisoned segment on a 4-wide mesh: the sentinel rolls back once,
    halves eta, and the recovered run is mesh 1's bit for bit."""
    _, y0, _, _, jidx, jval = problem
    outs = {}
    for d in (1, 4):
        faults.activate("nan@optimize:seg1")
        try:
            events = []
            opt = tmesh.ShardedOptimizer(
                TsneConfig(iterations=30, repulsion="exact", row_chunk=8),
                N, d, device="cpu")
            st, losses = opt(_state(y0), _t(jidx), _t(jval),
                             checkpoint_every=10,
                             checkpoint_cb=lambda *a: None,
                             health_check=True, events=events)
        finally:
            faults.activate(None)
        assert [e["type"] for e in events] == ["sentinel-rollback"]
        assert opt.cfg.learning_rate == 500.0
        outs[d] = (st.y.numpy(), losses.numpy())
    np.testing.assert_array_equal(outs[4][0], outs[1][0])
    np.testing.assert_array_equal(outs[4][1], outs[1][1])


def _csv(path, x):
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                f.write(f"{i},{j},{float(x[i, j])!r}\n")


def test_fat_checkpoint_portable_across_mesh_widths(tmp_path):
    """A fat checkpoint written at mesh 1 resumes at mesh 4, and one
    written at mesh 4 at mesh 1: both land the uninterrupted run's final
    arrays and loss trace bit for bit (the JAX test's CLI runs, in
    process)."""
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    from tsne_flink_tpu_torch.utils.cli import main

    inp = str(tmp_path / "in.csv")
    _csv(inp, _blobs(40, 6, 0))

    def cli(out, extra):
        main(["--input", inp, "--output", str(tmp_path / out),
              "--dimension", "6", "--knnMethod", "bruteforce",
              "--perplexity", "5", "--dtype", "float64", "--noCache",
              "--loss", str(tmp_path / "loss.txt")] + extra, device="cpu")

    cli("full.csv", ["--iterations", "40", "--mesh", "1", "--checkpoint",
                     str(tmp_path / "full.npz")])
    ref, it_ref, loss_ref = ckpt.load(str(tmp_path / "full.npz"))
    assert it_ref == 40
    for src, dst in ((1, 4), (4, 1)):
        cli(f"part{src}.csv", ["--iterations", "20", "--mesh", str(src),
                               "--fatCheckpoint", "--checkpoint",
                               str(tmp_path / f"part{src}.npz")])
        cli(f"res{src}{dst}.csv",
            ["--iterations", "40", "--mesh", str(dst), "--resume",
             str(tmp_path / f"part{src}.npz"), "--checkpoint",
             str(tmp_path / f"res{src}{dst}.npz")])
        got, it, losses = ckpt.load(str(tmp_path / f"res{src}{dst}.npz"))
        assert it == 40
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"{src}->{dst}")
        np.testing.assert_array_equal(losses, loss_ref)


def test_optimize_under_one_axis_is_the_plain_loop(problem):
    """``optimize`` with a one-shard axis over the whole problem is the
    plain single-device loop bit for bit when the padding and the row
    chunk are the same (48 rows, chunk 6)."""
    from tsne_flink_tpu_torch.models import tsne as ttsne
    _, y0, _, _, jidx, jval = problem
    cfg = TsneConfig(iterations=20, row_chunk=6, attraction="rows")
    opt = tmesh.ShardedOptimizer(cfg, N, 1, device="cpu")
    st_p, jidx_p, jval_p, valid = opt._pad_inputs(_state(y0), _t(jidx),
                                                  _t(jval))
    plain = ttsne.optimize(st_p, jidx_p, jval_p, cfg, valid=valid)
    opt.shard_inputs(_t(jidx), _t(jval))
    meshed = opt.segment(_state(y0), cfg, start_iter=0, num_iters=20)
    np.testing.assert_array_equal(meshed[0].y.numpy(),
                                  plain[0].y[:N].numpy())
    np.testing.assert_array_equal(meshed[1].numpy(), plain[1].numpy())
    assert replace(cfg, row_chunk=2048).row_chunk != opt.clamp(
        replace(cfg, row_chunk=2048)).row_chunk


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """A mesh's shards launch from their own threads: 16 threads x 2,000
    launches of a kernel (its library stubbed) count 32,000, under a
    shortened switch interval."""
    import sys
    from types import SimpleNamespace

    from tsne_flink_tpu_torch.kernels import build
    lib = SimpleNamespace(tsne_repulsion_f32=lambda *a: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=0))
    kern = build.Kernel("tsne_repulsion_f32")

    def launch():
        for _ in range(2000):
            kern()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kern.launches == 32_000


def test_more_shards_than_cores(problem):
    """A mesh of more CPU shards than the host has cores, under a
    shortened switch interval: the run ends inside its time limit, and
    the host-read counter, bumped from every shard thread, loses no
    update (one read a shard a report boundary)."""
    import os
    import sys

    from tsne_flink_tpu_torch.models import autopilot as ap
    _, y0, _, _, jidx, jval = problem
    d = min(64, (os.cpu_count() or 1) + 1)
    cfg = TsneConfig(iterations=30, row_chunk=8, autopilot=True)
    out = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ap.reset_host_reads()
        t = threading.Thread(target=lambda: out.append(
            tmesh.ShardedOptimizer(cfg, N, d, device="cpu")(
                _state(y0), _t(jidx), _t(jval))), daemon=True)
        t.start()
        t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive() and len(out) == 1
    assert np.isfinite(out[0][0].y.numpy()).all()
    assert ap.host_reads() == d * (30 // 10 - 1)
