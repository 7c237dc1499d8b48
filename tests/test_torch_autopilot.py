"""PyTorch port, the approximation policies vs the JAX package (f64, CPU).

* ``pilot_update`` makes the JAX function's decisions and writes its
  trace over a grad-norm sequence that fires every trigger (warmup, hold,
  raise, collapse-rough, the exaggeration crossing, collapse-tail);
  ``policy_report`` gives equal dicts; ``landmark_points`` equal ids;
* ``subsample_affinities``, ``landmark_placement_rows`` and
  ``interpolation_init`` agree to ±1e-12;
* ``optimize`` under ``repulsion_stride`` 2 and 4 and under the autopilot
  (exact, and FFT with its grid ladder) keeps y within ±1e-9 of the JAX
  function over 60 iterations on the CSR, rows and blocks layouts, with
  the same policy trace; the autopilot with a stride raises;
* ``landmark_optimize`` from the JAX init ends within
  ``KL_GUARDRAIL_TOL`` of the JAX schedule's final KL, and
  ``tsne_embed(landmark=...)`` runs it;
* checkpoints carry the pilot pair both ways between the packages, and a
  resumed CLI autopilot run reproduces the policy trace and the bits of
  the run that was not stopped.
"""

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.models import autopilot as jpilot
from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu.ops import affinities as jaff
from tsne_flink_tpu.serve.transform import interpolation_init as j_interp
from tsne_flink_tpu.utils import checkpoint as jckpt
from tsne_flink_tpu.utils.artifacts import prepare as jax_prepare
from tsne_flink_tpu_torch import convert
from tsne_flink_tpu_torch.models import autopilot as tpilot
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.ops import affinities as taff
from tsne_flink_tpu_torch.serve.transform import interpolation_init
from tsne_flink_tpu_torch.utils import checkpoint as tckpt

pytestmark = pytest.mark.fast

N, K, PERPLEXITY = 600, 8, 8.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: contending intra-op pools of parallel test workers
    slow them down, so torch runs one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n=N, clusters=12, seed=0, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (clusters, d))
    return centers[rng.integers(0, clusters, n)] + rng.normal(0.0, 0.5,
                                                              (n, d))


@pytest.fixture(scope="module")
def prep():
    return jax_prepare(jnp.asarray(_blobs()), neighbors=K,
                       knn_method="bruteforce", perplexity=PERPLEXITY)


# ---- the controller ---------------------------------------------------------

def _gn_sequence(cfg):
    """Grad norms at the report iterations, built to fire every trigger:
    warmup, raise x3, hold, collapse-rough, raise, the crossing of the
    exaggeration boundary, raises, then the tail."""
    seq = {9: 1.0, 19: 1.05, 29: 1.1, 39: 1.12, 49: 1.45, 59: 3.0,
           69: 3.1, 79: 3.2, 89: 3.25, 99: 3.3, 109: 0.5}
    gn, out = 0.5, {}
    for i in range(9, cfg.iterations, 10):
        if i in seq:
            gn = seq[i]
        else:
            gn *= 0.97
        out[i] = gn
    return out


def test_pilot_update_decisions_and_trace_match_jax():
    cfg_j = jtsne.TsneConfig(iterations=300, autopilot=True,
                             repulsion="fft")
    cfg_t = convert.config_from_jax(cfg_j)
    gns = _gn_sequence(cfg_j)
    pj, tj = (jpilot.pilot_init(cfg_j, jnp.float64),
              jpilot.trace_init(cfg_j, jnp.float64))
    pt, tt = (tpilot.pilot_init(cfg_t, torch.float64),
              tpilot.trace_init(cfg_t, torch.float64))
    n_slots = cfg_j.n_loss_slots
    upd = jax.jit(partial(jpilot.pilot_update, cfg=cfg_j))
    for i in range(cfg_j.iterations):
        record = (i + 1) % 10 == 0
        refreshed = i % 3 == 0
        slot = ttsne.loss_slot(i, n_slots)
        gn = gns.get(i, 0.25)
        pj, tj = upd(jnp.asarray(i), jnp.asarray(gn, jnp.float64), pj, tj,
                     jnp.asarray(refreshed), jnp.asarray(slot),
                     jnp.asarray(record))
        pt, tt = tpilot.pilot_update(i, torch.tensor(gn, dtype=torch.float64),
                                     pt, tt, refreshed, slot, record, cfg_t)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    fired = {tpilot.PILOT_TRIGGERS[int(c)] for c in tt[:, 3].tolist()}
    assert fired == set(tpilot.PILOT_TRIGGERS)
    # the report of that run, and of static policies, equal the JAX's
    for pilot in ((pt, tt), None):
        for landmark in (None, {"landmark": True, "n_landmark": 150,
                                "landmark_iters": 240, "polish_iters": 60,
                                "landmark_fraction": 0.25,
                                "landmark_grid": 512}):
            want = jpilot.policy_report(
                cfg_j, None if pilot is None else (pj, tj),
                landmark=landmark)
            assert tpilot.policy_report(cfg_t, pilot,
                                        landmark=landmark) == want
    stride = replace(cfg_j, autopilot=False, repulsion_stride=4)
    assert (tpilot.policy_report(convert.config_from_jax(stride), None,
                                 iterations_run=123)
            == jpilot.policy_report(stride, None, iterations_run=123))
    collapsed = tpilot.pilot_collapse(pt)
    np.testing.assert_array_equal(collapsed.numpy(),
                                  np.asarray(jpilot.pilot_collapse(pj)))


def test_policy_helpers_match_jax(monkeypatch):
    for it in (5, 30, 95, 300, 1000):
        cj = jtsne.TsneConfig(iterations=it, repulsion="fft", fft_grid=256)
        ct = convert.config_from_jax(cj)
        assert tpilot.tail_start(ct) == jpilot.tail_start(cj)
        assert tpilot.landmark_schedule(ct) == jpilot.landmark_schedule(cj)
        for m in (2, 3):
            assert tpilot.grid_ladder(ct, m) == jpilot.grid_ladder(cj, m)
            assert tpilot.landmark_grid(ct, m) == jpilot.landmark_grid(cj, m)
        for i in (0, 100, 101, 250):
            assert tpilot.grid_phase(i, ct) == int(jpilot.grid_phase(i, cj))
    for name in ("STRIDE_LADDER", "SMOOTH_REL", "ROUGH_REL",
                 "KL_GUARDRAIL_TOL", "LANDMARK_MIN_N", "PILOT_TRACE_FIELDS",
                 "PILOT_TRIGGERS", "PILOT_STATE_FIELDS"):
        assert getattr(tpilot, name) == getattr(jpilot, name), name
    cfg = jtsne.TsneConfig(autopilot=True)
    for mode in ("auto", "on", "off"):
        monkeypatch.setenv("TSNE_LANDMARK", mode)
        for n in (100, 20_000, 60_000):
            for c in (cfg, replace(cfg, autopilot=False)):
                assert (tpilot.pick_landmark(convert.config_from_jax(c), n,
                                             mode)
                        == jpilot.pick_landmark(c, n))
    for frac in (0.25, 0.1, 0.001, 0.95):
        monkeypatch.setenv("TSNE_LANDMARK_FRACTION", str(frac))
        assert tpilot.landmark_fraction(frac) == jpilot.landmark_fraction()
        for n, seed in ((600, 0), (20_000, 3), (60_000, 7)):
            np.testing.assert_array_equal(
                tpilot.landmark_points(n, seed, frac),
                jpilot.landmark_points(n, seed))


def test_landmark_layouts_and_interpolation_match_jax(prep):
    lm = jpilot.landmark_points(N, 5)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    si, sv = taff.subsample_affinities(jidx, jval, lm)
    wi, wv = jaff.subsample_affinities(prep.jidx, prep.jval, lm)
    np.testing.assert_array_equal(si.numpy(), np.asarray(wi))
    np.testing.assert_allclose(sv.numpy(), np.asarray(wv), rtol=0,
                               atol=1e-12)
    assert si.dtype == torch.int32 and sv.dtype == torch.float64
    ri, rv = taff.landmark_placement_rows(jidx, jval, lm)
    wi, wv = jaff.landmark_placement_rows(prep.jidx, prep.jval, lm)
    np.testing.assert_array_equal(ri.numpy(), np.asarray(wi))
    np.testing.assert_allclose(rv.numpy(), np.asarray(wv), rtol=0,
                               atol=1e-12)
    yb = np.random.default_rng(2).standard_normal((lm.shape[0], 2)) * 7.0
    got = interpolation_init(rv, ri, torch.from_numpy(yb))
    want = j_interp(jnp.asarray(wv), jnp.asarray(wi), jnp.asarray(yb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


# ---- optimize under the policies --------------------------------------------

def _layouts(layout, prep, cfg):
    """(JAX rows, JAX keywords, port rows, port keywords) of a layout."""
    jidx, jval = prep.jidx, prep.jval
    jkw, tkw = {}, {}
    if layout == "blocks":
        jidx, jval, extra = jaff.affinity_blocks(prep.idx, prep.dist,
                                                 cfg.perplexity)
        jkw.update(edges=extra, edges_extra=True)
        *t_rows, edges = convert.blocks_from_numpy(jidx, jval, extra,
                                                   device="cpu")
        tkw.update(edges=edges, edges_extra=True)
    else:
        t_rows = convert.rows_from_numpy(jidx, jval, device="cpu")
        if layout == "csr":
            _, csr = jtsne._plan_layout(jidx, jval, cfg)
            jkw["csr"] = csr
            tkw["csr"] = convert.csr_from_numpy(csr[:2], csr[2:],
                                                device="cpu")
    return (jidx, jval), jkw, tuple(t_rows), tkw


POLICIES = {"stride2": dict(repulsion_stride=2),
            "stride4": dict(repulsion_stride=4),
            "autopilot": dict(autopilot=True),
            "autopilot-fft": dict(autopilot=True, repulsion="fft",
                                  fft_grid=64)}


#: N/3, FIt-SNE's learning rate (the smoke's ``[large]`` uses it too).  At
#: the default 1000 a 600-point run amplifies rounding ~1e8-fold in 60
#: iterations under a stride, in the JAX package as in the port
LEARNING_RATE = N / 3


@pytest.mark.parametrize("layout", ["csr", "rows", "blocks"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_optimize_under_policies_matches_jax(prep, layout, policy):
    """60 iterations from a spread state: [110, 170) for the strides and
    the exact autopilot (the controller climbs there), [70, 130) across
    the exaggeration boundary for the FFT ladder."""
    start = 70 if policy == "autopilot-fft" else 110
    cfg = jtsne.TsneConfig(perplexity=PERPLEXITY, iterations=300,
                           row_chunk=64, learning_rate=LEARNING_RATE,
                           **POLICIES[policy])
    rng = np.random.default_rng(11)
    y0 = rng.standard_normal((N, 2)) * 5.0
    u0 = rng.standard_normal((N, 2)) * 0.05
    g0 = 1.0 + rng.random((N, 2))
    (jidx, jval), jkw, (tidx, tval), tkw = _layouts(layout, prep, cfg)
    statics = {k: jkw.pop(k) for k in ("edges_extra",) if k in jkw}
    run = jax.jit(partial(jtsne.optimize, cfg=cfg, num_iters=60, **statics))
    jout = run(jtsne.TsneState(*map(jnp.asarray, (y0, u0, g0))), jidx, jval,
               start_iter=start, **jkw)
    tout = ttsne.optimize(convert.state_from_numpy(y0, u0, g0, device="cpu"),
                          tidx, tval, convert.config_from_jax(cfg),
                          start_iter=start, num_iters=60, **tkw)
    assert len(tout) == len(jout)
    for a, b in zip(tout[0], jout[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               rtol=1e-9, atol=1e-12)
    if cfg.autopilot:
        (pt, tt), (pj, tj) = tout[2], jout[2]
        np.testing.assert_array_equal(tt[:, [0, 1, 3]].numpy(),
                                      np.asarray(tj)[:, [0, 1, 3]])
        np.testing.assert_allclose(tt[:, 2].numpy(), np.asarray(tj)[:, 2],
                                   rtol=1e-9)
        assert float(pt[2]) == float(pj[2])  # the refresh count
        written = tt[start // 10:(start + 60) // 10]
        if cfg.repulsion == "fft":  # both rungs of the grid ladder ran
            assert set(written[:, 1].tolist()) == {0.0, 1.0}
        else:  # the controller climbed
            assert float(written[:, 0].max()) > 1


def test_autopilot_with_a_stride_raises(prep):
    tcfg = ttsne.TsneConfig(autopilot=True, repulsion_stride=2)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    st = convert.state_from_numpy(np.zeros((N, 2)), device="cpu")
    with pytest.raises(ValueError, match="supersedes"):
        ttsne.optimize(st, jidx, jval, tcfg, num_iters=1)


def test_host_reads_once_a_report_boundary(prep):
    cfg = ttsne.TsneConfig(perplexity=PERPLEXITY, iterations=100,
                           autopilot=True)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    st = convert.state_from_numpy(
        np.random.default_rng(0).standard_normal((N, 2)), device="cpu")
    tpilot.reset_host_reads()
    out = ttsne.optimize(st, jidx, jval, cfg)
    assert tpilot.host_reads() == 9  # boundaries 10..90; none after 100
    tpilot.reset_host_reads()
    ttsne.optimize(st, jidx, jval, cfg, start_iter=50, num_iters=50,
                   pilot_carry=out[2])
    assert tpilot.host_reads() == 1 + 4  # the carried level, then 60..90


def test_landmark_optimize_within_guardrail_of_jax(prep, monkeypatch):
    """The schedule from the JAX init.  Its early phases are chaotic: at
    600 points the JAX schedule's own final KL moves by up to ~0.8 when
    its init moves by one part in 1e15 under the autopilot or at learning
    rate 1000, so the port is held where the JAX package reproduces
    itself (checked here): the schedule forced on, learning rate N/3."""
    monkeypatch.setenv("TSNE_LANDMARK_FRACTION", "0.25")
    cfg = jtsne.TsneConfig(perplexity=PERPLEXITY, iterations=300,
                           learning_rate=LEARNING_RATE)
    _, ikey = jax.random.split(jax.random.key(0))
    st = jtsne.init_working_set(ikey, N, 2, jnp.float64)
    jy, jl, jinfo = jtsne.landmark_optimize(st, prep.jidx, prep.jval, cfg,
                                            seed=0)
    yp = st.y * (1.0 + 1e-15 * np.random.default_rng(1).standard_normal(
        st.y.shape))
    _, pl, _ = jtsne.landmark_optimize(st._replace(y=yp), prep.jidx,
                                       prep.jval, cfg, seed=0)
    assert abs(float(pl[-1]) - float(jl[-1])) <= KL_GUARDRAIL_TOL / 2
    tcfg = convert.config_from_jax(cfg)
    jidx, jval = convert.rows_from_numpy(prep.jidx, prep.jval, device="cpu")
    pilots = {}
    ty, tl, tinfo = ttsne.landmark_optimize(
        convert.state_from_numpy(np.asarray(st.y), device="cpu"), jidx, jval,
        tcfg, seed=0, pilots=pilots)
    assert tinfo == jinfo
    assert pilots == {}  # no autopilot, no pilot pairs
    assert abs(float(tl[-1]) - float(jl[-1])) <= KL_GUARDRAIL_TOL
    assert torch.isfinite(ty).all() and ty.shape == (N, 2)
    # tsne_embed runs the schedule when asked, and reports it
    stats = {}
    y, losses = ttsne.tsne_embed(_blobs(), replace(tcfg, autopilot=True),
                                 neighbors=K, device="cpu", landmark="on",
                                 stats=stats)
    assert stats["policy"]["landmark"] and stats["policy"]["n_landmark"] \
        == 150 and torch.isfinite(y).all()
    assert set(stats["pilots"]) == {"landmark", "polish"}


# ---- checkpoints -------------------------------------------------------------

def test_pilot_pairs_cross_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    y = rng.standard_normal((20, 2))
    pvec, trace = np.array([2.0, 0.125, 37.0]), rng.random((30, 4))
    st = jtsne.TsneState(jnp.asarray(y), jnp.zeros((20, 2)),
                         jnp.ones((20, 2)))
    jckpt.save(str(tmp_path / "j"), st, 100, np.zeros(30), pilot=(pvec,
                                                                  trace))
    got = tckpt.load_pilot(str(tmp_path / "j"))
    np.testing.assert_array_equal(got[0], pvec)
    np.testing.assert_array_equal(got[1], trace)
    tst = convert.state_from_numpy(y, device="cpu")
    tckpt.save(str(tmp_path / "t"), tst, 100, torch.zeros(30),
               pilot=(torch.from_numpy(pvec), torch.from_numpy(trace)))
    got = jckpt.load_pilot(str(tmp_path / "t"))
    np.testing.assert_array_equal(got[0], pvec)
    np.testing.assert_array_equal(got[1], trace)
    tckpt.save(str(tmp_path / "none"), tst, 100, torch.zeros(30))
    assert tckpt.load_pilot(str(tmp_path / "none")) is None
    assert jckpt.load_pilot(str(tmp_path / "none")) is None


def test_resumed_cli_autopilot_run_reproduces_the_policy(tmp_path):
    from tsne_flink_tpu_torch.utils import cli as tcli
    x = _blobs(300, 6, seed=3, d=5)
    inp = tmp_path / "in.csv"
    with open(inp, "w") as f:
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                f.write(f"{i},{j},{float(x[i, j])!r}\n")
    base = ["--input", str(inp), "--dimension", "5", "--knnMethod",
            "bruteforce", "--perplexity", "8", "--iterations", "120",
            "--noCache", "--autopilot", "--checkpointEvery", "40",
            "--loss", str(tmp_path / "loss.txt")]
    tcli.main(base + ["--output", str(tmp_path / "a.csv"), "--checkpoint",
                      str(tmp_path / "a")], device="cpu")
    tcli.main(base + ["--output", str(tmp_path / "b.csv"), "--checkpoint",
                      str(tmp_path / "b"), "--resume", str(tmp_path / "a.1")],
              device="cpu")
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv"
                                                 ).read_bytes()
    pa = tckpt.load_pilot(str(tmp_path / "a"))
    pb = tckpt.load_pilot(str(tmp_path / "b"))
    np.testing.assert_array_equal(pa[0], pb[0])
    np.testing.assert_array_equal(pa[1], pb[1])
    assert pa[1][:, 0].max() > 1  # the controller climbed
