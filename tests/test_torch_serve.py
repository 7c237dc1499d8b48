"""PyTorch port, out-of-sample serving vs the JAX package (CPU).

* B2 with its rows past the base (``row_offset = N``, ``row_z``): the
  plain version against the JAX ``exact_repulsion`` (f64 rtol 1e-12,
  m = 1, 2, 3, 8); the wrapper refusing a mask with rows past ``y_full``;
* ``knn_queries`` against the JAX function (f64: indices equal,
  distances rtol 1e-12; every metric; k clamped to the base);
* ``fft_base_field``'s potentials and ``fft_field_repulsion``'s gather,
  strays included, against the JAX functions (f64 rtol 1e-9);
* ``model_id`` equal to JAX's from the same arrays and from the same
  JAX-written fat checkpoint; ``load_model`` leaves the directory
  byte-identical and refuses v1 and hash-less files; ``transform_peak``
  equal to the JAX HBM model's plus the query kNN's sort (``query_sort``),
  and ``admission_report`` the whole report, with the JAX report's stages;
* ``transform`` against JAX (exact and fft, f64 rtol 1e-9 at 1, 8 and
  75 iterations), through the port's own field and through the JAX
  field carried over by ``convert.frozen_from_jax``; bit-identical across
  batch splits in the port; empty input and wrong widths;
* the estimator's and the CLI's transform against the JAX estimator and
  CLI (rtol 1e-9);
* a port ``ServeDaemon`` draining a spool written by JAX ``submit``
  (mixed sizes, a pinned unknown model, a swap file), its answers read
  by JAX ``read_result``, each equal bit for bit to a direct port
  ``transform``; its ``.lat.json`` keys equal to a JAX daemon's.

The JAX reference runs as ``tests/test_serve.py`` runs it, on the CPU.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsne_flink_tpu.analysis.audit.hbm import transform_peak_bytes
from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu.models.tsne import TsneState as JState
from tsne_flink_tpu.ops import repulsion_fft as jfft
from tsne_flink_tpu.ops.knn import knn_queries as jknn_queries
from tsne_flink_tpu.ops.repulsion_exact import \
    exact_repulsion as jexact_repulsion
from tsne_flink_tpu.serve import daemon as jdaemon
from tsne_flink_tpu.serve.model import from_arrays as jfrom_arrays
from tsne_flink_tpu.serve.model import load_frozen as jload_frozen
from tsne_flink_tpu.serve.transform import transform as jtransform
from tsne_flink_tpu.utils import checkpoint as jckpt
from tsne_flink_tpu_torch import convert
from tsne_flink_tpu_torch.ops import repulsion_fft as tfft
from tsne_flink_tpu_torch.ops.knn import knn_queries
from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
from tsne_flink_tpu_torch.serve import daemon as tdaemon
from tsne_flink_tpu_torch.serve.model import (PlanConfig, from_arrays,
                                              load_frozen)
from tsne_flink_tpu_torch.serve.transform import transform
from tsne_flink_tpu_torch.utils import checkpoint as tckpt

pytestmark = pytest.mark.fast

N, D, M = 300, 6, 2
#: the stated tolerance of a transform against the JAX package, f64: 75
#: vdM steps with sign-driven gains, measured at ~2e-13 relative
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _base(n=N, d=D, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), scale * rng.standard_normal((n, M))


def _queries(rows, d=D, seed=9, strays=0):
    """Query rows; the last ``strays`` lie far outside the base."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, d))
    q[rows - strays:] *= 6.0
    return q


def _models(repulsion, n=N, seed=0, k=12, dtype=np.float64):
    x, y = _base(n, seed=seed)
    x, y = x.astype(dtype), y.astype(dtype)
    jm = jfrom_arrays(x, y, JPlan(n=n, d=D, k=k, backend="cpu",
                                  repulsion=repulsion, name="serve-test"),
                      perplexity=4.0, learning_rate=100.0)
    tm = from_arrays(x, y, PlanConfig(n=n, d=D, k=k, backend="cpu",
                                      repulsion=repulsion, name="serve-test"),
                     perplexity=4.0, learning_rate=100.0, device="cpu")
    return jm, tm


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)), err_msg=what)


# ---- C2: B2 with the rows past the base -------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_exact_repulsion_rows_past_the_base_match_jax(m):
    rng = np.random.default_rng(m)
    yb = 4.0 * rng.standard_normal((200, m))
    yq = 4.0 * rng.standard_normal((33, m))
    want_r, want_z = jexact_repulsion(jnp.asarray(yq), jnp.asarray(yb),
                                      row_offset=200, row_chunk=16,
                                      row_z=True)
    got_r, got_z = cuda_exact_repulsion(torch.from_numpy(yq),
                                        torch.from_numpy(yb), row_offset=200,
                                        row_chunk=16, row_z=True)
    _close(got_r.numpy(), np.asarray(want_r), 1e-12)
    _close(got_z.numpy(), np.asarray(want_z), 1e-12)
    # no pair is masked: every base row counts in each query's Z
    d2 = ((yq[:, None, :] - yb[None, :, :]) ** 2).sum(-1)
    _close(got_z.numpy(), (1.0 / (1.0 + d2)).sum(1), 1e-12)


def test_b2_wrapper_refuses_a_mask_with_rows_past_y_full():
    y = torch.zeros((10, 2), dtype=torch.float64)
    valid = torch.ones(10, dtype=torch.bool)
    with pytest.raises(ValueError, match="col_valid has no entry"):
        cuda_exact_repulsion(y[:4], y, row_offset=8, col_valid=valid)
    with pytest.raises(ValueError, match="negative"):
        cuda_exact_repulsion(y[:4], y, row_offset=-1)
    # without a mask the rows may lie anywhere past the base
    rep, z = cuda_exact_repulsion(y[:4], y, row_offset=10, row_z=True)
    assert torch.equal(z, torch.full((4,), 10.0, dtype=torch.float64))


# ---- the query kNN ----------------------------------------------------------

@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_knn_queries_match_jax(metric):
    x, _ = _base()
    q = _queries(40, strays=4)
    q[5] = x[17]   # a query on a base point: distance 0, nothing masked
    q[6] = q[7]    # two equal queries
    want_i, want_d = jknn_queries(jnp.asarray(q), jnp.asarray(x), 12, metric)
    got_i, got_d = knn_queries(torch.from_numpy(q), torch.from_numpy(x), 12,
                               metric)
    assert got_i.dtype == torch.int32 and got_i.shape == (40, 12)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_d.numpy(), np.asarray(want_d), 1e-12)
    assert int(got_i[5, 0]) == 17


def test_knn_queries_clamp_k_and_break_ties_low():
    x = np.zeros((5, 3))
    x[3] = 1.0
    q = np.zeros((2, 3))
    got_i, got_d = knn_queries(torch.from_numpy(q), torch.from_numpy(x), 9)
    want_i, _ = jknn_queries(jnp.asarray(q), jnp.asarray(x), 9)
    assert got_i.shape == (2, 5)  # k clamps to n_base, not n_base - 1
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i[0].numpy(), [0, 1, 2, 4, 3])


# ---- the FFT field ----------------------------------------------------------

@pytest.mark.parametrize("m,grid", [(2, 64), (3, 16)])
def test_fft_base_field_and_gather_match_jax(m, grid):
    rng = np.random.default_rng(m)
    yb = 5.0 * rng.standard_normal((400, m))
    yq = 5.0 * rng.standard_normal((50, m))
    yq[-5:] *= 8.0  # strays read the boundary
    jf = jfft.fft_base_field(jnp.asarray(yb), grid=grid)
    tf = tfft.fft_base_field(torch.from_numpy(yb), grid=grid)
    assert tf.pot.shape == (2 + m, grid ** m)
    _close(tf.pot.numpy(), np.asarray(jf.pot), 1e-9, "pot")
    _close(tf.h.numpy(), np.asarray(jf.h), 1e-12, "h")
    _close(tf.origin.numpy(), np.asarray(jf.origin), 1e-12, "origin")
    want_r, want_z = jfft.fft_field_repulsion(jf, jnp.asarray(yq))
    got_r, got_z = tfft.fft_field_repulsion(tf, torch.from_numpy(yq))
    _close(got_r.numpy(), np.asarray(want_r), 1e-9, "rep")
    _close(got_z.numpy(), np.asarray(want_z), 1e-9, "z")


def test_fft_field_is_near_the_exact_sum():
    """In-grid queries evaluate as exact repulsion would, to the FFT's
    interpolation error (``tests/test_fft.py``'s bars)."""
    rng = np.random.default_rng(4)
    yb = 3.0 * rng.standard_normal((500, 2))
    yq = 3.0 * rng.standard_normal((40, 2))
    rep, z = tfft.fft_field_repulsion(
        tfft.fft_base_field(torch.from_numpy(yb), grid=256),
        torch.from_numpy(yq))
    er, ez = cuda_exact_repulsion(torch.from_numpy(yq), torch.from_numpy(yb),
                                  row_offset=500, row_z=True)
    assert float((rep - er).abs().max() / er.abs().max()) < 1e-2
    assert float(((z - ez) / ez).abs().max()) < 1e-2


# ---- model identity and the frozen read -------------------------------------

@pytest.mark.parametrize("repulsion", ["exact", "fft"])
def test_model_id_matches_jax_from_arrays(repulsion):
    jm, tm = _models(repulsion)
    assert tm.repulsion == jm.repulsion == repulsion
    assert tm.model_id == jm.model_id and len(tm.model_id) == 16
    assert tm.k == jm.k == 12 and tm.n == jm.n
    # the JAX value plus the port's query kNN sort, exactly (fault C3)
    from tsne_flink_tpu_torch.analysis.audit.hbm import transform_terms
    sort = transform_terms(tm.serve_plan(256))["query_sort"]
    assert sort > 0
    assert tm.transform_peak(256) == int(
        transform_peak_bytes(jm.serve_plan(256)) + sort)
    # the whole report: the JAX report's stages, its transform stage the
    # admission unit above
    rep, jrep = tm.admission_report(256), jm.admission_report(256)
    assert set(rep["stages"]) == set(jrep["stages"])
    assert rep["peak_hbm_est"] >= tm.transform_peak(256)


def _jax_fat_checkpoint(tmp_path, n=64, seed=3):
    """A fat v2 checkpoint written by the JAX package: y, update, gains
    and a prepare payload with the joint P."""
    x, y = _base(n, seed=seed)
    y = y.astype(np.float32)
    st = JState(y=jnp.asarray(y), update=jnp.zeros_like(jnp.asarray(y)),
                gains=jnp.ones_like(jnp.asarray(y)))
    rng = np.random.default_rng(seed)
    prep = {"label": "split-rows", "affinity_fp": "fp",
            "jidx": rng.integers(0, n, (n, 8)).astype(np.int32),
            "jval": rng.random((n, 8)).astype(np.float32)}
    path = os.path.join(str(tmp_path), "model.npz")
    jckpt.save(path, st, 10, np.asarray([0.5]), prepare=prep)
    return x, y, path


def test_model_id_matches_jax_from_a_jax_checkpoint(tmp_path):
    x, y, path = _jax_fat_checkpoint(tmp_path)
    plan = dict(n=64, d=D, k=8, backend="cpu", repulsion="exact")
    jm = jload_frozen(path, x, JPlan(**plan), perplexity=4.0)
    tm = load_frozen(path, x, PlanConfig(**plan), perplexity=4.0,
                     device="cpu")
    assert tm.ckpt_hash == jm.ckpt_hash and tm.model_id == jm.model_id
    np.testing.assert_array_equal(tm.y.numpy(), y)
    with pytest.raises(ValueError, match="same dataset"):
        load_frozen(path, x[:-1], PlanConfig(**plan), device="cpu")


def test_load_model_is_read_only_and_strict(tmp_path):
    x, _, path = _jax_fat_checkpoint(tmp_path)
    before = {p: open(os.path.join(tmp_path, p), "rb").read()
              for p in os.listdir(tmp_path)}
    state, next_iter, losses, prep, digest = tckpt.load_model(path)
    assert next_iter == 10 and prep["label"] == "split-rows"
    assert digest == jckpt.load_model(path)[4]
    after = {p: open(os.path.join(tmp_path, p), "rb").read()
             for p in os.listdir(tmp_path)}
    assert after == before  # no rotation, no tmp file
    # a v1 file and a hash-less v2 file are refused, as by JAX
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    v1 = dict(arrays, magic=np.asarray(tckpt.MAGIC_V1))
    del v1["content_hash"]
    bare = dict(arrays)
    del bare["content_hash"]
    for name, payload in (("v1.npz", v1), ("bare.npz", bare)):
        p = os.path.join(tmp_path, name)
        np.savez(p, **payload)
        with pytest.raises(tckpt.NotACheckpoint):
            tckpt.load_model(p)
        with pytest.raises(jckpt.NotACheckpoint):
            jckpt.load_model(p)


# ---- the transform ----------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 8, 75])
@pytest.mark.parametrize("repulsion", ["exact", "fft"])
def test_transform_matches_jax(repulsion, iters):
    jm, tm = _models(repulsion)
    q = _queries(40, strays=6)
    want = jtransform(jm, q, bucket=16, iters=iters)
    got = transform(tm, q, bucket=16, iters=iters)
    assert got.shape == (40, M) and got.dtype == np.float64
    _close(got, want, RTOL)
    if repulsion == "fft":  # the JAX field through the port's gather
        _close(transform(convert.frozen_from_jax(jm, device="cpu"), q,
                         bucket=16, iters=iters), want, RTOL)


@pytest.mark.parametrize("repulsion", ["exact", "fft"])
def test_transform_batch_split_bit_identical(repulsion):
    """One batch == 4 buckets == 16 small requests == a ragged split,
    float32 as on the card."""
    _, tm = _models(repulsion, dtype=np.float32)
    q = _queries(64).astype(np.float32)
    whole = transform(tm, q, bucket=16, iters=12)
    assert whole.dtype == np.float32 and np.isfinite(whole).all()
    for step in (16, 4):
        parts = np.concatenate([transform(tm, q[s:s + step], bucket=16,
                                          iters=12)
                                for s in range(0, 64, step)])
        np.testing.assert_array_equal(whole, parts)
    ragged = np.concatenate([transform(tm, q[:30], bucket=16, iters=12),
                             transform(tm, q[30:], bucket=16, iters=12)])
    np.testing.assert_array_equal(whole, ragged)


def test_transform_validates_queries_and_handles_empty():
    _, tm = _models("exact", n=64)
    with pytest.raises(ValueError, match="queries must be"):
        transform(tm, np.zeros((4, D + 1)), bucket=8, iters=2)
    with pytest.raises(ValueError, match="queries must be"):
        transform(tm, np.zeros(D), bucket=8, iters=2)
    out = transform(tm, np.zeros((0, D)), bucket=8, iters=2)
    assert out.shape == (0, M) and out.dtype == np.float64


def test_estimator_transform_matches_jax():
    from tsne_flink_tpu.models.api import TSNE as JTSNE
    from tsne_flink_tpu_torch import TSNE

    with pytest.raises(RuntimeError, match="fit"):
        TSNE(device="cpu").transform(np.zeros((2, 3)))
    x, _ = _base(72)
    q = _queries(9, seed=2)
    est = TSNE(n_iter=12, perplexity=5.0, random_state=0, device="cpu").fit(x)
    assert est.frozen_model() is est.frozen_model()  # one freeze a fit
    jest = JTSNE(n_iter=12, perplexity=5.0, random_state=0).fit(x)
    # the fits' embeddings differ (each package's own init): freeze the
    # JAX fit's embedding in the port and compare the transforms
    est.embedding_ = jest.embedding_
    est._frozen = None
    got = est.transform(q, bucket=8, iters=4)
    _close(got, jest.transform(q, bucket=8, iters=4), RTOL)
    assert est.frozen_model().model_id == jest.frozen_model().model_id
    np.testing.assert_array_equal(got, est.transform(q, bucket=8, iters=4))


def _write_coo(path, x):
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                f.write(f"{i},{j},{float(x[i, j])!r}\n")


def test_cli_transform_route_matches_the_jax_cli(tmp_path, capsys):
    """A JAX-written fat checkpoint served by both CLIs' --model/
    --transform route: the same rows, the same model id, and the
    checkpoint's bytes unchanged.  (The JAX CLI's fit does not trace
    under jax 0.9, ROADMAP §C; its serve route runs no fit.)"""
    from tsne_flink_tpu.utils.cli import main as jmain
    from tsne_flink_tpu_torch.utils.cli import main as tmain

    x, _, ckpt_path = _jax_fat_checkpoint(tmp_path, n=40)
    q = _queries(7, seed=5)
    base_csv, query_csv = tmp_path / "base.csv", tmp_path / "q.csv"
    _write_coo(base_csv, x)
    _write_coo(query_csv, q)
    ckpt_bytes = open(ckpt_path, "rb").read()
    serve = ["--input", str(base_csv), "--model", ckpt_path, "--transform",
             str(query_csv), "--dimension", str(D), "--knnMethod",
             "bruteforce", "--perplexity", "5", "--repulsion", "exact"]
    capsys.readouterr()
    assert jmain(serve + ["--output", str(tmp_path / "j.csv")]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tmain(serve + ["--output", str(tmp_path / "t.csv")],
                 device="cpu") == 0
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tline.replace("t.csv", "j.csv") == jline
    want = np.loadtxt(tmp_path / "j.csv", delimiter=",", ndmin=2)
    got = np.loadtxt(tmp_path / "t.csv", delimiter=",", ndmin=2)
    assert got.shape == (7, 3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    _close(got[:, 1:], want[:, 1:], RTOL)
    assert open(ckpt_path, "rb").read() == ckpt_bytes
    with pytest.raises(SystemExit):  # --transform without --model
        tmain(["--input", str(base_csv), "--transform", str(query_csv),
               "--output", str(tmp_path / "o.csv"), "--dimension", str(D),
               "--knnMethod", "bruteforce"], device="cpu")
    with pytest.raises(SystemExit):  # a distance matrix has no features
        tmain(serve + ["--output", str(tmp_path / "o.csv"),
                       "--inputDistanceMatrix"], device="cpu")


# ---- the daemon against JAX spool clients -----------------------------------

def _swap_fixture(tmp_path):
    """A checkpoint + input .npy pair for a ``.swap.json`` file."""
    x, y = _base(64, seed=7)
    y = y.astype(np.float32)
    st = JState(y=jnp.asarray(y), update=jnp.zeros_like(jnp.asarray(y)),
                gains=jnp.ones_like(jnp.asarray(y)))
    model_path = str(tmp_path / "swap_model.npz")
    jckpt.save(model_path, st, 10, np.asarray([0.5]))
    input_path = str(tmp_path / "swap_x.npy")
    np.save(input_path, x)
    return model_path, input_path


@pytest.mark.parametrize("sched", ["on", "off"])
def test_daemon_serves_a_jax_spool(tmp_path, sched):
    _, tm = _models("exact")
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    sizes = {"a": 5, "b": 16, "c": 40, "d": 1, "e": 23}
    reqs = {rid: _queries(rows, seed=i) for i, (rid, rows)
            in enumerate(sizes.items())}
    for rid, q in reqs.items():
        jdaemon.submit(spool, q, rid)
    jdaemon.submit(spool, reqs["a"], "pinned", model_id=tm.model_id)
    jdaemon.submit(spool, reqs["a"], "ghost", model_id="0123456789abcdef")
    jdaemon.submit(spool, np.zeros((3, D + 2)), "wide")
    d = tdaemon.ServeDaemon(tm, spool, bucket=16, iters=8, tick_s=0.001,
                            sched=sched, idle_exit_s=0.05)
    summary = d.serve_forever(max_ticks=40)
    assert summary["served"] == 6 and summary["failed"] == 2
    for rid, q in [*reqs.items(), ("pinned", reqs["a"])]:
        np.testing.assert_array_equal(jdaemon.read_result(spool, rid),
                                      transform(tm, q, bucket=16, iters=8))
    for rid, why in (("ghost", "not resident"), ("wide", "queries must")):
        with open(os.path.join(spool, rid + ".err.json")) as f:
            assert why in json.load(f)["error"]
    left = sorted(f for f in os.listdir(spool)
                  if not f.endswith((".res.npz", ".lat.json", ".err.json")))
    assert left == []  # no request, lock, epoch or tmp file left
    # then a swap file: the next request answers with the swapped model
    model_path, input_path = _swap_fixture(tmp_path)
    with open(os.path.join(spool, "m2.swap.json"), "w") as f:
        json.dump({"model": model_path, "input": input_path,
                   "perplexity": 4.0, "neighbors": 8,
                   "repulsion": "exact"}, f)
    jdaemon.submit(spool, reqs["b"], "after")
    d.serve_forever(max_ticks=20)
    with open(os.path.join(spool, "m2.swap.done.json")) as f:
        done = json.load(f)
    assert done["status"] == "ok" and done["action"] == "admit"
    assert d.active_id == done["model_id"] != tm.model_id
    with open(os.path.join(spool, "after.lat.json")) as f:
        assert json.load(f)["model_id"] == done["model_id"]
    np.testing.assert_array_equal(
        jdaemon.read_result(spool, "after"),
        transform(d.models[done["model_id"]], reqs["b"], bucket=16,
                  iters=8))


@pytest.mark.parametrize("sched", ["on", "off"])
def test_lat_json_keys_match_a_jax_daemon(tmp_path, sched):
    jm, tm = _models("exact", n=96)
    keys = []
    for name, daemon, model in (("j", jdaemon, jm), ("t", tdaemon, tm)):
        spool = str(tmp_path / name)
        os.makedirs(spool)
        jdaemon.submit(spool, _queries(10), "r")
        daemon.ServeDaemon(model, spool, bucket=16, iters=2, tick_s=0.001,
                           sched=sched).serve_forever(max_ticks=6)
        with open(os.path.join(spool, "r.lat.json")) as f:
            keys.append(sorted(json.load(f)))
    assert keys[0] == keys[1]


def test_daemon_refusals(tmp_path):
    _, tm = _models("exact", n=64)
    with pytest.raises(RuntimeError, match="serve admission"):
        tdaemon.ServeDaemon(tm, str(tmp_path), bucket=8, budget_bytes=1)
    with pytest.raises(ValueError, match="shed depth"):
        tdaemon.ServeDaemon(tm, str(tmp_path), shed_depth=-1)
    with pytest.raises(ValueError, match="spool"):
        tdaemon.ServeDaemon(tm, None)
    with pytest.raises(ValueError, match="request must be"):
        tdaemon.submit(str(tmp_path), np.zeros(4), "bad")
    d = tdaemon.ServeDaemon(tm, str(tmp_path), bucket=8, iters=2,
                            tick_s=0.001, idle_exit_s=0.01)
    summary = d.run()  # no max_ticks: returns by the idle exit
    assert summary["served"] == 0 and summary["p50_ms"] == 0.0
    assert summary["admission"]["budget_bytes"] is None  # the CPU
