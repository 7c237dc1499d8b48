"""PyTorch port, embeddings wider than 8 against the JAX package.

On the card B2-B5 take m = 1 .. 8 in their register-held instances and
every wider m in their wide forms (``KERNELS["B2w"]`` .. ``["B5w_f64"]``).
Here, on the same seeded numpy inputs, the port's plain versions at m =
9, 16, 50 and 100 are held to the JAX package's XLA path
(``exact_repulsion``, the attraction functions with ``kernel="xla"``,
the edge forces and loss): float32 rtol 2e-5 (the fused step rtol 1e-4,
its gains equal), float64 at the golden ±1e-9; ``tsne_embed`` at m = 12
in float64 from the JAX init (±1e-9 after one iteration, the final KL
within the guardrail after a short run), the CLI at ``--nComponents 12``
against the JAX CLI's program, the transform at m = 12 (rtol 1e-9) and
the thread mesh at D = 2 and 4 (D = 1's bits).  The approximations take
m = 2 or 3 only: ``auto`` resolves a wide m to exact, and an explicit
``bh`` or ``fft`` fails as the JAX package fails.  The memory model
charges the wide form's partials slab, the split rule keeps a shard's
bits, and the recorder names the wide forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_cli_twin as twin
from tsne_flink_tpu.analysis.audit.plan import PlanConfig as JPlan
from tsne_flink_tpu.models import tsne as jtsne
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu.ops import attraction_pallas as jatt
from tsne_flink_tpu.ops.repulsion_exact import exact_repulsion as jexact
from tsne_flink_tpu.serve.model import from_arrays as jfrom_arrays
from tsne_flink_tpu.serve.transform import transform as jtransform
from tsne_flink_tpu.utils import cli as jcli
from tsne_flink_tpu_torch import TSNE, TsneConfig, convert, tsne_embed
from tsne_flink_tpu_torch.analysis.audit import hbm as thbm
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
from tsne_flink_tpu_torch.models import tsne as ttsne
from tsne_flink_tpu_torch.ops import attraction_cuda as tatt
from tsne_flink_tpu_torch.ops import repulsion_cuda as trc
from tsne_flink_tpu_torch.serve.model import from_arrays
from tsne_flink_tpu_torch.serve.transform import transform
from tsne_flink_tpu_torch.utils import cli as tcli

pytestmark = pytest.mark.fast

WIDE = [9, 16, 50, 100]
#: the stated bars: float32 kernels, the fused step, float64 (golden)
RTOL32, RTOL_STEP, RTOL64 = 2e-5, 1e-4, 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _blobs(n, d, clusters=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (clusters, d))
    return centers[rng.integers(0, clusters, n)] + rng.normal(size=(n, d))


# ---- B2-B5's plain versions at m > 8 against the JAX XLA path ----------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", WIDE)
def test_repulsion_matches_jax_past_8(m, dtype):
    """B2's plain version (what the wrapper runs on a CPU tensor) against
    the JAX ``exact_repulsion``: all rows, and a row shard with a column
    mask and per-row Z."""
    rng = np.random.default_rng(m)
    n = 260
    y = (3.0 * rng.standard_normal((n, m))).astype(dtype)
    rtol = RTOL32 if dtype == "float32" else RTOL64
    rep0, z0 = jexact(jnp.asarray(y), row_chunk=64)
    rep1, z1 = trc.cuda_exact_repulsion(_t(y), row_chunk=48)
    _close(rep1.numpy(), rep0, rtol)
    _close(float(z1), float(z0), rtol)
    valid = np.arange(n) % 11 != 3
    want = jexact(jnp.asarray(y[100:200]), jnp.asarray(y), row_offset=100,
                  col_valid=jnp.asarray(valid), row_chunk=64, row_z=True)
    got = trc.cuda_exact_repulsion(_t(y[100:200]), _t(y), row_offset=100,
                                   col_valid=_t(valid), row_z=True,
                                   row_chunk=48)
    for a, b in zip(got, want):
        _close(a.numpy(), b, rtol)


def _csr_problem(m, dtype, seed=4, n=150, w=16):
    """A CSR head [n, w] (20% padding), a src-sorted tail (row 0 a hub of
    40 edges, the others 0-3) and the step's planes (Z = 37.5)."""
    rng = np.random.default_rng(seed + m)
    y = rng.standard_normal((n, m)).astype(dtype)
    hidx = rng.integers(0, n, (n, w)).astype(np.int32)
    hval = (rng.random((n, w)) * 1e-3).astype(dtype)
    hval[rng.random((n, w)) < 0.2] = 0.0
    deg = rng.integers(0, 4, n)
    deg[0] = 40
    tsrc = np.repeat(np.arange(n), deg).astype(np.int32)
    tdst = rng.integers(0, n, tsrc.shape[0]).astype(np.int32)
    tval = (rng.random(tsrc.shape[0]) * 1e-3).astype(dtype)
    rep = (37.5e-3 * rng.standard_normal((n, m))).astype(dtype)
    upd = (1e-2 * rng.standard_normal((n, m))).astype(dtype)
    gains = (1.0 + rng.random((n, m))).astype(dtype)
    return y, hidx, hval, (tsrc, tdst, tval), rep, upd, gains


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m", WIDE)
def test_attraction_matches_jax_xla_past_8(m, dtype):
    """B3 (the CSR step over head + tail, with a padded-row mask), B4 and
    B5 (over the head, and over head + tail in one call) against the JAX
    package's XLA twins and its edge forces and loss."""
    y, hidx, hval, tail, rep, upd, gains = _csr_problem(m, dtype)
    n = y.shape[0]
    valid = np.arange(n) < 140
    j = jnp.asarray
    s = j(np.asarray(4.0, dtype))
    f32 = dtype == "float32"
    rtol, rtol_step = (RTOL32, RTOL_STEP) if f32 else (RTOL64, RTOL64)
    tail_att = jtsne._edge_forces(j(y), j(y), *map(j, tail), s)
    want = jatt.fused_step_update(
        j(y), j(y), j(hidx), j(hval), s, tail_att,
        j(rep) / j(np.asarray(37.5, dtype)), j(valid), j(upd), j(gains),
        j(np.asarray(0.8, dtype)), eta=1000.0, min_gain=0.01, row_chunk=64,
        kernel="xla")
    rag = tatt.ragged_edges(*map(_t, tail), n)
    got = tatt.fused_step_update(
        _t(y), _t(y), _t(hidx), _t(hval), 4.0, _t(rep),
        torch.tensor(37.5, dtype=getattr(torch, dtype)), _t(valid), _t(upd),
        _t(gains), 0.8, eta=1000.0, min_gain=0.01, ragged=rag, row_chunk=48)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[:2], want[:2]):
        _close(a.numpy(), b, rtol_step)
    z = j(np.asarray(2.5e3, dtype))
    zt = torch.tensor(2.5e3, dtype=getattr(torch, dtype))
    lw = np.asarray(jatt.attraction_loss(j(y), j(y), j(hidx), j(hval),
                                         j(np.asarray(1.0, dtype)), z,
                                         row_chunk=64, kernel="xla"))
    lg = tatt.attraction_loss(_t(y), _t(y), _t(hidx), _t(hval), 1.0, zt,
                              row_chunk=48).numpy()
    _close(lg, lw, rtol)
    lw_rag = lw + np.asarray(jtsne._edge_loss(
        j(y), j(y), *map(j, tail), j(np.asarray(1.0, dtype)), z))
    lg_rag = tatt.attraction_loss(_t(y), _t(y), _t(hidx), _t(hval), 1.0, zt,
                                  ragged=rag).numpy()
    _close(lg_rag, lw_rag, rtol)
    fw = np.asarray(jatt.attraction_forces(j(y), j(y), j(hidx), j(hval), s,
                                           row_chunk=64, kernel="xla"))
    fg = tatt.attraction_forces(_t(y), _t(y), _t(hidx), _t(hval), 4.0,
                                row_chunk=48).numpy()
    _close(fg, fw, rtol)
    fg_rag = tatt.attraction_forces(_t(y), _t(y), _t(hidx), _t(hval), 4.0,
                                    ragged=rag).numpy()
    _close(fg_rag, fw + np.asarray(tail_att), rtol)


# ---- the slice at m = 12 --------------------------------------------------

N_EMBED, K_EMBED, PERP_EMBED, M_EMBED = 600, 8, 8.0, 12


@pytest.fixture(scope="module")
def embed_problem():
    x = _blobs(N_EMBED, 8, clusters=12)
    _, ikey = jax.random.split(jax.random.key(0))
    y0 = np.asarray(jtsne.init_working_set(ikey, N_EMBED, M_EMBED,
                                           jnp.float64).y)
    return x, y0


@pytest.mark.parametrize("iterations", [1, 120])
def test_embed_at_m12_matches_jax(embed_problem, iterations):
    """``tsne_embed`` at n_components 12 in float64, from the JAX run's
    initial y: ±1e-9 after one iteration; a short run ends within
    KL_GUARDRAIL_TOL of the JAX run's final KL."""
    x, y0 = embed_problem
    cfg = jtsne.TsneConfig(n_components=M_EMBED, perplexity=PERP_EMBED,
                           iterations=iterations, row_chunk=64)
    y_j, loss_j = jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=K_EMBED,
                                   seed=0)
    y_t, loss_t = ttsne.tsne_embed(x, convert.config_from_jax(cfg),
                                   neighbors=K_EMBED, device="cpu", y0=y0)
    assert tuple(y_t.shape) == (N_EMBED, M_EMBED)
    assert bool(torch.isfinite(y_t).all())
    if iterations == 1:
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                                   atol=1e-9)
    else:
        loss_j = np.asarray(loss_j)
        assert abs(float(loss_t[-1]) - float(loss_j[-1])) <= \
            KL_GUARDRAIL_TOL
        assert float(loss_t[-1]) < float(loss_t[10])


@pytest.mark.parametrize("m", [0, 9, 16, 100])
def test_every_width_runs_through_each_route(m, tmp_path):
    """``tsne_embed``, the estimator and the CLI (``--nComponents m``)
    run every n_components >= 1 to a finite embedding at float32 and
    float64; 0 is refused when the config is built, before the kNN
    stage."""
    x = _blobs(90, 6, seed=m)
    if m == 0:
        with pytest.raises(ValueError, match="n_components"):
            TsneConfig(n_components=0)
        with pytest.raises(ValueError, match="n_components"):
            TSNE(n_components=0, device="cpu").fit(x)
        return
    coo = tmp_path / "in.csv"
    _coo(coo, x)
    for dtype in ("float32", "float64"):
        y, losses = tsne_embed(x.astype(dtype),
                               TsneConfig(n_components=m, perplexity=5.0,
                                          iterations=20), device="cpu")
        assert tuple(y.shape) == (90, m) and bool(torch.isfinite(y).all())
        assert y.dtype == getattr(torch, dtype)
        est = TSNE(n_components=m, perplexity=5.0, n_iter=20, device="cpu",
                   dtype=dtype).fit(x)
        assert est.embedding_.shape == (90, m)
        assert np.isfinite(est.embedding_).all()
        out = tmp_path / f"o_{dtype}.csv"
        assert tcli.main(["--input", str(coo), "--output", str(out),
                          "--dimension", "6", "--knnMethod", "bruteforce",
                          "--perplexity", "5", "--nComponents", str(m),
                          "--iterations", "20", "--dtype", dtype,
                          "--noCache"], device="cpu") == 0
        rows = np.loadtxt(out, delimiter=",", ndmin=2)
        assert rows.shape == (90, m + 1) and np.isfinite(rows).all()


def _coo(path, x):
    with open(path, "w") as f:
        f.writelines(f"{i},{j},{float(x[i, j])!r}\n"
                     for i in range(x.shape[0]) for j in range(x.shape[1]))


def test_cli_at_n_components_12_matches_the_jax_cli(tmp_path):
    """The port's CLI at ``--nComponents 12`` against the JAX CLI's
    program (``tests/jax_cli_twin.py``): the 12 columns written, finite,
    the final KL within KL_GUARDRAIL_TOL; ``auto`` resolved to exact on
    both sides."""
    x = _blobs(400, 8, clusters=10, seed=3)
    coo = tmp_path / "in.csv"
    _coo(coo, x)
    out = tmp_path / "o.csv"
    assert tcli.main(["--input", str(coo), "--output", str(out),
                      "--dimension", "8", "--knnMethod", "bruteforce",
                      "--perplexity", "8", "--nComponents", "12",
                      "--iterations", "150", "--noCache", "--loss",
                      str(out) + ".loss"], device="cpu") == 0
    rows = np.loadtxt(out, delimiter=",", ndmin=2)
    assert rows.shape == (400, 13) and np.isfinite(rows).all()
    loss = np.loadtxt(str(out) + ".loss", delimiter=",")
    _, loss_j = twin.embed_file(str(coo), 8, knn_method="bruteforce",
                                perplexity=8.0, iterations=150,
                                n_components=12)
    assert abs(loss[-1, 1] - float(loss_j[-1])) <= KL_GUARDRAIL_TOL


@pytest.mark.parametrize("n", [400, 200_000])
@pytest.mark.parametrize("theta", [0.0, 0.5])
def test_a_wide_width_resolves_to_exact_as_in_jax(n, theta):
    for explicit in (False, True):
        for backend in ("cpu", "cuda"):
            got = tcli.pick_repulsion("auto", theta, n, 12, explicit,
                                      backend=backend)
            assert got == "exact"
        assert jcli.pick_repulsion("auto", theta, n, 12, explicit) == \
            "exact"


@pytest.mark.parametrize("repulsion", ["bh", "fft"])
def test_an_explicit_approximation_past_3_fails_as_in_jax(repulsion):
    """``--repulsion bh|fft`` at m = 12: both packages raise the same
    ValueError at the first iteration."""
    x = _blobs(120, 6, seed=5)
    cfg = jtsne.TsneConfig(n_components=12, perplexity=5.0, iterations=10,
                           repulsion=repulsion)
    with pytest.raises(ValueError, match="2 or 3 components") as jerr:
        jtsne.tsne_embed(jnp.asarray(x), cfg, neighbors=15, seed=0)
    with pytest.raises(ValueError, match="2 or 3 components") as terr:
        tsne_embed(x, convert.config_from_jax(cfg), neighbors=15,
                   device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_transform_at_m12_matches_jax():
    """A frozen m = 12 model (exact serving) transforms new rows as the
    JAX package's does, float64 rtol 1e-9 over its 75 iterations."""
    rng = np.random.default_rng(0)
    n, d, k = 300, 6, 12
    x = rng.standard_normal((n, d))
    y = 3.0 * rng.standard_normal((n, M_EMBED))
    kw = dict(n=n, d=d, k=k, backend="cpu", repulsion="exact",
              n_components=M_EMBED, name="serve-test")
    jm = jfrom_arrays(x, y, JPlan(**kw), perplexity=4.0, learning_rate=100.0)
    tm = from_arrays(x, y, PlanConfig(**kw), perplexity=4.0,
                     learning_rate=100.0, device="cpu")
    q = rng.standard_normal((40, d))
    q[-6:] *= 6.0
    want = jtransform(jm, q, bucket=16)
    got = transform(tm, q, bucket=16)
    assert got.shape == (40, M_EMBED) and got.dtype == np.float64
    _close(got, want, RTOL64)
    # one bucket of 32 and two of 16: the same bits
    np.testing.assert_array_equal(transform(tm, q[:32], bucket=32),
                                  transform(tm, q[:32], bucket=16))


def test_thread_mesh_at_m12_gives_mesh_1_bits():
    x = _blobs(90, 6, seed=7)
    kw = dict(n_components=M_EMBED, perplexity=5.0, n_iter=40,
              random_state=4, knn_method="bruteforce", repulsion="exact",
              device="cpu", dtype="float64")
    y1 = TSNE(mesh=1, **kw).fit_transform(x)
    assert y1.shape == (90, M_EMBED) and np.isfinite(y1).all()
    for d in (2, 4):
        np.testing.assert_array_equal(TSNE(mesh=d, **kw).fit_transform(x),
                                      y1)


# ---- the wide forms' bookkeeping ---------------------------------------------

@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("m", [9, 16, 17, 64, 256])
def test_wide_column_splits_fill_the_card_and_cover_the_columns(sms, m):
    """Past M_NARROW the split count follows the wide form's blocks
    (float64: 128 rows of one thread each at m <= 16, tiles of 32 rows
    past it; float32: tiles of 4,096 pairs, 4,096 / the width class rows),
    all dims at once, never narrower than a tile; a function of (rows,
    columns, SMs, m, dtype) alone.  B3w / B5w run a force chunk per 256
    dims at float32, per 128 at float64."""
    cls = 16 if m <= 16 else 32 if m <= 32 else 64
    cls64 = 16 if m <= 16 else 64
    assert trc.wide_class(m) == cls and trc.wide_class64(m) == cls64
    for f64 in (False, True):
        c = trc.wide_chunk(m, f64)
        assert c == (cls64 if f64 else cls)
        rows = trc.wide_rows(m, f64)
        assert rows == ((128 if m <= 16 else 32) if f64 else 4096 // cls)
        per_sm = (4 if m <= 16 else 3) if f64 else 4 if m <= 16 else 2
        for nloc, nfull in ((60_000, 60_000), (256, 60_000), (7, 7),
                            (30_000, 60_000)):
            s = trc.column_splits(nloc, nfull, sms, m, f64)
            blocks = -(-nloc // rows)
            assert 1 <= s <= max(1, -(-nfull // trc.COLS_PER_TILE))
            if s > 1:
                assert (s - 1) * blocks < 2 * sms * per_sm
    # m <= 8 keeps the narrow rule
    assert trc.column_splits(60_000, 60_000, 132, 8, False) == \
        trc.column_splits(60_000, 60_000, 132, 2, False) == 36
    assert tatt.wide_chunks(256, False) == 1 and \
        tatt.wide_chunks(257, False) == 2
    assert tatt.wide_chunks(128, True) == 1 and \
        tatt.wide_chunks(129, True) == 2


@pytest.mark.parametrize("dtype,isz", [("float32", 4), ("float64", 8)])
@pytest.mark.parametrize("m", [2, 16, 64, 256])
def test_memory_model_charges_the_wide_partials(m, dtype, isz):
    """The optimize stage's ``repulsion_tile`` on the card is the slab B2
    (or B2w past m = 8) allocates: splits x rows rounded to 4 x (m + 1)
    x the value's bytes, the splits by ``column_splits`` at the width."""
    n = 60_001
    got = thbm.stage_terms(PlanConfig(n=n, d=784, k=90, backend="cuda",
                                      n_components=m, dtype=dtype))
    s = trc.column_splits(n, n, thbm.CARD_SMS, m, isz == 8)
    want = s * 60_004 * (m + 1) * isz
    assert got["optimize"]["repulsion_tile"] == want
    assert trc.partials_bytes(n, n, m, isz, thbm.CARD_SMS) == want


def test_recorder_names_the_wide_forms():
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    rng = np.random.default_rng(0)
    for dtype, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
        x = torch.as_tensor(rng.standard_normal((120, 6)), dtype=dtype)
        cfg = TsneConfig(n_components=12, perplexity=5.0, iterations=20,
                         repulsion="exact", attraction="csr")
        with Recorder() as rec:
            tsne_embed(x, cfg, neighbors=15, device="cpu")
        got = {e["plain_of"] for e in rec.events if "plain_of" in e}
        assert got == {"B1" + sfx, "B2w" + sfx, "B3w" + sfx, "B4w" + sfx}


def test_kernels_name_the_wide_forms():
    from tsne_flink_tpu_torch.kernels import build as kbuild
    assert kbuild.form_id("B2", False, 8) == "B2"
    assert kbuild.form_id("B2", True, 9) == "B2w_f64"
    assert kbuild.form_id("B3", False, 9) == "B3w"
    assert kbuild.form_id("B5", True, 2) == "B5_f64"
    assert kbuild.form_id("B1", True, 16) == "B1_f64"
    for base, symbol in (("B2", "repulsion"), ("B3", "fused_step"),
                         ("B4", "attraction_loss"),
                         ("B5", "attraction_forces")):
        for sfx, t in (("", "f32"), ("_f64", "f64")):
            k = kbuild.KERNELS[base + "w" + sfx]
            assert k.symbol == f"tsne_{symbol}_wide_{t}"
            assert kbuild.SIGNATURES[k.symbol] == \
                kbuild.SIGNATURES[f"tsne_{symbol}_{t}"]
    assert set(kbuild.launches()) >= {b + "w" + s for b in ("B2", "B3", "B4",
                                                            "B5")
                                      for s in ("", "_f64")}
