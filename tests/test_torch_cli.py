"""The port's command line against the JAX package's.

* the parser: the same flags, defaults and choices as
  ``tsne_flink_tpu.utils.cli.build_parser``;
* ``pick_repulsion(backend="cpu")`` equals the JAX function over a grid of
  (mode, theta, explicit, n, m);
* ``--dtype bfloat16`` (mixed precision) runs on the exact and the
  project kNN with float32 state; the analysis flags (``--auditPlan``,
  ``--executionPlan``), the runtime and the observability flags run; ``auto`` with an explicit --theta past EXACT_N_MAX runs
  Barnes-Hut; --model and --transform (the serve route) go together, and
  a fat checkpoint serves query rows through them;
* on a 600-point COO file (bruteforce, project, and the kNN graph as
  ``--inputDistanceMatrix``) the port's final KL is within
  ``KL_GUARDRAIL_TOL`` = 0.05 of the JAX CLI's program's
  (``jax_cli_twin``: the JAX CLI's mesh path does not trace under jax
  0.9, ROADMAP §C);
* the output is ``tsne_embed``'s y bit for bit (f32);
* a warm ``--cacheDir`` rerun runs no kNN and writes the same bytes.
"""

import argparse

import numpy as np
import pytest
import torch

import jax_cli_twin as twin
from tsne_flink_tpu.models.autopilot import KL_GUARDRAIL_TOL
from tsne_flink_tpu.utils import cli as jcli
from tsne_flink_tpu_torch import TsneConfig, tsne_embed
from tsne_flink_tpu_torch.utils import cli as tcli

pytestmark = pytest.mark.fast

N, D, PERPLEXITY = 600, 8, 8.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Test workers share the host; many small ops run far slower with
    contending intra-op thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 10.0, (12, d))
    return centers[rng.integers(0, 12, n)] + rng.normal(0.0, 0.5, (n, d))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The COO file of the blobs and their exact kNN graph as i,j,dist."""
    tmp = tmp_path_factory.mktemp("cli")
    x = _blobs()
    coo = tmp / "in.csv"
    with open(coo, "w") as f:
        for i in range(N):
            for j in range(D):
                f.write(f"{i},{j},{float(x[i, j])!r}\n")
    k = 3 * int(PERPLEXITY)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1, kind="stable")[:, :k]
    dm = tmp / "knn.csv"
    with open(dm, "w") as f:
        for i in range(N):
            for j in nn[i]:
                f.write(f"{i},{j},{float(d2[i, j])!r}\n")
    return {"coo": str(coo), "knn": str(dm), "x": x, "tmp": tmp}


def _actions(parser):
    return {a.dest if not a.option_strings else a.option_strings[0]:
            (tuple(a.option_strings), a.dest, a.default,
             None if a.choices is None else tuple(a.choices), a.required,
             a.nargs, a.const, a.type, type(a).__name__)
            for a in parser._actions if not isinstance(a,
                                                       argparse._HelpAction)}


def test_parser_matches_jax():
    port, ref = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert sorted(port) == sorted(ref)
    for flag in ref:
        assert port[flag] == ref[flag], flag


@pytest.mark.parametrize("mode", ["auto", "exact", "fft", "bh"])
def test_pick_repulsion_cpu_matches_jax(mode):
    for theta in (0.0, 0.25, 0.5):
        for explicit in (False, True):
            for n in (100, 32_768, 32_769, 99_999, 2_000_000):
                for m in (1, 2, 3, 4):
                    assert (tcli.pick_repulsion(mode, theta, n, m, explicit,
                                                backend="cpu")
                            == jcli.pick_repulsion(mode, theta, n, m,
                                                   explicit, backend="cpu"))


def test_pick_repulsion_cuda():
    top = tcli.EXACT_N_MAX["cuda"]
    assert tcli.pick_repulsion("auto", 0.5, 60_000, 2, True) == "exact"
    assert tcli.pick_repulsion("auto", 0.25, top, 2) == "exact"
    assert tcli.pick_repulsion("auto", 0.25, top + 1, 2) == "fft"
    assert tcli.pick_repulsion("auto", 0.5, top + 1, 2, True) == "bh"
    # m = 3: a defaulted theta stays exact up to the card's measured
    # exact/Barnes-Hut crossover; an explicit theta takes Barnes-Hut
    top3 = tcli.EXACT_3D_N_MAX["cuda"]
    assert tcli.pick_repulsion("auto", 0.25, top + 1, 3) == "exact"
    assert tcli.pick_repulsion("auto", 0.25, top3, 3) == "exact"
    assert tcli.pick_repulsion("auto", 0.25, top3 + 1, 3) == "bh"
    assert tcli.pick_repulsion("auto", 0.25, top + 1, 3, True) == "bh"
    assert tcli.pick_repulsion("auto", 0.0, 10 * top, 2, True) == "exact"
    assert tcli.pick_repulsion("auto", 0.25, 10 * top, 5) == "exact"


@pytest.mark.parametrize("method", ["bruteforce", "project"])
def test_dtype_bfloat16_runs_with_float32_state(files, tmp_path,
                                                monkeypatch, method):
    """``--dtype bfloat16`` runs (it was refused before the port had B1's
    bf16 form): the embedding it writes is float32."""
    from tsne_flink_tpu_torch.utils import io as tio
    written = {}
    real = tio.write_embedding

    def keep(path, ids, y):
        written["y"] = y
        real(path, ids, y)

    monkeypatch.setattr(tio, "write_embedding", keep)
    out = tmp_path / "o.csv"
    argv = ["--input", str(files["coo"]), "--output", str(out),
            "--dimension", str(D), "--knnMethod", method, "--perplexity",
            str(PERPLEXITY), "--iterations", "30", "--noCache", "--loss",
            str(tmp_path / "loss.txt"), "--dtype", "bfloat16"]
    assert tcli.main(argv, device="cpu") == 0
    assert written["y"].dtype == np.float32 and written["y"].shape == (N, 2)
    rows = np.loadtxt(out, delimiter=",", ndmin=2)
    assert rows.shape == (N, 3) and np.isfinite(rows).all()


#: the analysis flags (ported, queue A16): each runs, and before the kNN
#: stage on the plan it refuses (the JAX CLI's messages)
ANALYSIS_FLAGS = [["--auditPlan"], ["--executionPlan"]]


@pytest.mark.parametrize("extra", ANALYSIS_FLAGS,
                         ids=[" ".join(e) for e in ANALYSIS_FLAGS])
def test_analysis_flags_run(files, tmp_path, monkeypatch, capsys, extra):
    monkeypatch.chdir(tmp_path)
    argv = ["--input", str(files["coo"]), "--output", str(tmp_path / "o.csv"),
            "--dimension", str(D), "--knnMethod", "bruteforce",
            "--perplexity", str(PERPLEXITY), "--iterations", "30",
            "--noCache", "--loss", str(tmp_path / "loss.txt"), *extra]
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    if extra == ["--auditPlan"]:
        assert "# auditPlan: peak HBM est" in out
        assert (tmp_path / "o.csv").exists()
    else:
        assert "execution plan written to tsne_executionPlan.json" in out
        assert (tmp_path / "tsne_executionPlan.json").exists()
        assert not (tmp_path / "o.csv").exists()
        with pytest.raises(SystemExit, match="does not lower an execution"):
            tcli.main(argv + ["--affinityAssembly", "blocks"], device="cpu")


#: misuses of the multi-host flags, each refused by the parser (exit code
#: 2) with the JAX CLI's message, before the input is read
MULTIHOST_MISUSE = [
    (["--spmd", "--coordinator", "h:1", "--numProcesses", "2"], "together"),
    (["--coordinator", "h:1", "--numProcesses", "2", "--processId", "0"],
     "require --spmd"),
    (["--spmd", "--coordinator", "h:1", "--numProcesses", "1",
      "--processId", "0"], "must be >= 2"),
]


@pytest.mark.parametrize("extra,msg", MULTIHOST_MISUSE,
                         ids=["all-or-none", "needs-spmd", "two-or-more"])
def test_multihost_flags_checked_before_the_input_is_read(tmp_path, capsys,
                                                          extra, msg):
    argv = ["--input", str(tmp_path / "missing.csv"), "--output",
            str(tmp_path / "o.csv"), "--dimension", "4", "--knnMethod",
            "bruteforce", *extra]
    with pytest.raises(SystemExit) as e:
        tcli.main(argv, device="cpu")
    assert e.value.code == 2 and msg in capsys.readouterr().err
    assert not (tmp_path / "o.csv").exists()


#: the symmetrization flags (ported): a single-controller run takes them
#: and ignores them, as the JAX CLI does (they shape multi-controller
#: jobs: tests/test_torch_multiprocess.py)
SYM_FLAGS = [["--symWidth", "64"], ["--symMode", "alltoall"],
             ["--symSlack", "4"], ["--symStrict"]]


@pytest.mark.parametrize("extra", SYM_FLAGS,
                         ids=[" ".join(e) for e in SYM_FLAGS])
def test_sym_flags_run(tmp_path, files, extra):
    outs = []
    for flags in ([], extra):
        out = tmp_path / f"o{len(outs)}.csv"
        argv = ["--input", str(files["coo"]), "--output", str(out),
                "--dimension", str(D), "--knnMethod", "bruteforce",
                "--perplexity", str(PERPLEXITY), "--iterations", "20",
                "--noCache", "--loss", str(tmp_path / "loss.txt"), *flags]
        assert tcli.main(argv, device="cpu") == 0
        outs.append(np.loadtxt(out, delimiter=","))
    np.testing.assert_array_equal(outs[0], outs[1])


#: the mesh flags (the single-controller mesh is ported): each runs the
#: optimize stage on a point mesh of CPU shards
MESH_FLAGS = [["--mesh", "1"], ["--devices", "1"], ["--spmd"],
              ["--mesh", "2", "--meshReduce", "psum"]]


@pytest.mark.parametrize("extra", MESH_FLAGS,
                         ids=[" ".join(e) for e in MESH_FLAGS])
def test_mesh_flags_run(tmp_path, files, capsys, monkeypatch, extra):
    from tsne_flink_tpu_torch.parallel import mesh as tmesh
    widths = []
    real = tmesh.ShardedOptimizer.shard_inputs

    def shard_inputs(self, *a, **kw):
        widths.append((self.n_devices, self.mesh_reduce))
        return real(self, *a, **kw)

    monkeypatch.setattr(tmesh.ShardedOptimizer, "shard_inputs",
                        shard_inputs)
    out = tmp_path / "o.csv"
    argv = ["--input", str(files["coo"]), "--output", str(out),
            "--dimension", str(D), "--knnMethod", "bruteforce",
            "--perplexity", str(PERPLEXITY), "--iterations", "20",
            "--noCache", "--loss", str(tmp_path / "loss.txt"), *extra]
    assert tcli.main(argv, device="cpu") == 0
    y = np.loadtxt(out, delimiter=",", ndmin=2)
    assert y.shape == (N, 3) and np.isfinite(y).all()
    want = (2, "psum") if "psum" in extra else (1, "canonical")
    assert widths == [want]
    assert ("deprecated" in capsys.readouterr().err) == ("--spmd" in extra)


#: the runtime and observability flags (ported): each runs, and the
#: file or record it promises appears
RUNTIME_FLAGS = [
    (["--trace", "{tmp}/t.json"], "t.json"),
    (["--metricsOut", "{tmp}/m.json"], "m.json"),
    (["--faultPlan", "oom@knn"], "events"),
    (["--jobTimeout", "3600"], None), (["--stageTimeout", "3600"], None),
    (["--aotCache"], None), (["--noAotCache"], None),
    (["--profile", "{tmp}/prof"], "prof"),
]


@pytest.mark.parametrize("extra,made", RUNTIME_FLAGS,
                         ids=[e[0] for e, _ in RUNTIME_FLAGS])
def test_runtime_flags_run(tmp_path, files, capsys, extra, made):
    out = tmp_path / "o.csv"
    argv = ["--input", str(files["coo"]), "--output", str(out),
            "--dimension", str(D), "--knnMethod", "bruteforce",
            "--perplexity", str(PERPLEXITY), "--iterations", "20",
            "--noCache", "--loss", str(tmp_path / "loss.txt"),
            *[a.format(tmp=tmp_path) for a in extra]]
    assert tcli.main(argv, device="cpu") == 0
    assert out.exists()
    err = capsys.readouterr().err
    if made == "events":
        assert "# runtime event:" in err and "shrink-knn-tiles" in err
    elif made is not None:
        assert (tmp_path / made).exists()


@pytest.mark.parametrize("extra", [["--model", "m.npz"],
                                   ["--transform", "q.csv"]],
                         ids=["--model alone", "--transform alone"])
def test_model_and_transform_go_together(tmp_path, extra):
    """--model/--transform is the serve route (A13 is ported); either
    flag alone is a usage error before the input is read."""
    argv = ["--input", str(tmp_path / "missing.csv"), "--output",
            str(tmp_path / "o.csv"), "--dimension", "4", "--knnMethod",
            "bruteforce", *extra]
    with pytest.raises(SystemExit):
        tcli.main(argv, device="cpu")
    assert not (tmp_path / "o.csv").exists()


def test_fat_checkpoint_served_through_the_transform_route(files, tmp_path,
                                                           capsys):
    """Fit with --fatCheckpoint, then embed rows through --model/
    --transform: the base rows land near their own fitted coordinates,
    the rows equal ``serve/transform.transform`` of the same model, and
    the checkpoint's bytes are unchanged."""
    from tsne_flink_tpu_torch.serve.model import PlanConfig, load_frozen
    from tsne_flink_tpu_torch.serve.transform import transform

    ckpt = str(tmp_path / "model.npz")
    fit = tmp_path / "fit.csv"
    tcli.main(_argv(files, fit, "bruteforce", iterations=150)
              + ["--checkpoint", ckpt, "--fatCheckpoint"], device="cpu")
    before = open(ckpt, "rb").read()
    rows = np.arange(0, N, 37)
    qcsv = tmp_path / "q.csv"
    with open(qcsv, "w") as f:
        for a, i in enumerate(rows):
            for j in range(D):
                f.write(f"{a},{j},{float(files['x'][i, j])!r}\n")
    out = tmp_path / "q_out.csv"
    capsys.readouterr()
    assert tcli.main(["--input", files["coo"], "--model", ckpt,
                      "--transform", str(qcsv), "--output", str(out),
                      "--dimension", str(D), "--knnMethod", "bruteforce",
                      "--perplexity", str(PERPLEXITY)], device="cpu") == 0
    assert "transformed 17 rows into frozen map" in capsys.readouterr().out
    assert open(ckpt, "rb").read() == before
    ids, yq = _read(out)
    np.testing.assert_array_equal(ids, np.arange(len(rows)))
    model = load_frozen(ckpt, files["x"], PlanConfig(
        n=N, d=D, k=3 * int(PERPLEXITY), backend="cpu"),
        perplexity=PERPLEXITY, device="cpu")
    np.testing.assert_array_equal(yq, transform(model, files["x"][rows]))
    _, y_fit = _read(fit)
    span = np.ptp(y_fit, axis=0).max()
    assert np.median(np.linalg.norm(yq - y_fit[rows], axis=1)) < 0.05 * span


def test_accepted_runtime_flags_change_nothing(files, tmp_path):
    """--onOom/--maxRetries are accepted (no supervisor yet: an OOM
    propagates) and give the same bytes."""
    outs = []
    for extra in ([], ["--onOom", "fail", "--maxRetries", "0"]):
        out = tmp_path / f"o{len(outs)}.csv"
        tcli.main(_argv(files, out, "bruteforce", iterations=30) + extra,
                  device="cpu")
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_auto_bh_refused_before_knn(files, tmp_path, monkeypatch):
    """``auto`` with an explicit --theta past EXACT_N_MAX runs Barnes-Hut
    at that theta (A12 is ported; nothing is refused any more)."""
    from tsne_flink_tpu_torch.ops import repulsion_bh
    monkeypatch.setattr(tcli, "EXACT_N_MAX", {"cpu": 100})
    thetas = []
    real = repulsion_bh.bh_repulsion

    def counted(*a, **k):
        thetas.append(k["theta"])
        return real(*a, **k)

    monkeypatch.setattr(repulsion_bh, "bh_repulsion", counted)
    out = tmp_path / "o.csv"
    tcli.main(_argv(files, out, "bruteforce", iterations=10)
              + ["--theta", "0.5"], device="cpu")
    assert thetas == [0.5] * 10 and out.exists()


def _argv(files, out, method, iterations=300, source="coo"):
    argv = ["--input", files[source], "--output", str(out), "--dimension",
            str(D), "--knnMethod", method, "--perplexity", str(PERPLEXITY),
            "--iterations", str(iterations), "--randomState", "0",
            "--loss", str(out) + ".loss", "--noCache"]
    return argv + (["--inputDistanceMatrix"] if source == "knn" else [])


def _read(out):
    rows = np.loadtxt(out, delimiter=",", ndmin=2)
    return rows[:, 0], rows[:, 1:]


@pytest.mark.parametrize("method,source", [("bruteforce", "coo"),
                                           ("project", "coo"),
                                           ("bruteforce", "knn")])
def test_final_kl_within_guardrail_of_jax(files, tmp_path, method, source):
    out = tmp_path / "o.csv"
    assert tcli.main(_argv(files, out, method, source=source),
                     device="cpu") == 0
    ids, y = _read(out)
    np.testing.assert_array_equal(ids, np.arange(N))
    assert np.isfinite(y).all()
    loss = np.loadtxt(str(out) + ".loss", delimiter=",")
    np.testing.assert_array_equal(loss[:, 0], np.arange(10, 310, 10))
    _, loss_j = twin.embed_file(files[source], D, knn_method=method,
                                perplexity=PERPLEXITY,
                                distance_matrix=source == "knn")
    assert abs(loss[-1, 1] - float(loss_j[-1])) <= KL_GUARDRAIL_TOL
    assert loss[-1, 1] < loss[10, 1]  # fell after the exaggeration


@pytest.mark.parametrize("method", ["bruteforce", "project"])
def test_output_is_tsne_embed_bit_for_bit(files, tmp_path, method):
    out = tmp_path / "o.csv"
    tcli.main(_argv(files, out, method, iterations=120), device="cpu")
    _, y_cli = _read(out)
    y, losses = tsne_embed(files["x"].astype(np.float32),
                           TsneConfig(perplexity=PERPLEXITY, iterations=120),
                           knn_method=method, seed=0, device="cpu")
    np.testing.assert_array_equal(y_cli.astype(np.float32), y.numpy())
    loss = np.loadtxt(str(out) + ".loss", delimiter=",")
    np.testing.assert_array_equal(loss[:, 1].astype(np.float32),
                                  losses.numpy())


def test_warm_cache_rerun_bit_identical_and_skips_knn(files, tmp_path,
                                                      monkeypatch, capsys):
    cache = str(tmp_path / "cache")
    argv = [a for a in _argv(files, tmp_path / "cold.csv", "project",
                             iterations=60) if a != "--noCache"]
    tcli.main(argv + ["--cacheDir", cache], device="cpu")
    assert "knn" in capsys.readouterr().err

    def boom(*a, **k):
        raise AssertionError("the kNN stage ran on a warm cache")

    from tsne_flink_tpu_torch.ops import knn as tknn
    monkeypatch.setattr(tknn, "knn", boom)
    warm = [a if a != str(tmp_path / "cold.csv") else
            str(tmp_path / "warm.csv") for a in argv]
    tcli.main(warm + ["--cacheDir", cache], device="cpu")
    err = capsys.readouterr().err
    assert "(warm)" in err and "(cold)" not in err
    assert ((tmp_path / "cold.csv").read_bytes()
            == (tmp_path / "warm.csv").read_bytes())
