"""The port's checkpoints against the JAX package's (v2 format, f64).

* a port checkpoint loads in ``tsne_flink_tpu.utils.checkpoint.load`` and
  a JAX one in the port's, with equal arrays and the same content hash;
* a damaged file raises ``CheckpointCorrupt``; ``load_fallback`` takes
  the rotated ``<path>.1``;
* the port resumes a fat checkpoint that the JAX CLI's program wrote at
  iteration 50 and, 10 iterations on, ends within ±1e-9 of the JAX CLI's
  own resume (``jax_cli_twin``: the JAX CLI's mesh path does not trace
  under jax 0.9, ROADMAP §C);
* a port resume from a fat checkpoint runs no prepare work and equals the
  port's uninterrupted run bit for bit.
"""

import numpy as np
import pytest
import torch

import jax_cli_twin as twin
from tsne_flink_tpu.utils import checkpoint as jckpt
from tsne_flink_tpu_torch.models.tsne import TsneState
from tsne_flink_tpu_torch.utils import checkpoint as tckpt
from tsne_flink_tpu_torch.utils.cli import main as torch_main

pytestmark = pytest.mark.fast

N, D = 40, 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Test workers share the host; many small ops run far slower with
    contending intra-op thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _coo(path, n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)) * 4.0
    x = centers[rng.integers(0, 3, n)] + rng.normal(size=(n, d))
    with open(path, "w") as f:
        for i in range(n):
            for j in range(d):
                f.write(f"{i},{j},{float(x[i, j])!r}\n")


def _state(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, 2)).astype(dtype) for _ in range(3)]


def _hash(path):
    with np.load(path) as z:
        return str(z["content_hash"])


def test_port_checkpoint_loads_in_jax(tmp_path):
    y, upd, gains = _state(0)
    losses = np.arange(5, dtype=np.float64)
    jidx = np.arange(N * 4, dtype=np.int32).reshape(N, 4) % N
    jval = np.full((N, 4), 1.0 / (N * 4))
    path = str(tmp_path / "t.npz")
    tckpt.save(path, TsneState(torch.from_numpy(y), torch.from_numpy(upd),
                               torch.from_numpy(gains)), 50,
               torch.from_numpy(losses),
               prepare={"label": "sorted", "affinity_fp": "abc",
                        "jidx": torch.from_numpy(jidx),
                        "jval": torch.from_numpy(jval)})
    st, nxt, ls = jckpt.load(path)
    for got, want in zip(st, (y, upd, gains)):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert nxt == 50
    np.testing.assert_array_equal(ls, losses)
    prep = jckpt.load_prepare(path)
    assert prep["label"] == "sorted" and prep["affinity_fp"] == "abc"
    np.testing.assert_array_equal(prep["jidx"], jidx)
    np.testing.assert_array_equal(prep["jval"], jval)
    # the same arrays, saved by the JAX package, carry the same hash
    jpath = str(tmp_path / "j.npz")
    jckpt.save(jpath, jckpt.TsneState(y=y, update=upd, gains=gains), 50,
               losses, prepare={"label": "sorted", "affinity_fp": "abc",
                                "jidx": jidx, "jval": jval})
    assert _hash(path) == _hash(jpath)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jax_checkpoint_loads_in_port(tmp_path, dtype):
    y, upd, gains = _state(1, dtype)
    losses = np.linspace(1, 2, 7).astype(dtype)
    path = str(tmp_path / "j.npz")
    jckpt.save(path, jckpt.TsneState(y=y, update=upd, gains=gains), 70,
               losses, prepare={"label": "split-rows"},
               pilot=(np.zeros(3), np.zeros((7, 2))))
    st, nxt, ls = tckpt.load(path)
    for got, want in zip(st, (y, upd, gains)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want)
    assert nxt == 70
    np.testing.assert_array_equal(ls, losses)
    assert tckpt.load_prepare(path) == {"label": "split-rows"}
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "content_hash"}
    assert tckpt._content_hash(arrays) == jckpt._content_hash(arrays) \
        == _hash(path)


def test_damaged_checkpoint_raises_and_falls_back(tmp_path):
    path = str(tmp_path / "c.npz")
    for it in (10, 20):
        y, upd, gains = _state(it)
        tckpt.save(path, TsneState(*map(torch.from_numpy, (y, upd, gains))),
                   it, np.zeros(2))
    assert tckpt.load(path + ".1")[1] == 10
    raw = bytearray(open(path, "rb").read())
    mid = len(raw) // 2
    raw[mid] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.load(path)
    st, nxt, _, used = tckpt.load_fallback(path)
    assert (nxt, used) == (10, path + ".1")
    np.testing.assert_array_equal(st.y, _state(10)[0])
    _, nxt, _, payload, used = tckpt.load_resume(path)
    assert (nxt, payload, used) == (10, None, path + ".1")
    # a truncated file is damaged too
    open(path, "wb").write(bytes(raw[:mid]))
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.load(path)
    assert tckpt.load_resume(path)[4] == path + ".1"
    foreign = str(tmp_path / "f.npz")
    np.savez(foreign, magic=np.asarray("something-else"))
    with pytest.raises(tckpt.NotACheckpoint):
        tckpt.load(foreign)


def test_save_refuses_unknown_payload_key(tmp_path):
    y, upd, gains = _state(2)
    with pytest.raises(ValueError, match="unknown prepare payload key"):
        tckpt.save(str(tmp_path / "c.npz"), TsneState(y, upd, gains), 1,
                   np.zeros(1), prepare={"embedding": np.zeros(3)})


def _common(tmp_path, out, extra=(), method="bruteforce", dtype="float64"):
    return ["--input", str(tmp_path / "in.csv"), "--output", str(out),
            "--dimension", str(D), "--knnMethod", method,
            "--perplexity", "5", "--dtype", dtype, "--noCache",
            "--loss", str(out) + ".loss", *extra]


def test_port_resumes_jax_fat_checkpoint(tmp_path, capsys):
    """The JAX CLI's program writes its fat checkpoint at iteration 50
    (f64); the JAX CLI's resume and the port's run 10 more iterations and
    agree to ±1e-9.  The checkpoint's affinity fingerprint names the JAX
    package, so the port recomputes P (the same P to ±1e-12) and says
    so."""
    _coo(tmp_path / "in.csv")
    ck = str(tmp_path / "ck.npz")
    twin.fat_checkpoint(str(tmp_path / "in.csv"), ck, D, iterations=50,
                        perplexity=5.0, dtype=np.float64)
    assert jckpt.load(ck)[1] == 50 and "jidx" in jckpt.load_prepare(ck)
    yj, lj = twin.resume(ck, iterations=60, perplexity=5.0)
    capsys.readouterr()
    assert torch_main(_common(tmp_path, tmp_path / "t.csv",
                              ["--iterations", "60", "--resume", ck]),
                      device="cpu") == 0
    err = capsys.readouterr().err
    assert "does not match this run's data/plan" in err
    yt = np.loadtxt(tmp_path / "t.csv", delimiter=",")
    np.testing.assert_array_equal(yt[:, 0], np.arange(N))
    np.testing.assert_allclose(yt[:, 1:], yj, rtol=0, atol=1e-9)
    lt = np.loadtxt(str(tmp_path / "t.csv") + ".loss", delimiter=",")
    np.testing.assert_array_equal(lt[:, 0], np.arange(10, 70, 10))
    np.testing.assert_allclose(lt[:, 1], lj, rtol=1e-9, atol=0)


@pytest.mark.parametrize("method", ["bruteforce", "project"])
def test_port_resume_is_the_uninterrupted_run(tmp_path, monkeypatch,
                                              method):
    """--checkpointEvery 20 over 60 iterations writes at 20 and 40 and the
    end (60); with keep-last-2, ck.1 holds iteration 40.  Resuming it runs
    no kNN or affinity work and gives the uninterrupted run's bytes."""
    _coo(tmp_path / "in.csv", n=120, seed=3)
    ck = str(tmp_path / "ck.npz")
    def run(out, extra):
        return torch_main(_common(tmp_path, out, ["--iterations", "60",
                                                  *extra], method=method,
                                  dtype="float32"), device="cpu")

    assert run(tmp_path / "full.csv", ["--checkpoint", ck,
                                       "--checkpointEvery", "20",
                                       "--fatCheckpoint"]) == 0
    assert tckpt.load(ck)[1] == 60 and tckpt.load(ck + ".1")[1] == 40
    plain = tmp_path / "plain.csv"
    assert run(plain, []) == 0
    assert (tmp_path / "full.csv").read_bytes() == plain.read_bytes()

    def boom(*a, **k):
        raise AssertionError("the resume ran the prepare stage")

    from tsne_flink_tpu_torch.utils import artifacts
    monkeypatch.setattr(artifacts, "prepare", boom)
    out = tmp_path / "resumed.csv"
    assert run(out, ["--resume", ck + ".1"]) == 0
    assert out.read_bytes() == plain.read_bytes()
    assert (open(str(out) + ".loss", "rb").read()
            == open(str(plain) + ".loss", "rb").read())
