"""The port's CSV ingest and writers against the JAX package's
(``tsne_flink_tpu_torch/utils/io.py`` vs ``tsne_flink_tpu/utils/io.py``).

The same files go through both readers and must give equal arrays (exact:
both parse with the same C++ parser, or numpy where it refuses a line);
the same ids and embedding go through both writers and must give the
same bytes.  A parser that does not build raises in the port (the JAX
package falls back to numpy there).
"""

import numpy as np
import pytest

from tsne_flink_tpu.utils import io as jio
from tsne_flink_tpu_torch.utils import io as tio
from tsne_flink_tpu_torch.utils import native

pytestmark = pytest.mark.fast


def _dense(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 7)) * 3.0
    return "".join(f"{i},{j},{float(x[i, j])!r}\n"
                   for i in range(40) for j in range(7))


def _sparse(tmp_path):
    # non-contiguous, unsorted ids; missing entries are zeros
    rng = np.random.default_rng(1)
    ids = rng.permutation(np.arange(0, 600, 7))[:50]
    lines = []
    for i in ids:
        for j in sorted(rng.choice(12, 4, replace=False)):
            lines.append(f"{i},{j},{rng.random():.17g}\n")
    return "".join(lines)


def _whitespace(tmp_path):
    # blank lines, tabs and spaces as delimiters, a leading '+', no final
    # newline
    return "0 1 2.5\n\n  \n1\t0\t-3e-4\n+2,2,1e10\n3 , 3 , 4"


def _four_columns(tmp_path):
    # the native parser refuses the fourth column: numpy parses the file
    return "0,1,2.0,9.9\n1,0,3.5,0.1\n"


CASES = {"dense": (_dense, 7), "sparse": (_sparse, 12),
         "whitespace": (_whitespace, 4), "four_columns": (_four_columns, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_read_input_matches_jax(tmp_path, case):
    make, dim = CASES[case]
    path = tmp_path / "in.csv"
    path.write_text(make(tmp_path))
    ids_t, x_t = tio.read_input(str(path), dim)
    ids_j, x_j = jio.read_input(str(path), dim)
    np.testing.assert_array_equal(ids_t, ids_j)
    assert x_t.dtype == x_j.dtype == np.float64
    np.testing.assert_array_equal(x_t, x_j)


def test_read_input_refuses_feature_past_dimension(tmp_path):
    path = tmp_path / "in.csv"
    path.write_text("0,0,1.0\n0,5,2.0\n")
    for reader in (tio.read_input, jio.read_input):
        with pytest.raises(ValueError, match="out of range"):
            reader(str(path), 5)


@pytest.mark.parametrize("case", ["ragged", "sparse_ids"])
def test_read_distance_matrix_matches_jax(tmp_path, case):
    path = tmp_path / "d.csv"
    if case == "ragged":
        # rows of 2, 1, 3 and 1 neighbours, out of order
        path.write_text("0,1,0.5\n2,3,0.1\n0,2,1.5\n1,0,0.5\n2,0,1.5\n"
                        "2,1,0.7\n3,2,0.1\n")
    else:
        rng = np.random.default_rng(3)
        ids = np.arange(5, 300, 11)
        lines = [f"{i},{j},{rng.random()!r}\n" for i in ids
                 for j in rng.choice(ids[ids != i], rng.integers(1, 6),
                                     replace=False)]
        path.write_text("".join(lines))
    got = tio.read_distance_matrix(str(path))
    want = jio.read_distance_matrix(str(path))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_writers_byte_identical_to_jax(tmp_path, m):
    rng = np.random.default_rng(m)
    ids = np.array([3, 7, 900, 12, 0, 41], np.int64)
    y = (rng.standard_normal((6, m)) * 17.3).astype(np.float32)
    y[0, 0] = 1e-5  # a value %.15g does not round-trip
    losses = rng.random(9).astype(np.float32)
    tio.write_embedding(str(tmp_path / "t.csv"), ids, y)
    jio.write_embedding(str(tmp_path / "j.csv"), ids, y)
    tio.write_loss(str(tmp_path / "tl.txt"), losses)
    jio.write_loss(str(tmp_path / "jl.txt"), losses)
    assert ((tmp_path / "t.csv").read_bytes()
            == (tmp_path / "j.csv").read_bytes())
    assert ((tmp_path / "tl.txt").read_bytes()
            == (tmp_path / "jl.txt").read_bytes())
    # the embedding reads back bit for bit as float32
    back = np.loadtxt(tmp_path / "t.csv", delimiter=",", ndmin=2)
    np.testing.assert_array_equal(back[:, 0], ids)
    np.testing.assert_array_equal(back[:, 1:].astype(np.float32), y)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded library, undone after."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    yield
    native.library.cache_clear()


def test_native_build_failure_raises(tmp_path, monkeypatch, fresh_build):
    """With no compiler the port raises, where the JAX package would parse
    with numpy instead."""
    path = tmp_path / "in.csv"
    path.write_text("0,0,1.0\n1,1,2.0\n")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(native.NativeBuildError, match="no-such-g\\+\\+"):
        tio.read_input(str(path), 2)
    with pytest.raises(native.NativeBuildError):
        tio.write_embedding(str(tmp_path / "o.csv"), np.arange(2),
                            np.zeros((2, 2)))
    assert not (tmp_path / "o.csv").exists()
    # a compiler that fails raises too, with its output
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.load_coo(str(path))


def test_native_build_is_keyed_and_reused(fresh_build):
    so = native.build()
    assert so.exists() and so.name.startswith("fastcsv-")
    assert native.build() == so
