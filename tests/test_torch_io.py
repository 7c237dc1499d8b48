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


def _sorted_gaps(tmp_path):
    # ids that never decrease, with gaps, a point's lines in any feature
    # order: the reader's native assembly
    rng = np.random.default_rng(2)
    lines = []
    for i in np.sort(rng.choice(900, 60, replace=False)):
        for j in rng.permutation(9)[:rng.integers(1, 6)]:
            lines.append(f"{i},{j},{rng.standard_normal():.17g}\n")
    return "".join(lines)


def _four_columns(tmp_path):
    # the native parser refuses the fourth column: numpy parses the file
    return "0,1,2.0,9.9\n1,0,3.5,0.1\n"


CASES = {"dense": (_dense, 7), "sparse": (_sparse, 12),
         "sorted_gaps": (_sorted_gaps, 9),
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


@pytest.mark.parametrize("case", ["dense", "sparse", "sorted_gaps",
                                  "whitespace"])
def test_parse_is_the_same_on_any_number_of_slices(tmp_path, case):
    """The file cut into 1..9 slices parses to the same array as numpy's
    parser gives (slices past the file's lines are empty)."""
    make, _ = CASES[case]
    path = tmp_path / "in.csv"
    path.write_text(make(tmp_path))
    want = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2) \
        if case != "whitespace" else native.load_coo(str(path), threads=1)
    for threads in range(1, 10):
        got = native.load_coo(str(path), threads=threads)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [1, 2, 57, 143, 280])
def test_malformed_line_is_named_alike_on_any_number_of_slices(tmp_path,
                                                              bad):
    """A bad line (1-based ``bad``, blank lines before it counted) is
    reported as the one-slice parse reports it, however the file is cut."""
    lines = [f"{i // 7},{i % 7},{i * 0.5!r}" for i in range(280)]
    lines[3] = ""
    lines[bad - 1] = "1,2,x"
    path = tmp_path / "bad.csv"
    path.write_text("\n".join(lines) + "\n")
    for threads in range(1, 10):
        with pytest.raises(native.MalformedCsv) as e:
            native.load_coo(str(path), threads=threads)
        assert e.value.line == bad


def _numpy_dense(coo, dim):
    """The numpy assembly of ``read_input`` (the JAX package's)."""
    pts = coo[:, 0].astype(np.int64)
    ids, pos = np.unique(pts, return_inverse=True)
    x = np.zeros((len(ids), dim), np.float64)
    x[pos, coo[:, 1].astype(np.int64)] = coo[:, 2]
    return ids, x


def _coo(rng, n_points, dim, gaps=True):
    """Point by point, features in any order, some points empty-featured
    rows of one zero, ids with gaps."""
    ids = np.sort(rng.choice(10 * n_points if gaps else n_points, n_points,
                             replace=False))
    rows = [(i, j, rng.standard_normal()) for i in ids
            for j in rng.permutation(dim)[:rng.integers(1, dim + 1)]]
    return np.array(rows, np.float64)


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 64])
def test_native_assembly_is_numpys_on_any_number_of_slices(threads):
    rng = np.random.default_rng(threads)
    for n_points, dim, gaps in ((1, 3, False), (7, 5, True), (300, 9, True),
                                (500, 4, False)):
        coo = _coo(rng, n_points, dim, gaps)
        got = native.coo_dense(coo, dim, threads=threads)
        assert got is not None
        want = _numpy_dense(coo, dim)
        assert got[0].dtype == want[0].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # a feature given twice keeps its last value
    coo = np.array([[0, 1, 1.0], [0, 1, 2.0], [4, 0, 3.0], [4, 0, -0.0]])
    ids, x = native.coo_dense(coo, 2, threads=threads)
    np.testing.assert_array_equal(ids, [0, 4])
    np.testing.assert_array_equal(x, [[0.0, 2.0], [-0.0, 0.0]])
    assert np.signbit(x[1, 0])


@pytest.mark.parametrize("bad", ["unsorted", "fractional_id",
                                 "fractional_feature", "negative_id",
                                 "negative_feature", "feature_past_dim",
                                 "nan_id", "four_columns", "empty"])
def test_native_assembly_leaves_other_files_to_numpy(bad):
    """Any COO but a point-by-point one of integer ids gets None, and the
    reader assembles it with numpy (raising where numpy raises)."""
    coo = np.array([[0, 0, 1.0], [1, 1, 2.0], [1, 2, 3.0], [3, 0, 4.0]])
    if bad == "unsorted":
        coo = coo[[0, 3, 1, 2]]
    elif bad == "fractional_id":
        coo[1, 0] = 1.5
    elif bad == "fractional_feature":
        coo[2, 1] = 0.25
    elif bad == "negative_id":
        coo[0, 0] = -1.0
    elif bad == "negative_feature":
        coo[3, 1] = -1.0
    elif bad == "feature_past_dim":
        coo[3, 1] = 3.0
    elif bad == "nan_id":
        coo[2, 0] = np.nan
    elif bad == "four_columns":
        coo = np.hstack([coo, coo[:, :1]])
    elif bad == "empty":
        coo = coo[:0]
    for threads in (1, 3):
        assert native.coo_dense(coo, 3, threads=threads) is None


def test_parse_threads_follow_the_file_size():
    cpus = len(native.os.sched_getaffinity(0))
    assert native.parse_threads(1) == 1
    assert native.parse_threads(native.PARSE_SLICE_BYTES) == 1
    assert native.parse_threads(native.PARSE_SLICE_BYTES + 1) == min(2, cpus)
    assert native.parse_threads(1 << 40) == min(native.PARSE_THREADS, cpus)


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
