"""ctypes bindings of the host CSV parser and embedding writer
(``native/fastcsv.cpp``; port of ``tsne_flink_tpu/utils/native.py``).

The library is built with ``g++`` at first use into ``native/build/``
(listed in ``.gitignore``) under a name keyed by the source's hash, so a
stale build is never loaded.  A failed build raises
:class:`NativeBuildError`: the port has no slower path that would hide it.
Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "fastcsv.cpp"
BUILD_DIR = SRC.parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# a parse thread for each PARSE_SLICE_BYTES of file, at most PARSE_THREADS
PARSE_SLICE_BYTES = 1 << 24
PARSE_THREADS = 8


class NativeBuildError(RuntimeError):
    """The host parser did not build (no compiler, or the compiler failed)."""


class MalformedCsv(ValueError):
    """The native parser refuses a line of the file (1-based ``line``)."""

    def __init__(self, path, line: int):
        self.line = line
        super().__init__(f"{path}: malformed CSV at line {line}")


def build() -> Path:
    """Compile ``fastcsv.cpp`` unless the keyed library exists; returns its
    path.  Raises :class:`NativeBuildError` when the compiler is missing or
    fails."""
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"fastcsv-{tag.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        try:
            res = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SRC)],
                                 capture_output=True, text=True, check=False)
        except OSError as e:
            raise NativeBuildError(
                f"cannot run the C++ compiler '{CXX}' to build the CSV "
                f"parser {SRC.name}: {e}") from e
        if res.returncode != 0:
            raise NativeBuildError(
                f"'{CXX}' failed ({res.returncode}) building {SRC.name}:\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded parser library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    lib.coo_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.coo_count_rows.restype = ctypes.c_longlong
    lib.coo_parse.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.coo_parse.restype = ctypes.c_longlong
    lib.coo_points.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    lib.coo_points.restype = ctypes.c_longlong
    lib.coo_dense.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.coo_dense.restype = None
    lib.write_embedding.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_longlong, ctypes.c_int]
    lib.write_embedding.restype = ctypes.c_longlong
    return lib


def parse_threads(size: int) -> int:
    """Threads for a file of ``size`` bytes: one for each PARSE_SLICE_BYTES,
    at most PARSE_THREADS and the CPUs this process may run on."""
    cpus = len(os.sched_getaffinity(0))
    return max(1, min(PARSE_THREADS, cpus, -(-size // PARSE_SLICE_BYTES)))


def load_coo(path: str, cols: int = 3, threads: int | None = None
             ) -> np.ndarray:
    """Parse a numeric CSV of ``cols`` columns into a float64 [rows, cols]
    array, the file cut into ``threads`` slices of whole lines parsed at
    once (default :func:`parse_threads`; the result does not depend on
    it).  Raises :class:`MalformedCsv` on a line the parser refuses,
    ``FileNotFoundError`` for a missing file, ``ValueError`` for an empty
    one."""
    lib = library()
    size = os.stat(path).st_size
    if size == 0:
        raise ValueError(f"{path} is empty")
    if threads is None:
        threads = parse_threads(size)
    pathb = os.fsencode(path)
    rows = lib.coo_count_rows(pathb, threads)
    if rows < 0:
        raise OSError(f"cannot read {path}")
    out = np.empty((rows, cols), np.float64)
    got = lib.coo_parse(pathb, out, rows, cols, threads)
    if got < 0:
        raise MalformedCsv(path, -got - 1)
    return out[:got]


def coo_dense(coo: np.ndarray, dimension: int, threads: int | None = None):
    """(ids [N] int64, x [N, dimension] float64) of a parsed COO ([rows, 3]
    float64 point, feature, value) whose point ids never decrease and whose
    ids and features are integers (features below ``dimension``), as a
    file written point by point gives them: one pass over slices of
    whole points on ``threads`` threads (default :func:`parse_threads` of
    its bytes).  ``None`` for any other COO."""
    if coo.ndim != 2 or coo.shape[1] != 3 or coo.shape[0] == 0:
        return None
    coo = np.ascontiguousarray(coo, np.float64)
    if threads is None:
        threads = parse_threads(coo.nbytes)
    lib = library()
    n = lib.coo_points(coo, coo.shape[0], dimension, threads)
    if n < 0:
        return None
    ids = np.empty(n, np.int64)
    x = np.zeros((n, dimension), np.float64)
    lib.coo_dense(coo, coo.shape[0], dimension, threads, ids, x)
    return ids, x


def write_embedding(path: str, ids: np.ndarray, y: np.ndarray) -> None:
    """Write ``id,y0,...`` lines, each float the shortest of %.15g and
    %.17g that reads back to the same float64."""
    ids64 = np.ascontiguousarray(ids, np.int64)
    y64 = np.ascontiguousarray(y, np.float64)
    if y64.ndim != 2 or ids64.shape != (y64.shape[0],):
        raise ValueError(f"ids {ids64.shape} and y {y64.shape} do not pair")
    if library().write_embedding(os.fsencode(path), ids64, y64,
                                 y64.shape[0], y64.shape[1]) < 0:
        raise OSError(f"cannot write {path}")
