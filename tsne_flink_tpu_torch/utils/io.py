"""Host-side COO CSV ingest and output (port of
``tsne_flink_tpu/utils/io.py``; the same formats and the same arrays).

* :func:`read_input` — CSV rows ``point_id,feature_id,value`` assembled
  into dense per-point vectors (``Tsne.readInput``, Tsne.scala:138-153).
  Point ids need not be contiguous: they are mapped to positions, and the
  original ids are carried to the output.
* :func:`read_distance_matrix` — CSV rows ``i,j,distance`` as the
  precomputed neighbour graph (Tsne.scala:155-159), padded to [N, K] with
  +inf distances.
* :func:`write_embedding` — ``id,y0,...`` for every component (the
  reference truncates to two; SURVEY §7).
* :func:`write_loss` — one ``iteration,loss`` line per recorded slot.

Every function returns or takes numpy arrays; the caller moves them to
the device.  The parser is the native one (``utils/native``): a file it
refuses (a format corner, such as a fourth column) goes to numpy's parser,
which raises its own error for input that is really malformed.  A parser
that does not build raises.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from tsne_flink_tpu_torch.utils import native


def atomic_write(path: str, write_fn, *, tag: str | None = None) -> None:
    """tmp + rename: ``write_fn(tmp_path)`` writes the content, which then
    replaces ``path`` in one rename, so a kill mid-write never leaves a
    truncated file.  A ``write_fn`` that raises leaves ``path`` as it
    was.  ``tag`` names the tmp (``.<tag>.out.tmp``: the serve daemon's
    claim epoch)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=f".{tag}.out.tmp" if tag
                               else ".out.tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_coo(path: str) -> np.ndarray:
    try:
        return native.load_coo(path)
    except native.MalformedCsv:
        return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)


def read_input(path: str, dimension: int):
    """COO (point, feature, value) CSV -> (ids [N], dense X [N, dimension]
    float64).  A file written point by point is assembled natively
    (``native.coo_dense``); any other by numpy, to the same arrays."""
    coo = _load_coo(path)
    dense = native.coo_dense(coo, dimension)
    if dense is not None:
        return dense
    pts = coo[:, 0].astype(np.int64)
    feats = coo[:, 1].astype(np.int64)
    if feats.max() >= dimension:
        raise ValueError(
            f"feature id {feats.max()} out of range for --dimension {dimension}")
    ids, pos = np.unique(pts, return_inverse=True)
    x = np.zeros((len(ids), dimension), np.float64)
    x[pos, feats] = coo[:, 2]
    return ids, x


def read_distance_matrix(path: str):
    """COO (i, j, distance) CSV -> (ids [N], idx [N, K] int32, dist [N, K]
    float64), each row ascending by distance; K is the longest row, and
    shorter rows are padded with dist = +inf."""
    coo = _load_coo(path)
    ii = coo[:, 0].astype(np.int64)
    jj = coo[:, 1].astype(np.int64)
    ids, ipos = np.unique(np.concatenate([ii, jj]), return_inverse=True)
    n = len(ids)
    ipos_i = ipos[: len(ii)]
    ipos_j = ipos[len(ii):]
    order = np.lexsort((coo[:, 2], ipos_i))  # by row, then distance
    ipos_i, ipos_j, vals = ipos_i[order], ipos_j[order], coo[:, 2][order]
    counts = np.bincount(ipos_i, minlength=n)
    k = int(counts.max())
    idx = np.zeros((n, k), np.int32)
    dist = np.full((n, k), np.inf, np.float64)
    slot = np.arange(len(ipos_i)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    idx[ipos_i, slot] = ipos_j
    dist[ipos_i, slot] = vals
    return ids, idx, dist


def write_embedding(path: str, ids: np.ndarray, y: np.ndarray) -> None:
    atomic_write(path, lambda tmp: native.write_embedding(tmp, ids, y))


def write_loss(path: str, losses: np.ndarray, every: int = 10) -> None:
    def emit(tmp):
        with open(tmp, "w") as f:
            for t, v in enumerate(np.asarray(losses)):
                f.write(f"{(t + 1) * every},{float(v)!r}\n")

    atomic_write(path, emit)
