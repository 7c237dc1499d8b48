"""The prepare stage and its artifact cache (port of
``tsne_flink_tpu/utils/artifacts.py``).

:func:`prepare` is kNN graph -> β search -> assembled joint P, with the
seconds of each stage measured to the end of the device's work.  With an
:class:`ArtifactCache` the kNN graph and the assembled P are stored as
``.npz`` files keyed by a sha256 fingerprint of everything they are a
deterministic function of: the input's bytes as the kNN sees them (dtype,
shape, data), the resolved kNN plan, k, the metric, the seed of the
hybrid plan's draws, the matmul operand dtype of a mixed-precision run
(a bf16 prepare never serves a float32 run, nor the reverse), the
perplexity, the assembly and its width.  The fingerprint also names the port, the torch version, the device type and
:data:`FORMAT_VERSION`, so the port's entries and the JAX package's never
collide.  A warm hit loads the cold run's own arrays: bit-identical.
Damaged, foreign or mismatched files are removed and count as a miss.

Tile sizes are not fingerprinted (as in the JAX package): the refine
chunk never changes the graph and the band block is pinned
(``ops/knn_tiles``), so an autotuned chunk never splits the cache.

As in the JAX package, each stage runs under a trace span
(``prepare.knn``, ``prepare.affinities``) that ends after the stage's
closing device sync, starts with its fault site (``fire("knn")``,
``fire("affinities")``, ``runtime/faults.py``), and ends with a memory
watermark sample (``obs/memory.py``) and the caller's ``on_stage`` hook
(the supervisor's stage tracking, the fleet's watchdog heartbeat).
Cache writes take a cross-process :class:`~tsne_flink_tpu_torch.utils
.locks.FileLock` per entry, so concurrent fleet jobs preparing the same
key do not interleave.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile
from dataclasses import dataclass

import numpy as np
import torch

# resolve_knn_plan lives with the policies it applies; it is importable
# from here as from the JAX package's utils/artifacts
from tsne_flink_tpu_torch.convert import to_numpy
from tsne_flink_tpu_torch.obs import memory as obmem
from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.ops.knn import resolve_knn_plan
from tsne_flink_tpu_torch.utils.device import resolve_device, timed_stage

MAGIC = "tsne_flink_tpu_torch-artifact-v1"
#: bump to invalidate every entry when the arrays change for the same
#: fingerprint inputs
FORMAT_VERSION = 1

KIND_KNN = "knn"
KIND_AFFINITY = "affinity"


def default_root() -> str:
    """The repository-local ``.tsne_artifacts`` (shared with the JAX
    package; the fingerprints keep the two apart)."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".tsne_artifacts")


def data_fingerprint(x) -> str:
    """sha256 of an array or tensor: dtype, shape and raw bytes."""
    a = np.ascontiguousarray(to_numpy(x))
    h = hashlib.sha256()
    h.update(repr((a.dtype.str, a.shape)).encode())
    h.update(a.view(np.uint8).reshape(-1).data)
    return h.hexdigest()[:32]


def fingerprint(parts: dict, device) -> str:
    """Order-independent digest of a flat {name: scalar} dict, with the
    port's identity folded in."""
    parts = dict(parts, _format=FORMAT_VERSION,
                 _package="tsne_flink_tpu_torch", _torch=torch.__version__,
                 _device=torch.device(device).type)
    blob = repr(sorted((str(k), repr(v)) for k, v in parts.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def knn_fingerprint(data_fp: str, *, n: int, d: int, k: int, method: str,
                    metric: str, rounds, refine, seed, device,
                    matmul_dtype=None) -> str:
    """Fingerprint of the kNN graph (``data_fp`` names the input's dtype,
    shape and bytes).  ``method``/``rounds``/``refine`` are
    the RESOLVED plan (``resolve_knn_plan``), so an explicit value equal to
    the auto policy hits the same entry; only the hybrid plan draws, so
    the seed and its rounds are normalized out of the exact methods (whose
    graphs are one and the same).  ``matmul_dtype`` (bf16 operands) is
    named as the JAX key names it (``matmul_dtype``); a float32 run's key
    keeps its form, so its entries stay warm."""
    if method != "project":
        rounds = refine = seed = None
        method = "exact"
    parts = {"kind": KIND_KNN, "data": data_fp, "n": n, "d": d, "k": k,
             "method": method, "metric": metric, "rounds": rounds,
             "refine": refine, "seed": seed}
    if matmul_dtype is not None:
        parts["matmul_dtype"] = str(matmul_dtype)
    return fingerprint(parts, device)


def affinity_fingerprint(knn_fp: str, *, perplexity: float, assembly: str,
                         sym_width, device) -> str:
    """Fingerprint of the assembled joint P, layered on the kNN graph's."""
    return fingerprint({"kind": KIND_AFFINITY, "knn": knn_fp,
                        "perplexity": float(perplexity),
                        "assembly": assembly, "sym_width": sym_width},
                       device)


class ArtifactCache:
    """Prepare artifacts on disk, one ``.npz`` per fingerprint.

    :meth:`load` checks the magic, the embedded fingerprint and the
    required array names; a damaged, foreign or mismatched file is deleted
    and reported as a miss.  :meth:`save` is atomic (tmp + rename) under
    the entry's cross-process lock."""

    def __init__(self, root: str | None = None):
        self.root = root or default_root()
        self.hits = 0
        self.misses = 0

    def path(self, kind: str, fp: str) -> str:
        return os.path.join(self.root, f"{kind}-{fp}.npz")

    def load(self, kind: str, fp: str, required=()) -> dict | None:
        path = self.path(kind, fp)
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["magic"]) != MAGIC or str(z["fingerprint"]) != fp:
                    raise ValueError("foreign or fingerprint-mismatched "
                                     "artifact")
                out = {name: z[name] for name in z.files
                       if name not in ("magic", "fingerprint")}
            for name in required:
                if name not in out:
                    raise KeyError(name)
        except FileNotFoundError:
            self.misses += 1
            return None
        except (OSError, ValueError, KeyError, zipfile.BadZipFile, EOFError):
            # never trust a damaged entry: remove it, so that the cold
            # path's save replaces it
            try:
                os.remove(path)
            except OSError:
                pass
            self.misses += 1
            return None
        self.hits += 1
        return out

    def save(self, kind: str, fp: str, arrays: dict) -> bool:
        """Write the entry; False (and no file) when the root is not
        writable or another process holds the entry's lock past the
        bounded wait (it is writing these same content-addressed bytes)."""
        from tsne_flink_tpu_torch.utils.locks import FileLock

        arrays = {k: to_numpy(v) for k, v in arrays.items()}
        path = self.path(kind, fp)
        try:
            os.makedirs(self.root, exist_ok=True)
        except OSError:
            return False
        lock = FileLock(path + ".lock")
        if not lock.acquire():
            return False
        try:
            try:
                fd, tmp = tempfile.mkstemp(dir=self.root,
                                           suffix=".artifact.tmp")
            except OSError:
                return False
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, magic=MAGIC, fingerprint=fp, **arrays)
                os.replace(tmp, path)
            except OSError:
                return False
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            lock.release()
        return True


@dataclass
class PrepareResult:
    """Everything the optimize loop needs, plus the stage times and where
    each stage's arrays came from."""

    idx: torch.Tensor | None   # [N, k] kNN structure
    dist: torch.Tensor | None  # [N, k] kNN distances
    jidx: torch.Tensor         # [N, S] joint-P rows (blocks: [N, k])
    jval: torch.Tensor
    extra_edges: tuple | None  # blocks: the reverse (src, dst, val)
    label: str                 # resolved assembly: split-rows | sorted |
    # split | blocks
    knn_seconds: float
    affinity_seconds: float
    knn_substages: dict | None = None  # kNN substage seconds (None when
    # the graph was given or loaded)
    knn_cache: str = "off"       # off | cold | warm | input
    affinity_cache: str = "off"  # off | cold | warm
    knn_fp: str | None = None
    affinity_fp: str | None = None
    knn_tiles: dict | None = None  # the tile plan the kNN ran with
    memory: dict | None = None     # {stage: obs/memory sample} at stage end


def prepare_fingerprints(x=None, knn=None, *, neighbors: int,
                         knn_method: str = "bruteforce",
                         metric: str = "sqeuclidean", knn_rounds=None,
                         knn_refine=None, seed: int | None = None,
                         perplexity: float, assembly: str = "auto",
                         sym_width: int | None = None, device=None,
                         matmul_dtype=None):
    """``(knn_fp, affinity_fp)`` of these prepare inputs: what
    :func:`prepare` keys its artifacts by.  ``x`` (or the ``knn=(idx,
    dist)`` graph) is hashed as given: pass it in the dtype the kNN runs
    in.  Host hashing only, no kNN work; the CLI checks a checkpoint's
    embedded P with it."""
    device = resolve_device(device)
    k = int(neighbors)
    if knn is not None:
        knn_fp = fingerprint({"kind": KIND_KNN, "precomputed": True,
                              "idx": data_fingerprint(knn[0]),
                              "dist": data_fingerprint(knn[1])}, device)
    else:
        n, d = int(x.shape[0]), int(x.shape[1])
        method, rounds, refine = resolve_knn_plan(
            n, d, knn_method, knn_rounds, knn_refine, k=k,
            backend=device.type)
        knn_fp = knn_fingerprint(
            data_fingerprint(x), n=n, d=d, k=k, method=method,
            metric=metric, rounds=rounds, refine=refine, seed=seed,
            device=device, matmul_dtype=matmul_dtype)
    return knn_fp, affinity_fingerprint(knn_fp, perplexity=perplexity,
                                        assembly=assembly,
                                        sym_width=sym_width, device=device)


def prepare(x=None, *, knn=None, neighbors: int,
            knn_method: str = "bruteforce", metric: str = "sqeuclidean",
            knn_rounds: int | None = None, knn_refine: int | None = None,
            knn_blocks: int = 8, generator: torch.Generator | None = None,
            seed: int | None = None, perplexity: float,
            assembly: str = "auto", sym_width: int | None = None,
            device=None, cache: ArtifactCache | None = None,
            knn_tiles=None, knn_autotune: bool = False,
            on_stage=None, on_graph=None,
            matmul_dtype=None) -> PrepareResult:
    """kNN (or the given ``knn=(idx, dist)``), then the symmetrized P by
    ``assembly``: ``auto`` (``affinity_auto``: split rows, or blocks when
    the rows would not fit), ``blocks`` (``affinity_blocks``), or
    ``sorted`` / ``split`` (``affinity_pipeline`` at ``sym_width``).

    The kNN plan resolves through ``ops/knn.resolve_knn_plan``
    (``knn_rounds``/``knn_refine`` None = the auto policies); the hybrid
    plan draws from ``generator``, or from ``models/tsne.knn_generator
    (seed)`` when only ``seed`` is given (both None: the kNN functions'
    seeded defaults).

    ``cache`` keys both stages' arrays by :func:`prepare_fingerprints`
    (a hybrid plan needs ``seed``, which names its draws, not a bare
    ``generator``).  ``knn_tiles`` (an ``ops/knn_tiles.KnnTilePlan``) pins
    the tile shapes; ``knn_autotune`` replaces the model's refine chunk
    by the fastest measured (``autotune_knn_tiles``) when the graph is
    computed by a refining plan.  The plan used lands in
    ``PrepareResult.knn_tiles``.

    ``on_stage(stage, seconds, cache_state)`` is called after each stage
    (``knn``, then ``affinities``), and ``on_graph(idx)`` with the kNN
    graph once its stage ends (the run supervisor's width bound); neither
    changes a bit of the result.  ``matmul_dtype`` (None, or
    ``torch.bfloat16``: mixed precision) is the kNN products' operand
    dtype (``ops/knn``), named in the kNN fingerprint."""
    from tsne_flink_tpu_torch.ops.knn import backend_of
    from tsne_flink_tpu_torch.runtime import faults

    if assembly not in ("auto", "sorted", "split", "blocks"):
        raise ValueError(f"assembly '{assembly}' not defined "
                         "(auto | sorted | split | blocks)")
    inj = faults.injector()  # None (one check) without a fault plan
    device = resolve_device(device)
    k = int(neighbors)
    # the kNN stage's seconds include the plan resolution and the
    # fingerprints (hashing the input)
    sp_setup = obtrace.begin("prepare.setup", cat="prepare")
    try:
        given = x if knn is None else knn  # hashed as given: no device copy
        method = refine = None
        if knn is None:
            x = torch.as_tensor(x, device=device)
            n, d = x.shape
            method, rounds, refine = resolve_knn_plan(
                n, d, knn_method, knn_rounds, knn_refine, k=k,
                backend=backend_of(x))
            if generator is None and seed is not None:
                from tsne_flink_tpu_torch.models.tsne import knn_generator
                generator = knn_generator(seed, device)
        knn_fp = affinity_fp = None
        if cache is not None:
            if knn is None and method == "project" and seed is None:
                raise ValueError("a cached hybrid kNN needs seed= (the "
                                 "fingerprint names its draws by their seed)")
            knn_fp, affinity_fp = prepare_fingerprints(
                *((given, None) if knn is None else (None, given)),
                neighbors=k, knn_method=knn_method, metric=metric,
                knn_rounds=knn_rounds, knn_refine=knn_refine, seed=seed,
                perplexity=perplexity, assembly=assembly, sym_width=sym_width,
                device=device, matmul_dtype=matmul_dtype)
    finally:
        sp_setup.end()

    # ---- kNN graph: the span ends after the stage's closing sync, and
    # the try/finally keeps the span stack clean when the stage raises (an
    # out-of-memory error unwinds to the supervisor, which relaunches)
    subs = tiles_rec = None
    sp_knn = obtrace.begin("prepare.knn", cat="prepare")
    try:
        if inj is not None:
            inj.fire("knn")
        if knn is not None:
            idx, dist = (torch.as_tensor(a, device=device) for a in knn)
            knn_cache = "input"
        else:
            got = (cache.load(KIND_KNN, knn_fp, ("idx", "dist"))
                   if cache is not None else None)
            if got is not None:
                idx, dist = (torch.as_tensor(got[nm], device=device)
                             for nm in ("idx", "dist"))
                knn_cache = "warm"
            else:
                idx, dist, subs, tiles_rec = _compute_knn(
                    x, k, knn_method, metric, method, refine,
                    knn_rounds=knn_rounds, knn_refine=knn_refine,
                    knn_blocks=knn_blocks, generator=generator,
                    knn_tiles=knn_tiles, knn_autotune=knn_autotune,
                    matmul_dtype=matmul_dtype)
                knn_cache = "off"
                if cache is not None:
                    cache.save(KIND_KNN, knn_fp, {"idx": idx, "dist": dist})
                    knn_cache = "cold"
        t_knn = sp_setup.seconds + timed_stage(device, sp_knn)
        sp_knn.set(cache=knn_cache)
    finally:
        sp_knn.end()
    mem_knn = obmem.sample("knn", device)
    if on_stage is not None:
        on_stage("knn", t_knn, knn_cache)
    if on_graph is not None:
        on_graph(idx)

    # ---- affinities: beta search + symmetrized assembly ----
    sp_aff = obtrace.begin("prepare.affinities", cat="prepare")
    try:
        if inj is not None:
            inj.fire("affinities")
        jidx, jval, extra, label, affinity_cache = _affinity_stage(
            idx, dist, perplexity=perplexity, assembly=assembly,
            sym_width=sym_width, cache=cache, affinity_fp=affinity_fp,
            device=device)
        t_aff = timed_stage(device, sp_aff)
        sp_aff.set(cache=affinity_cache, assembly=label)
    finally:
        sp_aff.end()
    mem_aff = obmem.sample("affinities", device)
    if on_stage is not None:
        on_stage("affinities", t_aff, affinity_cache)
    return PrepareResult(idx=idx, dist=dist, jidx=jidx, jval=jval,
                         extra_edges=extra, label=label, knn_seconds=t_knn,
                         affinity_seconds=t_aff, knn_substages=subs,
                         knn_cache=knn_cache, affinity_cache=affinity_cache,
                         knn_fp=knn_fp, affinity_fp=affinity_fp,
                         knn_tiles=tiles_rec,
                         memory={"knn": mem_knn, "affinities": mem_aff})


def _compute_knn(x, k, knn_method, metric, method, refine, *, knn_rounds,
                 knn_refine, knn_blocks, generator, knn_tiles,
                 knn_autotune, matmul_dtype=None):
    """The kNN graph computed: ``(idx, dist, substage seconds, the tile
    plan's record)``."""
    from tsne_flink_tpu_torch.ops.knn import backend_of, knn as knn_dispatch
    from tsne_flink_tpu_torch.ops.knn_tiles import (autotune_knn_tiles,
                                                    pick_knn_tiles)
    n, d = x.shape
    tiles = knn_tiles or pick_knn_tiles(n, d, k, backend_of(x),
                                        metric=metric)
    if knn_autotune and knn_tiles is None and method == "project" and refine:
        tiles = autotune_knn_tiles(x, k, metric, plan=tiles)
    subs = {}
    idx, dist = knn_dispatch(x, k, knn_method, metric, blocks=knn_blocks,
                             rounds=knn_rounds, refine=knn_refine,
                             generator=generator, tiles=tiles,
                             on_substage=subs.update,
                             matmul_dtype=matmul_dtype)
    return idx, dist, subs, tiles.as_record()


def _affinity_stage(idx, dist, *, perplexity, assembly, sym_width, cache,
                    affinity_fp, device):
    """The joint P, loaded or computed: ``(jidx, jval, extra, label,
    cache state)``."""
    from tsne_flink_tpu_torch.ops import affinities as aff

    got = (cache.load(KIND_AFFINITY, affinity_fp, ("label", "jidx", "jval"))
           if cache is not None else None)
    label = str(got["label"]) if got is not None else None
    if got is not None and label == "blocks" and not all(
            nm in got for nm in ("rsrc", "rdst", "rval")):
        got = None  # a torn blocks entry: recompute (the save replaces it)
    if got is not None:
        jidx, jval = (torch.as_tensor(got[nm], device=device)
                      for nm in ("jidx", "jval"))
        extra = (tuple(torch.as_tensor(got[nm], device=device)
                       for nm in ("rsrc", "rdst", "rval"))
                 if label == "blocks" else None)
        return jidx, jval, extra, label, "warm"
    if assembly == "auto":
        jidx, jval, extra, label = aff.affinity_auto(idx, dist, perplexity)
    elif assembly == "blocks":
        jidx, jval, extra = aff.affinity_blocks(idx, dist, perplexity)
        label = "blocks"
    else:
        jidx, jval = aff.affinity_pipeline(idx, dist, perplexity, sym_width,
                                           assembly=assembly)
        extra, label = None, assembly
    state = "off"
    if cache is not None:
        arrays = {"label": label, "jidx": jidx, "jval": jval}
        if extra is not None:
            arrays.update(rsrc=extra[0], rdst=extra[1], rval=extra[2])
        cache.save(KIND_AFFINITY, affinity_fp, arrays)
        state = "cold"
    return jidx, jval, extra, label, state
