"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into one shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds.  The library lands in ``kernels/build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so
a stale build is never loaded.  Nothing here runs at import: ``nvcc`` is
looked up and the library built on the first launch, which only a CUDA
tensor reaches — the CPU tests import every module without a toolkit.

Each kernel is a :class:`Kernel`: it launches its C entry point on
PyTorch's current stream, raises on a non-zero return (a refused launch
never runs and ``torch.cuda.synchronize`` would not report it), and counts
its launches, so a run can show that the main path went through it.

The keyed library is the port's compiled-program cache across processes
(the JAX package's ``--aotCache``).  Concurrent processes (fleet
children) take a cross-process :class:`~tsne_flink_tpu_torch.utils.locks
.FileLock` around the build, so the first builds and the others load its
file.  :func:`set_cache` ``(False)`` (``--noAotCache``) builds into a
directory of this process's own, removed at exit; :func:`cache_state`
reports ``hit`` (a library already on disk was loaded), ``built`` (this
process compiled it) or ``off`` (nothing built or loaded yet).
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

from tsne_flink_tpu_torch.obs import trace as obtrace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_S = ctypes.c_size_t

#: C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "tsne_knn_f32": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "tsne_knn_cross_f32": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P],
    "tsne_knn_bf16": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "tsne_knn_cross_bf16": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P],
    "tsne_repulsion_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "tsne_fused_step_f32": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P,
                            _P, _P, _P, _P, _F, _F, _F, _F, _P, _P, _P, _P,
                            _P],
    "tsne_attraction_loss_f32": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                 _F, _P, _P, _P],
    "tsne_attraction_forces_f32": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                   _F, _P, _P],
    "tsne_refine_chunk_f32": [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I,
                              _I, _P, _P, _I, _I, _I, _P, _P, _P, _S, _P],
    # the float64 forms: the same operands, float64 values and scalars
    "tsne_knn_f64": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "tsne_knn_cross_f64": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P],
    "tsne_repulsion_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "tsne_fused_step_f64": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P,
                            _P, _P, _P, _P, _D, _D, _D, _D, _P, _P, _P, _P,
                            _P],
    "tsne_attraction_loss_f64": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                 _D, _P, _P, _P],
    "tsne_attraction_forces_f64": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                   _D, _P, _P],
    "tsne_refine_chunk_f64": [_P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I,
                              _I, _P, _P, _I, _I, _I, _P, _P, _P, _S, _P],
}
# the wide forms of B2-B5 (m > 8): the narrow forms' operands; B6's
# unstaged form (F > 12,288): the staged form's and its scratch (a
# pointer and the bytes a row) before the stream
for _name in ("repulsion", "fused_step", "attraction_loss",
              "attraction_forces"):
    for _t in ("f32", "f64"):
        SIGNATURES[f"tsne_{_name}_wide_{_t}"] = SIGNATURES[
            f"tsne_{_name}_{_t}"]
for _t in ("f32", "f64"):
    SIGNATURES[f"tsne_refine_chunk_unstaged_{_t}"] = SIGNATURES[
        f"tsne_refine_chunk_{_t}"][:-1] + [_P, _S, _P]


#: seconds a process waits for another's build of the same library, and
#: the age past which a build lock counts as left by a process that died
#: while building
BUILD_WAIT_S = 900.0
BUILD_LOCK_STALE_S = 600.0

_CACHE_ENABLED: bool | None = None  # None / True: the keyed library
_PRIVATE_DIR: Path | None = None
_STATE = "off"


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when an identical build was already on disk
    log: str         # nvcc's output (the -Xptxas -v resource lines)


def set_cache(enabled: bool | None) -> None:
    """``True``/``None``: build into and reuse the keyed library under
    ``kernels/build/``; ``False``: build into a directory of this
    process's own, removed at exit (takes effect at the next build; a
    library already loaded in this process stays loaded)."""
    global _CACHE_ENABLED
    _CACHE_ENABLED = enabled


def cache_enabled() -> bool | None:
    """The current :func:`set_cache` value (callers save and restore it
    around a run, as ``utils/cli.main`` does)."""
    return _CACHE_ENABLED


def cache_state() -> str:
    """``hit`` | ``built`` | ``off``: how this process got its kernel
    library."""
    return _STATE


def _build_dir() -> Path:
    global _PRIVATE_DIR
    if _CACHE_ENABLED is not False:
        return BUILD_DIR
    if _PRIVATE_DIR is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _PRIVATE_DIR = Path(tempfile.mkdtemp(prefix=f"private_{os.getpid()}_",
                                             dir=BUILD_DIR))
        atexit.register(shutil.rmtree, _PRIVATE_DIR, True)
    return _PRIVATE_DIR


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into the keyed library unless it exists: one
    ``nvcc -c`` per source, all running at once, then one link.  The
    build holds the library's cross-process lock; a process that finds the
    library built while it waited loads that file."""
    from tsne_flink_tpu_torch.obs import metrics
    from tsne_flink_tpu_torch.utils.locks import FileLock

    global _STATE
    root = _build_dir()
    root.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    out = root / f"libtsne_kernels_{digest}.so"
    if out.exists():
        _STATE = "hit"
        metrics.counter("kernels.library_hits").inc()
        return BuildResult(out, 0.0, "")
    lock = FileLock(str(out) + ".lock", stale_s=BUILD_LOCK_STALE_S)
    if not lock.acquire(timeout_s=BUILD_WAIT_S):
        raise RuntimeError(f"timed out after {BUILD_WAIT_S:.0f} s waiting "
                           f"for another process's build of {out}")
    try:
        if out.exists():
            _STATE = "hit"
            metrics.counter("kernels.library_hits").inc()
            return BuildResult(out, 0.0, "")
        got = _compile(root, digest, out)
    finally:
        lock.release()
    _STATE = "built"
    metrics.counter("kernels.library_builds").inc()
    return got


def _compile(root: Path, digest: str, out: Path) -> BuildResult:
    tag = f"{digest}.{os.getpid()}"
    objs = [root / f"{src.stem}_{tag}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    sp = obtrace.begin("kernels.build", cat="build")
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    try:
        logs = [(src.name, proc.communicate()[0], proc.returncode)
                for src, proc in zip(sources(), procs)]
        log = "".join(f"[{name}]\n{text}" for name, text, _ in logs)
        failed = [name for name, _, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        link = subprocess.run([nvcc(), *ARCH_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for proc in procs:
            proc.kill()  # a no-op for those that ended
            proc.wait()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
        sp.end()
    return BuildResult(out, sp.seconds, log)


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, once a process:
    a mesh's shard threads may ask for it together)."""
    with _LIBRARY_LOCK:
        return _library()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tsne_knn_config.argtypes = [_I, _P, _P, _P, _P]
    lib.tsne_knn_config.restype = ctypes.c_int
    lib.tsne_refine_route.argtypes = [_I, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _P]
    lib.tsne_refine_route.restype = _S
    lib.tsne_refine_scratch.argtypes = [_I, _I, _I, _I]
    lib.tsne_refine_scratch.restype = _S
    lib.tsne_repulsion_wide_config.argtypes = [_I, _I, _P, _P]
    lib.tsne_repulsion_wide_config.restype = ctypes.c_int
    lib.tsne_attraction_wide_config.argtypes = [_I, _I, _P, _P]
    lib.tsne_attraction_wide_config.restype = ctypes.c_int
    lib.tsne_error_string.argtypes = [ctypes.c_int]
    lib.tsne_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One hand-written kernel: its C entry point and its launch count
    (counted under a lock: a mesh's shards launch from their threads).
    ``entry`` calls another C entry point of the same kernel (B1's cross
    sweep), counted as a launch of it."""

    def __init__(self, symbol: str, kid: str = ""):
        self.symbol = symbol
        self.kid = kid
        self.launches = 0
        self._lock = threading.Lock()

    def __call__(self, *args) -> None:
        self.entry(self.symbol, *args)

    def entry(self, symbol: str, *args) -> None:
        import torch

        lib = library()
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, symbol)(*args, stream)
        if rc != 0:
            msg = lib.tsne_error_string(rc).decode()
            raise RuntimeError(f"{symbol} launch failed: CUDA error "
                               f"{rc} ({msg})")
        with self._lock:
            self.launches += 1
        for hook in LAUNCH_HOOKS:
            hook(self, symbol, args)


#: callables ``(kernel, symbol, args)`` told of every counted launch
#: (``analysis/audit/record``'s hook); empty, at no cost, otherwise
LAUNCH_HOOKS: list = []

#: the port's kernels by the id of the TPU kernel each replaces; B1's
#: bf16-operand form (mixed precision), the float64 forms of B1-B6, the
#: wide forms of B2-B5 (``w``: embeddings wider than 8) and B6's unstaged
#: form (``u``: rows wider than :data:`B6_STAGED_F_MAX`) count under names
#: of their own, so a run's launches tell the forms apart
KERNELS = {
    "B1": Kernel("tsne_knn_f32", "B1"),
    "B1_bf16": Kernel("tsne_knn_bf16", "B1_bf16"),
    "B1_f64": Kernel("tsne_knn_f64", "B1_f64"),
    "B2": Kernel("tsne_repulsion_f32", "B2"),
    "B2_f64": Kernel("tsne_repulsion_f64", "B2_f64"),
    "B3": Kernel("tsne_fused_step_f32", "B3"),
    "B3_f64": Kernel("tsne_fused_step_f64", "B3_f64"),
    "B4": Kernel("tsne_attraction_loss_f32", "B4"),
    "B4_f64": Kernel("tsne_attraction_loss_f64", "B4_f64"),
    "B5": Kernel("tsne_attraction_forces_f32", "B5"),
    "B5_f64": Kernel("tsne_attraction_forces_f64", "B5_f64"),
    "B6": Kernel("tsne_refine_chunk_f32", "B6"),
    "B6_f64": Kernel("tsne_refine_chunk_f64", "B6_f64"),
    "B6u": Kernel("tsne_refine_chunk_unstaged_f32", "B6u"),
    "B6u_f64": Kernel("tsne_refine_chunk_unstaged_f64", "B6u_f64"),
    "B2w": Kernel("tsne_repulsion_wide_f32", "B2w"),
    "B2w_f64": Kernel("tsne_repulsion_wide_f64", "B2w_f64"),
    "B3w": Kernel("tsne_fused_step_wide_f32", "B3w"),
    "B3w_f64": Kernel("tsne_fused_step_wide_f64", "B3w_f64"),
    "B4w": Kernel("tsne_attraction_loss_wide_f32", "B4w"),
    "B4w_f64": Kernel("tsne_attraction_loss_wide_f64", "B4w_f64"),
    "B5w": Kernel("tsne_attraction_forces_wide_f32", "B5w"),
    "B5w_f64": Kernel("tsne_attraction_forces_wide_f64", "B5w_f64"),
}


#: the widest embedding with a register-held instance of B2-B5 (the JAX
#: package's MPAD; M_NARROW in csrc/common.cuh); a wider one launches the
#: kernel's wide form
M_NARROW = 8
#: the kernels with a wide form
WIDE_FORMS = ("B2", "B3", "B4", "B5")
#: the widest row (features) whose values B6 stages in shared memory
#: (STAGED_F_MAX in csrc/knn_cand.cu); a wider one launches its unstaged
#: form, which reads the row from global memory
B6_STAGED_F_MAX = 12_288


def form_id(kid: str, float64: bool, m: int = 0) -> str:
    """The ``KERNELS`` entry kernel ``kid`` launches at width ``m`` (the
    last axis of its [N, m] operand): its wide form past :data:`M_NARROW`
    (B2-B5), B6's unstaged form past :data:`B6_STAGED_F_MAX`, its float64
    form at float64."""
    form = ""
    if kid in WIDE_FORMS and m > M_NARROW:
        form = "w"
    elif kid == "B6" and m > B6_STAGED_F_MAX:
        form = "u"
    return kid + form + ("_f64" if float64 else "")


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
