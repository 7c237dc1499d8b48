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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "tsne_knn_f32": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "tsne_repulsion_f32": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "tsne_fused_step_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                            _F, _F, _F, _F, _P, _P, _P, _P, _P],
    "tsne_attraction_loss_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P,
                                 _P],
    "tsne_attraction_forces_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    "tsne_cand_sqdist_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float   # 0.0 when an identical build was already on disk
    log: str         # nvcc's output (the -Xptxas -v resource lines)


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
    ``nvcc -c`` per source, all running at once, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    out = BUILD_DIR / f"libtsne_kernels_{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources()]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
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
    return BuildResult(out, time.perf_counter() - t0, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tsne_error_string.argtypes = [ctypes.c_int]
    lib.tsne_error_string.restype = ctypes.c_char_p
    return lib


class Kernel:
    """One hand-written kernel: its C entry point and its launch count."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def __call__(self, *args) -> None:
        import torch

        lib = library()
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, self.symbol)(*args, stream)
        if rc != 0:
            msg = lib.tsne_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1


#: the port's kernels by the id of the TPU kernel each replaces
KERNELS = {
    "B1": Kernel("tsne_knn_f32"),
    "B2": Kernel("tsne_repulsion_f32"),
    "B3": Kernel("tsne_fused_step_f32"),
    "B4": Kernel("tsne_attraction_loss_f32"),
    "B5": Kernel("tsne_attraction_forces_f32"),
    "B6": Kernel("tsne_cand_sqdist_f32"),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
