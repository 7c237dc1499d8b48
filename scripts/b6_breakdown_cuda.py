"""Where kernel B6's time goes on the card: variants of csrc/knn_cand.cu,
each with one part of the work changed, timed side by side on the stages
of real refine chunks.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/b6_breakdown_cuda.py

Each variant is the committed source with one text substitution, built by
nvcc into kernels/build/b6_variants/ and launched through the port's own
wrappers (``ops/knn_cuda.refine_keep`` / ``refine_final``) in place of
the committed kernel.  The stages are those chip_smoke.py holds: the
refine chunks of the blobs (60,000 x 784: the cascade stage at F = 128,
the exact stage at F = 784) and of the cells (1,306,127 x 50: the exact
stage at F = 50).  Variants marked "wrong" drop work the kernel needs
(the candidate gather, the merge's lookups, the sorts) and exist only to
price it.  Each stage runs over the first 32 chunks of a refine round in
sequence, as the round runs them (``chip_smoke.chunks_ms``); the median
and min-max of 3 such CUDA-event times a chunk are printed per variant,
with whether the variant gives the committed kernel's bits on the first
chunk.  The card's name and power limit head the output.
"""

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tsne_flink_tpu_torch.kernels import build as kb  # noqa: E402

CSRC = os.path.join(ROOT, "tsne_flink_tpu_torch", "csrc")
SRC = open(os.path.join(CSRC, "knn_cand.cu")).read()

LANES = "constexpr int NARROW_LANES = 8;"
GATHER = ("ga = fmaf(rq, __ldg(ba + q), ga);\n"
          "        gb = fmaf(rq, __ldg(bb + q), gb);")
LOOKUP = "for (int o = 0; o < p.k; ++o) {"
THREADS = "constexpr int THREADS = 256;"
BOUNDS = "__launch_bounds__(THREADS) refine_kernel"
SORT = "bitonic_sort(keys, L.sortcap);"

VARIANTS = {
    "committed (8 lanes a candidate below F = 64)": SRC,
    "1 lane a candidate below F = 64": SRC.replace(
        LANES, "constexpr int NARROW_LANES = 1;"),
    "4 lanes": SRC.replace(LANES, "constexpr int NARROW_LANES = 4;"),
    "16 lanes": SRC.replace(LANES, "constexpr int NARROW_LANES = 16;"),
    "32 lanes": SRC.replace(LANES, "constexpr int NARROW_LANES = 32;"),
    "128 threads a row": SRC.replace(THREADS, "constexpr int THREADS = 128;"),
    "512 threads a row": SRC.replace(THREADS, "constexpr int THREADS = 512;"),
    "at most 32 registers (8 blocks an SM)": SRC.replace(
        BOUNDS, "__launch_bounds__(THREADS, 8) refine_kernel"),
    "no sorts (wrong)": SRC.replace(SORT, "(void)keys;"),
    "no candidate gather (wrong)": SRC.replace(
        GATHER, "ga = fmaf(rq, rq, ga);\n        gb = fmaf(rq, rq, gb);"),
    "no merge lookups (wrong)": SRC.replace(
        LOOKUP, "for (int o = 0; o < 0; ++o) {"),
}


class Variant:
    """A variant library in the place of the committed B6."""

    def __init__(self, lib):
        self.fn = lib.tsne_refine_chunk_f32
        self.fn.argtypes = kb.SIGNATURES["tsne_refine_chunk_f32"]
        self.fn.restype = ctypes.c_int
        self.launches = 0

    def __call__(self, *args):
        rc = self.fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant launch failed: CUDA error {rc}")
        self.launches += 1


def build_all():
    """{variant: Variant}, every nvcc started at once."""
    out_dir = kb.BUILD_DIR / "b6_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(VARIANTS.items()):
        if i and src == SRC:
            raise SystemExit(f"variant {name!r} changed nothing: the "
                             "source no longer holds its pattern")
        path = out_dir / f"knn_cand_{i}.cu"
        path.write_text(src)
        lib = out_dir / f"libknn_cand_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [kb.nvcc(), *kb.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
             str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = sorted({ln.split("Used ")[1].split(",")[0]
                       for ln in log.splitlines() if "Used " in ln})
        print(f"[build] {name}: {', '.join(regs)}")
        out[name] = Variant(ctypes.CDLL(str(lib)))
    return out


def same_bits(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = build_all()
    committed = kb.KERNELS["B6"]
    xb, _ = cs.make_data()
    xc, _, _ = cs.make_cells()
    for tag, data, k in (("blobs", xb, cs.K), ("cells", xc, cs.K_CELLS)):
        x = torch.from_numpy(data).cuda()
        chunks = cs.capture_refine_chunks(x, k, cs.B6_TIMED_CHUNKS)
        for s_idx, (kind, args, kwargs) in enumerate(chunks[0]):
            f = cs.stage_rows(kind, args)[1].shape[1]
            name = f"{tag} {'cascade' if kind == 'keep' else 'exact'} F={f}"
            stages = [chunk[s_idx] for chunk in chunks]
            ref = cs.stage_call(kind, args, kwargs)
            for vname, var in variants.items():
                kb.KERNELS["B6"] = var
                try:
                    out = cs.stage_call(kind, args, kwargs)
                    ms = [cs.chunks_ms(stages) for _ in range(3)]
                finally:
                    kb.KERNELS["B6"] = committed
                print(f"[{name}] {vname}: {statistics.median(ms):.4f} ms "
                      f"(min-max {min(ms):.4f}-{max(ms):.4f}); the "
                      f"committed kernel's bits: {same_bits(out, ref)}")
        del x, chunks


if __name__ == "__main__":
    main()
