"""Where kernel B1's time goes on the card: variants of csrc/knn.cu, each
with one part of the work changed, timed side by side.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/b1_breakdown_cuda.py

Each variant is the committed source with one text substitution, built by
nvcc into kernels/build/b1_variants/ and loaded with ctypes.  Variants
marked "wrong" or "inexact" drop work the kernel needs (the merge, the
exact flush, the TF32 split) and exist only to price that work: the
difference between the committed kernel and a variant is what the dropped
part costs.  Each shape prints the median and min-max of 3 warm CUDA-event
launches per variant, whether the variant gives the committed kernel's
bits, and, at 60,000 x 784, the library yardstick of chip_smoke.py.
The card's name and power limit head the output.
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
from tsne_flink_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, nvcc  # noqa: E402
from tsne_flink_tpu_torch.ops.knn_cuda import norm_pairs  # noqa: E402

CSRC = os.path.join(ROOT, "tsne_flink_tpu_torch", "csrc")
SRC = open(os.path.join(CSRC, "knn.cu")).read()

SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  lo = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;
"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
"""
FLUSH = """            two_sum(sh[i][j][e], acc[i][j][e], hi, err);
            sh[i][j][e] = hi;
            sl[i][j][e] += err;"""
PLAIN_FLUSH = "            sh[i][j][e] += acc[i][j][e];"
MERGE = "      while (rows) {"
NO_MERGE = "      while (false && rows) {"

VARIANTS = {
    "committed": SRC,
    "cvt.rna split": SRC.replace(SPLIT, CVT_SPLIT),
    "no merge (wrong)": SRC.replace(MERGE, NO_MERGE),
    "plain flush (inexact)": SRC.replace(FLUSH, PLAIN_FLUSH),
    "no split (wrong)": SRC.replace(SPLIT, "  hi = __float_as_uint(x);\n"
                                           "  lo = 0u;\n"),
    "product only (wrong)": SRC.replace(MERGE, NO_MERGE).replace(
        FLUSH, PLAIN_FLUSH),
}


def build_all():
    """{variant: loaded library}, every nvcc started at once."""
    out_dir = BUILD_DIR / "b1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(VARIANTS.items()):
        if name != "committed" and src == SRC:
            raise SystemExit(f"variant {name!r} changed nothing: the "
                             "source no longer holds its pattern")
        path = out_dir / f"knn_{i}.cu"
        path.write_text(src)
        procs[name] = (out_dir / f"libknn_{i}.so", subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
             str(out_dir / f"libknn_{i}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in lines
                       if "Used " in ln})
        spills = [ln.strip() for ln in lines
                  if "spill" in ln and "0 bytes spill stores" not in ln]
        print(f"[build] {name}: {', '.join(regs)}; "
              f"{'; '.join(spills) or 'no spills'}")
        cdll = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        cdll.tsne_knn_f32.argtypes = [p, p, i, i, i, i, p, p, p]
        libs[name] = cdll
    return libs


def launch(lib, x, norms, k):
    n, f = x.shape
    dist = torch.empty((n, k), device=x.device)
    idx = torch.empty((n, k), device=x.device, dtype=torch.int32)
    rc = lib.tsne_knn_f32(x.data_ptr(), norms.data_ptr(), n, f, k, 0,
                          dist.data_ptr(), idx.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return dist, idx


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_all()
    xb, _ = cs.make_data()
    xc, _, _ = cs.make_cells(n=300_000)
    shapes = {
        "60000x784 k=90": (torch.from_numpy(xb).cuda(), 90),
        "300000x50 (padded to 64) k=150": (torch.nn.functional.pad(
            torch.from_numpy(xc).cuda(), (0, 14)).contiguous(), 150),
    }
    for tag, (x, k) in shapes.items():
        norms = norm_pairs(x)
        ref = launch(libs["committed"], x, norms, k)
        for name, lib in libs.items():
            out = launch(lib, x, norms, k)
            same = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            ms = [cs.cuda_ms(lambda: launch(lib, x, norms, k), 1, 0)
                  for _ in range(3)]
            print(f"[{tag}] {name}: {statistics.median(ms):.3f} ms "
                  f"(min-max {min(ms):.3f}-{max(ms):.3f}); the committed "
                  f"kernel's bits: {same}")
        if x.shape[1] == 784:
            ms = [cs.cuda_ms(lambda: cs.library_knn(x, k), 1, 0)
                  for _ in range(3)]
            print(f"[{tag}] library (chunked matmul + topk): "
                  f"{statistics.median(ms):.3f} ms (min-max {min(ms):.3f}-"
                  f"{max(ms):.3f})")


if __name__ == "__main__":
    main()
