"""The kernels of the main paths that a change must not slow down, timed on
the card for one tree: B1 at 60,000 x 784 (k = 90) and at 1,306,127 x 50
(k = 150), B2 at 60,000 x 2, B3 over the 60k CSR run's head (W = 256) and
B5 over the latent blobs' [N, S] rows (S = 146) — the shapes of
``chip_smoke.py``'s ``[full]``, ``[large]`` and ``[rows]`` runs — and B5
over the blobs' padded [N, S] rows (S = 3,474, 4% filled).

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/kernel_regression_cuda.py [--root DIR]

``--root`` imports the port (and its chip_smoke.py's data makers) from
another tree, e.g. an unpacked earlier commit; run the two trees in turns
in one call (parent, change, change, parent) to compare them on one card.
B1 is timed as the median (min-max) of 3 warm launches, the others as the
mean of 20-50 launches in a row, each after one warm-up (CUDA events).
The card's name and power limit head the output.
"""

import argparse
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree to import tsne_flink_tpu_torch from")
    return ap.parse_args()


def main():
    args = parse()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, _plan_layout
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_sweep_cuda
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"[tree] {root}")
    torch.backends.cuda.matmul.allow_tf32 = False

    def b1(x, k):
        knn_sweep_cuda(x, k, False)
        ms = [cs.cuda_ms(lambda: knn_sweep_cuda(x, k, False), 1, 0)
              for _ in range(3)]
        return (f"{statistics.median(ms):.4f} ms (min-max {min(ms):.4f}-"
                f"{max(ms):.4f})")

    x_np, _ = cs.make_data()
    x = torch.from_numpy(x_np).cuda()
    print(f"[regress] B1 60000x784 k=90: {b1(x, 90)}")
    y = cs.embedding_like(x.shape[0], 1)
    print(f"[regress] B2 60000x2: "
          f"{cs.cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20):.4f}"
          f" ms")
    prep = prepare(x_np, neighbors=90, perplexity=30.0)
    _, csr = _plan_layout(prep.jidx, prep.jval,
                          TsneConfig(perplexity=30.0, attraction="csr"))
    hidx, hval = csr[:2]
    zeros = torch.zeros_like(y)
    ones = torch.ones_like(y)
    step = (y, y, hidx, hval, 1.0, zeros, zeros, None, zeros, ones, 0.8)
    print(f"[regress] B3 60000 x W={hidx.shape[1]}: "
          f"{cs.cuda_ms(lambda: att.fused_step_update(*step, eta=1000.0, min_gain=0.01), 50):.4f}"
          f" ms")
    ji, jv = prep.jidx, prep.jval
    print(f"[regress] B5 60000 x W={ji.shape[1]} (blobs rows, "
          f"{float((jv > 0).float().mean()):.3f} filled): "
          f"{cs.cuda_ms(lambda: att.attraction_forces(y, y, ji, jv, 1.0), 50):.4f}"
          f" ms")
    del x, prep, csr, hidx, hval, ji, jv
    xl_np, _, _ = cs.make_latent_blobs()
    prep = prepare(xl_np, neighbors=90, perplexity=30.0)
    ji, jv = prep.jidx, prep.jval
    print(f"[regress] B5 60000 x W={ji.shape[1]} (latent-blobs rows): "
          f"{cs.cuda_ms(lambda: att.attraction_forces(y, y, ji, jv, 1.0), 50):.4f}"
          f" ms")
    del prep, ji, jv, y
    xc_np, _, _ = cs.make_cells()
    xc = torch.from_numpy(xc_np).cuda()
    print(f"[regress] B1 {xc.shape[0]}x{xc.shape[1]} k=150: {b1(xc, 150)}")


if __name__ == "__main__":
    main()
