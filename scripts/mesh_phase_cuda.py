"""``chip_smoke.py``'s ``[mesh]`` phase alone, on the card.

It first makes what the phase reuses, as the smoke makes it: ``[full]``'s
plain run (60,000 x 784 MNIST-like blobs, k = 90, perplexity 30, exact
repulsion, the CSR layout, 300 iterations), the latent blobs' joint P
(the ``[rows]`` configuration) and ``[large]``'s run (1,306,127 x 50
synthetic cells, the hybrid kNN, FFT repulsion; its blocks-layout P).
Then it runs ``chip_smoke.phase_mesh`` — the sharded optimizer on the
test mesh (the one card listed once a shard) at mesh 1, 2 and 4, bits
across widths, launches, a checkpoint across widths, B2 at shard shapes
and the memory model — and, unless ``--skip-cli``, writes config 2's COO
file (~1 GB) and runs the CLI's mesh gates (``chip_smoke
.mesh_cli_gates``).  About three minutes on one H100.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/mesh_phase_cuda.py [--skip-cli]

The card's name and power limit head the output.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-cli", action="store_true",
                    help="skip the CLI gates (and the 1 GB COO file)")
    args = ap.parse_args()
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.ops.affinities import affinity_blocks
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    x, labels = cs.make_data()
    xl, _, _ = cs.make_latent_blobs()
    xc, _, _ = cs.make_cells()
    tmp = tempfile.mkdtemp(prefix="tsne_mesh_")
    try:
        cfg = TsneConfig(perplexity=cs.PERPLEXITY, iterations=cs.ITERATIONS,
                         repulsion="exact", attraction="csr")
        y, losses = tsne_embed(x, cfg, neighbors=cs.K, seed=0)
        full, csr_kl = (y, None), float(losses[-1])
        prep = prepare(xl, neighbors=cs.K, perplexity=cs.PERPLEXITY)
        rows = (prep.jidx, prep.jval)
        del prep
        n = xc.shape[0]
        cfg_l = TsneConfig(perplexity=cs.PERPLEXITY_CELLS,
                           iterations=cs.ITERATIONS,
                           learning_rate=cs.fitsne_learning_rate(n),
                           repulsion="fft", fft_grid=1024, fft_interp=3)
        stats = {}
        with cs.record_knn() as graph:
            y_l, loss_l = tsne_embed(xc, cfg_l, neighbors=cs.K_CELLS,
                                     knn_method="project", seed=0,
                                     stats=stats)
        _, fwd_val, rev = affinity_blocks(graph[0], graph[1],
                                          cs.PERPLEXITY_CELLS)
        large = (y_l, float(loss_l[-1]), stats["optimize"], graph[0],
                 fwd_val, rev, cfg_l)
        del graph[:], xc
        torch.cuda.synchronize()
        print(f"[mesh] script: the reused runs in "
              f"{time.perf_counter() - t0:.1f} s")
        cs.phase_mesh(x, labels, full, csr_kl, rows, large, tmp)
        del large
        if not args.skip_cli:
            coo = os.path.join(tmp, "mnist60k.csv")
            cs.write_coo(coo, x)

            def argv(out, *extra):
                return ["--input", coo, "--output", os.path.join(tmp, out),
                        "--loss", os.path.join(tmp, out + ".loss"),
                        "--dimension", str(x.shape[1]), "--perplexity",
                        str(cs.PERPLEXITY), "--iterations",
                        str(cs.ITERATIONS), "--randomState", "0", *extra]

            cs.mesh_cli_gates(x, argv, cs.run_cli,
                              ("--knnMethod", "project", "--theta", "0.5"))
        print(f"[mesh] script {time.perf_counter() - t0:.1f} s")
    except cs.SmokeFailure as e:
        print(f"mesh_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
