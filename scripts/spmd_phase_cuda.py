"""``chip_smoke.py``'s ``[spmd]`` phase alone, on the card.

It first makes what the phase reuses, as the smoke makes it: ``[full]``'s
final KL (60,000 x 784 MNIST-like blobs, k = 90, perplexity 30, exact
repulsion, the CSR layout, 300 iterations) and B1's time at that shape
(the median of 3 warm launches).  Then it runs ``chip_smoke.phase_spmd``:
the ring on the test mesh, B1's cross sweep a hop, B6 with ``n_valid``,
the in-process job at mesh 1 and 2, the NCCL route at world size 1, and
the two-process jobs on the one card (the command line, the project kNN
at float32 and at float64, the alltoall job, ``--symStrict``), the
float64 project kNN on the test mesh at D = 2 against D = 1 (bit for
bit), and prints the phase's two kernel records.  About three minutes on
one H100.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/spmd_phase_cuda.py

The card's name and power limit head the output.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_sweep_cuda

    cs.phase_device()
    cs.phase_build()
    t0 = time.perf_counter()
    x, labels = cs.make_data()
    cfg = TsneConfig(perplexity=cs.PERPLEXITY, iterations=cs.ITERATIONS,
                     repulsion="exact", attraction="csr")
    _, losses = tsne_embed(x, cfg, neighbors=cs.K, seed=0)
    csr_kl = float(losses[-1])
    xt = torch.from_numpy(x).cuda()
    b1 = cs.alternated_ms({"kernel": lambda: knn_sweep_cuda(xt, cs.K, False)},
                          ["kernel"] * 3)
    b1_ms = statistics.median(b1["kernel"])
    del xt
    print(f"[spmd] script: [full]'s final KL {csr_kl:.6f}, B1 {b1_ms:.4f} ms; "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        records = cs.phase_spmd(x, labels, csr_kl, b1_ms)
    except cs.SmokeFailure as e:
        print(f"spmd_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
