"""``chip_smoke.py``'s ``[bf16]`` phase alone, on the card.

B1's bf16-operand form (``--dtype bfloat16``, mixed precision) against
its plain version at [full]'s shape (60,000 x 784, k = 90) and [large]'s
(1,306,127 x 50, k = 150), its recall against the float64 graph beside
3xTF32's and the plain FP32 sweep's, its time beside 3xTF32's and its
library yardstick with its bound, then ``TSNE(dtype="bfloat16")`` at
[full]'s configuration against the float32 fit of the same configuration
(launches, final KL within 0.05, label agreement).  About two minutes on
one H100.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/bf16_phase_cuda.py

The card's name and power limit head the output.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    x, labels = cs.make_data()
    xc, _, _ = cs.make_cells()
    try:
        times, bnd, err = cs.phase_bf16(x, xc)
        del xc
        from tsne_flink_tpu_torch import TSNE
        t0 = time.perf_counter()
        kl32 = TSNE(perplexity=cs.PERPLEXITY, n_iter=cs.ITERATIONS,
                    repulsion="exact", attraction="csr",
                    random_state=0).fit(x).kl_divergence_
        print(f"[bf16] float32 fit at [full]'s configuration: final KL "
              f"{kl32:.6f} ({time.perf_counter() - t0:.3f} s)")
        counts = cs.bf16_embed_gate(x, labels, kl32)
        print(cs.json.dumps(cs.kernel_record(
            "B1_bf16", *cs.KERNEL_META["B1_bf16"], counts["B1_bf16"], err,
            times, bnd)))
    except cs.SmokeFailure as e:
        print(f"bf16_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    print("bf16_phase_cuda: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
