"""``chip_smoke.py``'s ``[bigk]`` phase alone, on the card.

k past 1,024 (perplexity above 341): B1, its bf16 form and B1_f64 at k =
1,025, 1,500, 2,048 and 4,096 against their plain versions, in their
pending class; B6 and B6_f64 at k = 1,500 on captured refine stages (the
workspace route among them); ``TSNE(perplexity=500)`` at 60,000 x 784
on the exact and the project plan (launches, KL, label agreement,
recall@1,500, the memory model), the cross sweep and the ring at D = 2,
config 2's command line at ``--perplexity 500``, a 256-row serving
bucket, and B1's time at k = 1,500 beside its library yardstick and its
bound.  About three minutes on one H100.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/bigk_phase_cuda.py

The card's name and power limit head the output; the last line is the
phase's records as JSON.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    x, labels = cs.make_data()
    xc, _, _ = cs.make_cells()
    try:
        rec = cs.phase_bigk(x, labels, xc)
    except cs.SmokeFailure as e:
        print(f"bigk_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    print("bigk_phase_cuda: OK")
    print(cs.json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
