"""``chip_smoke.py``'s ``[runtime]`` phase alone, on the card.

The memory model against the five full-size runs, the CUDA context
probe, the real OOM recovered by the ladder, the fault rehearsals, the
fleet of three 60,000 x 784 jobs and tracing's cost in bits (the phase's
docstrings say what each gates).  ``[serve]``'s memory gate runs in
that phase, not here.  About four minutes on one H100, against the whole
smoke's ten.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/runtime_phase_cuda.py

The card's name and power limit head the output.
"""

import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    x, _ = cs.make_data()
    xl, _, _ = cs.make_latent_blobs()
    xc, _, _ = cs.make_cells()
    tmp = tempfile.mkdtemp(prefix="tsne_runtime_")
    try:
        cs.phase_runtime(x, xl, xc, tmp, [], serial=True)
    except cs.SmokeFailure as e:
        print(f"runtime_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
