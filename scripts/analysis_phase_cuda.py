"""``chip_smoke.py``'s ``[analysis]`` phase alone, on the card.

It first makes what the phase reuses, as the smoke's ``[cli]`` phase
makes it: the 60,000 x 784 MNIST-like blobs written as a COO CSV, and
config 2's command line (``--knnMethod project --theta 0.5``) run once
through the port's ``main`` (its embedding and launches).  Then it runs
``chip_smoke.phase_analysis``: ``--auditPlan`` on that command line at
the kNN graph's width bound and as given (the gate's report and seconds,
predicted vs measured peak, the same bits),
a plan the memory model puts above the card refused before any launch,
``--executionPlan`` at 60k, and the ``--audit`` of ``python -m
tsne_flink_tpu_torch.analysis`` on the card.  About two minutes on one
H100.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/analysis_phase_cuda.py

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
    x, _labels = cs.make_data()
    tmp = tempfile.mkdtemp(prefix="tsne_analysis_")
    try:
        coo = os.path.join(tmp, "mnist60k.csv")
        cs.write_coo(coo, x)

        def argv(out, *extra):
            return ["--input", coo, "--output", os.path.join(tmp, out),
                    "--loss", os.path.join(tmp, out + ".loss"),
                    "--dimension", str(x.shape[1]), "--perplexity",
                    str(cs.PERPLEXITY), "--iterations", str(cs.ITERATIONS),
                    "--randomState", "0", *extra]

        config2 = ("--knnMethod", "project", "--theta", "0.5")
        y, counts, _, _ = cs.run_cli("config 2", argv("c2.csv", *config2,
                                                      "--noCache"))
        cs.phase_analysis(x, argv, config2, y, counts, tmp)
    except cs.SmokeFailure as e:
        print(f"analysis_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("analysis_phase_cuda: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
