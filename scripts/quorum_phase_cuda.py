"""``chip_smoke.py``'s ``[quorum]`` phase alone, on the card.

It first makes the run the phase reuses, as the smoke makes it:
``[project]`` (config 2: 60,000 x 784 MNIST-like blobs, k = 90,
perplexity 30, the hybrid kNN, exact repulsion, 300 iterations), written
as a fat checkpoint, and runs ``[serve]``'s in-process daemon on it (the
rows/s the replicas are printed beside).  Then it removes the kernel
library's build directory, so that the clean fleet's two replicas build
the library themselves under its cross-process lock, and runs
``chip_smoke.phase_quorum``: the clean, kill, hang, watchdog, shed and
memory cases (the phase's docstrings say what each gates).  About two
minutes on one H100.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/quorum_phase_cuda.py

The card's name and power limit head the output.
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tsne_flink_tpu_torch import TsneConfig, tsne_embed  # noqa: E402


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    from tsne_flink_tpu_torch.serve.model import PlanConfig, load_frozen
    x, _ = cs.make_data()
    tmp = tempfile.mkdtemp(prefix="tsne_quorum_")
    try:
        path = os.path.join(tmp, "project.npz")
        cfg = TsneConfig(perplexity=cs.PERPLEXITY, iterations=cs.ITERATIONS,
                         repulsion="exact")
        with cs.record_prepare() as prep:
            y, losses = tsne_embed(x, cfg, neighbors=cs.K,
                                   knn_method="project", seed=0)
        cs.write_fat_checkpoint(path, y, losses, prep[0])
        del prep[:], y
        model = load_frozen(path, x, PlanConfig(
            n=cs.N_FULL, d=cs.F_FULL, k=cs.K, backend="cuda",
            name="project"), perplexity=cs.PERPLEXITY)
        solo = cs.serve_daemon(model, tmp, np.random.default_rng(0))
        del model
        t0 = time.perf_counter()
        cs.phase_quorum(x, path, tmp, solo, cold_build=True)
        print(f"[quorum] script {time.perf_counter() - t0:.1f} s")
    except cs.SmokeFailure as e:
        print(f"quorum_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
