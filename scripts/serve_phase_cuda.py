"""``chip_smoke.py``'s ``[serve]`` phase alone, on the card.

It first makes the two runs the phase reuses, as the smoke makes them:
``[project]`` (config 2: 60,000 x 784 MNIST-like blobs, k = 90,
perplexity 30, the hybrid kNN, exact repulsion, 300 iterations), written
as a fat checkpoint, and ``[large]`` (1,306,127 x 50 synthetic cells,
k = 150, perplexity 50, the hybrid kNN, FFT repulsion, learning rate
N/3).  Then ``chip_smoke.phase_serve``: both frozen models' quality bars,
launches, bucket split, device busy share, B2/B5 at the serving shapes,
batch-split bits and peak memory, and the scheduled daemon on the 60k
model.  About a minute on one H100, against the whole smoke's five.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/serve_phase_cuda.py

The card's name and power limit head the output; the last line is the
B2/B5 records at the serving shapes as JSON.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from tsne_flink_tpu_torch import TsneConfig, tsne_embed  # noqa: E402


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    x, _ = cs.make_data()
    xc, _, _ = cs.make_cells()
    tmp = tempfile.mkdtemp(prefix="tsne_serve_")
    try:
        path = os.path.join(tmp, "project.npz")
        cfg = TsneConfig(perplexity=cs.PERPLEXITY, iterations=cs.ITERATIONS,
                         repulsion="exact")
        with cs.record_prepare() as prep:
            y, losses = tsne_embed(x, cfg, neighbors=cs.K,
                                   knn_method="project", seed=0)
        cs.write_fat_checkpoint(path, y, losses, prep[0])
        del prep[:], y
        cfg_l = TsneConfig(perplexity=cs.PERPLEXITY_CELLS,
                           iterations=cs.ITERATIONS,
                           learning_rate=cs.fitsne_learning_rate(len(xc)),
                           repulsion="fft", fft_grid=1024, fft_interp=3)
        y_l, _ = tsne_embed(xc, cfg_l, neighbors=cs.K_CELLS,
                            knn_method="project", seed=0)
        t0 = time.perf_counter()
        recs, counts = cs.phase_serve(x, path, (y_l,), xc, tmp)
        print(f"[serve] phase {time.perf_counter() - t0:.1f} s; launches "
              f"{json.dumps(counts)}")
    except cs.SmokeFailure as e:
        print(f"serve_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(recs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
