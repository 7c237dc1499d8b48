"""What the autopilot's two approximations cost in quality, on the card.

``tsne_embed`` at perplexity 30, k = 90, 300 iterations, exact
repulsion, on two of ``chip_smoke.py``'s data sets:

* the guardrail shape: 10,000 x 784 MNIST-like blobs (``make_data``,
  seed 0; the JAX package pins its landmark schedule's KL there);
* ``[rows]``'s 60,000 x 784 latent blobs (``make_latent_blobs``: 10
  clusters in a 3-D latent), where ``landmark="auto"`` engages under the
  autopilot.

Each with the plain loop, the autopilot with the landmark schedule off
(the stride alone), the landmark schedule without the autopilot, and
both, at seeds 0 and 1: the final KL, the 10-NN label agreement
(``chip_smoke.label_agreement``, 5k subsample) and the optimize
seconds.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/landmark_quality_cuda.py

The card's name and power limit head the output.
"""

import dataclasses
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main() -> int:
    if not torch.cuda.is_available():
        print("landmark_quality_cuda: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = TsneConfig(perplexity=cs.PERPLEXITY, iterations=cs.ITERATIONS)
    pilot = dataclasses.replace(cfg, autopilot=True)
    variants = (("plain", cfg, "off"), ("autopilot, landmark off", pilot,
                                        "off"),
                ("landmark on, autopilot off", cfg, "on"),
                ("autopilot + landmark on", pilot, "on"))
    x10, lab10 = cs.make_data(n=10_000)
    xl, labl, _ = cs.make_latent_blobs()
    for name, x, labels in (("blobs 10k", x10, lab10),
                            ("latent blobs 60k", xl, labl)):
        for seed in (0, 1):
            for tag, c, landmark in variants:
                stats = {}
                y, losses = tsne_embed(x, c, neighbors=cs.K, seed=seed,
                                       landmark=landmark, stats=stats)
                torch.cuda.synchronize()
                print(f"[landmark] {name} seed {seed} {tag}: final KL "
                      f"{float(losses[-1]):.6f}, 10-NN label agreement "
                      f"{cs.label_agreement(y, labels):.4f}, optimize "
                      f"{stats['optimize']:.4f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
