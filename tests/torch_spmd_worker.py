"""One rank of a multi-controller job on the CPU, for
``tests/test_torch_multiprocess.py``: it imports torch and the port only.

    python tests/torch_spmd_worker.py '<json spec>'

``spec``: ``coordinator`` (host:port), ``world``, ``rank``, ``timeout_s``,
``out`` (a directory), ``kind``:

* ``pipeline`` — ``SpmdPipeline`` on ``x`` (an .npy) for each of ``arms``
  (``[method, sym_mode, attraction]``), saving ``y_<arm>_<rank>.npy`` and
  the runner's layout, then, given ``estimator`` (keywords),
  ``TSNE(spmd=True, ...)`` (``y_est_<rank>.npy``);
* ``cli`` — ``utils/cli.main(argv, device="cpu")`` with ``argv`` (given
  ``hbm_budget``, the memory model's device budget is that many bytes);
* ``raise`` — rank ``fail`` raises before its first collective, the other
  ranks run the ``pipeline`` kind.
"""

import json
import os
import sys


def run_arms(spec):
    import numpy as np
    import torch
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    x = torch.from_numpy(np.load(spec["x"]))
    n, d = x.shape
    out = {}
    for method, mode, attraction in spec["arms"]:
        cfg = TsneConfig(perplexity=spec["perplexity"],
                         iterations=spec["iterations"], repulsion="exact",
                         attraction=attraction)
        pipe = SpmdPipeline(cfg, n, d, spec["k"], knn_method=method,
                            sym_mode=mode, knn_refine=spec.get("refine"),
                            device="cpu")
        y, losses = pipe(x, spec["seed"])
        tag = f"{method}-{mode}-{attraction}"
        np.save(os.path.join(spec["out"], f"y_{tag}_{spec['rank']}.npy"),
                y.numpy())
        out[tag] = pipe._runner.layout
    if spec.get("estimator"):
        from tsne_flink_tpu_torch import TSNE
        est = TSNE(spmd=True, device="cpu", **spec["estimator"])
        np.save(os.path.join(spec["out"], f"y_est_{spec['rank']}.npy"),
                est.fit_transform(x.numpy()))
    with open(os.path.join(spec["out"], f"layouts_{spec['rank']}.json"),
              "w") as f:
        json.dump(out, f)


def main():
    spec = json.loads(sys.argv[1])
    # a rank yields the CPU to the timing-bound tests that share the host
    # (the serve fleet's heartbeat bounds); its results do not depend on it
    os.nice(10)
    import torch
    torch.set_num_threads(1)
    if spec["kind"] == "cli":
        from tsne_flink_tpu_torch.utils.cli import main as cli_main
        if spec.get("hbm_budget"):  # the memory model's budget, pinned
            from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
            PlanConfig.hbm_budget = lambda self: spec["hbm_budget"]
        return cli_main(spec["argv"], device="cpu")
    from tsne_flink_tpu_torch.parallel.mesh import distributed_init
    distributed_init(spec["coordinator"], spec["world"], spec["rank"],
                     device="cpu", timeout_s=spec["timeout_s"])
    if spec["kind"] == "raise" and spec["rank"] == spec["fail"]:
        raise RuntimeError(f"rank {spec['rank']} fails on purpose")
    run_arms(spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
