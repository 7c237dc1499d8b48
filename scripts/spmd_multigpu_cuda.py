"""The multi-controller job and the single-controller mesh across the
cards of one host: bits against one card, and seconds.

On a machine with D >= 2 cards (all visible): [full]'s configuration as
the command line runs it (60,000 x 784 MNIST-like blobs, seed 0, k = 90,
perplexity 30, exact repulsion, the auto layout, 300 iterations) through
``parallel/pipeline.SpmdPipeline``

* in this process on one card (mesh 1), the reference;
* in this process over the first 2 and D cards (the single-controller
  thread mesh, one card a shard);
* as 2 and D processes, one card a rank, over NCCL (the backend
  ``distributed_init`` picks when every rank has a card of its own).

Each run's y must equal mesh 1's bit for bit.  Printed: each run's
prepare and whole-job seconds (host clock, ending with the device's
work; a process job's from the slowest rank, with its own clock), and
the cards' names and power limits.

    python scripts/spmd_multigpu_cuda.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

#: one rank of the process job: prepare timed alone, then the whole job
RANK = r"""
import json, sys, time
import numpy as np, torch
from tsne_flink_tpu_torch import TsneConfig
from tsne_flink_tpu_torch.parallel.mesh import distributed_init
from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
spec = json.loads(sys.argv[1])
r = spec["rank"]
distributed_init(spec["coordinator"], spec["world"], r, timeout_s=300)
x = torch.from_numpy(np.load(spec["x"]))
pipe = SpmdPipeline(TsneConfig(**spec["cfg"]), x.shape[0], x.shape[1],
                    spec["k"])
torch.cuda.synchronize()
t0 = time.perf_counter()
pipe.prepare(x, 0)
torch.cuda.synchronize()
t_prep = time.perf_counter() - t0
t0 = time.perf_counter()
y, losses = pipe(x, 0)
torch.cuda.synchronize()
t_job = time.perf_counter() - t0
if r == 0:
    np.save(spec["y"], y.cpu().numpy())
print("RANK " + json.dumps({"rank": r, "backend": pipe.axis.backend,
                            "device": str(pipe.axis.device),
                            "prepare_s": t_prep, "job_s": t_job,
                            "kl": float(losses[-1])}))
"""


def in_process(x, devices):
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    pipe = SpmdPipeline(TsneConfig(**cs.spmd_cfg_kw()), x.shape[0],
                        x.shape[1], cs.K, devices=devices)
    xt = torch.from_numpy(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.prepare(xt, 0)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    y, losses = pipe(xt, 0)
    torch.cuda.synchronize()
    return y.cpu().numpy(), t_prep, time.perf_counter() - t0, float(
        losses[-1])


def main() -> int:
    import numpy as np
    import torch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    d = torch.cuda.device_count()
    if d < 2:
        print("spmd_multigpu_cuda: needs 2 or more cards", file=sys.stderr)
        return 1
    cs.phase_build()
    x, _ = cs.make_data()
    y1, p1, j1, kl1 = in_process(x, ["cuda:0"])
    print(f"[multigpu] mesh 1 (one card): prepare {p1:.3f} s, job "
          f"{j1:.3f} s, final KL {kl1:.6f}")
    ok = True
    widths = sorted({2, d})
    for w in widths:
        y, p, j, kl = in_process(x, [f"cuda:{i}" for i in range(w)])
        same = cs.same_bits(y, y1)
        ok &= same
        print(f"[multigpu] thread mesh over {w} cards: prepare {p:.3f} s, "
              f"job {j:.3f} s, y equal to mesh 1: {same}")
    tmp = tempfile.mkdtemp(prefix="tsne_multigpu_")
    np.save(os.path.join(tmp, "x.npy"), x)
    for w in widths:
        spec = dict(x=os.path.join(tmp, "x.npy"), y=os.path.join(tmp,
                                                                 "y.npy"),
                    k=cs.K, world=w, coordinator="{coord}",
                    cfg=cs.spmd_cfg_kw())
        rcs, secs, outs = cs.spmd_job(f"{w} processes", [
            [sys.executable, "-c", RANK, json.dumps(dict(spec, rank=r))]
            for r in range(w)], timeout=600)
        if rcs != [0] * w:
            print(outs[0][-3000:])
            return 1
        recs = [json.loads(line.split(" ", 1)[1]) for out in outs
                for line in out.splitlines() if line.startswith("RANK ")]
        same = cs.same_bits(np.load(spec["y"]), y1)
        ok &= same
        print(f"[multigpu] {w} processes ({recs[0]['backend']}, "
              f"{sorted(r['device'] for r in recs)}): prepare "
              f"{max(r['prepare_s'] for r in recs):.3f} s, job "
              f"{max(r['job_s'] for r in recs):.3f} s (slowest rank), "
              f"{secs:.1f} s with the processes' start; y equal to mesh "
              f"1: {same}")
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
