"""The sharded optimizer's cost of driving D shards from one process, on
one card (the test mesh).

[full]'s configuration (60,000 x 784 MNIST-like blobs, k = 90,
perplexity 30, exact repulsion, the CSR fused step, 300 iterations)
through ``parallel/mesh.ShardedOptimizer`` at mesh 1, 2 and 4, the
shards on the one card, in turns (1, 2, 4, 4, 2, 1): the milliseconds an
iteration of each (host clock to the device's end, the layout's plan
included), each run checked against mesh 1's bits.  Then one profiled
window of 30 iterations at each width (``torch.profiler``; the rows
placed before it): the device's
busy share (the sum of the card's kernel times over the wall) and the
launches an iteration.  The shards share one card, so this measures the
host's cost of D shard threads (D x the launches, the barriers, the
interpreter lock), not a multi-GPU speed.

Run from the repository root on a machine with an sm_90a card:

    python scripts/mesh_overhead_cuda.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import init_working_set
    from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    cs.phase_device()
    cs.phase_build()
    x, _ = cs.make_data()
    prep = prepare(torch.as_tensor(x, device="cuda"), neighbors=cs.K,
                   seed=0, perplexity=cs.PERPLEXITY, device="cuda")
    cfg = TsneConfig(perplexity=cs.PERPLEXITY, iterations=cs.ITERATIONS,
                     repulsion="exact", attraction="csr")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    st0 = init_working_set(gen, x.shape[0], 2, torch.float32, "cuda")
    ref = None
    for d in (1, 2, 4, 4, 2, 1):
        opt = ShardedOptimizer(cfg, x.shape[0], devices=["cuda:0"] * d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = opt(st0, prep.jidx, prep.jval)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ref = st.y if ref is None else ref
        same = bool(torch.equal(st.y, ref))
        print(f"[overhead] mesh {d}: {secs / cs.ITERATIONS * 1e3:.4f} "
              f"ms/iter, mesh 1's bits {same}")
        if not same:
            print("mesh_overhead_cuda: FAIL: bits differ", file=sys.stderr)
            return 1
    window = dataclasses.replace(cfg, iterations=30)
    for d in (1, 2, 4):
        opt = ShardedOptimizer(window, x.shape[0], devices=["cuda:0"] * d)
        opt.shard_inputs(prep.jidx, prep.jval)
        opt.segment(st0, window, start_iter=0, num_iters=30)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            opt.segment(st0, window, start_iter=0, num_iters=30)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time for e in kernels) / 1e6  # us -> s
        print(f"[overhead] mesh {d}, 30 iterations profiled: wall "
              f"{wall * 1e3:.3f} ms, the card busy {busy * 1e3:.3f} ms "
              f"({busy / wall:.3f} of the wall), {len(kernels) / 30:.1f} "
              "device operations an iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
