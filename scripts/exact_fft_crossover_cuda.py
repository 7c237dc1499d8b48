"""The crossovers the batch job's auto policies rest on, measured on the
card:

1. ``--repulsion auto`` (``utils/cli.EXACT_N_MAX["cuda"]``): one full
   iteration of ``optimize`` with exact repulsion (kernel B2) and with FFT
   repulsion, at N = 80,000, 100,000, 120,000 and 140,000.  The data are
   ``chip_smoke.make_cells`` cut to N rows (50 features), P from the
   hybrid kNN (k = 90, perplexity 30, seed 0) and the auto layout, the
   state ``chip_smoke.embedding_like`` (a spread 2-D layout) at iteration
   150 (final momentum, no exaggeration).  An iteration's time is the
   difference of two calls, 2R and R iterations long, over R (CUDA
   events), which removes each call's set-up; the two backends are timed
   in turns (exact, fft, fft, exact, three times), the median of each
   backend's six kept.  The
   crossover is the N where the two lines meet (linear between the
   bracketing sizes), and the constant is that N rounded down to a
   thousand.
2. ``pick_knn_method`` at ~800,000 x 50, k = 90: kernel B1's exact graph
   against the hybrid plan (auto seed rounds and refine cycles), each one
   host-clock call ending in a synchronize, in turns (exact, hybrid,
   hybrid, exact), beside the cost model's predictions from
   ``KNN_EXACT_EFF``/``KNN_HYBRID_EFF["cuda"]`` and the hybrid's recall.
3. The 3-D route (``utils/cli.EXACT_3D_N_MAX["cuda"]``): one full
   iteration at m = 3 with exact repulsion (B2) and with Barnes-Hut at
   θ = 0.25 (the defaulted θ a 3-D run gets), at N = 150,000, 300,000 and
   600,000, timed as in 1 with R3 iterations (exact, bh, bh, exact); the
   state is a spread 3-D layout (``embedding_like`` with a third axis).
   B2 grows as N² and BH as N, so the crossover is where the fitted
   a·N² and b·N (each fitted at the largest N) meet.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/exact_fft_crossover_cuda.py [--skip-2d] [--skip-knn]
        [--skip-3d]

The card's name and power limit head the output.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SIZES = (80_000, 100_000, 120_000, 140_000)
R = 40
N_KNN, K_KNN = 800_000, 90
SIZES_3D = (150_000, 300_000, 600_000)
R3 = 4


def iteration_ms(state, jidx, jval, cfg, edges, csr, r=R):
    """ms of one iteration: (2r iterations − r iterations) / r."""
    from tsne_flink_tpu_torch.models.tsne import optimize

    def run(num):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        optimize(state, jidx, jval, cfg, start_iter=150, num_iters=num,
                 edges=edges, edges_extra=False, csr=csr)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    run(2)  # warm-up
    return (run(2 * r) - run(r)) / r


def repulsion_crossover():
    import chip_smoke as cs
    from dataclasses import replace

    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import TsneState, _plan_layout
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    xc, _, _ = cs.make_cells(n=max(SIZES), d=cs.F_CELLS)
    rows = []
    for n in SIZES:
        x = torch.from_numpy(xc[:n]).cuda()
        prep = prepare(x, neighbors=cs.K, knn_method="project", seed=0,
                       perplexity=cs.PERPLEXITY)
        cfg = TsneConfig(perplexity=cs.PERPLEXITY, repulsion="exact")
        edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
        y = cs.embedding_like(n, seed=1)
        state = TsneState(y=y, update=torch.zeros_like(y),
                          gains=torch.ones_like(y))
        t = {"exact": [], "fft": []}
        for rep in ("exact", "fft", "fft", "exact") * 3:
            t[rep].append(iteration_ms(state, prep.jidx, prep.jval,
                                       replace(cfg, repulsion=rep), edges,
                                       csr))
        layout = ("csr" if csr is not None
                  else "rows" if edges is None else "edges")
        e, f = statistics.median(t["exact"]), statistics.median(t["fft"])
        print(f"[repulsion] N={n}: one iteration exact {e:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in t['exact'])}), fft "
              f"{f:.4f} ms ({', '.join(f'{v:.4f}' for v in t['fft'])}); "
              f"layout {layout}, assembly {prep.label}")
        rows.append((n, e, f))
        del prep, edges, csr, state, x
        torch.cuda.empty_cache()
    cross = None
    for (n0, e0, f0), (n1, e1, f1) in zip(rows, rows[1:]):
        d0, d1 = e0 - f0, e1 - f1
        if d0 <= 0 < d1:
            cross = n0 + (n1 - n0) * (-d0) / (d1 - d0)
    if cross is None:
        print("[repulsion] no crossover between "
              f"{SIZES[0]} and {SIZES[-1]}: exact − fft "
              + ", ".join(f"{e - f:+.4f}" for _, e, f in rows) + " ms")
    else:
        print(f"[repulsion] crossover N = {cross:.0f}; EXACT_N_MAX['cuda'] "
              f"= {int(cross) // 1000 * 1000}")


def bh_3d_crossover():
    import chip_smoke as cs
    from dataclasses import replace

    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import TsneState, _plan_layout
    from tsne_flink_tpu_torch.ops.repulsion_bh import (default_frontier,
                                                       default_levels)
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    xc, _, _ = cs.make_cells(n=max(SIZES_3D), d=cs.F_CELLS)
    rows = []
    for n in SIZES_3D:
        x = torch.from_numpy(xc[:n]).cuda()
        prep = prepare(x, neighbors=cs.K, knn_method="project", seed=0,
                       perplexity=cs.PERPLEXITY)
        cfg = TsneConfig(perplexity=cs.PERPLEXITY, n_components=3,
                         theta=0.25)
        edges, csr = _plan_layout(prep.jidx, prep.jval, cfg)
        y2 = cs.embedding_like(n, seed=1)
        z = cs.embedding_like(n, seed=2)[:, :1]
        y = torch.cat([y2, z], dim=1).contiguous()
        state = TsneState(y=y, update=torch.zeros_like(y),
                          gains=torch.ones_like(y))
        t = {"exact": [], "bh": []}
        torch.cuda.reset_peak_memory_stats()
        for rep in ("exact", "bh", "bh", "exact"):
            t[rep].append(iteration_ms(state, prep.jidx, prep.jval,
                                       replace(cfg, repulsion=rep), edges,
                                       csr, r=R3))
        e, b = statistics.median(t["exact"]), statistics.median(t["bh"])
        print(f"[3d] N={n} m=3: one iteration exact {e:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in t['exact'])}), bh "
              f"theta=0.25 (levels {default_levels(n, 3)}, frontier "
              f"{default_frontier(n, 3, None, 0.25)}) {b:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in t['bh'])}); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        rows.append((n, e, b))
        del prep, edges, csr, state, x, y
        torch.cuda.empty_cache()
    n, e, b = rows[-1]
    a, c = e / n ** 2, b / n
    cross = c / a
    faster = [f"{n0}: {'exact' if e0 < b0 else 'bh'}" for n0, e0, b0 in rows]
    print(f"[3d] faster: {', '.join(faster)}; exact a·N² and bh b·N meet at "
          f"N ~ {cross:.0f}; EXACT_3D_N_MAX['cuda'] = "
          f"{int(cross) // 1000 * 1000}")


def knn_crossover():
    import chip_smoke as cs

    from tsne_flink_tpu_torch.ops import knn as tknn
    from tsne_flink_tpu_torch.utils.flops import knn_flops

    xc, _, _ = cs.make_cells(n=N_KNN, d=cs.F_CELLS)
    x = torch.from_numpy(xc).cuda()
    n, d = x.shape
    rounds, refine = tknn.pick_knn_rounds(n), tknn.pick_knn_refine(n, d)

    def exact():
        return tknn.knn_bruteforce(x, K_KNN)

    def hybrid():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return tknn.knn(x, K_KNN, "project", generator=gen)

    secs = {"exact": [], "hybrid": []}
    out = {}
    for name in ("exact", "hybrid", "hybrid", "exact"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = (exact if name == "exact" else hybrid)()
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    kth = out["exact"][1][:, -1:] * (1 + 1e-5) + 1e-5
    recall = float((out["hybrid"][1] <= kth).double().mean())
    fl_e = knn_flops(n, d, K_KNN, "bruteforce")
    fl_h = knn_flops(n, d, K_KNN, "project", rounds=rounds,
                     refine_rounds=refine)
    pred_e = fl_e / tknn.KNN_EXACT_EFF["cuda"]
    pred_h = fl_h / tknn.KNN_HYBRID_EFF["cuda"]
    print(f"[knn] {n}x{d} k={K_KNN}: exact (B1) "
          f"{', '.join(f'{v:.3f}' for v in secs['exact'])} s (model "
          f"{pred_e:.3f} s), hybrid ({rounds} seed rounds + {refine} cycles) "
          f"{', '.join(f'{v:.3f}' for v in secs['hybrid'])} s (model "
          f"{pred_h:.3f} s); recall@{K_KNN} {recall:.4f}; measured "
          f"efficiencies exact {fl_e / min(secs['exact']):.3e}, hybrid "
          f"{fl_h / min(secs['hybrid']):.3e} FLOP/s; pick_knn_method -> "
          f"{tknn.pick_knn_method(n, d, K_KNN, 'cuda')}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-2d", action="store_true",
                    help="skip the 2-D exact/FFT crossover")
    ap.add_argument("--skip-knn", action="store_true",
                    help="skip the exact/hybrid kNN crossover")
    ap.add_argument("--skip-3d", action="store_true",
                    help="skip the 3-D exact/Barnes-Hut crossover")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exact_fft_crossover_cuda: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if not args.skip_2d:
        repulsion_crossover()
    if not args.skip_knn:
        knn_crossover()
    if not args.skip_3d:
        bh_3d_crossover()
    return 0


if __name__ == "__main__":
    sys.exit(main())
