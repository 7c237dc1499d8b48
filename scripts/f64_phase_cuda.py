"""``chip_smoke.py``'s ``[f64]`` phase alone, on the card.

float64 on the card (``--dtype float64``): B1_f64 (FP64 tensor cores)
against its plain version at [full]'s shape (60,000 x 784, k = 90) and on
4,096 rows of [large]'s (1,306,127 x 50, k = 150), timed beside its
library yardstick with its bound; B2_f64-B5_f64 at m = 1..8 against their
plain versions (rtol 1e-12); B6_f64 against its plain version on the
stages of real refine chunks captured at float64 (the blobs' cascade and
exact stage, the cells' exact stage, the edge chunks, n_valid, k = 600 on
cuts), each timed with its bound; ``TSNE(dtype="float64")`` at [full]'s
configuration against the float32 fit of the same configuration
(launches, final KL within 0.05, label agreement; the same fit on the
test mesh of two shards bit for bit); B2_f64 and B3_f64 at its final y
and [full]'s CSR layout; the rows, blocks and FFT routes at float64;
``TSNE(dtype="float64", knn_method="project")`` at [project]'s
configuration against the float32 [project] run (B6_f64's launches,
recall@90 against B1_f64's graph, the final KL); the card against the
CPU at 2,500 x 50 (kNN ids, P ±1e-12, one iteration ±1e-9, the final KL;
the project kNN from the same draws).  With ``--cli``, also the batch
job's float64 gate on config 2's command line from a COO CSV (the exact
and the project kNN); with ``--large``, [large]'s run, B4_f64 / B5_f64
on its attraction pass in float64 (their timed records) and config 5's
shape at float64 end to end (B6_f64's launches, recall on B1_f64's rows
against the float32 run's, the final KL, the memory model).  About
eight minutes on one H100 with both options (the CPU's 1,000 iterations
of the card-against-CPU check, ~4 minutes on 4 threads, run beside the
rest).

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/f64_phase_cuda.py [--cli] [--large]

The card's name and power limit head the output.
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


def cli_gate(x, tmp):
    """The float32 config 2 line from a COO CSV of ``x``, then the float64
    gate on it."""
    coo = os.path.join(tmp, "mnist60k.csv")
    cs.write_coo(coo, x)

    def argv(out, *extra):
        return ["--input", coo, "--output", os.path.join(tmp, out),
                "--loss", os.path.join(tmp, out + ".loss"),
                "--dimension", str(x.shape[1]), "--perplexity",
                str(cs.PERPLEXITY), "--iterations", str(cs.ITERATIONS),
                "--randomState", "0", *extra]
    config2 = ("--knnMethod", "project", "--theta", "0.5")
    cs.run_cli("config 2", argv("c2.csv", *config2, "--noCache"))
    kl_32 = float(cs.np.loadtxt(os.path.join(tmp, "c2.csv.loss"),
                                delimiter=",", ndmin=2)[-1, 1])
    cs.cli_f64_gate(argv, config2, kl_32, tmp)


def large_pass(b1_rows):
    """[large]'s run (1,306,127 x 50 cells, project kNN, FFT, blocks),
    B5_f64 / B4_f64 on its attraction pass in float64, then config 5's
    shape at float64 end to end against it (``b1_rows``: the rows [f64]
    held B1_f64 on, with their exact distances)."""
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.ops.affinities import affinity_blocks
    xc, labels, z = cs.make_cells()
    cfg = TsneConfig(perplexity=cs.PERPLEXITY_CELLS, iterations=cs.ITERATIONS,
                     learning_rate=cs.fitsne_learning_rate(len(xc)),
                     repulsion="fft", fft_grid=1024, fft_interp=3)
    with cs.record_knn() as graph:
        y, losses = tsne_embed(xc, cfg, neighbors=cs.K_CELLS,
                               knn_method="project", seed=0)
    _, fwd_val, rev = affinity_blocks(graph[0], graph[1],
                                      cs.PERPLEXITY_CELLS)
    run = (y, float(losses[-1]), None, graph[0], fwd_val, rev, cfg)
    out = cs.f64_large_pass(run)
    counts, _ = cs.f64_large_run(xc, labels, z, run, b1_rows)
    return out, counts


def main() -> int:
    from tsne_flink_tpu_torch import TSNE, TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.models.tsne import _plan_layout
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    cs.phase_device()
    cs.phase_build()
    x, labels = cs.make_data()
    xl, labels_l, _ = cs.make_latent_blobs()
    xc, _, _ = cs.make_cells()
    tmp = tempfile.mkdtemp(prefix="tsne_f64_")
    cpu = None
    try:
        t_phase = time.perf_counter()
        cpu = cs.f64_cpu_start(tmp)
        errs, times, bnd, _, b1_rows = cs.phase_f64(x, xc)
        errs["B6_f64"], b6_shapes = cs.phase_b6_f64(x, xc)
        del xc
        t0 = time.perf_counter()
        kl32 = TSNE(perplexity=cs.PERPLEXITY, n_iter=cs.ITERATIONS,
                    repulsion="exact", attraction="csr",
                    random_state=0).fit(x).kl_divergence_
        print(f"[f64] float32 fit at [full]'s configuration: final KL "
              f"{kl32:.6f} ({time.perf_counter() - t0:.3f} s)")
        counts, y64, _ = cs.f64_embed_gate(x, labels, kl32)
        prep = prepare(x, neighbors=cs.K, perplexity=cs.PERPLEXITY)
        _, csr = _plan_layout(prep.jidx, prep.jval,
                              TsneConfig(perplexity=cs.PERPLEXITY,
                                         attraction="csr"))
        del prep
        t, b, e = cs.f64_full_kernels(y64, csr)
        del y64, csr
        rows = cs.f64_routes(x, xl, labels, labels_l, kl32)
        _, losses = tsne_embed(x, TsneConfig(perplexity=cs.PERPLEXITY,
                                             iterations=cs.ITERATIONS,
                                             repulsion="exact"),
                               neighbors=cs.K, knn_method="project", seed=0)
        project64, _ = cs.f64_project_gate(x, labels, float(losses[-1]))
        n = {**counts, "B5_f64": rows["B5_f64"],
             "B6_f64": project64["B6_f64"]}
        if "--cli" in sys.argv[1:]:
            cli_gate(x, tmp)
        if "--large" in sys.argv[1:]:
            (lt, lb, le), large64 = large_pass(b1_rows)
            t.update(lt)
            b.update(lb)
            e.update(le)
            n["B6_f64"] = large64["B6_f64"]
        cs.f64_card_vs_cpu(cpu)
        print(f"[f64] phase {time.perf_counter() - t_phase:.1f} s")
        t["B1_f64"], b["B1_f64"] = times, bnd
        (t["B6_f64"], b["B6_f64"], _), = [
            v for key, v in b6_shapes.items() if key[0] == "cells"]
        for kid in [k for k in cs.KERNEL_META
                    if k.endswith("_f64") and t.get(k)]:
            print(json.dumps(cs.kernel_record(
                kid, *cs.KERNEL_META[kid], n[kid],
                max(errs.get(kid, 0.0), e.get(kid, 0.0)), t[kid], b[kid])))
    except cs.SmokeFailure as err:
        print(f"f64_phase_cuda: FAIL: {err}", file=sys.stderr)
        return 1
    finally:
        if cpu is not None:
            cpu[0].kill()
            cpu[0].wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print("f64_phase_cuda: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
