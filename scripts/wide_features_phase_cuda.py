"""``chip_smoke.py``'s ``[features]`` phase alone, at full size, on the card.

More than 12,288 features on a refining project plan, where B6 launches
its unstaged form (B6u, B6u_f64).  The data is ``chip_smoke.make_counts``:
a synthetic stand-in for 10x Genomics' "Fresh 68k PBMCs (Donor A)" raw
counts (Zheng et al., Nat. Commun. 2017), 68,579 cells x 32,738 genes,
~2% of a row detected, log1p per 10,000, densified on the card (8.98 GB,
2.245e9 elements).  The phase holds B6u and B6u_f64 against their plain
versions on a 64-row refine chunk captured from a 20,000-row cut, then
on the run's own 4,096-row chunks (B6u_f64's at the cut, B6u's at the
full size: the first chunk and the last, whose rows lie past 2^31 / F)
on 64-row slices of each launch, and times them there; it runs
``tsne_embed(x, TsneConfig(perplexity=30), knn_method="project")`` at
the full 68,579 x 32,738 (k = 90; the auto funnel: cascade at 128,
exact stage at F; 300 iterations) with its exact launches, stage split,
B1's exact graph (timed beside the hybrid plan) and recall@90 against
it, and the memory model against the run's peak, then the cut through
``TSNE(dtype="float64")``, ``TSNE(dtype="bfloat16")``, ``TSNE().fit``,
the command line on a COO CSV with ``--auditPlan``, two gloo processes
against the in-process job, and perplexity 500 (k = 1,500).

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/wide_features_phase_cuda.py [--root DIR] [--cut]
        [--no-routes] [--chunks]

``--root`` imports the port and its ``chip_smoke.py`` from another tree
(an unpacked earlier commit, to time it in the same call); ``--cut`` runs
the main run at the cut; ``--no-routes`` leaves the
cut's routes out; ``--chunks`` first times the exact stage a row at
several refine chunk sizes (64 to 4,096 rows) on the cut.  The card's
name and power limit head the output; the last line is the phase's
records as JSON.
"""

import argparse
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree to import tsne_flink_tpu_torch from")
    ap.add_argument("--cut", action="store_true",
                    help="the main run at the 20,000-row cut")
    ap.add_argument("--no-routes", action="store_true",
                    help="leave the cut's routes out")
    ap.add_argument("--chunks", action="store_true",
                    help="the exact stage's ms a row at several chunk sizes")
    return ap.parse_args()


def chunk_sizes(cs):
    """The exact stage (B6u, k = 90) at the cut over 4 consecutive chunks
    of each size, kernel ms a row."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    x, _, _, _ = cs.features_data(cs.N_COUNTS_CUT)
    plan = pick_knn_tiles(cs.N_COUNTS, cs.F_COUNTS, cs.K, "cuda")
    print(f"[features] tile plan at {cs.N_COUNTS} x {cs.F_COUNTS}: refine "
          f"chunk {plan.refine_chunk} rows")
    out = {}
    for c in (64, 256, 1024, 4096):
        chunks = cs.capture_refine_chunks(x, cs.K, 4, row_chunk=c)
        stages = [ch[-1] for ch in chunks]
        ms = cs.chunks_ms(stages)
        out[c] = ms / c
        print(f"[features] exact stage at c = {c}: {ms:.3f} ms a chunk, "
              f"{ms / c * 1e3:.3f} us a row")
        del chunks, stages
    del x
    torch.cuda.empty_cache()
    return out


def main() -> int:
    args = parse()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    cs.phase_device()
    cs.phase_build()
    print(f"[tree] {root}")
    rec = {}
    try:
        if args.chunks:
            rec["chunk_us_a_row"] = chunk_sizes(cs)
        x_np, _ = cs.make_data()
        errs, times, bnds, launches, recs = cs.phase_features(
            x_np, full=not args.cut, routes=not args.no_routes)
        rec.update({kid: {"launches": launches[kid],
                          "max_abs_err": errs[kid], "ms": times[kid][0],
                          "plain_ms": times[kid][1],
                          "bound_ms": bnds[kid][0],
                          "bound_by": bnds[kid][1]} for kid in errs})
        rec["runs"] = recs
    except cs.SmokeFailure as e:
        print(f"wide_features_phase_cuda: FAIL: {e}", file=sys.stderr)
        return 1
    print("wide_features_phase_cuda: OK")
    print(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
