"""The memory model against the card, function by function.

``chip_smoke.py``'s ``[runtime]`` phase holds the memory model
(``tsne_flink_tpu_torch/analysis/audit/hbm.py``) to each full-size run's
measured peak.  This script runs the same five runs (``[full]``,
``[rows]``, ``[blocks]``, ``[project]``, ``[large]``) and also splits
each stage: every call of the functions that hold the large transients
(the kNN rounds, their merge, the reverse-edge sort, the refine round,
the affinity builders, the CSR build, the optimize loop) is bracketed by
peak marks, and its allocated peak is printed beside the bytes held when
it started.  The marks synchronize the device, so the times are not the
runs' own.  Then the fresh-process CUDA context probe.

Run from the repository root on a machine with an sm_90a card and nvcc
(about three minutes on one H100):

    python scripts/memory_model_cuda.py [tag ...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

#: (module, function) pairs bracketed by peak marks
WRAPPED = (
    ("tsne_flink_tpu_torch.ops.knn", "knn_bruteforce"),
    ("tsne_flink_tpu_torch.ops.knn", "knn_project"),
    ("tsne_flink_tpu_torch.ops.knn", "merge_rounds"),
    ("tsne_flink_tpu_torch.ops.knn", "_project_round"),
    ("tsne_flink_tpu_torch.ops.knn", "pairwise"),
    ("tsne_flink_tpu_torch.ops.knn", "_topk_smallest"),
    ("tsne_flink_tpu_torch.ops.knn", "_dedup_smallest"),
    ("tsne_flink_tpu_torch.ops.knn", "_reverse_sample"),
    ("tsne_flink_tpu_torch.ops.knn", "knn_refine"),
    ("tsne_flink_tpu_torch.ops.affinities", "pairwise_affinities"),
    ("tsne_flink_tpu_torch.ops.affinities", "split_width"),
    ("tsne_flink_tpu_torch.ops.affinities", "joint_distribution_split"),
    ("tsne_flink_tpu_torch.ops.affinities", "symmetrize_split_blocks"),
    ("tsne_flink_tpu_torch.ops.affinities", "edge_count"),
    ("tsne_flink_tpu_torch.ops.attraction_cuda", "build_csr"),
)


def main() -> int:
    import importlib

    import torch
    cs.phase_device()
    cs.phase_build()
    tags = sys.argv[1:] or list(cs.MEMORY_RUNS)
    data = {}
    need = {cs.MEMORY_RUNS[t][0] for t in tags}
    if "blobs" in need:
        data["blobs"] = cs.make_data()[0]
    if "latent" in need:
        data["latent"] = cs.make_latent_blobs()[0]
    if "cells" in need:
        data["cells"] = cs.make_cells()[0]
    if "blobs64" in need:
        data["blobs64"] = cs.make_data()[0].astype(cs.np.float64)
    for tag in tags:
        rec = {}
        reals = []

        def hook(tr, rec=rec, reals=reals):
            for modname, name in WRAPPED:
                mod = importlib.import_module(modname)
                real = getattr(mod, name)
                reals.append((mod, name, real))

                def wrapped(*a, _real=real, _name=name, **kw):
                    tr.mark()
                    held = torch.cuda.memory_allocated() - tr.base
                    out = _real(*a, **kw)
                    peak, _ = tr.mark()
                    rec.setdefault(_name, []).append((held, peak))
                    return out
                setattr(mod, name, wrapped)

        x_np = data[cs.MEMORY_RUNS[tag][0]]
        try:
            peaks, label, width, _, _ = cs.stage_peaks(
                tag, x_np, cs.memory_cfg(tag, x_np.shape[0]), hook)
        finally:
            for mod, name, real in reals:
                setattr(mod, name, real)
        print(f"[memory] {tag}: label {label} width {width}; stages " +
              ", ".join(f"{st} {a / 2**30:.3f} GiB ({r / 2**30:.3f} "
                        "reserved)" for st, (a, r) in peaks.items()))
        for name, calls in rec.items():
            held = max(h for h, _ in calls)
            peak = max(p for _, p in calls)
            print(f"[memory] {tag}:   {name} x{len(calls)}: peak "
                  f"{peak / 2**30:.3f} GiB, held at entry up to "
                  f"{held / 2**30:.3f} GiB")
        torch.cuda.empty_cache()
    context = cs.runtime_context()
    try:
        cs.runtime_memory(data, context, only=tags)
    except cs.SmokeFailure as e:
        print(f"memory_model_cuda: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
