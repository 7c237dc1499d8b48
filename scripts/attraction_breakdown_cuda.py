"""The attraction pass of the blocks layout on the card: kernel B5 over the
forward block beside the reverse edges' sorted segment sum, and kernel B4
beside the reverse edges' KL, at the smoke's two blocks shapes.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/attraction_breakdown_cuda.py [--root DIR] [--skip-large]

``--root`` imports the port from another tree, e.g. an unpacked earlier
commit, so that two versions are timed by the same script on one card.

Shapes (``chip_smoke.py``'s): ``[blocks]`` — 60,000 x 784 blobs, k = 90,
perplexity 30, the exact graph; ``[large]`` — the 1,306,127 x 50 cell
stand-in, k = 150, perplexity 50, the hybrid graph as ``tsne_embed``
draws it (seed 0).  Both go through ``affinity_blocks``; the embedding is
``chip_smoke.embedding_like`` (a spread 2-D layout).  The reverse edges
are taken without their padding, as ``optimize`` runs them.

Timed, each as the median of REPS single calls, each call after a 256 MiB
write that flushes the L2 cache (CUDA events; min-max beside it):

* the forces: B5 over the forward block, the reverse edges' segment sum
  (the plain edge-list forces), and the pair as ``optimize`` ran it before
  the two became one launch; where the tree has it, the one launch of B5
  that takes the reverse edges as its ragged part;
* the KL: B4 over the forward block, the reverse edges' KL, the pair, and
  where the tree has it, B4's one launch with the ragged part.

Beside them: the bytes the pass must move (each input read once, the
output written once) over 3.35 TB/s, and the L2 sectors its gathers touch
(32 B per gathered neighbour row).  The card's name and power limit head
the output.
"""

import argparse
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REPS = 10
FLUSH_FLOATS = 1 << 26   # 256 MiB


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree to import tsne_flink_tpu_torch from")
    ap.add_argument("--skip-large", action="store_true",
                    help="time the [blocks] shape only")
    return ap.parse_args()


def flushed_ms(fn, reps=REPS):
    """CUDA-event ms of single calls of ``fn``, each after an L2 flush."""
    fn()
    flush = torch.empty(FLUSH_FLOATS, dtype=torch.float32, device="cuda")
    out = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def spread(ms):
    return (f"{statistics.median(ms):.4f} ms (min-max {min(ms):.4f}-"
            f"{max(ms):.4f}, {len(ms)} reps)")


def edge_helpers():
    """(edge forces, edge loss, without padding) of the imported tree:
    plain PyTorch over a src-sorted edge list."""
    from tsne_flink_tpu_torch.models import tsne
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    if hasattr(att, "edge_forces_plain"):
        return att.edge_forces_plain, att.edge_loss_plain, tsne._without_padding
    return tsne._edge_forces, tsne._edge_loss, tsne._without_padding


def blocks_layout(cs, tag):
    """(y, forward idx, forward val, reverse (src, dst, val) without
    padding) of one of the smoke's blocks shapes."""
    from tsne_flink_tpu_torch.models.tsne import knn_generator
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    dev = torch.device("cuda")
    if tag == "large":
        x, _, _ = cs.make_cells()
        prep = prepare(x, neighbors=cs.K_CELLS, knn_method="project",
                       generator=knn_generator(0, dev),
                       perplexity=cs.PERPLEXITY_CELLS, assembly="blocks",
                       device=dev)
    else:
        x, _ = cs.make_data()
        prep = prepare(x, neighbors=cs.K, perplexity=cs.PERPLEXITY,
                       assembly="blocks", device=dev)
    _, _, without_padding = edge_helpers()
    rev = without_padding(prep.extra_edges)
    y = cs.embedding_like(x.shape[0], 1)
    return y, prep.jidx, prep.jval, rev


def measure(cs, tag):
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    edge_forces, edge_loss, _ = edge_helpers()
    y, fidx, fval, (rsrc, rdst, rval) = blocks_layout(cs, tag)
    n, w = fidx.shape
    m = y.shape[1]
    e = int(rval.shape[0])
    lengths = torch.bincount(rsrc.long(), minlength=n)
    z = torch.tensor(float(n) * n, device=y.device)
    nnz = int((fval > 0).sum())
    fwd_bytes = fval.numel() * 4 + nnz * 4
    rev_bytes = 8.0 * e + 8.0 * (n + 1)
    planes = 2 * n * m * 4
    sectors = 32.0 * (nnz + e)
    print(f"[{tag}] {n} rows, forward block W={w} ({nnz} entries), {e} "
          f"reverse edges (max {int(lengths.max())} a row, "
          f"{int((lengths == 0).sum())} rows with none)")
    t = {
        "B5 forward": flushed_ms(lambda: att.attraction_forces(
            y, y, fidx, fval, 1.0)),
        "reverse segment sum": flushed_ms(lambda: edge_forces(
            y, y, rsrc, rdst, rval, 1.0, lengths)),
        "B5 + segment sum": flushed_ms(lambda: att.attraction_forces(
            y, y, fidx, fval, 1.0) + edge_forces(y, y, rsrc, rdst, rval, 1.0,
                                                 lengths)),
        "B4 forward": flushed_ms(lambda: att.attraction_loss(
            y, y, fidx, fval, 1.0, z)),
        "reverse edge loss": flushed_ms(lambda: edge_loss(
            y, y, rsrc, rdst, rval, 1.0, z, lengths)),
        "B4 + edge loss": flushed_ms(lambda: att.attraction_loss(
            y, y, fidx, fval, 1.0, z) + edge_loss(y, y, rsrc, rdst, rval,
                                                  1.0, z, lengths)),
    }
    if hasattr(att, "ragged_edges"):
        rag = att.ragged_edges(rsrc, rdst, rval, n)
        t["B5 one launch (forward + reverse)"] = flushed_ms(
            lambda: att.attraction_forces(y, y, fidx, fval, 1.0, ragged=rag))
        t["B4 one launch (forward + reverse)"] = flushed_ms(
            lambda: att.attraction_loss(y, y, fidx, fval, 1.0, z,
                                        ragged=rag))
    for name, ms in t.items():
        print(f"[{tag}] {name}: {spread(ms)}")
    bound_f = (fwd_bytes + rev_bytes + planes) / cs.PEAK_HBM_BYTES * 1e3
    bound_l = (fwd_bytes + rev_bytes + n * m * 4 + n * 4) \
        / cs.PEAK_HBM_BYTES * 1e3
    print(f"[{tag}] bytes bound of the whole pass: forces {bound_f:.4f} ms, "
          f"KL {bound_l:.4f} ms (forward {fwd_bytes / 1e9:.4f} GB, reverse "
          f"{rev_bytes / 1e9:.4f} GB); the gathers touch "
          f"{(nnz + e) / 1e6:.2f}M L2 sectors ({sectors / 1e9:.3f} GB at "
          f"32 B each)")


def main():
    args = parse()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    print(f"[tree] {os.path.abspath(args.root)}: "
          f"{'B5/B4 take a ragged part' if hasattr(att, 'ragged_edges') else 'B5/B4 over a row block only'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    measure(cs, "blocks")
    if not args.skip_large:
        measure(cs, "large")


if __name__ == "__main__":
    main()
