"""Where one refine round of the hybrid kNN spends its time on the card, at
the large run's shape (1,306,127 x 50 synthetic cells, k = 150, no
funnel: one exact stage scored by kernel B6).

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/b6_refine_breakdown_cuda.py [--root DIR]

``--root`` imports the port from another tree, e.g. an unpacked earlier
commit, so that two versions are timed by the same script on one card.

The seed graph is three Z-order rounds of ``knn_project`` (seed 0); one
refine round on it, with its draws made once and injected, is split into
the draws, the out-gateway pick, the reverse sample
(``_reverse_sample``), the gateway dedup and the chunk loop (the whole
round less the other parts).  The chunk loop is split per chunk (CUDA
events, summed over every chunk of the round):

* where the tree's B6 scores a [c, Z] candidate tensor built in PyTorch
  (``knn_cuda.cand_sqdist``): the candidate build + id sort, the masks,
  B6, the pre-top-k, the merge (``_dedup_smallest``);
* where B6 is the fused refine-chunk kernel (``knn_cuda.refine_final``):
  the kernel, and the copy of its rows into the round's graph.

Every part is timed three times (the round-level parts as host clock to
the end of the device's work); the median and min-max are printed.  The
card's name and power limit head the output.
"""

import argparse
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REPS = 3


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree to import tsne_flink_tpu_torch from")
    return ap.parse_args()


def host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, to the end of the
    device's work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class Events:
    """Summed CUDA-event milliseconds per named part."""

    def __init__(self):
        self.ms = {}
        self.pending = []

    def part(self, name, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        self.pending.append((name, a, b))
        return out

    def totals(self):
        torch.cuda.synchronize()
        for name, a, b in self.pending:
            self.ms[name] = self.ms.get(name, 0.0) + a.elapsed_time(b)
        self.pending = []
        return self.ms


def spread(vals, unit):
    return (f"{statistics.median(vals):.4f} {unit} (min-max {min(vals):.4f}"
            f"-{max(vals):.4f}, {len(vals)} reps)")


def gateways(tknn, idx, dr, s, k):
    gidx = idx.long()
    if s < k:
        score = dr.gate.clone()
        score[:, :max(1, s // 2)] = -math.inf
        _, gsel = tknn._topk_smallest(score, s)
        return torch.gather(gidx, 1, gsel)
    return gidx[:, :s]


def gateway_dedup(gate, rev, rows_g):
    us = torch.sort(torch.cat([gate, rev], dim=1), dim=1).values
    dupu = torch.zeros_like(us, dtype=torch.bool)
    dupu[:, 1:] = us[:, 1:] == us[:, :-1]
    return torch.where(dupu, rows_g[:, None], us)


def chunks_unfused(tknn, x, xcache, idx, dist, u_loc, plan, c, ev):
    """The chunk body that scores a [c, Z] candidate tensor with B6."""
    gidx = idx.long()
    nloc, k = idx.shape
    rows_g = torch.arange(nloc, device=x.device)
    for c0 in range(0, nloc, c):
        rc = rows_g[c0:c0 + c]
        cc = rc.shape[0]
        mine = u_loc[c0:c0 + c]
        cand = ev.part("candidate build + sort", lambda: torch.sort(
            torch.cat([mine, gidx[mine][..., :plan.ke].reshape(cc, -1)],
                      dim=1), dim=1).values)

        def masks():
            bad = cand == rc[:, None]
            bad[:, 1:] |= cand[:, 1:] == cand[:, :-1]
            return bad
        bad = ev.part("masks", masks)
        d2 = ev.part("B6 (cand_sqdist)", lambda: tknn._cand_exact(
            "sqeuclidean", x, xcache, rc, cand))
        dd = ev.part("masks", lambda: d2.masked_fill(bad, math.inf))

        def pretop():
            d, sel = tknn._topk_smallest(dd, k)
            return d, torch.gather(cand, 1, sel)
        dk, ck = ev.part("pre-top-k (_topk_smallest + gather)", pretop)
        ev.part("merge (_dedup_smallest)", lambda: tknn._dedup_smallest(
            torch.cat([idx[c0:c0 + c], ck.to(idx.dtype)], dim=1),
            torch.cat([dist[c0:c0 + c], dk], dim=1), k))
        ev.totals()


def chunks_fused(kc, x, xcache, idx, dist, u_loc, plan, c, ev):
    """The chunk body of the fused refine-chunk kernel."""
    nloc = idx.shape[0]
    u32 = u_loc.to(torch.int32)
    new_i, new_d = torch.empty_like(idx), torch.empty_like(dist)
    for c0 in range(0, nloc, c):
        ni, nd = ev.part("B6 (fused refine chunk)", lambda: kc.refine_final(
            "sqeuclidean", x, xcache, c0, u32[c0:c0 + c], idx[c0:c0 + c],
            dist[c0:c0 + c], graph=idx, ke=plan.ke))

        def store():
            new_i[c0:c0 + c] = ni
            new_d[c0:c0 + c] = nd
        ev.part("copy into the round's graph", store)
        ev.totals()


def main():
    args = parse()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from tsne_flink_tpu_torch.ops import knn as tknn
    from tsne_flink_tpu_torch.ops import knn_cuda as kc
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fused = hasattr(kc, "refine_final")
    print(f"[tree] {os.path.abspath(args.root)}: "
          f"{'fused refine-chunk B6' if fused else 'score-only B6'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    xc, _, _ = cs.make_cells()
    x = torch.from_numpy(xc).cuda()
    n, dim = x.shape
    k = cs.K_CELLS
    gen = torch.Generator(device=x.device).manual_seed(0)
    (idx, dist), t = host_s(lambda: tknn.knn_project(x, k, rounds=3,
                                                     generator=gen))
    print(f"[seed] {n}x{dim} k={k}: three Z-order rounds {t:.3f} s")
    plan = tknn._refine_plan(dim, k)
    c = pick_knn_tiles(n, dim, k, "cuda").refine_chunk
    s = plan.s
    print(f"[plan] s={s} ke={plan.ke} Z={plan.n_cand} chunk={c} "
          f"({math.ceil(n / c)} chunks)")
    rows_g = torch.arange(n, device=x.device)
    xcache = torch.sum(x * x, dim=1)

    parts = {name: [] for name in ("draws", "out-gateways", "reverse sample",
                                   "gateway dedup", "whole round")}
    chunk_ms = []
    for _ in range(REPS):
        dr, t = host_s(lambda: tknn.draw_refine(gen, plan, n, k, dim,
                                                x.dtype, x.device))
        parts["draws"].append(t)
        gate, t = host_s(lambda: gateways(tknn, idx, dr, s, k))
        parts["out-gateways"].append(t)

        def rev_fn():
            r = tknn._reverse_sample(idx, s, perm=dr.rev).long()
            return torch.where(r < 0, rows_g[:, None], r)
        rev, t = host_s(rev_fn)
        parts["reverse sample"].append(t)
        u_loc, t = host_s(lambda: gateway_dedup(gate, rev, rows_g))
        parts["gateway dedup"].append(t)
        del gate, rev
        _, t = host_s(lambda: tknn.knn_refine(x, idx, dist, rounds=1,
                                              draws=[dr]))
        parts["whole round"].append(t)
        ev = Events()
        body = chunks_fused if fused else chunks_unfused
        body(kc if fused else tknn, x, xcache, idx, dist, u_loc, plan, c, ev)
        chunk_ms.append(dict(ev.ms))
        del dr, u_loc
    loop = [w - g - r - d for w, g, r, d in zip(
        parts["whole round"], parts["out-gateways"], parts["reverse sample"],
        parts["gateway dedup"])]
    for name, vals in parts.items():
        print(f"[round] {name}: {spread(vals, 's')}")
    print(f"[round] chunk loop (whole round less gateways, reverse sample "
          f"and dedup): {spread(loop, 's')}")
    nchunks = math.ceil(n / c)
    for name in chunk_ms[0]:
        vals = [m[name] for m in chunk_ms]
        print(f"[chunk] {name}: {spread(vals, 'ms')} over the round's "
              f"{nchunks} chunks; {statistics.median(vals) / nchunks:.4f} ms "
              f"a chunk")
    tot = [sum(m.values()) for m in chunk_ms]
    print(f"[chunk] all parts: {spread(tot, 'ms')} a round, "
          f"{statistics.median(tot) / nchunks:.4f} ms a chunk")
    print(f"[memory] peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB")


if __name__ == "__main__":
    main()
