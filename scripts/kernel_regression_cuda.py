"""The kernels and stages of the main paths that a change must not slow
down, timed on the card for one tree: B1 at 60,000 x 784 (k = 90) and at
1,306,127 x 50 (k = 150), B2 at 60,000 x 2, B5 over the latent blobs'
[N, S] rows (S = 146) and the blobs' padded [N, S] rows (S = 3,474, 4%
filled) — the shapes of ``chip_smoke.py``'s ``[full]``, ``[large]`` and
``[rows]`` runs — and the CSR path: its plan stage (``build_csr``), the
``[full]`` and ``[project]`` runs end to end (stage seconds, peak memory,
a digest of the final embedding), and the CSR step at ``[full]``'s final
y as the tree's ``optimize`` runs it — one launch of B3 over head + tail
(rows in index order and in each of ``chip_smoke.visit_orders``, beside
the cost of building each), or, in a tree from before that launch, B5
over the tail + rep / Z + B3 over the head.

Run from the repository root on a machine with an sm_90a card and nvcc:

    python scripts/kernel_regression_cuda.py [--root DIR]

``--root`` imports the port (and its chip_smoke.py's data makers) from
another tree, e.g. an unpacked earlier commit; run the two trees in turns
in one call (parent, change, change, parent) to compare them on one card.
B1 is timed as the median (min-max) of 3 warm launches, the CSR step as
the median (min-max) of 6 means of 20 launches (CUDA events), the others
as the mean of 20-50 launches in a row, each after one warm-up; the plan
stage as the median of 3 host-clock calls ending in a synchronize.  The
card's name and power limit head the output.  Each float32 kernel's
output at those shapes is printed as a digest of its bytes (``out``): B1
and B1's bf16 form (60k), B2, B3's step, B4 over the CSR head + tail, B5
over both row layouts, B1 at 1.3M, and B6 through the ``[project]`` run's
y digest and on the funnel stages of real refine chunks: the first 32
chunks of a refine round at ``[project]``'s shape (the blobs' cascade at
F = 128 and exact stage at F = 784) and at ``[large]``'s (the cells'
exact stage at F = 50), and one chunk at the deep k (600 on 20,000-row
cuts of both, 1,024 on the cells' cut), each stage's outputs over its
chunks as one digest and its ms a chunk over them in sequence (the
median (min-max) of 3 runs after an L2 flush, ``chip_smoke.chunks_ms``);
two trees whose digests match give the same bits; with ``--b6`` each
stage's B6 routes too (``ops/knn_cuda.ROUTE_LAUNCHES``) and, where the
toolkit has cuobjdump, each B6 instance's registers and a digest of its
SASS (named ``refine_kernel<T, build, final, lanes, workspace>``; the
unstaged form's instances, F > 12,288, marked ``unstaged``), so two
trees' staged instances can be shown to be the same code.  ``--forms``
times B6's staged form against its unstaged form forced on the same
stages (``b6_forms``: F = 128, 784 and 12,288).  ``--widths`` runs
B2-B5 alone at every m = 1 .. 8 (the register-held instances) in
float32 and float64 at 60,000 rows of a seeded 10·N(0, 1) y, B3-B5 over
``[full]``'s CSR head + tail, each with its digest and its time (the
median (min-max) of 3 means of 5-20 launches).  ``--sass`` prints a
digest of each B2-B5 instance's SASS in the tree's library
(``cuobjdump -sass``: its instruction lines, the name without the
anonymous namespace's hash), so two trees' instances can be shown to be
the same code.  ``--b6u`` times B6's unstaged form (B6u and B6u_f64) on the
exact stage of ``chip_smoke.make_counts``'s 4,096-row refine chunks, every
chunk of one round captured as the tile plan cuts it, at the 20,000-row
cut and at the full 68,579 x 32,738 (the ms a chunk over the round's full
chunks in sequence after an L2 flush, the median (min-max) of 3, and a
digest of the chunks' outputs).  ``--wide`` times B2w (and B2w_f64) at
60,000 rows of a seeded 10·N(0, 1) y at m = 16 and 64 (the median
(min-max) of 3 means of 5 launches, and the output's digest), then B3w,
B5w and B4w (and their float64 forms) over ``[full]``'s CSR head + tail
at the same y (B3w's step hubs first, Z fixed at N²/3,000; the median
(min-max) of 3 means of 20 launches taken in turns, and each output's
digest).  ``--b6``
runs the
``[project]`` run and B6's stages alone; ``--b1`` runs B1 alone at
60,000 x 784 in each class up to k = 1,024 and each form: k = 90 (the
first class), 300 and 1,024 (the deep class) with 3xTF32, k = 90 with
bf16 operands, and k = 90 and 1,024 at float64, each with its digest.
"""

import argparse
import hashlib
import inspect
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def parse():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree to import tsne_flink_tpu_torch from")
    ap.add_argument("--b6", action="store_true",
                    help="the [project] run and B6's stages alone")
    ap.add_argument("--b1", action="store_true",
                    help="B1 alone, each class up to k = 1,024, each form")
    ap.add_argument("--widths", action="store_true",
                    help="B2-B5 alone at m = 1 .. 8, float32 and float64")
    ap.add_argument("--sass", action="store_true",
                    help="a digest of each B2-B5 instance's SASS")
    ap.add_argument("--b6u", action="store_true",
                    help="B6u / B6u_f64 on the raw counts' refine chunks")
    ap.add_argument("--wide", action="store_true",
                    help="B2w-B5w and their float64 forms at 60,000 x 16 "
                    "and x 64")
    ap.add_argument("--forms", action="store_true",
                    help="B6's staged form against its unstaged form "
                    "forced, at F = 128, 784 and 12,288")
    return ap.parse_args()


def digest(*ts):
    """The first 16 hex digits of the sha256 of tensors' bytes."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def spread(ms):
    return (f"{statistics.median(ms):.4f} ms (min-max {min(ms):.4f}-"
            f"{max(ms):.4f})")


def embed(tag, x_np, cfg, **kw):
    """One ``tsne_embed`` of the tree: its stage seconds, peak memory and a
    digest of its final embedding; returns the embedding."""
    from tsne_flink_tpu_torch import tsne_embed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    y, losses = tsne_embed(x_np, cfg, neighbors=90, seed=0, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"[regress] {tag}: {wall:.3f} s end to end, layout "
          f"{stats['layout']}; stages s: knn {stats['knn']:.4f}, affinities "
          f"{stats['affinities']:.4f}, plan {stats['plan']:.4f}, optimize "
          f"{stats['optimize']:.4f} "
          f"({stats['optimize'] / cfg.iterations * 1e3:.4f} ms/iter); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; final KL {float(losses[-1]):.6f}; y digest {digest}")
    return y


def csr_step(cs, att, y, csr):
    """The CSR step at ``y`` as this tree's optimize runs it, timed."""
    from tsne_flink_tpu_torch.models.tsne import _without_padding
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    hidx, hval = csr[:2]
    n = y.shape[0]
    rag = att.ragged_edges(*_without_padding(csr[2:]), n)
    rep, zrow = cuda_exact_repulsion(y, row_z=True)
    z = torch.sum(zrow)
    upd, gains = torch.zeros_like(y), torch.ones_like(y)
    kw = dict(eta=1000.0, min_gain=0.01)
    if "ragged" in inspect.signature(att.fused_step_update).parameters:
        args = (y, y, hidx, hval, 1.0, rep, z, None, upd, gains, 0.8)
        fns = {"B3 one launch, index order": lambda: att.fused_step_update(
            *args, ragged=rag, **kw)}
        for name, order in cs.visit_orders(y, rag).items():
            fns[f"B3 one launch, rows {name}"] = (
                lambda o: lambda: att.fused_step_update(
                    *args, ragged=rag, order=o, **kw))(order)
            fns[f"building the order {name}"] = (
                lambda n: lambda: cs.visit_orders(y, rag, n))(name)
    else:
        def step():
            tail = att.attraction_forces(y, y, None, None, 1.0, ragged=rag)
            return att.fused_step_update(y, y, hidx, hval, 1.0, tail, rep / z,
                                         None, upd, gains, 0.8, **kw)
        tail = att.attraction_forces(y, y, None, None, 1.0, ragged=rag)
        repz = rep / z
        fns = {
            "B5 tail + rep/Z + B3 head": step,
            "B3 head alone": lambda: att.fused_step_update(
                y, y, hidx, hval, 1.0, tail, repz, None, upd, gains, 0.8,
                **kw)}
    for name, fn in fns.items():
        out = fn()
        if name.startswith("B3 one launch, index") or name.startswith("B5"):
            print(f"[regress] CSR step at [full]'s final y: {name} out "
                  f"{digest(*out)}")
    loss = att.attraction_loss(y, y, hidx, hval, 1.0, z, ragged=rag) if (
        "ragged" in inspect.signature(att.attraction_loss).parameters) \
        else None
    if loss is not None:
        print(f"[regress] B4 at [full]'s final y over the head + tail: out "
              f"{digest(loss)}")
    times = {name: [] for name in fns}
    for _ in range(3):
        for name in [*fns, *reversed(fns)]:
            times[name].append(cs.cuda_ms(fns[name], 20, 0))
    for name, ms in times.items():
        print(f"[regress] CSR step at [full]'s final y, W={hidx.shape[1]} + "
              f"{int(rag.dst.shape[0])} tail edges: {name} {spread(ms)}")


def widths(cs, att, x_np, cfg):
    """B2-B5 at m = 1 .. 8 in float32 and float64 (see the module text)."""
    import numpy as np
    from tsne_flink_tpu_torch.models.tsne import (_plan_layout,
                                                  _without_padding)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    prep = prepare(x_np, neighbors=90, perplexity=30.0)
    _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    hidx = csr[0]
    n = hidx.shape[0]
    tail = _without_padding(csr[2:])
    del prep
    rng = np.random.default_rng(5)
    for dt, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
        hval = csr[1].to(dt)
        rag = att.ragged_edges(tail[0], tail[1], tail[2].to(dt), n)
        for m in range(1, 9):
            y = torch.from_numpy(10.0 * rng.standard_normal((n, m))).to(
                "cuda", dt)
            rep, zr = cuda_exact_repulsion(y, row_z=True)
            z = torch.sum(zr)
            upd = 1e-2 * torch.from_numpy(rng.standard_normal((n, m))).to(
                "cuda", dt)
            gains = 1.0 + torch.from_numpy(rng.random((n, m))).to("cuda", dt)
            calls = {
                "B2": (lambda: cuda_exact_repulsion(y, row_z=True), 5),
                "B3": (lambda: att.fused_step_update(
                    y, y, hidx, hval, 1.0, rep, z, None, upd, gains, 0.8,
                    eta=1000.0, min_gain=0.01, ragged=rag), 20),
                "B4": (lambda: att.attraction_loss(y, y, hidx, hval, 1.0, z,
                                                   ragged=rag), 20),
                "B5": (lambda: att.attraction_forces(y, y, hidx, hval, 1.0,
                                                     ragged=rag), 20)}
            for kid, (fn, reps) in calls.items():
                out = fn()
                out = out if isinstance(out, tuple) else (out,)
                ms = [cs.cuda_ms(fn, reps) for _ in range(3)]
                print(f"[regress] {kid}{sfx} m={m} {n} rows: {spread(ms)}; "
                      f"out {digest(*out)}")
            del y, rep, zr, upd, gains


def sass_digests():
    """A digest of each B2-B5 instance's SASS (see the module text)."""
    import re
    import shutil
    from tsne_flink_tpu_torch.kernels.build import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("[regress] sass: cuobjdump not found")
        return
    sass = subprocess.run([tool, "-sass", str(build().path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_[a-z_]+_cu_[0-9a-f]+")
    n = 0
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if not re.search(r"(repulsion|fused_step|loss|forces)_\w*kernel",
                         name):
            continue
        code = "\n".join(anon.sub("", ln) for ln in chunk.splitlines()
                         if "/*" in ln)
        print(f"[regress] sass {anon.sub('', name)}: "
              f"{hashlib.sha256(code.encode()).hexdigest()[:16]}")
        n += 1
    print(f"[regress] sass: {n} B2-B5 instances")


def b6_instances():
    """Each B6 instance of the tree's library (``cuobjdump``): its
    registers and a digest of its SASS instruction lines, by a name that
    two trees share: ``refine_kernel<T, build, final, lanes, workspace>``
    (``unstaged`` appended for the form past 12,288 features)."""
    import re
    import shutil
    from tsne_flink_tpu_torch.kernels.build import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("[regress] B6 instances: cuobjdump not found")
        return
    lib = str(build().path)

    def short(mangled):
        m = re.search(r"refine_kernelI([fd])((?:L[bi]\d+E)+)E", mangled)
        if m is None:
            return None
        flags = re.findall(r"L[bi](\d+)E", m.group(2))
        name = f"refine_kernel<{m.group(1)}, {', '.join(flags[:4])}>"
        return name + (" unstaged" if flags[4:] == ["0"] else "")
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    regs, fn = {}, None
    for line in res.splitlines():
        if "Function " in line:
            fn = short(line.split("Function ", 1)[1])
        elif fn and "REG:" in line:
            regs[fn] = int(line.split("REG:")[1].split()[0])
            fn = None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_[a-z_]+_cu_[0-9a-f]+")
    for chunk in sass.split("Function : ")[1:]:
        name = short(chunk.split(None, 1)[0])
        if name is None:
            continue
        code = "\n".join(anon.sub("", ln) for ln in chunk.splitlines()
                         if "/*" in ln)
        print(f"[regress] B6 instance {name}: {regs.get(name, '?')} "
              f"registers, sass {hashlib.sha256(code.encode()).hexdigest()[:16]}")


def b6_stages(cs, x_np, xc_np):
    """B6 on the funnel stages of refine chunks captured as the tree's
    refine round calls them: each stage's outputs over its chunks as one
    digest, its routes, and its ms a chunk over them in sequence."""
    from tsne_flink_tpu_torch.ops import knn_cuda as kc
    for tag, data, k, chunks in (
            ("[project] blobs", x_np, 90, 32),
            ("[large] cells", xc_np, 150, 32),
            ("blobs cut k=600", x_np[:20_000], 600, 1),
            ("cells cut k=600", xc_np[:20_000], 600, 1),
            ("cells cut k=1024", xc_np[:20_000], 1024, 1)):
        x = torch.from_numpy(data).cuda()
        got = cs.capture_refine_chunks(x, k, chunks)
        for s_idx, (kind, args, _) in enumerate(got[0]):
            stages = [chunk[s_idx] for chunk in got]
            outs = []
            kc.reset_route_launches()
            for st in stages:
                out = cs.stage_call(*st)
                outs += [t for t in (out if isinstance(out, tuple)
                                     else (out,)) if t is not None]
            routes = dict(kc.ROUTE_LAUNCHES)
            ms = [cs.chunks_ms(stages) for _ in range(3)]
            base = args[0] if kind == "keep" else args[1]
            print(f"[regress] B6 {tag} k={k} {kind} stage F="
                  f"{base.shape[1]}: {spread(ms)} a chunk over "
                  f"{len(stages)} chunks; routes {routes}; out "
                  f"{digest(*outs)}")
        del x, got


def b6_forms(cs, x_np):
    """B6's staged form against its unstaged form forced on the same
    captured stages (k = 90): the blobs' cascade (F = 128) and exact stage
    (F = 784) over 32 chunks of the tile plan's, and ``make_counts`` at
    20,000 x 12,288 (the widest staged F) over 16 of its chunks (128 rows)
    and 4 of 4,096 rows; each form's ms a chunk over them in sequence
    (the median (min-max) of 3 runs after an L2 flush, as
    ``chip_smoke.chunks_ms``) and whether their outputs' bytes agree."""
    from tsne_flink_tpu_torch.ops import knn_cuda as kc
    r, c, v, _ = cs.make_counts(20_000, 12_288)
    xw = cs.counts_dense(r, c, v, 20_000, 12_288)
    del r, c, v

    def launch(st, staged):
        kind, args, kwargs = st
        rows, base, sq = cs.stage_rows(kind, args)
        call = dict(n_valid=kwargs.get("n_valid"))
        if kind == "keep":
            call["keep"] = args[4]
        else:
            call.update(old=(args[5], args[6]),
                        euclid=args[0] == "euclidean")
        out = kc._refine_launch(base, sq, int(rows[0]),
                                args[3] if kind == "keep" else args[4],
                                kwargs.get("graph"), kwargs.get("ke", 0),
                                staged=staged, **call)
        return out if isinstance(out, tuple) else (out,)

    def timed(stages, staged):
        for st in stages[:2]:
            launch(st, staged)
        flush = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for st in stages:
            launch(st, staged)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / len(stages)

    for tag, x, chunks, rows in (
            ("blobs 60000x784", torch.from_numpy(x_np).cuda(), 32, None),
            ("counts 20000x12288", xw, 16, None),
            ("counts 20000x12288", xw, 4, 4096)):
        got = cs.capture_refine_chunks(x, 90, chunks, row_chunk=rows)
        for s_idx, (kind, args, _) in enumerate(got[0]):
            stages = [chunk[s_idx] for chunk in got]
            same = all(torch.equal(a, b) for st in stages for a, b in zip(
                launch(st, True), launch(st, False)))
            ms = {f: [timed(stages, f) for _ in range(3)]
                  for f in (True, False)}
            base = args[0] if kind == "keep" else args[1]
            print(f"[regress] B6 forms {tag} {kind} stage F={base.shape[1]} "
                  f"c={stages[0][1][3 if kind == 'keep' else 4].shape[0]}: "
                  f"staged {spread(ms[True])}, unstaged forced "
                  f"{spread(ms[False])} a chunk over {len(stages)} chunks; "
                  f"the same bytes: {same}")
        del got
    del xw


def b6u_chunks(cs):
    """B6u and B6u_f64 on the exact stage of the raw counts' refine
    chunks (see the module text): at the cut, then at the full size."""
    import torch
    for n in (cs.N_COUNTS_CUT, cs.N_COUNTS):
        x, _, _, _ = cs.features_data(n)
        for dt in (torch.float32, torch.float64):
            xd = x if dt == torch.float32 else x.double()
            finals = [ch[-1] for ch in cs.capture_refine_chunks(xd, cs.K,
                                                                None)]
            c = finals[0][1][4].shape[0]
            full = [st for st in finals if st[1][4].shape[0] == c]
            outs = []
            for st in finals:
                outs += list(cs.stage_call(*st))
            ms = [cs.chunks_ms(full) for _ in range(3)]
            kid = "B6u" + ("_f64" if dt == torch.float64 else "")
            print(f"[regress] {kid} counts {n} x {x.shape[1]} exact stage: "
                  f"{spread(ms)} a {c}-row chunk over {len(full)} chunks "
                  f"({len(finals)} in the round); out {digest(*outs)}")
            del finals, full, outs
            if dt == torch.float64:
                del xd
            torch.cuda.empty_cache()
        del x
        torch.cuda.empty_cache()


def wide_b2(cs):
    """B2w and B2w_f64 at 60,000 rows of a seeded spread y, m = 16 and 64."""
    import numpy as np
    import torch
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    for m in (16, 64):
        y0 = 10.0 * np.random.default_rng(m).standard_normal((60_000, m))
        for dt in (torch.float32, torch.float64):
            y = torch.from_numpy(y0).to("cuda", dt)
            out = cuda_exact_repulsion(y, row_z=True)
            ms = [cs.cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 5)
                  for _ in range(3)]
            kid = "B2w" + ("_f64" if dt == torch.float64 else "")
            print(f"[regress] {kid} 60000x{m}: {spread(ms)}; out "
                  f"{digest(*out)}")
            del y, out


def wide_csr(cs, att, x_np, cfg):
    """B3w, B4w and B5w (and their float64 forms) over [full]'s CSR head +
    tail at m = 16 and 64, on a seeded spread y (the B2w one): B3w's step
    with the rows hubs first as optimize runs it, B5w's forces and B4w's
    KL over head + tail, each with its digest and its time (the median
    (min-max) of 3 means of 20 launches, taken in turns)."""
    import numpy as np
    from tsne_flink_tpu_torch.models.tsne import (_plan_layout,
                                                  _without_padding)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    prep = prepare(x_np, neighbors=90, perplexity=30.0)
    _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    del prep
    hidx = csr[0]
    n = hidx.shape[0]
    tail = _without_padding(csr[2:])
    for m in (16, 64):
        y0 = 10.0 * np.random.default_rng(m).standard_normal((n, m))
        rng = np.random.default_rng(100 + m)
        upd0 = 1e-2 * rng.standard_normal((n, m))
        gains0 = 1.0 + rng.random((n, m))
        for dt in (torch.float32, torch.float64):
            sfx = "_f64" if dt == torch.float64 else ""
            y = torch.from_numpy(y0).to("cuda", dt)
            hval = csr[1].to(dt)
            rag = att.ragged_edges(tail[0], tail[1], tail[2].to(dt), n)
            order = att.visit_order(rag)
            rep, _ = cuda_exact_repulsion(y, row_z=True)
            # a fixed Z, so B4w's output does not follow B2w's bits
            z = torch.tensor(n * n / 3000.0, dtype=dt, device="cuda")
            upd = torch.from_numpy(upd0).to("cuda", dt)
            gains = torch.from_numpy(gains0).to("cuda", dt)
            fns = {
                "B3w": lambda: att.fused_step_update(
                    y, y, hidx, hval, 4.0, rep, z, None, upd, gains, 0.8,
                    eta=1000.0, min_gain=0.01, ragged=rag, order=order),
                "B5w": lambda: att.attraction_forces(y, y, hidx, hval, 4.0,
                                                     ragged=rag),
                "B4w": lambda: att.attraction_loss(y, y, hidx, hval, 4.0, z,
                                                   ragged=rag)}
            outs = {}
            for kid, fn in fns.items():
                out = fn()
                outs[kid] = digest(*(out if isinstance(out, tuple)
                                     else (out,)))
            times = {kid: [] for kid in fns}
            for _ in range(3):
                for kid in [*fns, *reversed(fns)]:
                    times[kid].append(cs.cuda_ms(fns[kid], 20, 0))
            for kid in fns:
                print(f"[regress] {kid}{sfx} [full]'s CSR {n}x{m}, W="
                      f"{hidx.shape[1]} + {int(rag.dst.shape[0])} tail "
                      f"edges: {spread(times[kid])}; out {outs[kid]}")
            del y, rep, upd, gains, hval, rag, order


def main():
    args = parse()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, _plan_layout
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.knn_cuda import knn_sweep_cuda
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"[tree] {root}")
    torch.backends.cuda.matmul.allow_tf32 = False

    def b1(x, k, *operands):
        out = knn_sweep_cuda(x, k, False, *operands)
        ms = [cs.cuda_ms(lambda: knn_sweep_cuda(x, k, False, *operands), 1,
                         0) for _ in range(3)]
        return f"{spread(ms)}; out {digest(*out)}"

    x_np, _ = cs.make_data()
    cfg = TsneConfig(perplexity=30.0, iterations=300, repulsion="exact",
                     attraction="csr")
    if args.sass:
        sass_digests()
        return
    if args.forms:
        b6_forms(cs, x_np)
        return
    if args.b6u or args.wide:
        if args.wide:
            wide_b2(cs)
            wide_csr(cs, att, x_np, cfg)
        if args.b6u:
            b6u_chunks(cs)
        return
    if args.widths:
        widths(cs, att, x_np, cfg)
        return
    if args.b1:
        x = torch.from_numpy(x_np).cuda()
        for k in (90, 300, 1024):
            print(f"[regress] B1 60000x784 k={k}: {b1(x, k)}")
        print(f"[regress] B1 bf16 form 60000x784 k=90: "
              f"{b1(x, 90, torch.bfloat16)}")
        x = x.double()
        for k in (90, 1024):
            print(f"[regress] B1 f64 form 60000x784 k={k}: {b1(x, k)}")
        del x
        if not args.b6:
            return
    if args.b6:
        embed("[project] 60000x784 project", x_np,
              TsneConfig(perplexity=30.0, iterations=300, repulsion="exact"),
              knn_method="project")
        b6_stages(cs, x_np, cs.make_cells()[0])
        b6_instances()
        return
    y_full = embed("[full] 60000x784 CSR", x_np, cfg)
    embed("[project] 60000x784 project", x_np,
          TsneConfig(perplexity=30.0, iterations=300, repulsion="exact"),
          knn_method="project")
    x = torch.from_numpy(x_np).cuda()
    print(f"[regress] B1 60000x784 k=90: {b1(x, 90)}")
    print(f"[regress] B1 bf16 form 60000x784 k=90: "
          f"{b1(x, 90, torch.bfloat16)}")
    y = cs.embedding_like(x.shape[0], 1)
    print(f"[regress] B2 60000x2: "
          f"{cs.cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20):.4f}"
          f" ms; out {digest(*cuda_exact_repulsion(y, row_z=True))}")
    prep = prepare(x_np, neighbors=90, perplexity=30.0)
    plan = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
        torch.cuda.synchronize()
        plan.append(time.perf_counter() - t0)
    print(f"[regress] plan stage (build_csr) 60000 x S={prep.jidx.shape[1]}"
          f" -> W={csr[0].shape[1]}: {statistics.median(plan):.4f} s "
          f"(min-max {min(plan):.4f}-{max(plan):.4f})")
    csr_step(cs, att, y_full, csr)
    ji, jv = prep.jidx, prep.jval
    print(f"[regress] B5 60000 x W={ji.shape[1]} (blobs rows, "
          f"{float((jv > 0).float().mean()):.3f} filled): "
          f"{cs.cuda_ms(lambda: att.attraction_forces(y, y, ji, jv, 1.0), 50):.4f}"
          f" ms; out {digest(att.attraction_forces(y, y, ji, jv, 1.0))}")
    del x, prep, csr, ji, jv
    xl_np, _, _ = cs.make_latent_blobs()
    prep = prepare(xl_np, neighbors=90, perplexity=30.0)
    ji, jv = prep.jidx, prep.jval
    print(f"[regress] B5 60000 x W={ji.shape[1]} (latent-blobs rows): "
          f"{cs.cuda_ms(lambda: att.attraction_forces(y, y, ji, jv, 1.0), 50):.4f}"
          f" ms; out {digest(att.attraction_forces(y, y, ji, jv, 1.0))}")
    del prep, ji, jv, y
    xc_np, _, _ = cs.make_cells()
    xc = torch.from_numpy(xc_np).cuda()
    print(f"[regress] B1 {xc.shape[0]}x{xc.shape[1]} k=150: {b1(xc, 150)}")
    del xc
    b6_stages(cs, x_np, xc_np)


if __name__ == "__main__":
    main()
