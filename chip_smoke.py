#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (tsne_flink_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — name, count, and nvidia-smi's name + power limit;
2. build   — nvcc of csrc/*.cu, one process per source, all at once
   (seconds + ptxas lines);
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main paths (B1 at 8,192 x 784; B2,
   B3, B4 at 60,000 rows; B5 and B4 at the three widths below; B6 on the
   candidate sets of a real refine chunk at both hybrid-kNN shapes), and
   one CSR step fused (B3) against unfused (B5 + tail + the vdM update);
4. full    — ``tsne_embed`` on 60,000 x 784 MNIST-like blobs (perplexity
   30, k = 90, exact repulsion, CSR attraction, 300 iterations): stage
   seconds, the launches of each kernel in that run (counted from 0 just
   before it), each kernel's CUDA-event time at the run's shapes beside its
   plain version's and its bound, peak memory, the loss trace, and the
   quality checks (finite, falling KL, 10-NN label agreement >= 0.9);
5. rows    — the default configuration (``attraction="auto"``) on
   60,000 x 784 "latent blobs" (10 clusters in a 3-D latent, lifted
   linearly to 784 dims), where auto must pick the rows layout: launches,
   the per-iteration split (B2, B5, B4/10, the rest), and the quality
   checks (finite, falling KL, label agreement within 0.05 of the latent
   itself);
6. blocks  — the blocks assembly on the blobs of phase 4: launches, the
   split with the reverse edges' segment sum, the checks of phase 4, and
   a final KL within 0.05 of phase 4's (both optimize the same P);
7. project — ``tsne_embed`` on the blobs of phase 4 with the hybrid kNN
   (``knn_method="project"``: 3 seed rounds + 6 refine cycles, B6 scoring
   every refine chunk) and exact repulsion: launches, the kNN substage
   seconds, recall@90 against B1's exact graph (>= 0.93), B6's time
   beside B1's, and the checks of phase 4;
8. large — ``tsne_embed`` at the shape of the 10x Genomics 1.3M mouse
   brain cells (1,306,127 x 50 principal components; a synthetic
   stand-in, see ``make_cells``): perplexity 50, k = 150, the hybrid kNN
   (3 + 5 cycles), FFT repulsion (grid 1024, p = 3), 300 iterations at
   FIt-SNE's large-N learning rate (``fitsne_learning_rate``):
   stage and kNN substage seconds, B1's exact graph at this shape (its
   time, and the hybrid's recall against it, >= 0.90), the FFT
   repulsion's per-iteration split (spread / FFTs / gather) beside B2's
   at 60,000 and at this N (the exact/FFT crossover), peak memory, and
   the quality checks (finite, falling KL, label agreement within 0.05
   of the latent's own);
9. determinism — two runs at N = 2,000 give the same bits, on the CSR
   path, the rows path, and the hybrid kNN + FFT path.

The widths at which B5 and B4 are held: the latent blobs' [N, S] rows
(S ~ 146), the blobs' [N, S] rows (S ~ 3,466: what attraction="rows"
runs there) and the blocks layout's forward block (W = k = 90).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON record of every kernel.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks at 700 W (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

N_FULL, F_FULL, CLASSES = 60_000, 784, 10
#: the 10x Genomics 1.3M mouse brain cells (BASELINE.json config 5) after
#: FIt-SNE's preprocessing: 1,306,127 cells x 50 principal components
N_CELLS, F_CELLS, CELL_TYPES = 1_306_127, 50, 30
PERPLEXITY_CELLS, K_CELLS = 50.0, 150
N_B1_CHECK = 8_192
N_DETERMINISM = 2_000
PERPLEXITY, K, ITERATIONS = 30.0, 90, 300
#: the final-KL gap allowed between two runs over the same P
#: (tsne_flink_tpu/models/autopilot.py KL_GUARDRAIL_TOL, copied)
KL_GUARDRAIL_TOL = 0.05


#: kernel id -> (name, source, the TPU kernel it replaces)
KERNEL_META = {
    "B1": ("knn", "tsne_flink_tpu_torch/csrc/knn.cu",
           "tsne_flink_tpu/ops/knn_pallas.py:73"),
    "B2": ("exact_repulsion", "tsne_flink_tpu_torch/csrc/repulsion.cu",
           "tsne_flink_tpu/ops/repulsion_pallas.py:33"),
    "B3": ("fused_step", "tsne_flink_tpu_torch/csrc/attraction.cu",
           "tsne_flink_tpu/ops/attraction_pallas.py:313"),
    "B4": ("attraction_loss", "tsne_flink_tpu_torch/csrc/attraction.cu",
           "tsne_flink_tpu/ops/attraction_pallas.py:156"),
    "B5": ("attraction_forces", "tsne_flink_tpu_torch/csrc/attraction.cu",
           "tsne_flink_tpu/ops/attraction_pallas.py:140"),
    "B6": ("cand_sqdist", "tsne_flink_tpu_torch/csrc/knn_cand.cu",
           "tsne_flink_tpu/ops/knn_pallas.py:264"),
}


def fitsne_learning_rate(n: int) -> float:
    """The learning rate a user sets at large N: FIt-SNE's default,
    max(200, N/12) for the usual gradient 4·Σ(p − q)q̃(y_i − y_j), times
    4 for this package's gradient, which has no factor 4
    (TsneHelpers.scala:311-317).  The default 1000 leaves a 1.3M-point
    map unconverged after 300 iterations."""
    return 4.0 * max(200.0, n / 12.0)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def make_data(n=N_FULL, d=F_FULL, classes=CLASSES, seed=0):
    """bench.py's make_data (10-class MNIST-like blobs in [0, 1]), with the
    labels it draws."""
    rng = np.random.default_rng(seed)
    centers = rng.random((classes, d)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    x = centers[labels] + 0.15 * rng.standard_normal((n, d)).astype(
        np.float32)
    return np.clip(x, 0.0, 1.0), labels


def make_cells(n=N_CELLS, d=F_CELLS, types=CELL_TYPES, latent=10, seed=0):
    """A stand-in for the 1.3M-cell PCA matrix (the real one is not in
    the repository): ``types`` cell types with Zipf-skewed sizes,
    Gaussian clusters in a ``latent``-D space, lifted to ``d`` dims by a
    random map with a decaying per-dim scale (as principal components
    decay), plus small noise.  Returns (x f32 [n, d], labels, latent z)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, types + 1)
    labels = rng.choice(types, n, p=p / p.sum())
    centers = 4.0 * rng.standard_normal((types, latent))
    z = (centers[labels] + rng.standard_normal((n, latent))).astype(
        np.float32)
    scale = np.exp(-np.arange(d) / 12.0).astype(np.float32)
    lift = rng.standard_normal((latent, d)).astype(np.float32) * scale
    x = z @ lift + 0.05 * scale * rng.standard_normal((n, d)).astype(
        np.float32)
    return x.astype(np.float32), labels, z


def make_latent_blobs(n=N_FULL, d=F_FULL, classes=CLASSES, seed=0):
    """10 Gaussian clusters in a 3-D latent, lifted linearly to ``d``
    dims with a little noise: data of low intrinsic dimension, whose kNN
    graph has few hubs.  Returns (x f32 [n, d], labels, the latent z)."""
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.random((classes, 3))
    labels = rng.integers(0, classes, n)
    z = centers[labels] + 0.3 * rng.standard_normal((n, 3))
    a = rng.standard_normal((3, d)) / np.sqrt(3.0)
    x = z @ a + 0.01 * rng.standard_normal((n, d))
    return x.astype(np.float32), labels, z


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of ops at the FP32 peak and bytes
    at the HBM rate."""
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def head_need(jval):
    """(valid entries, bytes) a head kernel needs from a row layout: every
    value (4 bytes a slot, to find the valid ones), and an index only for
    each valid entry (padding slots are skipped, their index never read)."""
    nnz = int((jval > 0).sum())
    return nnz, jval.numel() * 4 + nnz * 4


def embedding_like(n, seed):
    """A spread 2-D layout (10 clusters on a radius-30 ring) for the
    kernel checks: the magnitudes of an embedding mid-run."""
    import torch
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * rng.integers(0, 10, n) / 10
    y = np.stack([30 * np.cos(ang), 30 * np.sin(ang)], 1)
    y = y + 3.0 * rng.standard_normal((n, 2))
    return torch.from_numpy(y.astype(np.float32)).cuda()


def rel_close(a, b, rtol, what):
    """|a - b| <= rtol·|b| + rtol·max|b|, elementwise; returns max |a - b|."""
    import torch
    err = torch.abs(a - b)
    tol = rtol * torch.abs(b) + rtol * torch.max(torch.abs(b))
    bad = int(torch.sum(err > tol))
    check(bad == 0, f"{what}: {bad} elements beyond rtol {rtol} "
          f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(f"[device] {name} x{count}")
    print(smi.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, count


def phase_build():
    from tsne_flink_tpu_torch.kernels.build import build, library
    res = build()
    print(f"[build] nvcc {res.seconds:.2f} s -> {os.path.relpath(res.path)}")
    for line in res.log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())
    library()


def phase_kernels(x_np, xl_np):
    """Kernel vs plain on the card.  Returns each kernel's max abs error,
    the real CSR layout of the blobs, the latent blobs' [N, S] rows and
    the blobs' blocks layout (forward rows, reverse edges)."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import (TsneConfig, TsneState,
                                                  _plan_layout,
                                                  _update_embedding)
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.affinities import affinity_blocks
    from tsne_flink_tpu_torch.ops.knn_cuda import (_fused_final,
                                                   knn_sweep_cuda,
                                                   knn_sweep_plain)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion
    from tsne_flink_tpu_torch.utils.artifacts import prepare

    errs = {}
    # B1 at 8,192 x 784, k = 90
    xs = torch.from_numpy(x_np[:N_B1_CHECK]).cuda()
    ik, dk = _fused_final(*knn_sweep_cuda(xs, K, False), "sqeuclidean")
    ip, dp = _fused_final(*knn_sweep_plain(xs, K, False), "sqeuclidean")
    torch.cuda.synchronize()
    agree = float(torch.mean((ik == ip).float()))
    check(agree >= 0.999, f"B1 index agreement {agree:.5f} < 0.999")
    errs["B1"] = rel_close(dk, dp, 1e-4, "B1 distances")
    print(f"[kernels] B1 {N_B1_CHECK}x{F_FULL} k={K}: index agreement "
          f"{agree:.6f}, max |d err| {errs['B1']:.3e}")

    # B2 at 60,000 x 2
    y = embedding_like(N_FULL, 1)
    rk, zk = cuda_exact_repulsion(y, row_z=True)
    rp, zp = exact_repulsion(y, row_z=True)
    errs["B2"] = max(rel_close(rk, rp, 2e-5, "B2 rep"),
                     rel_close(zk, zp, 2e-5, "B2 row Z"))
    zt_k, zt_p = float(torch.sum(zk)), float(torch.sum(zp))
    check(abs(zt_k - zt_p) <= 2e-5 * abs(zt_p), "B2 global Z")
    print(f"[kernels] B2 {N_FULL}x2: max |rep err| {errs['B2']:.3e}, "
          f"Z {zt_k:.8e} vs {zt_p:.8e}")

    # B3 / B4 at 60,000 x W of the real CSR
    prep = prepare(x_np, neighbors=K, perplexity=PERPLEXITY)
    cfg = TsneConfig(perplexity=PERPLEXITY, attraction="csr")
    _, csr = _plan_layout(prep.jidx, prep.jval, cfg)
    hidx, hval, _, _, tval = csr
    exag, momentum = 1.0, 0.8
    repz = (rp / torch.sum(zp)).contiguous()
    att_p = att.attraction_forces_plain(y, y, hidx, hval, exag)
    # tie-free inputs: tail makes every grad (att + tail) - repz sit at
    # s·(|att| + 1e-3·max|att|), so the gains ladder's sign test has a
    # margin far above rounding while att still shapes grad
    rng = np.random.default_rng(2)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], y.shape).astype(
        np.float32)).cuda()
    mag = torch.abs(att_p) + 1e-3 * torch.max(torch.abs(att_p))
    tail = (repz - att_p + sign * mag).contiguous()
    upd = (1e-2 * torch.from_numpy(rng.standard_normal(y.shape).astype(
        np.float32)).cuda()).contiguous()
    gains = (1.0 + torch.from_numpy(rng.random(y.shape).astype(
        np.float32)).cuda()).contiguous()
    args = (y, y, hidx, hval, exag, tail, repz, None, upd, gains, momentum)
    kw = dict(eta=1000.0, min_gain=0.01)
    out_k = att.fused_step_update(*args, **kw)
    out_p = att.fused_step_plain(*args, **kw)
    check(torch.equal(out_k[2], out_p[2]), "B3 gains not exactly equal")
    errs["B3"] = max(rel_close(out_k[0], out_p[0], 1e-4, "B3 y"),
                     rel_close(out_k[1], out_p[1], 1e-4, "B3 update"))
    z = torch.sum(zp)
    lk = att.attraction_loss(y, y, hidx, hval, exag, z)
    lp = att.attraction_loss_plain(y, y, hidx, hval, exag, z)
    errs["B4"] = rel_close(lk, lp, 2e-5, "B4 per-row loss")
    check(abs(float(lk.sum()) - float(lp.sum()))
          <= 2e-5 * abs(float(lp.sum())), "B4 total loss")
    print(f"[kernels] B3/B4 {N_FULL}x{hidx.shape[1]} (S="
          f"{prep.jidx.shape[1]}, {int((hval > 0).sum())} head and "
          f"{int((tval > 0).sum())} tail edges): gains equal, max |y/upd "
          f"err| {errs['B3']:.3e}, max |loss err| {errs['B4']:.3e}")

    # the same CSR step unfused: B5's forces + tail, then the vdM update
    forces = att.attraction_forces(y, y, hidx, hval, exag)
    unfused = _update_embedding(TsneState(y, upd, gains),
                                (forces + tail) - repz, momentum,
                                TsneConfig(learning_rate=kw["eta"],
                                           min_gain=kw["min_gain"]))
    check(torch.equal(out_k[2], unfused.gains),
          "fused vs unfused step: gains not exactly equal")
    diff = max(rel_close(out_k[0], unfused.y, 1e-4, "fused vs unfused y"),
               rel_close(out_k[1], unfused.update, 1e-4,
                         "fused vs unfused update"))
    bits = (torch.equal(out_k[0], unfused.y)
            and torch.equal(out_k[1], unfused.update))
    print(f"[kernels] CSR step fused (B3) vs unfused (B5 + tail + update): "
          f"gains equal, max |y/upd diff| {diff:.3e}, bits equal: {bits}")

    # B5 and B4 at the three widths of the new paths
    prep_l = prepare(xl_np, neighbors=K, perplexity=PERPLEXITY)
    _, fwd_val, rev = affinity_blocks(prep.idx, prep.dist, PERPLEXITY)
    widths = {"latent-blobs rows": (prep_l.jidx, prep_l.jval),
              "blobs rows": (prep.jidx, prep.jval),
              "blobs blocks forward": (prep.idx, fwd_val)}
    errs["B5"] = 0.0
    for name, (ji, jv) in widths.items():
        fk = att.attraction_forces(y, y, ji, jv, 4.0)
        fp = att.attraction_forces_plain(y, y, ji, jv, 4.0)
        e5 = rel_close(fk, fp, 2e-5, f"B5 {name}")
        lk = att.attraction_loss(y, y, ji, jv, 1.0, z)
        lp = att.attraction_loss_plain(y, y, ji, jv, 1.0, z)
        e4 = rel_close(lk, lp, 2e-5, f"B4 {name}")
        check(abs(float(lk.sum()) - float(lp.sum()))
              <= 2e-5 * abs(float(lp.sum())), f"B4 {name} total loss")
        errs["B5"], errs["B4"] = max(errs["B5"], e5), max(errs["B4"], e4)
        print(f"[kernels] B5/B4 {name} {N_FULL}x{ji.shape[1]} "
              f"({int((jv > 0).sum())} entries): max |att err| {e5:.3e}, "
              f"max |loss err| {e4:.3e}")
    ji, jv = widths["blobs rows"]
    ms, plain_ms, bms, by, b4 = b5_times(y, ji, jv)
    print(f"[kernels] B5 at W={ji.shape[1]} (blobs rows): {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}); B4 there "
          f"{b4:.4f} ms")
    return errs, csr, widths["latent-blobs rows"], (prep.idx, fwd_val, rev)


def library_knn(x, k, chunk=1024):
    """One-PyTorch-call yardstick for B1: chunked matmul + topk."""
    import torch
    n = x.shape[0]
    r = torch.sum(x * x, 1)
    out = []
    for s in range(0, n, chunk):
        d = r[s:s + chunk, None] + r[None, :] - 2.0 * (x[s:s + chunk] @ x.T)
        d[torch.arange(d.shape[0]), torch.arange(s, s + d.shape[0])] = \
            float("inf")
        out.append(torch.topk(d, k, dim=1, largest=False))
    return out


def label_agreement(y, labels, n_sub=5000, nn=10, seed=3):
    import torch
    rng = np.random.default_rng(seed)
    sub = rng.choice(y.shape[0], min(n_sub, y.shape[0]), replace=False)
    ys = y[torch.from_numpy(sub).cuda()].double()
    d = torch.cdist(ys, ys)
    d.fill_diagonal_(float("inf"))
    nb = torch.topk(d, nn, dim=1, largest=False).indices.cpu().numpy()
    lab = labels[sub]
    return float(np.mean(lab[nb] == lab[:, None]))


def run_embed(tag, x_np, cfg, want, neighbors=K, knn_method="bruteforce",
              **kw):
    """One ``tsne_embed`` at full size, its launches counted from 0 just
    before it: prints the stage seconds, launches and peak memory, checks
    the launches against ``want`` (a dict, or a function of the run's
    stats); returns (y, losses, stats, launches)."""
    import torch
    from tsne_flink_tpu_torch import tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    y, losses = tsne_embed(x_np, cfg, neighbors=neighbors,
                           knn_method=knn_method, seed=0, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    n, f = x_np.shape
    print(f"[{tag}] {n}x{f} k={neighbors} knn {knn_method} perplexity="
          f"{cfg.perplexity} repulsion {cfg.repulsion} {cfg.iterations} "
          f"iterations, assembly {stats['assembly']}, layout "
          f"{stats['layout']}: {wall:.3f} s end to end")
    print(f"[{tag}] stages s: " + ", ".join(
        f"{k}={v:.4f}" for k, v in stats.items() if isinstance(v, float))
        + f", s/iter={stats['optimize'] / cfg.iterations:.6f}")
    print(f"[{tag}] knn substages s: " + ", ".join(
        f"{k}={v:.4f}" for k, v in stats["knn_substages"].items()))
    if callable(want):
        want = want(stats)
    print(f"[{tag}] launches {json.dumps(counts)}")
    print(f"[{tag}] peak memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
          "GiB of it held by this script before the run)")
    check(counts == want, f"[{tag}] launch counts {counts} != {want}")
    return y, losses, stats, counts


def quality(tag, y, losses, labels, cfg, min_agree):
    """Finite, falling KL, 10-NN label agreement >= ``min_agree``;
    returns the final KL."""
    import torch
    lh = losses.cpu().numpy()
    print(f"[{tag}] loss trace head {np.round(lh[:5], 5).tolist()} tail "
          f"{np.round(lh[-5:], 5).tolist()}; final KL {lh[-1]:.6f}")
    check(bool(torch.isfinite(y).all()) and bool(np.isfinite(lh).all()),
          f"[{tag}] non-finite embedding or loss")
    first_post = cfg.exaggeration_end // 10  # slot of iteration 110
    check(lh[-1] < lh[first_post], f"[{tag}] KL did not fall: {lh[-1]} vs "
          f"slot {first_post} {lh[first_post]}")
    agree = label_agreement(y, labels)
    print(f"[{tag}] 10-NN label agreement (5k subsample) {agree:.4f} "
          f"(bar {min_agree:.4f})")
    check(agree >= min_agree, f"[{tag}] label agreement {agree} < "
          f"{min_agree}")
    return float(lh[-1])


def want_launches(b3, b5, b1=1, b2=None, b6=0, b4=None):
    """Launches of one run; B2 and B4 default to every iteration and
    every 10th."""
    return {"B1": b1, "B2": ITERATIONS if b2 is None else b2, "B3": b3,
            "B4": ITERATIONS // 10 if b4 is None else b4, "B5": b5,
            "B6": b6}


def layout_launches(layout, **kw):
    """The launches of a run whose attraction layout resolved to
    ``layout``: B3 runs the CSR step, B5 the rows and blocks layouts' row
    part, B4 every layout with a row part."""
    it = ITERATIONS
    return want_launches(b3=it if layout == "csr" else 0,
                         b5=it if layout in ("rows", "blocks") else 0,
                         b4=0 if layout == "edges" else it // 10, **kw)


def b6_launches(n, d, k, cycles):
    """B6 launches of the hybrid plan: one per funnel stage (JL filter,
    cascade, exact) per refine chunk per cycle."""
    from tsne_flink_tpu_torch.ops import knn as tknn
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    fd = tknn.pick_knn_filter(d)
    plan = tknn._refine_plan(d, k, filter_dims=fd,
                             expand_k=(k + 1) // 2 if fd else None)
    stages = 1 + bool(plan.filter_dims) + bool(plan.cascade_dims)
    chunk = pick_knn_tiles(n, d, k, "cuda").refine_chunk
    return cycles * math.ceil(n / chunk) * stages


@contextlib.contextmanager
def record_knn():
    """Keep the graph the run's kNN stage returns (the list yielded gets
    (idx, dist)); the stage itself runs unchanged."""
    from tsne_flink_tpu_torch.ops import knn as tknn
    real = tknn.knn
    graph = []

    def recorded(*a, **kw):
        out = real(*a, **kw)
        graph[:] = out
        return out

    tknn.knn = recorded
    try:
        yield graph
    finally:
        tknn.knn = real


def recall_at_k(dist_approx, dist_exact, tol=1e-5):
    """scripts/measure_recall.recall_at_k: the approximate distances
    within the exact k-th (ties count as hits)."""
    import torch
    kth = dist_exact[:, -1:] * (1 + tol) + tol
    return float(torch.mean((dist_approx <= kth).double()))


def timed_exact_graph(x, k):
    """B1's exact graph of ``x`` and its seconds (host clock to the end
    of the device's work)."""
    import torch
    from tsne_flink_tpu_torch.ops.knn import knn_bruteforce
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx, dist = knn_bruteforce(x, k)
    torch.cuda.synchronize()
    return idx, dist, time.perf_counter() - t0


def kernel_record(kid, name, src, repl, launches, err, times, bnd):
    ms, plain_ms, lib_ms = times
    bms, by = bnd
    return {"name": f"{kid} {name}", "route": "cuda", "source": src,
            "replaces": repl, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def phase_full(x_np, labels, errs, csr):
    """The CSR run; returns the records of B1-B4, its final KL, its final
    embedding, and B1's and B2's ms at its shapes."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import (_edge_forces,
                                                  _without_padding)
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.knn_cuda import (knn_sweep_cuda,
                                                   knn_sweep_plain)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact", attraction="csr")
    y, losses, stats, counts = run_embed("full", x_np, cfg,
                                         want_launches(ITERATIONS, 0))
    check(stats["layout"] == "csr", f"[full] layout {stats['layout']}")
    final_kl = quality("full", y, losses, labels, cfg, 0.9)

    # each kernel at the run's shapes: the final embedding and the real CSR
    x = torch.from_numpy(x_np).cuda()
    hidx, hval, tsrc, tdst, tval = csr
    n, w, m = N_FULL, hidx.shape[1], 2
    rep, zrow = cuda_exact_repulsion(y, row_z=True)
    z = torch.sum(zrow)
    repz = (rep / z).contiguous()
    tail = _edge_forces(y, y, tsrc, tdst, tval, 1.0).contiguous()
    upd, gains = torch.zeros_like(y), torch.ones_like(y)
    step = (y, y, hidx, hval, 1.0, tail, repz, None, upd, gains, 0.8)
    kw = dict(eta=cfg.learning_rate, min_gain=cfg.min_gain)
    t = {
        "B1": (cuda_ms(lambda: knn_sweep_cuda(x, K, False), 1, 0),
               cuda_ms(lambda: knn_sweep_plain(x, K, False), 1, 0),
               cuda_ms(lambda: library_knn(x, K), 1, 0)),
        "B2": (cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20),
               cuda_ms(lambda: exact_repulsion(y, row_z=True), 3), None),
        "B3": (cuda_ms(lambda: att.fused_step_update(*step, **kw), 50),
               cuda_ms(lambda: att.fused_step_plain(*step, **kw), 5), None),
        "B4": (cuda_ms(lambda: att.attraction_loss(y, y, hidx, hval, 1.0,
                                                   z), 50),
               cuda_ms(lambda: att.attraction_loss_plain(y, y, hidx, hval,
                                                         1.0, z), 5), None),
    }
    nnz, head_bytes = head_need(hval)
    bounds = {
        "B1": bound(2.0 * n * n * F_FULL, n * F_FULL * 4 + n * K * 8),
        "B2": bound(20.0 * n * n, n * m * 4 * 2 + n * 4),
        "B3": bound(20.0 * nnz, head_bytes + 8 * n * m * 4 + n * 4),
        "B4": bound(25.0 * nnz, head_bytes + n * m * 4 + n * 4),
    }
    kernels = []
    for kid, (name, src, repl) in KERNEL_META.items():
        if kid not in t:  # B5 and B6: from the runs that launch them
            continue
        ms, plain_ms, lib_ms = t[kid]
        bms, by = bounds[kid]
        print(f"[full] {kid} {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
              f"bound {bms:.4f} ms by {by}) x{counts[kid]} launches")
        kernels.append(kernel_record(kid, name, src, repl, counts[kid],
                                     errs[kid], t[kid], bounds[kid]))
    # the rest of an iteration: the CSR tail's sorted segment sum (plain
    # PyTorch) over the tail as optimize runs it (without its padding),
    # then whatever is left of s/iter besides the kernels
    tsrc, tdst, tval = _without_padding((tsrc, tdst, tval))
    lengths = torch.bincount(tsrc.long(), minlength=n)
    tail_ms = cuda_ms(lambda: _edge_forces(y, y, tsrc, tdst, tval, 1.0,
                                           lengths), 20)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    rest = it_ms - t["B2"][0] - t["B3"][0] - t["B4"][0] / 10 - tail_ms
    print(f"[full] per iteration {it_ms:.4f} ms: B2 {t['B2'][0]:.4f}, B3 "
          f"{t['B3'][0]:.4f}, B4/10 {t['B4'][0] / 10:.4f}, tail forces "
          f"{tail_ms:.4f} ({int((tval > 0).sum())} edges), the rest "
          f"{rest:.4f} (by difference)")
    return kernels, final_kl, y, t["B1"][0], t["B2"][0]


def b5_times(y, jidx, jval):
    """(ms, plain ms, bound ms, bound by) of B5, and B4's ms, at a
    layout's shapes.  B5's bound: the bytes of ``head_need`` + y read and
    att written (2·N·m·4), about 20 operations a valid entry."""
    import torch
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    n = jidx.shape[0]
    m = y.shape[1]
    nnz, need = head_need(jval)
    z = torch.tensor(float(n) * n, device=y.device)
    return (cuda_ms(lambda: att.attraction_forces(y, y, jidx, jval, 1.0),
                    50),
            cuda_ms(lambda: att.attraction_forces_plain(y, y, jidx, jval,
                                                        1.0), 5),
            *bound(20.0 * nnz, need + 2 * n * m * 4),
            cuda_ms(lambda: att.attraction_loss(y, y, jidx, jval, 1.0, z),
                    50))


def phase_rows(xl_np, labels, z_latent, rows, errs):
    """The default configuration on the latent blobs: auto must take the
    rows layout.  Returns B5's record, at this run's shapes."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS)
    agree_z = label_agreement(torch.from_numpy(z_latent).cuda(), labels)
    print(f"[rows] the 3-D latent's own 10-NN label agreement {agree_z:.4f}")
    y, losses, stats, counts = run_embed("rows", xl_np, cfg,
                                         want_launches(0, ITERATIONS))
    check(stats["layout"] == "rows",
          f"[rows] auto resolved to {stats['layout']}, not rows")
    quality("rows", y, losses, labels, cfg, agree_z - 0.05)
    jidx, jval = rows
    n, s = jidx.shape
    print(f"[rows] S={s}, {int((jval > 0).sum())} entries "
          f"({float((jval > 0).sum()) / n:.2f} a row)")
    b2 = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20)
    ms, plain_ms, bms, by, b4 = b5_times(y, jidx, jval)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    rest = it_ms - b2 - ms - b4 / 10
    print(f"[rows] B5 at W={s}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms by {by}) x{counts['B5']} launches; B4 "
          f"{b4:.4f} ms")
    print(f"[rows] per iteration {it_ms:.4f} ms: B2 {b2:.4f}, B5 {ms:.4f}, "
          f"B4/10 {b4 / 10:.4f}, the rest {rest:.4f} (by difference)")
    name, src, repl = KERNEL_META["B5"]
    return kernel_record("B5", name, src, repl, counts["B5"], errs["B5"],
                         (ms, plain_ms, None), (bms, by))


def phase_blocks(x_np, labels, blocks, csr_kl):
    """The blocks assembly on the blobs: the CSR run's checks, and its
    final KL within KL_GUARDRAIL_TOL of the CSR run's."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.models.tsne import (_edge_forces,
                                                  _without_padding)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact")
    y, losses, stats, _ = run_embed("blocks", x_np, cfg,
                                    want_launches(0, ITERATIONS),
                                    affinity_assembly="blocks")
    check(stats["layout"] == "blocks", f"[blocks] layout {stats['layout']}")
    kl = quality("blocks", y, losses, labels, cfg, 0.9)
    print(f"[blocks] final KL {kl:.6f} vs the CSR run's {csr_kl:.6f}: gap "
          f"{kl - csr_kl:+.6f} (bar {KL_GUARDRAIL_TOL})")
    check(abs(kl - csr_kl) <= KL_GUARDRAIL_TOL,
          f"[blocks] final KL {kl} vs CSR {csr_kl}")
    fidx, fval, rev = blocks
    n, w = fidx.shape
    b2 = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 20)
    ms, plain_ms, bms, by, b4 = b5_times(y, fidx, fval)
    # the reverse edges as optimize runs them: without their padding
    rsrc, rdst, rval = _without_padding(rev)
    lengths = torch.bincount(rsrc.long(), minlength=n)
    rev_ms = cuda_ms(lambda: _edge_forces(y, y, rsrc, rdst, rval, 1.0,
                                          lengths), 20)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    rest = it_ms - b2 - ms - b4 / 10 - rev_ms
    print(f"[blocks] forward block W={w}, {rval.shape[0]} reverse edges "
          f"(of {rev[2].shape[0]} slots)")
    print(f"[blocks] B5 at W={w}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms by {by}); B4 {b4:.4f} ms")
    print(f"[blocks] per iteration {it_ms:.4f} ms: B2 {b2:.4f}, B5 "
          f"{ms:.4f}, B4/10 {b4 / 10:.4f}, reverse-edge segment sum "
          f"{rev_ms:.4f}, the rest {rest:.4f} (by difference)")


class _Captured(Exception):
    pass


def capture_refine_chunk(x, k, calls):
    """The (base, sq, rows, cand) of the first ``calls`` B6 calls of one
    refine round (its first chunk's funnel stages), over a one-round
    Z-order seed graph of ``x`` — the round stops once they are taken."""
    import torch
    from tsne_flink_tpu_torch.ops import knn as tknn
    got = []
    real = tknn._cand_sqdist

    def grab(base, sq, rows, cand, compact=False):
        got.append((base, sq, rows.to(torch.int32),
                    cand.to(torch.int32).contiguous()))
        if len(got) == calls:
            raise _Captured
        return real(base, sq, rows, cand, compact)

    gen = torch.Generator(device=x.device)
    gen.manual_seed(0)
    idx, dist = tknn.knn_project(x, k, rounds=1, generator=gen)
    fd = tknn.pick_knn_filter(x.shape[1])
    tknn._cand_sqdist = grab
    try:
        tknn.knn_refine(x, idx, dist, generator=gen, filter_dims=fd,
                        expand_k=(k + 1) // 2 if fd else None)
    except _Captured:
        pass
    finally:
        tknn._cand_sqdist = real
    return got


def phase_b6(x_np, xc_np):
    """B6 against its plain version on the candidate sets of a real refine
    chunk: the blobs' cascade (F = 128) and exact (F = 784) stages, and
    the cells' exact stage (F = 50).  Returns its max abs error and, per
    shape, its (ms, plain ms, library ms), bound and chunk rows."""
    import torch
    from tsne_flink_tpu_torch.ops.knn_cuda import (cand_sqdist,
                                                   cand_sqdist_plain)
    err, shapes = 0.0, {}
    for tag, data, k, calls in (("blobs", x_np, K, 2),
                                ("cells", xc_np, K_CELLS, 1)):
        x = torch.from_numpy(data).cuda()
        for base, sq, rows, cand in capture_refine_chunk(x, k, calls):
            (c, z), f = cand.shape, base.shape[1]
            got = cand_sqdist(base, sq, rows, cand)
            want = cand_sqdist_plain(base, sq, rows, cand)
            e = rel_close(got, want, 2e-5, f"B6 {tag} F={f} Z={z}")
            err = max(err, e)
            nrm = (sq[rows.long()][:, None] + sq[cand.long()])[:, :, None]
            times = (cuda_ms(lambda: cand_sqdist(base, sq, rows, cand), 20),
                     cuda_ms(lambda: cand_sqdist_plain(base, sq, rows,
                                                       cand), 3),
                     cuda_ms(lambda: torch.baddbmm(
                         nrm, base[cand.long()], base[rows.long()][:, :, None],
                         alpha=-2.0), 3))
            # each input read once: the U distinct rows of base (and their
            # norms) the chunk touches, the ids; the scores written once
            u = int(torch.unique(torch.cat([rows, cand.reshape(-1)])).numel())
            bnd = bound(c * z * (2.0 * f + 3.0),
                        4.0 * (u * (f + 1) + c + 2 * c * z))
            shapes[(tag, f, z)] = (times, bnd, c)
            print(f"[kernels] B6 {tag} refine chunk c={c} Z={z} F={f} ({u} "
                  f"distinct rows; the gathered rows are {c * z * f * 4e-9:.3f}"
                  f" GB): max |d2 err| {e:.3e} (max d2 "
                  f"{float(want.max()):.4g}); {times[0]:.4f} ms (plain "
                  f"{times[1]:.4f} ms, library gather + baddbmm "
                  f"{times[2]:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]})")
        del x
    return err, shapes


def fft_split(y, cfg):
    """CUDA-event ms of one FFT repulsion call on ``y`` and its parts:
    (spread = stencil + sorted segment sum, the FFTs with the spectral Z,
    the gather, the whole call)."""
    import torch
    from tsne_flink_tpu_torch.ops import repulsion_fft as rf
    geom = rf.fft_geometry(y.shape[1], cfg.fft_grid, y.dtype, y.device)
    g, p = geom.grid, cfg.fft_interp
    ones = torch.ones(y.shape[0], device=y.device)
    rows = torch.arange(y.shape[0], device=y.device)
    st = rf.fft_stencil(y, g, p)
    grid = rf.fft_spread(y, st, g, ones)
    pot, _ = rf.fft_convolve(grid, geom, st.h)
    return (cuda_ms(lambda: rf.fft_spread(y, rf.fft_stencil(y, g, p), g,
                                          ones), 10),
            cuda_ms(lambda: rf.fft_convolve(grid, geom, st.h), 10),
            cuda_ms(lambda: rf.fft_gather(y, pot, st, g, rows, ones), 10),
            cuda_ms(lambda: rf.fft_repulsion(y, geom=geom,
                                             interp=p), 10))


def phase_project(x_np, labels, b1_ms, b6_shapes):
    """The blobs with the hybrid kNN: exact launch counts, substages,
    recall@90 against B1's exact graph, the checks of phase 4."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine

    n, d = x_np.shape
    cycles = pick_knn_refine(n, d)
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact")
    with record_knn() as graph:
        y, losses, stats, counts = run_embed(
            "project", x_np, cfg,
            lambda st: layout_launches(st["layout"], b1=0,
                                       b6=b6_launches(n, d, K, cycles)),
            knn_method="project")
    quality("project", y, losses, labels, cfg, 0.9)
    _, dist_e, t_b1 = timed_exact_graph(torch.from_numpy(x_np).cuda(), K)
    recall = recall_at_k(graph[1], dist_e)
    print(f"[project] recall@{K} against B1's exact graph {recall:.4f} "
          f"(bar 0.93)")
    check(recall >= 0.93, f"[project] recall {recall} < 0.93")
    per = {key: v for key, v in b6_shapes.items() if key[0] == "blobs"}
    b6_ms = " + ".join(f"{v[0][0]:.4f} ms at F={key[1]}, Z={key[2]}"
                       for key, v in per.items())
    print(f"[project] {cycles} refine cycles; B6 x{counts['B6']} launches "
          f"({b6_ms} per chunk); knn stage {stats['knn']:.3f} s vs B1's "
          f"exact sweep {t_b1:.3f} s here ({b1_ms / 1e3:.3f} s in [full])")


def phase_large(xc_np, labels, z_latent, y_60k, b2_ms_60k):
    """The 1.3M-cell shape with the hybrid kNN and FFT repulsion.  Returns
    the run's B6 launches."""
    import torch
    from tsne_flink_tpu_torch import TsneConfig
    from tsne_flink_tpu_torch.ops.knn import pick_knn_refine, pick_knn_rounds
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.utils.flops import knn_flops

    n, d = xc_np.shape
    rounds, cycles = pick_knn_rounds(n), pick_knn_refine(n, d)
    cfg = TsneConfig(perplexity=PERPLEXITY_CELLS, iterations=ITERATIONS,
                     learning_rate=fitsne_learning_rate(n),
                     repulsion="fft", fft_grid=1024, fft_interp=3)
    agree_z = label_agreement(torch.from_numpy(z_latent).cuda(), labels)
    print(f"[large] the {z_latent.shape[1]}-D latent's own 10-NN label "
          f"agreement {agree_z:.4f}")
    with record_knn() as graph:
        y, losses, stats, counts = run_embed(
            "large", xc_np, cfg,
            lambda st: layout_launches(st["layout"], b1=0, b2=0,
                                       b6=b6_launches(n, d, K_CELLS,
                                                      cycles)),
            neighbors=K_CELLS, knn_method="project")
    quality("large", y, losses, labels, cfg, agree_z - 0.05)
    x = torch.from_numpy(xc_np).cuda()
    _, dist_e, t_b1 = timed_exact_graph(x, K_CELLS)
    recall = recall_at_k(graph[1], dist_e)
    del graph[:], dist_e, x
    print(f"[large] {rounds} seed rounds + {cycles} cycles, B6 x"
          f"{counts['B6']}: knn stage {stats['knn']:.3f} s; B1's exact "
          f"graph {t_b1:.3f} s; recall@{K_CELLS} {recall:.4f} (bar 0.90)")
    check(recall >= 0.90, f"[large] recall {recall} < 0.90")
    eff_exact = knn_flops(n, d, K_CELLS, "bruteforce") / t_b1
    eff_hybrid = knn_flops(n, d, K_CELLS, "project", rounds=rounds,
                           refine_rounds=cycles) / stats["knn"]
    print(f"[large] knn efficiencies (knn_flops / s): exact (B1) "
          f"{eff_exact:.4e}, hybrid {eff_hybrid:.4e}")
    sp, ff, ga, whole = fft_split(y, cfg)
    sp6, ff6, ga6, whole6 = fft_split(y_60k, cfg)
    b2_large = cuda_ms(lambda: cuda_exact_repulsion(y, row_z=True), 1, 0)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    print(f"[large] FFT repulsion at N={n}: {whole:.4f} ms (spread "
          f"{sp:.4f}, FFTs {ff:.4f}, gather {ga:.4f}); at N={N_FULL} "
          f"{whole6:.4f} ms (spread {sp6:.4f}, FFTs {ff6:.4f}, gather "
          f"{ga6:.4f}); per iteration {it_ms:.4f} ms")
    # B2 grows as N², the FFT as c0 + c1·N: the N where they cross
    a = b2_ms_60k / N_FULL ** 2
    c1 = (whole - whole6) / (n - N_FULL)
    c0 = whole6 - c1 * N_FULL
    cross = (c1 + math.sqrt(c1 * c1 + 4 * a * c0)) / (2 * a)
    print(f"[large] B2 exact repulsion: {b2_ms_60k:.4f} ms at N={N_FULL}, "
          f"{b2_large:.4f} ms at N={n}; exact/FFT crossover at N ~ "
          f"{cross:.0f}")
    return counts["B6"]


def phase_determinism(x_np, xl_np):
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    for name, data, attraction in (("CSR", x_np, "csr"),
                                   ("rows", xl_np, "rows")):
        cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                         attraction=attraction)
        stats = [{}, {}]
        runs = [tsne_embed(data[:N_DETERMINISM], cfg, neighbors=K, seed=0,
                           stats=st) for st in stats]
        check(stats[0]["layout"] == attraction,
              f"[determinism] {name} ran {stats[0]['layout']}")
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"[determinism] {name} N={N_DETERMINISM} two runs "
              f"bit-identical: {same}")
        check(same, f"two {name} runs at N={N_DETERMINISM} differ")
    # the large-N path: hybrid kNN (two refine cycles, so B6 runs) + FFT
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="fft")
    reset_launches()
    runs = [tsne_embed(x_np[:N_DETERMINISM], cfg, neighbors=K, seed=0,
                       knn_method="project", knn_refine=2)
            for _ in range(2)]
    b6 = launches()["B6"]
    check(b6 > 0, "[determinism] project + FFT: B6 never launched")
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[determinism] project + FFT N={N_DETERMINISM} (B6 x{b6}) two "
          f"runs bit-identical: {same}")
    check(same, f"two project + FFT runs at N={N_DETERMINISM} differ")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import tsne_flink_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        name, count = phase_device()
        phase_build()
        x_np, labels = make_data()
        xl_np, labels_l, z_latent = make_latent_blobs()
        xc_np, labels_c, z_cells = make_cells()
        errs, csr, rows, blocks = phase_kernels(x_np, xl_np)
        errs["B6"], b6_shapes = phase_b6(x_np, xc_np)
        kernels, csr_kl, y_60k, b1_ms, b2_ms = phase_full(x_np, labels,
                                                          errs, csr)
        kernels.append(phase_rows(xl_np, labels_l, z_latent, rows, errs))
        phase_blocks(x_np, labels, blocks, csr_kl)
        phase_project(x_np, labels, b1_ms, b6_shapes)
        b6_count = phase_large(xc_np, labels_c, z_cells, y_60k, b2_ms)
        (times, bnd, _), = [v for key, v in b6_shapes.items()
                            if key[0] == "cells"]
        kernels.append(kernel_record("B6", *KERNEL_META["B6"], b6_count,
                                     errs["B6"], times, bnd))
        phase_determinism(x_np, xl_np)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
