#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (tsne_flink_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — name, count, and nvidia-smi's name + power limit;
2. build   — nvcc of csrc/*.cu, one process per source, all at once
   (seconds + ptxas lines);
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main paths (B1 at 8,192 x 784; B2,
   B3, B4 at 60,000 rows; B5 and B4 at the three widths below), and one
   CSR step fused (B3) against unfused (B5 + tail + the vdM update);
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
7. determinism — two runs at N = 2,000 give the same bits, on the CSR
   path and on the rows path.

The widths at which B5 and B4 are held: the latent blobs' [N, S] rows
(S ~ 146), the blobs' [N, S] rows (S ~ 3,466: what attraction="rows"
runs there) and the blocks layout's forward block (W = k = 90).

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the JSON record of every kernel.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
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
}


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


def run_embed(tag, x_np, cfg, want, **kw):
    """One ``tsne_embed`` at full size, its launches counted from 0 just
    before it: prints the stage seconds, launches and peak memory, checks
    the launches against ``want``; returns (y, losses, stats, launches)."""
    import torch
    from tsne_flink_tpu_torch import tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    y, losses = tsne_embed(x_np, cfg, neighbors=K, knn_method="bruteforce",
                           seed=0, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    n, f = x_np.shape
    print(f"[{tag}] {n}x{f} k={K} perplexity={cfg.perplexity} "
          f"{cfg.iterations} iterations, assembly {stats['assembly']}, "
          f"layout {stats['layout']}: {wall:.3f} s end to end")
    print(f"[{tag}] stages s: " + ", ".join(
        f"{k}={v:.4f}" for k, v in stats.items() if isinstance(v, float))
        + f", s/iter={stats['optimize'] / cfg.iterations:.6f}")
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


def want_launches(b3, b5):
    return {"B1": 1, "B2": ITERATIONS, "B3": b3, "B4": ITERATIONS // 10,
            "B5": b5}


def kernel_record(kid, name, src, repl, launches, err, times, bnd):
    ms, plain_ms, lib_ms = times
    bms, by = bnd
    return {"name": f"{kid} {name}", "route": "cuda", "source": src,
            "replaces": repl, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms}


def phase_full(x_np, labels, errs, csr):
    """The CSR run; returns the records of B1-B4 and its final KL."""
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
        if kid == "B5":
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
    return kernels, final_kl


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


def phase_determinism(x_np, xl_np):
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
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
        errs, csr, rows, blocks = phase_kernels(x_np, xl_np)
        kernels, csr_kl = phase_full(x_np, labels, errs, csr)
        kernels.append(phase_rows(xl_np, labels_l, z_latent, rows, errs))
        phase_blocks(x_np, labels, blocks, csr_kl)
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
