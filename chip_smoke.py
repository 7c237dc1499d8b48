#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (tsne_flink_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — name, count, and nvidia-smi's name + power limit;
2. build   — nvcc of csrc/*.cu into one library (seconds + ptxas lines);
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes of the main path (B1 at 8,192 x 784);
4. full    — ``tsne_embed`` on 60,000 x 784 MNIST-like blobs (perplexity
   30, k = 90, exact repulsion, CSR attraction, 300 iterations): stage
   seconds, the launches of each kernel in that run (counted from 0 just
   before it), each kernel's CUDA-event time at the run's shapes beside its
   plain version's and its bound, peak memory, the loss trace, and the
   quality checks (finite, falling KL, 10-NN label agreement >= 0.9);
5. determinism — two runs at N = 2,000 give the same bits.

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


def embedding_like(n, seed):
    """A spread 2-D layout (10 clusters on a radius-30 ring) for the
    kernel checks: the magnitudes of an embedding mid-run."""
    import torch
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * rng.integers(0, 10, n) / 10
    y = np.stack([30 * np.cos(ang), 30 * np.sin(ang)], 1)
    y = y + 3.0 * rng.standard_normal((n, 2))
    return torch.from_numpy(y.astype(np.float32)).cuda()


def head_forces(y, hidx, hval, exag):
    """Plain CSR-head attraction (input construction for the B3 check)."""
    import torch
    yj = y[hidx.long()]
    d2 = (torch.sum(y * y, 1)[:, None] + torch.sum(yj * yj, 2)
          - 2.0 * torch.sum(y[:, None, :] * yj, 2))
    w = hval * exag / (1.0 + torch.clamp(d2, min=0.0))
    return y * torch.sum(w, 1)[:, None] - torch.sum(w[:, :, None] * yj, 1)


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


def phase_kernels(x_np):
    """Kernel vs plain on the card; returns each kernel's max abs error
    and the real CSR layout of the data."""
    import torch
    from tsne_flink_tpu_torch.models.tsne import TsneConfig, _plan_layout
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
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
    att_p = head_forces(y, hidx, hval, exag)
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
    return errs, csr


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


def phase_full(x_np, labels, errs, csr):
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    from tsne_flink_tpu_torch.kernels.build import launches, reset_launches
    from tsne_flink_tpu_torch.models.tsne import _edge_forces
    from tsne_flink_tpu_torch.ops import attraction_cuda as att
    from tsne_flink_tpu_torch.ops.knn_cuda import (knn_sweep_cuda,
                                                   knn_sweep_plain)
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     repulsion="exact", attraction="csr")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    reset_launches()
    t0 = time.perf_counter()
    y, losses = tsne_embed(x_np, cfg, neighbors=K, knn_method="bruteforce",
                           seed=0, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"[full] {N_FULL}x{F_FULL} k={K} perplexity={PERPLEXITY} "
          f"{ITERATIONS} iterations: {wall:.3f} s end to end")
    print("[full] stages s: " + ", ".join(f"{k}={v:.4f}"
                                          for k, v in stats.items())
          + f", s/iter={stats['optimize'] / ITERATIONS:.6f}")
    print(f"[full] launches {json.dumps(counts)}")
    print(f"[full] peak memory {peak / 2**30:.3f} GiB")
    want = {"B1": 1, "B2": ITERATIONS, "B3": ITERATIONS,
            "B4": ITERATIONS // 10}
    check(counts == want, f"launch counts {counts} != {want}")
    lh = losses.cpu().numpy()
    print(f"[full] loss trace head {np.round(lh[:5], 5).tolist()} tail "
          f"{np.round(lh[-5:], 5).tolist()}; final KL {lh[-1]:.6f}")
    check(bool(torch.isfinite(y).all()) and bool(np.isfinite(lh).all()),
          "non-finite embedding or loss")
    first_post = cfg.exaggeration_end // 10  # slot of iteration 110
    check(lh[-1] < lh[first_post], f"KL did not fall: {lh[-1]} vs slot "
          f"{first_post} {lh[first_post]}")
    agree = label_agreement(y, labels)
    print(f"[full] 10-NN label agreement (5k subsample) {agree:.4f}")
    check(agree >= 0.9, f"label agreement {agree} < 0.9")

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
    head_bytes = n * w * 8
    bounds = {
        "B1": bound(2.0 * n * n * F_FULL, n * F_FULL * 4 + n * K * 8),
        "B2": bound(20.0 * n * n, n * m * 4 * 2 + n * 4),
        "B3": bound(20.0 * n * w, head_bytes + 8 * n * m * 4 + n * 4),
        "B4": bound(25.0 * n * w, head_bytes + n * m * 4 + n * 4),
    }
    meta = {
        "B1": ("knn", "tsne_flink_tpu_torch/csrc/knn.cu",
               "tsne_flink_tpu/ops/knn_pallas.py:73"),
        "B2": ("exact_repulsion", "tsne_flink_tpu_torch/csrc/repulsion.cu",
               "tsne_flink_tpu/ops/repulsion_pallas.py:33"),
        "B3": ("fused_step", "tsne_flink_tpu_torch/csrc/attraction.cu",
               "tsne_flink_tpu/ops/attraction_pallas.py:313"),
        "B4": ("attraction_loss", "tsne_flink_tpu_torch/csrc/attraction.cu",
               "tsne_flink_tpu/ops/attraction_pallas.py:156"),
    }
    kernels = []
    for kid, (name, src, repl) in meta.items():
        ms, plain_ms, lib_ms = t[kid]
        bms, by = bounds[kid]
        print(f"[full] {kid} {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, "
              f"bound {bms:.4f} ms by {by}) x{counts[kid]} launches")
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": src, "replaces": repl,
                        "launches": counts[kid], "max_abs_err": errs[kid],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": lib_ms})
    # the rest of an iteration: the CSR tail's sorted segment sum (plain
    # PyTorch), then whatever is left of s/iter besides the kernels
    lengths = torch.bincount(tsrc.long(), minlength=n)
    tail_ms = cuda_ms(lambda: _edge_forces(y, y, tsrc, tdst, tval, 1.0,
                                           lengths), 20)
    it_ms = stats["optimize"] / ITERATIONS * 1e3
    rest = it_ms - t["B2"][0] - t["B3"][0] - t["B4"][0] / 10 - tail_ms
    print(f"[full] per iteration {it_ms:.4f} ms: B2 {t['B2'][0]:.4f}, B3 "
          f"{t['B3'][0]:.4f}, B4/10 {t['B4'][0] / 10:.4f}, tail forces "
          f"{tail_ms:.4f} ({int((tval > 0).sum())} edges), the rest "
          f"{rest:.4f} (by difference)")
    return kernels


def phase_determinism(x_np):
    import torch
    from tsne_flink_tpu_torch import TsneConfig, tsne_embed
    cfg = TsneConfig(perplexity=PERPLEXITY, iterations=ITERATIONS,
                     attraction="csr")
    runs = [tsne_embed(x_np[:N_DETERMINISM], cfg, neighbors=K, seed=0)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[determinism] N={N_DETERMINISM} two runs bit-identical: {same}")
    check(same, "two runs at N=2000 differ")


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
        errs, csr = phase_kernels(x_np)
        kernels = phase_full(x_np, labels, errs, csr)
        phase_determinism(x_np)
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
