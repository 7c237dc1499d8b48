"""Host-calibration probe: a measured matmul GFLOP/s sample per process
(port of ``tsne_flink_tpu/obs/calibrate.py``).

Identical code can run at different speeds on different hosts, and
nothing in a record says so.  This probe runs a short f32 matmul loop
once per process and records (measured GFLOP/s, a host signature), so a
reader can normalize stage times across runs: two records with the same
signature ran on interchangeable hosts.

The number is a CALIBRATION sample, not a hardware claim: one shape, a
few reps.  It rides the ``host.matmul_gflops`` gauge.  The probe runs on
the CPU (``device="cpu"``, the default: the host's speed is what it
calibrates) or, given ``device="cuda"``, on the card, where it ends with
one ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import hashlib
import os
import platform

from tsne_flink_tpu_torch.obs import metrics, trace

#: probe shape/reps: 2 * 768^3 * 3 ≈ 2.7 GFLOP
PROBE_SIZE = 768
PROBE_REPS = 3

_CACHED: dict = {}


def host_signature() -> str:
    """A short digest of what makes two hosts comparable: the machine,
    the processor, the CPU count and the torch build."""
    import torch

    parts = (platform.machine(), platform.processor(), os.cpu_count(),
             torch.__version__, torch.get_num_threads())
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def host_calibration(size: int = PROBE_SIZE, reps: int = PROBE_REPS,
                     device: str = "cpu") -> dict:
    """``{"signature", "matmul_gflops", "backend", "size", "reps"}`` —
    measured once per process and device (later calls return the cached
    sample)."""
    if device in _CACHED:
        return dict(_CACHED[device])
    import torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn(size, size, generator=gen).to(device)
    b = torch.randn(size, size, generator=gen).to(device)
    reps = max(1, int(reps))
    (a @ b).sum().item()  # warm outside the measurement
    with trace.span("host.calibrate", cat="calibrate", size=size,
                    reps=reps) as sp:
        out = a
        for _ in range(reps):
            out = out @ b
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    gflops = 2.0 * size ** 3 * reps / max(sp.seconds, 1e-9) / 1e9
    rec = {"signature": host_signature(), "matmul_gflops": round(gflops, 2),
           "backend": torch.device(device).type, "size": int(size),
           "reps": reps}
    _CACHED[device] = rec
    metrics.gauge("host.matmul_gflops").set(rec["matmul_gflops"])
    metrics.gauge("host.signature").set(rec["signature"])
    return dict(rec)
