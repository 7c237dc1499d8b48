"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``cuda``, and with no
card that raises instead of falling back to the CPU.  The CPU is used
only when the caller asks for it (the parity tests do).
"""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tsne_flink_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{dev}' (cuda | cpu)")
    return dev


def timed_stage(device: torch.device, t0: float) -> float:
    """Seconds since ``t0`` after the device has finished its queue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
