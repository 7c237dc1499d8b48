"""Per-stage observed memory watermark — the memory model's closing loop
(port of ``tsne_flink_tpu/obs/memory.py``).

``analysis/audit/hbm.py`` PREDICTS a per-stage peak; this module samples
the observed one — the caching allocator's peak on the card
(``torch.cuda.max_memory_allocated``, the bytes the model's terms count)
and the process RSS high-water mark (``VmHWM``) elsewhere — and
:func:`drift` turns (predicted, observed) into a ratio.

Both peaks are process-lifetime watermarks (until a caller resets the
card's with ``torch.cuda.reset_peak_memory_stats``): a stage's sample is
"the peak so far, at stage end".  On the CPU the RSS basis includes the
Python heap and is labeled ``"rss"``, so a reader never mistakes it for
device memory.  Reading the card's counter is a host read of allocator
state: it does not synchronize the device.
"""

from __future__ import annotations

from contextlib import contextmanager

from tsne_flink_tpu_torch.obs import metrics


def _rss_peak_bytes() -> int:
    """VmHWM (peak resident set) from /proc/self/status, in bytes; falls
    back to current VmRSS, then 0 where /proc is unavailable."""
    hwm = rss = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
                elif line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return 0
    return hwm or rss


def observed_peak_bytes(device=None) -> tuple[int, str]:
    """(peak bytes so far, basis): basis ``"device"`` when ``device`` is
    a CUDA device (None: the current one, when the card is initialised),
    ``"rss"`` elsewhere."""
    import torch

    if device is None:
        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    else:
        on_card = torch.device(device).type == "cuda"
    if on_card:
        return int(torch.cuda.max_memory_allocated(device)), "device"
    return _rss_peak_bytes(), "rss"


def sample(stage: str | None = None, device=None) -> dict:
    """One watermark sample ``{"observed_bytes", "basis"}``; with a stage
    name, also recorded as the ``memory.<stage>.observed_bytes`` gauge."""
    peak, basis = observed_peak_bytes(device)
    rec = {"observed_bytes": peak, "basis": basis}
    if stage is not None:
        metrics.gauge(f"memory.{stage}.observed_bytes").set(peak)
        metrics.gauge("memory.basis").set(basis)
    return rec


def drift(observed_bytes: int, predicted_bytes) -> float | None:
    """observed / predicted ratio (None when the model predicted nothing
    for this stage) — >1 means the static model under-predicted."""
    if not predicted_bytes:
        return None
    return round(float(observed_bytes) / float(predicted_bytes), 3)


@contextmanager
def watermark(stage: str, device=None):
    """Context manager form: yields a dict filled with the stage-end
    sample."""
    rec: dict = {}
    try:
        yield rec
    finally:
        rec.update(sample(stage, device))
