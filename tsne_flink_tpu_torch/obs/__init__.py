"""The tracing and metrics layer of the PyTorch port (mirrors
``tsne_flink_tpu/obs``): ``trace`` (spans, instants, the Chrome trace),
``metrics`` (counters, gauges, histograms, one snapshot schema),
``memory`` (per-stage observed peaks) and ``calibrate`` (the host probe).
``trace`` and ``metrics`` are pure stdlib."""

from tsne_flink_tpu_torch.obs import metrics, trace  # noqa: F401

__all__ = ["trace", "metrics"]
