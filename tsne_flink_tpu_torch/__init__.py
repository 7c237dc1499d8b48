"""PyTorch + CUDA port of ``tsne_flink_tpu`` for NVIDIA Hopper (sm_90a).

The module tree mirrors the JAX package's (``ops/knn.py`` <->
``ops/knn.py``, ``models/tsne.py`` <-> ``models/tsne.py``); each Pallas
kernel of the JAX package becomes a hand-written CUDA C++ kernel under
``csrc/`` with a plain PyTorch version beside its wrapper.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors
every wrapper runs its plain version, on CUDA tensors it launches its
kernel or raises.

Ported so far: the single-device ``tsne_embed`` main path — kNN (exact,
or the hybrid Z-order + refine plan) -> perplexity-calibrated affinities
(sorted, split or blocks assembly) -> the attraction layout
(capped-width CSR, padded rows, flat edge list or blocks) -> the optimize
loop with exact, FFT or Barnes-Hut repulsion, fused (CSR) or unfused,
with the JAX package's approximation policies (the repulsion stride, the
autopilot, the landmark schedule) and loop extras (the divergence
sentinel, telemetry) — and the batch job around it: the :class:`TSNE`
estimator and the command line (``python -m
tsne_flink_tpu_torch.utils.cli``, the ``tsne-torch`` script) with CSV
ingest, checkpoints and the prepare-artifact cache; out-of-sample
serving (``serve/``); and the runtime and observability layers
(``runtime/``: the run supervisor with its OOM ladder, fault injection,
the job fleet under a memory budget; ``obs/``: tracing, metrics, memory
watermarks; ``analysis/audit``: the memory model they charge); the
serve fleet (``serve/replicas``: N daemon processes over one spool); and
the single-controller point mesh (``parallel/mesh``: the optimize stage
sharded over D devices, bit for bit the one-device run); and the
multi-controller job (``parallel/pipeline``: N processes, one rank each,
over ``torch.distributed``, the sharded prepare and optimize).

The public names are imported on first use (PEP 562), so the parts that
need no torch — the serve fleet's supervisor process above all — import
none: ``from tsne_flink_tpu_torch import TSNE`` works as before.
"""

import importlib

_PUBLIC = {
    "TSNE": "tsne_flink_tpu_torch.models.api",
    "TsneConfig": "tsne_flink_tpu_torch.models.tsne",
    "TsneState": "tsne_flink_tpu_torch.models.tsne",
    "optimize": "tsne_flink_tpu_torch.models.tsne",
    "tsne_embed": "tsne_flink_tpu_torch.models.tsne",
}

__all__ = sorted(_PUBLIC)


def __getattr__(name):
    if name in _PUBLIC:
        value = getattr(importlib.import_module(_PUBLIC[name]), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_PUBLIC))
