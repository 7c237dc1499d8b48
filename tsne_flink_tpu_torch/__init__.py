"""PyTorch + CUDA port of ``tsne_flink_tpu`` for NVIDIA Hopper (sm_90a).

The module tree mirrors the JAX package's (``ops/knn.py`` <->
``ops/knn.py``, ``models/tsne.py`` <-> ``models/tsne.py``); each Pallas
kernel of the JAX package becomes a hand-written CUDA C++ kernel under
``csrc/`` with a plain PyTorch version beside its wrapper.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors
every wrapper runs its plain version, on CUDA tensors it launches its
kernel or raises.

Ported so far (slice 1): the single-device ``tsne_embed`` main path —
exact kNN -> perplexity-calibrated affinities -> capped-width CSR layout
-> the fused CSR optimize loop with exact repulsion.
"""

from tsne_flink_tpu_torch.models.tsne import (TsneConfig, TsneState,
                                              optimize, tsne_embed)

__all__ = ["TsneConfig", "TsneState", "optimize", "tsne_embed"]
