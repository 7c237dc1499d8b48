"""The audit tier's tiny concrete cases: the runs the recorder watches.

Every case is small (n <= 256 points) and seeded, so an audit takes
seconds on either device: a blobs input, its prepared P (the kNN and the
affinities of ``utils/artifacts.prepare``), the initial state, and the
optimizer over a thread mesh of ``D`` shards on one device (the test
mesh: the device listed once a shard).
"""

from __future__ import annotations

import functools

import numpy as np

#: the tiny case's shape: points, features, neighbours, perplexity
N, D, K, PERPLEXITY = 160, 12, 12, 4.0

#: the optimize variants the audits run: (label, TsneConfig overrides as
#: (name, value) pairs, assembly) — exact on the CSR layout, the padded
#: rows, blocks + FFT, Barnes-Hut
VARIANTS = (
    ("exact-csr", (("repulsion", "exact"), ("attraction", "csr")), "sorted"),
    ("exact-rows", (("repulsion", "exact"), ("attraction", "rows")),
     "sorted"),
    ("blocks-fft", (("repulsion", "fft"), ("fft_grid", 32)), "blocks"),
    ("bh", (("repulsion", "bh"), ("attraction", "rows")), "sorted"),
)


def blobs(n: int = N, d: int = D, seed: int = 0) -> np.ndarray:
    """``n`` points in 4 Gaussian blobs (float32)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(4, d)) * 5.0
    return (centres[rng.integers(0, 4, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def prepared(device, *, n: int = N, assembly: str = "sorted",
             seed: int = 0):
    """The tiny case's P: ``utils/artifacts.prepare`` on :func:`blobs`
    (bruteforce kNN) — its ``PrepareResult``, made once a process for
    each (device, n, assembly, seed): the audits only read it."""
    import torch
    return _prepared(str(torch.device(device)), n, assembly, seed)


@functools.lru_cache(maxsize=16)
def _prepared(device: str, n: int, assembly: str, seed: int):
    from tsne_flink_tpu_torch.utils.artifacts import prepare
    return prepare(blobs(n, seed=seed), neighbors=K,
                   knn_method="bruteforce", perplexity=PERPLEXITY,
                   assembly=assembly, device=device)


def config(iterations: int = 20, **kw):
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    return TsneConfig(iterations=iterations, perplexity=PERPLEXITY,
                      row_chunk=64, **kw)


def state(n: int, m: int, device, seed: int = 0):
    import torch

    from tsne_flink_tpu_torch.models.tsne import init_working_set
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_working_set(gen, n, m, torch.float32, device)


def sharded(cfg, prep, device, mesh: int, mesh_reduce: str = "canonical"):
    """A ``ShardedOptimizer`` of ``mesh`` shards on ``device`` with the
    prepared P sharded (``shard_inputs``)."""
    from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
    n = int(prep.jidx.shape[0])
    opt = ShardedOptimizer(cfg, n, devices=[device] * mesh,
                           mesh_reduce=mesh_reduce)
    opt.shard_inputs(prep.jidx, prep.jval, prep.extra_edges)
    return opt
