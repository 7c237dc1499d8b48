"""The out-of-sample query path, in fixed-width micro-buckets (port of
``tsne_flink_tpu/serve/transform.py``).

The openTSNE recipe for van der Maaten's tree-accelerated t-SNE, built
from the port's kernels:

1. **query→base kNN** — ``ops/knn.knn_queries``, the exact cross-set
   sweep (no self-mask: queries are not base points);
2. **directed affinities** — ``ops/affinities.pairwise_affinities`` on
   the query→base distances at the trained perplexity, not symmetrized:
   the serving distribution is the conditional ``P_{j|query}``;
3. **interpolation init** — each query starts at the affinity-weighted
   mean of its neighbours' frozen coordinates;
4. **query-row optimize** — a fixed number of iterations over ONLY the
   query rows: attraction to the base through kernel B5 (a [B, k]
   directed graph is a row block with no ragged part), repulsion against
   the frozen base through kernel B2 (``row_offset = N``: the query rows
   are numbered past the base, so no pair is masked) or the precomputed
   FFT field's gather, and the vdM gains and momentum update.  The base
   never moves, there is no centering, and Z is PER ROW, so each query's
   trajectory is independent of every other row in its bucket.

**Micro-buckets.**  A batch is cut into zero-padded ``bucket``-row
buckets and each runs the same stages at the same shapes, so B2's column
splits and each matmul's algorithm are the same for every bucket: with
per-row independence, the result is bit-identical across batch splits
(one batch of 1,024 == 4 of 256 == 16 of 64).  The last bucket stays
padded, never trimmed.

The stages of one (model, bucket, iters, eta) are built once and cached
(:func:`stage_cache`); ``cache_states()`` reports how the process got
the compiled kernels the stages launch (``kernels/build.cache_state``:
``hit`` | ``built``; ``off`` on the CPU or before any launch).  On the card,
:func:`dispatch_bucket` returns the result tensor without a host sync:
the loop reads nothing back, and the query rows reach the card through a
pinned buffer.  The port reads no environment variable: the pickers take
arguments whose defaults are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

#: the JAX package's defaults (``TSNE_SERVE_BUCKET``,
#: ``TSNE_TRANSFORM_ITERS``, the serve policy's eta)
DEFAULT_BUCKET = 256
DEFAULT_ITERS = 75
DEFAULT_ETA = 0.5
#: floor of the per-row partition term (engages only on all-distant
#: strays)
Z_FLOOR = 1e-12

#: (model_id, bucket, iters, eta) -> the built stages of a warm process
_STAGES: dict = {}


# graftlint: disable=policy-recorded -- its argument or the
# module default; the port has no serve bench record for ``bucket``
# (the JAX package's), and the daemon's latency record keys
# are serve/sched.SCHED_RECORD_KEYS
def pick_serve_bucket(bucket: int | None = None) -> int:
    """The transform micro-bucket width (recorded as ``bucket``)."""
    return int(bucket) if bucket else DEFAULT_BUCKET


# graftlint: disable=policy-recorded -- its argument or the
# module default; the port has no serve bench record for ``iters``
# (the JAX package's), and the daemon's latency record keys
# are serve/sched.SCHED_RECORD_KEYS
def pick_transform_iters(iters: int | None = None) -> int:
    """Fixed query-row optimize iterations (recorded as ``iters``)."""
    return int(iters) if iters else DEFAULT_ITERS


# graftlint: disable=policy-recorded -- its argument or the
# module default; the port has no serve bench record for ``eta``
# (the JAX package's), and the daemon's latency record keys
# are serve/sched.SCHED_RECORD_KEYS
def pick_transform_eta(eta: float | None = None) -> float:
    """Query-row step size (recorded as ``eta``): NOT the trained
    learning rate and not scaled by N.  The query path optimizes the
    per-row conditional KL, whose gradient is O(1) embedding units at any
    N, and must close the interpolation-init gap within a fixed budget;
    the JAX package measured every eta in 0.1-2.0 reaching the same
    equilibrium on its 60k self-transform sweep and took 0.5."""
    return float(eta) if eta is not None else DEFAULT_ETA


def interpolation_init(p: torch.Tensor, idx: torch.Tensor,
                       yb: torch.Tensor) -> torch.Tensor:
    """Each row starts at the affinity-weighted mean of its neighbours'
    frozen coordinates, ``y0_i = Σ_a p[i, a] · yb[idx[i, a]]``; a row of
    zero affinities lands at the origin.  ``[B, m]`` in ``yb``'s dtype.
    The landmark schedule shares it (``models/tsne.landmark_optimize``)."""
    dt = torch.promote_types(p.dtype, yb.dtype)
    return torch.einsum("bk,bkm->bm", p.to(dt),
                        yb[idx.long()].to(dt)).to(yb.dtype)


class _Stages:
    """The three stage callables of one (model, bucket, iters, eta).  They
    take the model's tensors as arguments and close over none, so a
    cached entry keeps no evicted model's tensors alive."""

    def __init__(self, knn, init, optimize):
        self.knn = knn
        self.init = init
        self.optimize = optimize

    def cache_states(self) -> tuple:
        from tsne_flink_tpu_torch.kernels.build import cache_state
        return (cache_state(),) * 3


def _momentum_switch(iters: int) -> int:
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    return TsneConfig(iterations=iters).momentum_switch


def _build_stages(model, bucket: int, iters: int, eta: float,
                  matmul_dtype=None) -> _Stages:
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.ops.affinities import pairwise_affinities
    from tsne_flink_tpu_torch.ops.attraction_cuda import attraction_forces
    from tsne_flink_tpu_torch.ops.knn import knn_queries
    from tsne_flink_tpu_torch.ops.repulsion_cuda import cuda_exact_repulsion
    from tsne_flink_tpu_torch.ops.repulsion_fft import fft_field_repulsion

    k, metric, perplexity = model.k, model.metric, model.perplexity
    fft = model.repulsion == "fft"
    min_gain = TsneConfig().min_gain
    mom_switch = _momentum_switch(iters)

    def knn(q, xb):
        return knn_queries(q, xb, k, metric, matmul_dtype)

    def init(dist, idx, yb):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            p = pairwise_affinities(dist, perplexity)
            return p, interpolation_init(p, idx, yb)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def optimize(y0, idx, p, yb, field):
        n_base = yb.shape[0]
        y, upd, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
        for i in range(iters):
            att = attraction_forces(y, yb, idx, p, 1.0,
                                    row_chunk=bucket).to(y.dtype)
            if fft:
                rep, z_row = fft_field_repulsion(field, y)
            else:
                rep, z_row = cuda_exact_repulsion(
                    y, yb, row_offset=n_base, row_chunk=bucket, row_z=True)
            # per-row Z: the conditional query distribution normalizes
            # over the base alone, so row i's gradient cannot see row j
            z_row = torch.clamp(z_row, min=Z_FLOOR)
            grad = att - rep.to(y.dtype) / z_row.to(y.dtype)[:, None]
            momentum = 0.5 if i < mom_switch else 0.8
            same_sign = (grad > 0.0) == (upd > 0.0)
            gains = torch.clamp(torch.where(same_sign, gains * 0.8,
                                            gains + 0.2), min=min_gain)
            upd = momentum * upd - eta * gains * grad
            y = y + upd
        return y

    return _Stages(knn=knn, init=init, optimize=optimize)


def stage_cache(model, bucket: int, iters: int, eta: float,
                matmul_dtype=None) -> _Stages:
    """The stages of ``model`` at this (bucket, iters, eta) and query-kNN
    operand dtype, built on first use and kept for the process."""
    key = (model.model_id, int(bucket), int(iters), float(eta))
    if matmul_dtype is not None:
        key += (str(matmul_dtype),)
    got = _STAGES.get(key)
    if got is None:
        got = _STAGES[key] = _build_stages(model, bucket, iters, eta,
                                           matmul_dtype)
    return got


def _run_bucket(model, stages: _Stages, q: torch.Tensor) -> torch.Tensor:
    idx, dist = stages.knn(q, model.x)
    p, y0 = stages.init(dist, idx, model.y)
    return stages.optimize(y0, idx, p, model.y, model.field)


def _to_device(qp: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host bucket on ``device``; on the card through pinned memory and
    an asynchronous copy, so no host sync waits for earlier buckets."""
    t = torch.from_numpy(qp)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def dispatch_bucket(model, q_padded, *, bucket: int | None = None,
                    iters: int | None = None, eta: float | None = None):
    """Run the three stages over ONE pre-padded ``[bucket, d]`` array and
    return the ``[bucket, m]`` result tensor on the model's device WITHOUT
    a host sync: on the card the call returns once the work is enqueued,
    so the daemon's double-buffered tick overlaps spool I/O with compute,
    and ``.cpu()`` on the result is what blocks.  Same stages and padding
    as :func:`transform`, so a bucket packed from many requests is
    bit-identical to serving each alone."""
    bucket = pick_serve_bucket(bucket)
    iters = pick_transform_iters(iters)
    eta = pick_transform_eta(eta)
    stages = stage_cache(model, bucket, iters, eta)
    qp = np.ascontiguousarray(np.asarray(q_padded, dtype=model.np_dtype))
    if qp.shape != (bucket, model.x.shape[1]):
        raise ValueError(f"dispatch_bucket wants [{bucket}, "
                         f"{model.x.shape[1]}] pre-padded, got {qp.shape}")
    return _run_bucket(model, stages, _to_device(qp, model.x.device))


def warm_stages(model, *, bucket: int | None = None,
                iters: int | None = None, eta: float | None = None) -> tuple:
    """Build the stages of ``model`` and run one bucket through them (the
    kernels' first launch builds the library), so a swapped-in model
    never pays that on the serving path; returns the cache states."""
    bucket = pick_serve_bucket(bucket)
    iters = pick_transform_iters(iters)
    eta = pick_transform_eta(eta)
    transform(model, model.x[:1].cpu().numpy(), bucket=bucket, iters=iters,
              eta=eta)
    return stage_cache(model, bucket, iters, eta).cache_states()


def transform(model, x_new, *, bucket: int | None = None,
              iters: int | None = None, eta: float | None = None,
              matmul_dtype=None) -> np.ndarray:
    """Embed ``x_new`` into the frozen map; returns ``[B, m]`` numpy.
    Deterministic: no random draw anywhere (the init is the affinity
    interpolation), so the same (model, queries) pair gives the same bits
    across processes, restarts and batch splits.  ``matmul_dtype`` (the
    CLI's ``--transform`` under ``--dtype bfloat16``) rounds the query
    sweep's operands (``ops/knn.knn_queries``)."""
    bucket = pick_serve_bucket(bucket)
    iters = pick_transform_iters(iters)
    eta = pick_transform_eta(eta)
    stages = stage_cache(model, bucket, iters, eta, matmul_dtype)
    d = model.x.shape[1]
    xq = np.asarray(x_new)
    if xq.ndim != 2 or xq.shape[1] != d:
        raise ValueError(f"queries must be [B, {d}], got {xq.shape}")
    xq = np.ascontiguousarray(xq, dtype=model.np_dtype)
    out = []
    for s in range(0, max(xq.shape[0], 1), bucket):
        chunk = xq[s:s + bucket]
        rows = chunk.shape[0]
        qp = (chunk if rows == bucket
              else np.pad(chunk, ((0, bucket - rows), (0, 0))))
        yq = _run_bucket(model, stages, _to_device(qp, model.x.device))
        out.append(yq[:rows])
    return torch.cat(out).cpu().numpy()
