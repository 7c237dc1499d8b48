"""FrozenModel — a fitted embedding as a device-resident, read-only model
(port of ``tsne_flink_tpu/serve/model.py``).

One load pays everything the query path needs from the base set: the
base features ``x`` (the query kNN and β search run against them), the
base embedding ``y`` (interpolation init, attraction and repulsion
targets), the plan, and for an fft-serving plan the precomputed FFT
field of the frozen base (``ops/repulsion_fft.fft_base_field``), which
leaves only the per-query gather to serving time.

:func:`load_frozen` opens a checkpoint through
``utils/checkpoint.load_model`` (one verified read, nothing written;
v1 and hash-less files refused).  ``model_id`` is the JAX package's,
computed with the same sha256 recipe over the same numpy bytes, so a
request that pins a model id names the same model on both packages.

:class:`PlanConfig` is the memory model's (``analysis/audit/plan.py``,
the JAX package's fields), and :meth:`FrozenModel.transform_peak` its
transform stage (``analysis/audit/hbm.transform_peak_bytes``): the JAX
arithmetic plus the query kNN's sort (``query_sort``), and on the card
the port's own terms; :meth:`FrozenModel.admission_report` is the
plan's whole report (``plan_hbm_report``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from tsne_flink_tpu_torch.analysis.audit.hbm import (plan_hbm_report,
                                                     residency_report,
                                                     transform_peak_bytes)
from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig

__all__ = ["FrozenModel", "PlanConfig", "from_arrays", "frozen_from_files",
           "load_frozen", "residency_report", "serve_repulsion"]

def _fingerprint(*arrays) -> str:
    """sha256 over (dtype, shape, bytes) of each array, in order (the JAX
    package's recipe)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(repr((a.dtype.str, a.shape)).encode())
        h.update(a.view(np.uint8).reshape(-1).data)
    return h.hexdigest()


def serve_repulsion(plan: PlanConfig) -> str:
    """The repulsion the QUERY path runs: the plan's, with ``bh`` demoted
    to ``exact`` (a tree rebuilt every iteration amortizes nothing
    against a frozen base at bucket sizes; the fft field precomputes
    entirely)."""
    return "fft" if plan.resolved_repulsion() == "fft" else "exact"


@dataclass(frozen=True)
class FrozenModel:
    """The loaded model: device-resident tensors, identity and plan.
    Nothing in the serving path writes to it; the transform stages take
    its tensors as arguments."""

    x: torch.Tensor      # [N, d] base features
    y: torch.Tensor      # [N, m] base embedding, its own allocation
    plan: PlanConfig
    perplexity: float
    learning_rate: float
    metric: str
    repulsion: str       # exact | fft (serve_repulsion)
    model_id: str
    ckpt_hash: str | None = None
    field: object = None  # ops/repulsion_fft.FftField for fft serving

    @property
    def n(self) -> int:
        return int(self.x.shape[0])

    @property
    def k(self) -> int:
        return int(min(self.plan.k, self.n))

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy dtype of the base features (queries are cast to it)."""
        return torch.empty(0, dtype=self.x.dtype).numpy().dtype

    def serve_plan(self, bucket: int) -> PlanConfig:
        """This model's plan as a serving plan of ``bucket``-row buckets."""
        return replace(self.plan, serve_queries=int(bucket),
                       name=f"serve-{self.plan.name}")

    def admission_report(self, bucket: int) -> dict:
        """The memory model's report of this model serving ``bucket``-row
        buckets, the frozen model counted as resident (the ``transform``
        stage of ``analysis/audit/hbm.py``)."""
        return plan_hbm_report(self.serve_plan(bucket))

    def transform_peak(self, bucket: int) -> int:
        """Predicted peak bytes of this model serving ``bucket``-row
        buckets: the unit the daemon's residency admission sums."""
        return transform_peak_bytes(self.serve_plan(int(bucket)))


def frozen_dtype(device_type: str, dtype=None):
    """The dtype a frozen model's tensors take, from the device type and
    the dtype the caller asked for (``dtype``: ``torch.float64`` for a
    float64 fit, an ``x64`` serve spec or ``--dtype float64``; None
    otherwise).  On the card float64 when asked for (the kernels' float64
    forms serve it), else float32; on the CPU None: the base features'
    own dtype, as the JAX ``from_arrays`` keeps x's."""
    if device_type != "cuda":
        return None
    return torch.float64 if dtype == torch.float64 else torch.float32


def from_arrays(x, y, plan: PlanConfig, *, perplexity: float = 30.0,
                learning_rate: float = 1000.0, metric: str = "sqeuclidean",
                ckpt_hash: str | None = None, device=None,
                dtype=None) -> FrozenModel:
    """A FrozenModel from arrays (the estimator freezes its own fit this
    way).  ``model_id`` = sha256 over the checkpoint content hash when
    there is one, else the embedding's fingerprint, with the base
    features' fingerprint and the serving repulsion.  The tensors take
    :func:`frozen_dtype` of the device and ``dtype``: on the card float32,
    or float64 when the caller asks for it; on the CPU the features'
    dtype."""
    from tsne_flink_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    x_np, y_np = np.asarray(x), np.asarray(y)
    if x_np.shape[0] != y_np.shape[0]:
        raise ValueError(f"base features and embedding disagree on N: "
                         f"{x_np.shape[0]} vs {y_np.shape[0]}")
    rep = serve_repulsion(plan)
    emb_id = ckpt_hash if ckpt_hash else _fingerprint(y_np)
    model_id = hashlib.sha256(
        f"{emb_id}|{_fingerprint(x_np)}|{rep}".encode()).hexdigest()[:16]
    xd = torch.as_tensor(np.array(x_np),
                         dtype=frozen_dtype(device.type, dtype),
                         device=device)
    if device.type == "cuda":
        # the memory model charges the bytes the card's tensors take
        plan = replace(plan, dtype=str(xd.dtype).removeprefix("torch."))
    # a fresh contiguous allocation: B5 gathers y's rows as 16-byte vectors
    yd = torch.tensor(y_np, dtype=xd.dtype, device=device).contiguous()
    field = None
    if rep == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import fft_base_field
        field = fft_base_field(yd)
    return FrozenModel(x=xd, y=yd, plan=plan, perplexity=float(perplexity),
                       learning_rate=float(learning_rate), metric=metric,
                       repulsion=rep, model_id=model_id, ckpt_hash=ckpt_hash,
                       field=field)


def load_frozen(ckpt_path: str, x, plan: PlanConfig, *,
                perplexity: float = 30.0, learning_rate: float = 1000.0,
                metric: str = "sqeuclidean", device=None,
                dtype=None) -> FrozenModel:
    """A fat v2 checkpoint as a FrozenModel, its base features supplied
    by the caller (checkpoints do not carry the input: the CLI's
    ``--model`` pairs with ``--input``); ``dtype`` as
    :func:`from_arrays` takes it."""
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt

    state, _, _, _, content_hash = ckpt.load_model(ckpt_path)
    x_arr = np.asarray(x)
    if state.y.shape[0] != x_arr.shape[0]:
        raise ValueError(
            f"checkpoint {ckpt_path} embeds {state.y.shape[0]} points but "
            f"the supplied base features carry {x_arr.shape[0]} rows — "
            "the --model/--input pair must describe the same dataset")
    return from_arrays(x_arr, state.y, plan, perplexity=perplexity,
                       learning_rate=learning_rate, metric=metric,
                       ckpt_hash=content_hash, device=device, dtype=dtype)


def frozen_from_files(ckpt_path: str, input_path: str, *,
                      perplexity: float = 10.0,
                      learning_rate: float = 1000.0,
                      metric: str = "sqeuclidean",
                      neighbors: int | None = None,
                      repulsion: str = "auto", name: str = "swap",
                      device=None, dtype=None) -> FrozenModel:
    """A FrozenModel from (checkpoint, input ``.npy``) paths: the loader
    behind the daemon's ``<name>.swap.json`` hot-swap files (``dtype`` as
    :func:`from_arrays` takes it)."""
    from tsne_flink_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    x = np.load(input_path)
    k = int(neighbors) if neighbors is not None else 3 * int(perplexity)
    plan = PlanConfig(n=int(x.shape[0]), d=int(x.shape[1]), k=k,
                      backend=device.type, repulsion=repulsion,
                      name=f"serve-load-{name}")
    return load_frozen(ckpt_path, x, plan, perplexity=float(perplexity),
                       learning_rate=float(learning_rate), metric=metric,
                       device=device, dtype=dtype)
