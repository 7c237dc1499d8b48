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

:class:`PlanConfig` holds only the plan fields serving reads; the JAX
package's full ``PlanConfig`` and its HBM report belong to the analysis
tier (ROADMAP queue A16).  :meth:`FrozenModel.transform_peak` is the
arithmetic of the JAX ``analysis/audit/hbm._transform_stage``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace

import numpy as np
import torch

#: the factor the JAX HBM model charges a pipelined transient tile
#: (``analysis/audit/hbm.PIPELINE_FACTOR``)
PIPELINE_FACTOR = 2


@dataclass(frozen=True)
class PlanConfig:
    """The fields of a run's plan that serving reads (the JAX
    ``analysis/audit/plan.PlanConfig``'s names and defaults)."""

    n: int
    d: int
    k: int = 90
    n_components: int = 2
    backend: str = "cuda"            # cuda | cpu
    repulsion: str = "auto"          # auto resolves by pick_repulsion
    theta: float = 0.25
    theta_explicit: bool = False
    row_chunk: int = 2048
    itemsize: int = 4
    fft_grid: int | None = None      # None: repulsion_fft.DEFAULT_GRID
    serve_queries: int = 0           # rows a transform bucket holds
    name: str = "plan"

    def resolved_repulsion(self) -> str:
        """The repulsion the optimizer would dispatch for this plan."""
        from tsne_flink_tpu_torch.utils.cli import pick_repulsion
        return pick_repulsion(self.repulsion or "auto", self.theta, self.n,
                              self.n_components, self.theta_explicit,
                              backend=self.backend)


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


def _transform_stage(plan: PlanConfig) -> dict:
    """The serving process's steady state in bytes: the frozen model
    resident (base X and Y, the [N, k] graph of a fat checkpoint, the FFT
    potentials when fft serves) plus one bucket of ``serve_queries`` rows'
    transients (the [c, N] query sweep, the query working set, the
    attraction and repulsion tiles)."""
    n, d, k, m, isz = (plan.n, plan.d, plan.k, plan.n_components,
                       plan.itemsize)
    b = int(plan.serve_queries)
    rep = plan.resolved_repulsion()
    terms: dict = {"repulsion": rep}
    model = float(n * d * isz + n * m * isz + n * k * (4 + isz))
    if rep == "fft":
        from tsne_flink_tpu_torch.ops.repulsion_fft import DEFAULT_GRID
        g = plan.fft_grid or DEFAULT_GRID.get(m, 1024)
        model += float((2 + m) * g ** m * isz)
    terms["model"] = model
    from tsne_flink_tpu_torch.ops.knn_tiles import pick_knn_tiles
    tiles = pick_knn_tiles(max(b, 1), d, k, plan.backend)
    c = min(tiles.row_chunk, max(b, 1))
    terms["knn_tile"] = PIPELINE_FACTOR * c * n * isz
    terms["queries"] = float(b * d * isz + 3.0 * b * m * isz
                             + b * k * (4 + 2.0 * isz))
    rows = min(plan.row_chunk, max(b, 1))
    attr = PIPELINE_FACTOR * rows * k * (m * isz + 4.0 * isz)
    rep_tile = 0.0 if rep == "fft" else PIPELINE_FACTOR * rows * n * isz
    terms["attraction"] = attr
    terms["repulsion_tile"] = rep_tile
    terms["peak"] = (model + terms["knn_tile"] + terms["queries"] + attr
                     + rep_tile)
    return terms


def residency_report(plans) -> dict:
    """Several resident models: their arrays all at once, plus at most
    two buckets' transients (the double-buffered tick), beside the
    conservative sum the admission gate charges."""
    stages = [_transform_stage(p) for p in plans]
    resident = float(sum(s["model"] for s in stages))
    transient = max((float(s["peak"]) - float(s["model"]) for s in stages),
                    default=0.0)
    return {"models": len(stages),
            "resident_bytes": int(resident),
            "transient_bytes": int(transient),
            "peak_bytes": int(resident + 2.0 * transient),
            "conservative_sum_bytes": int(sum(float(s["peak"])
                                              for s in stages))}


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
        raise NotImplementedError("the full HBM report of a serving plan is "
                                  "the analysis tier (ROADMAP queue A16); "
                                  "transform_peak gives its admission unit")

    def transform_peak(self, bucket: int) -> int:
        """Predicted peak bytes of this model serving ``bucket``-row
        buckets: the unit the daemon's residency admission sums."""
        return int(_transform_stage(self.serve_plan(int(bucket)))["peak"])


def from_arrays(x, y, plan: PlanConfig, *, perplexity: float = 30.0,
                learning_rate: float = 1000.0, metric: str = "sqeuclidean",
                ckpt_hash: str | None = None, device=None) -> FrozenModel:
    """A FrozenModel from arrays (the estimator freezes its own fit this
    way).  ``model_id`` = sha256 over the checkpoint content hash when
    there is one, else the embedding's fingerprint, with the base
    features' fingerprint and the serving repulsion.  On the card the
    tensors are float32 (the kernels' type); on the CPU they keep the
    features' dtype."""
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
    dtype = torch.float32 if device.type == "cuda" else None
    xd = torch.as_tensor(np.array(x_np), dtype=dtype, device=device)
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
                metric: str = "sqeuclidean", device=None) -> FrozenModel:
    """A fat v2 checkpoint as a FrozenModel, its base features supplied
    by the caller (checkpoints do not carry the input: the CLI's
    ``--model`` pairs with ``--input``)."""
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
                       ckpt_hash=content_hash, device=device)


def frozen_from_files(ckpt_path: str, input_path: str, *,
                      perplexity: float = 10.0,
                      learning_rate: float = 1000.0,
                      metric: str = "sqeuclidean",
                      neighbors: int | None = None,
                      repulsion: str = "auto", name: str = "swap",
                      device=None) -> FrozenModel:
    """A FrozenModel from (checkpoint, input ``.npy``) paths: the loader
    behind the daemon's ``<name>.swap.json`` hot-swap files."""
    from tsne_flink_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    x = np.load(input_path)
    k = int(neighbors) if neighbors is not None else 3 * int(perplexity)
    plan = PlanConfig(n=int(x.shape[0]), d=int(x.shape[1]), k=k,
                      backend=device.type, repulsion=repulsion,
                      name=f"serve-load-{name}")
    return load_frozen(ckpt_path, x, plan, perplexity=float(perplexity),
                       learning_rate=float(learning_rate), metric=metric,
                       device=device)
