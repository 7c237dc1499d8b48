"""Pipeline plan descriptions — the memory model's input (port of
``tsne_flink_tpu/analysis/audit/plan.py``, the same fields and defaults,
save ``backend``, which defaults to the card).

A :class:`PlanConfig` is everything the memory model needs to reason
about one pipeline invocation WITHOUT running it: the workload shape
``(n, d, k)``, the backend (``cuda`` | ``cpu``), the compute dtype, and
the stage choices (kNN method/rounds, assembly, repulsion, attraction).
Every resolver calls the SAME policy function the port's pipeline calls
(``ops/knn.resolve_knn_plan``, ``utils/cli.pick_repulsion``, the
``affinity_auto`` byte gate), so the modelled plan cannot drift from the
launched one.  Plans are JSON-serializable.

``sym_width`` is the hub-widened symmetrized row width when known (it is
data-dependent); ``None`` falls back, as in the JAX model, to the
lossless lower bound ``2k`` (rounded to 8), an underestimate on hub-heavy
graphs.  What a run is charged does not rest on it:
``hbm.charged_peak_bytes`` takes the widest rows the run may build, and
the run supervisor narrows that to ``ops/affinities.width_bound`` of the
kNN graph once the graph exists.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass

KNN_PADDING_MODES = ("index-space", "materialized")


def card_memory_bytes(device=None) -> int | None:
    """The card's memory in bytes (``torch.cuda.get_device_properties``),
    or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(
        device if device is not None else 0).total_memory)


@dataclass(frozen=True)
class PlanConfig:
    """One pipeline invocation, statically described."""

    n: int
    d: int
    k: int = 90
    backend: str = "cuda"
    dtype: str = "float32"
    n_components: int = 2
    iterations: int = 300
    knn_method: str = "project"
    knn_rounds: int | None = None    # None = pick_knn_rounds(n)
    knn_refine: int | None = None    # None = pick_knn_refine(n, d)
    repulsion: str = "auto"          # None/auto = pick_repulsion(...)
    theta: float = 0.25
    theta_explicit: bool = False
    assembly: str = "auto"
    attraction: str = "auto"
    sym_width: int | None = None     # measured hub width when known
    row_chunk: int = 2048            # optimizer tile rows (TsneConfig)
    knn_padding: str = "index-space"
    #: width of the point mesh the optimize loop runs on (the run's
    #: ``--mesh`` / ``TSNE(mesh=)``; 1 on the single-device path): the
    #: optimize stage's row terms are one device's share, ``n_local`` rows
    mesh: int = 1
    #: pinned FFT grid (None = repulsion_fft.DEFAULT_GRID)
    fft_grid: int | None = None
    #: the approximation autopilot is armed
    autopilot: bool = False
    #: query rows per transform bucket when this plan describes a SERVING
    #: process (0 = batch fit, no transform stage)
    serve_queries: int = 0
    #: the kNN products' operand dtype of a mixed-precision run
    #: (``bfloat16``; None: the array's own).  ``dtype`` stays the state's
    #: (float32), as the JAX CLI's plan takes it
    matmul_dtype: str | None = None
    #: the kNN metric: cosine's exact refine stage is the plain version on
    #: the card, which gathers its candidates' vectors
    #: (``ops/knn_tiles.refine_chunk_bytes``)
    metric: str = "sqeuclidean"
    name: str = "plan"

    def __post_init__(self):
        if self.knn_padding not in KNN_PADDING_MODES:
            raise ValueError(f"knn_padding '{self.knn_padding}' not defined "
                             f"({' | '.join(KNN_PADDING_MODES)})")
        if self.assembly not in ("auto", "sorted", "split", "blocks"):
            raise ValueError(f"assembly '{self.assembly}' not defined")
        if int(self.mesh) < 1:
            raise ValueError(f"mesh width {self.mesh} must be >= 1")

    # ---- resolved plan quantities (the pipeline's own policies) ----

    @property
    def itemsize(self) -> int:
        return {"float32": 4, "float64": 8, "bfloat16": 2}[self.dtype]

    def resolved_method(self) -> str:
        """The kNN method the dispatch will run (``auto`` through the
        exact-vs-hybrid cost model, as ``prepare`` resolves it)."""
        method, _, _ = self._resolved_plan()
        return method

    def resolved_knn(self) -> tuple[int, int]:
        """(rounds, refine) as ``prepare`` resolves them."""
        _, rounds, refine = self._resolved_plan()
        return (rounds or 0, refine or 0)

    def _resolved_plan(self):
        if self.knn_method == "precomputed":
            return "precomputed", None, None
        from tsne_flink_tpu_torch.ops.knn import resolve_knn_plan
        return resolve_knn_plan(self.n, self.d, self.knn_method,
                                self.knn_rounds, self.knn_refine, k=self.k,
                                backend=self.backend)

    def resolved_repulsion(self) -> str:
        """The repulsion the optimizer will dispatch."""
        from tsne_flink_tpu_torch.utils.cli import pick_repulsion
        return pick_repulsion(self.repulsion or "auto", self.theta, self.n,
                              self.n_components, self.theta_explicit,
                              backend=self.backend)

    def sym_width_est(self) -> int:
        """Symmetrized row width: the measured width when the plan carries
        one, else the hub-free lossless bound 2k (rounded to 8)."""
        if self.sym_width is not None:
            return int(self.sym_width)
        return max(8, (2 * self.k + 7) // 8 * 8)

    def resolved_assembly(self) -> str:
        """``auto`` resolved through the byte gate of
        ``ops/affinities.affinity_auto``: split rows when the estimated
        [N, S] layout fits ``ROWS_BYTES_MAX``, else blocks."""
        if self.assembly != "auto":
            return self.assembly
        from tsne_flink_tpu_torch.ops.affinities import ROWS_BYTES_MAX
        rows_bytes = self.n * self.sym_width_est() * (4 + self.itemsize)
        return "split-rows" if rows_bytes <= ROWS_BYTES_MAX else "blocks"

    def hbm_budget(self) -> int | None:
        """The device's memory for the admission gate: the card's on
        ``cuda`` (None without a card), None on the CPU (host RAM is not
        a launch-refusal criterion)."""
        return card_memory_bytes() if self.backend == "cuda" else None

    # ---- (de)serialization ----

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PlanConfig":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, path: str) -> "PlanConfig":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def bench_plan(n: int = 60_000, d: int = 784, k: int = 90,
               backend: str = "cuda", **kw) -> PlanConfig:
    """The headline workload (the smoke's 60k x 784 blobs, config 2's
    shape) as a PlanConfig."""
    return PlanConfig(n=n, d=d, k=k, backend=backend,
                      name=kw.pop("name", f"bench-{n // 1000}k-{backend}"),
                      **kw)
