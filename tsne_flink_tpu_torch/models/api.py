"""Estimator API: ``TSNE(...).fit_transform(X)`` (port of
``tsne_flink_tpu/models/api.py``).

The in-process twin of the CLI: the JAX estimator's keyword arguments and
defaults, plus ``device`` (None: the card) and ``fault_plan`` (the CLI's
``--faultPlan``; the JAX estimator reads it from the environment).
``fit`` runs the port's ``tsne_embed`` and sets ``embedding_``,
``kl_trace_`` (the KL at every 10th iteration) and ``kl_divergence_``
(the last of them).  With ``health_check``, ``telemetry``, ``autopilot``,
a fault plan or a mesh (``mesh=N``, or the deprecated ``spmd=True`` over
``devices`` or all visible devices) it takes the supervised path instead
(``runtime/supervisor.supervised_embed``, as the JAX estimator does; the
mesh runs the optimize stage on ``parallel/mesh.ShardedOptimizer`` with
``mesh_reduce``); ``spmd=True`` in a process of a multi-controller job
(a ``torch.distributed`` group of more than one rank, opened by
``parallel/mesh.distributed_init``) runs this rank's shard of
``parallel/pipeline.SpmdPipeline`` instead, with ``sym_width``,
``sym_mode``, ``sym_slack`` and ``sym_strict``, and every rank gets the
embedding;
an out-of-memory error on the fast path refits through it under
``on_oom="ladder"``.  Either way it sets ``runtime_events_`` and
``degradations_`` (the supervisor's record), ``trace_`` (the fit's
spans, recorded in an ``obs/trace.collecting`` scope) and ``metrics_``
(the obs snapshot, with ``metrics_["telemetry"]`` and
``metrics_["policy"]`` when those ran).  ``aot_cache`` False builds the
kernel library into a directory of the process's own
(``kernels/build.set_cache``).  ``dtype="float64"`` runs on the card
through the kernels' float64 forms (B1_f64-B6_f64), every kNN plan
included.
``transform`` embeds new rows
into the fitted map without moving it (``serve/transform.py``): the fit
keeps its input, and ``frozen_model`` freezes the two on first use.
"""

from __future__ import annotations

import numpy as np
import torch

from tsne_flink_tpu_torch.models.tsne import TsneConfig, tsne_embed


def _group_size() -> int:
    """The ranks of the open ``torch.distributed`` process group (1 with
    none)."""
    from tsne_flink_tpu_torch.parallel.mesh import group_size
    return group_size()


class TSNE:
    """t-SNE estimator on the card (or ``device="cpu"``).

    Parameters are :class:`TsneConfig`'s plus the kNN stage's, named as
    in the JAX package (``n_iter``, ``random_state`` as in scikit-learn).
    ``dtype`` None means float32 on the card (the kernels' type) and the
    input's dtype on the CPU; ``bfloat16`` is mixed precision, as in the
    JAX package: float32 state with bf16 operands in the kNN stage's
    distance and projection products (B1's bf16 form on the card), for
    ``fit`` alone (``transform`` runs float32 operands).  ``cache_dir`` enables the prepare-artifact
    cache under that root (None: off; a library writes no file unasked).
    ``fault_plan`` installs a fault plan for the fit (``runtime/faults``;
    deactivated when the fit ends).  ``mesh`` is a width (N distinct
    devices) or an explicit device list (the test mesh: one card listed
    once a shard).
    """

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 early_exaggeration: float = 4.0, learning_rate: float = 1000.0,
                 n_iter: int = 300, metric: str = "sqeuclidean",
                 initial_momentum: float = 0.5, final_momentum: float = 0.8,
                 theta: float | None = None, repulsion: str = "auto",
                 knn_method: str = "bruteforce", neighbors: int | None = None,
                 knn_blocks: int | None = None,
                 knn_iterations: int | None = None,
                 knn_refine: int | None = None, knn_autotune: bool = False,
                 random_state: int = 0,
                 spmd: bool = False, devices: int | None = None,
                 mesh=None,
                 sym_mode: str = "replicated", attraction: str = "auto",
                 sym_width: int | None = None, sym_slack: int | None = None,
                 sym_strict: bool = False, bh_gate: str = "vdm",
                 dtype: str | None = None,
                 affinity_assembly: str | None = None,
                 cache_dir: str | None = None,
                 max_retries: int = 2, on_oom: str = "ladder",
                 health_check: bool = False,
                 aot_cache: bool | None = None,
                 telemetry: bool = False,
                 autopilot: bool = False,
                 mesh_reduce: str = "canonical", device=None,
                 fault_plan: str | None = None):
        from tsne_flink_tpu_torch.ops.affinities import ATTRACTION_MODES
        from tsne_flink_tpu_torch.utils.cli import REPULSION_CHOICES

        checks = (("bh_gate", bh_gate, ("vdm", "flink")),
                  ("attraction", attraction, ATTRACTION_MODES),
                  ("repulsion", repulsion, REPULSION_CHOICES),
                  ("affinity_assembly", affinity_assembly,
                   (None, "auto", "sorted", "split", "blocks")),
                  ("on_oom", on_oom, ("ladder", "fail")),
                  ("mesh_reduce", mesh_reduce, ("canonical", "psum")))
        for name, value, allowed in checks:
            if value not in allowed:
                raise ValueError(f"{name} '{value}' not defined ("
                                 + " | ".join(map(str, allowed)) + ")")
        self.n_components = n_components
        self.perplexity = perplexity
        self.early_exaggeration = early_exaggeration
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.metric = metric
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        # None = defaulted (0.25, Tsne.scala:59); an explicit theta steers
        # repulsion="auto" to Barnes-Hut above EXACT_N_MAX, as --theta does
        self.theta_explicit_ = theta is not None
        self.theta = 0.25 if theta is None else theta
        self.repulsion = repulsion
        self.knn_method = knn_method
        self.neighbors = neighbors
        self.knn_blocks = knn_blocks  # None: the device count (--knnBlocks)
        self.knn_iterations = knn_iterations
        self.knn_refine = knn_refine
        self.knn_autotune = knn_autotune
        self.random_state = random_state
        if spmd:
            import warnings
            warnings.warn("TSNE(spmd=True) is deprecated — the pipeline is "
                          "mesh-parametric (graftmesh); use TSNE(mesh=N) "
                          "instead", DeprecationWarning, stacklevel=2)
        self.spmd = spmd
        self.devices = devices
        self.mesh = mesh
        self.sym_mode = sym_mode
        self.attraction = attraction
        self.sym_width = sym_width
        self.sym_slack = sym_slack
        self.sym_strict = sym_strict
        self.bh_gate = bh_gate
        self.dtype = dtype
        self.affinity_assembly = affinity_assembly
        self.cache_dir = cache_dir
        self.max_retries = max_retries
        self.on_oom = on_oom
        self.health_check = health_check
        self.aot_cache = aot_cache
        self.telemetry = telemetry
        self.autopilot = autopilot
        self.mesh_reduce = mesh_reduce
        self.device = device
        self.fault_plan = fault_plan
        self.embedding_ = None
        self.kl_divergence_ = None
        self.kl_trace_ = None
        self.runtime_events_ = None
        self.degradations_ = None
        self.trace_ = None
        self.metrics_ = {}
        self._fit_x = self._frozen = None

    @property
    def _matmul_dtype(self):
        """The kNN products' operand dtype: bf16 under
        ``dtype="bfloat16"``, else None (the card's default stays 3xTF32:
        ``ops/metrics.default_matmul_dtype``)."""
        from tsne_flink_tpu_torch.ops.metrics import resolve_matmul_dtype
        return resolve_matmul_dtype(self.dtype)[1]

    def _mesh(self, device: torch.device):
        """The optimize stage's mesh devices (``parallel/mesh.make_mesh``:
        a width past the visible devices raises here, before the input
        is read), or None for the single-device path.  ``devices`` alone
        is a width too, as the CLI's ``--devices``."""
        if self.mesh is None and self.devices is None and not self.spmd:
            return None
        from tsne_flink_tpu_torch.parallel.mesh import make_mesh
        if isinstance(self.mesh, (list, tuple)):
            return make_mesh(list(self.mesh))
        width = self.mesh if self.mesh is not None else self.devices
        return make_mesh(width, device)

    def _config(self, n: int, backend: str = "cuda") -> TsneConfig:
        from tsne_flink_tpu_torch.utils.cli import pick_repulsion

        repulsion = pick_repulsion(self.repulsion, self.theta, n,
                                   self.n_components, self.theta_explicit_,
                                   backend=backend)
        return TsneConfig(
            n_components=self.n_components, perplexity=self.perplexity,
            early_exaggeration=self.early_exaggeration,
            learning_rate=self.learning_rate, iterations=self.n_iter,
            initial_momentum=self.initial_momentum,
            final_momentum=self.final_momentum, theta=self.theta,
            metric=self.metric, repulsion=repulsion,
            attraction=self.attraction, bh_gate=self.bh_gate,
            autopilot=self.autopilot)

    def fit(self, x, y=None) -> "TSNE":
        from tsne_flink_tpu_torch.kernels import build as kbuild
        from tsne_flink_tpu_torch.obs import metrics as obmetrics
        from tsne_flink_tpu_torch.obs import trace as obtrace
        from tsne_flink_tpu_torch.runtime import faults
        from tsne_flink_tpu_torch.utils.device import resolve_device

        device = resolve_device(self.device)
        spmd_job = self.spmd and _group_size() > 1
        mesh = None if spmd_job else self._mesh(device)
        prev_cache = kbuild.cache_enabled()
        if self.aot_cache is not None:
            kbuild.set_cache(self.aot_cache)
        if self.fault_plan:
            faults.activate(self.fault_plan)
        i0 = obtrace.event_count()
        try:
            # the fit's spans, without flipping process-global tracing
            with obtrace.collecting():
                if spmd_job:
                    self._fit_spmd(x, device)
                else:
                    self._fit_body(x, device, mesh)
        finally:
            kbuild.set_cache(prev_cache)
            if self.fault_plan:
                faults.activate(None)
        self.trace_ = obtrace.events_since(i0)
        extra = self.metrics_
        self.metrics_ = obmetrics.snapshot()
        self.metrics_.update(extra)
        return self

    def _fit_spmd(self, x, device) -> None:
        """This rank's shard of the multi-controller job (the JAX
        estimator's ``SpmdPipeline`` branch)."""
        from tsne_flink_tpu_torch.ops.knn import resolve_knn_plan
        from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
        from tsne_flink_tpu_torch.utils.artifacts import ArtifactCache

        cfg = self._config(len(x), device.type)
        x = torch.as_tensor(x, dtype=self._torch_dtype(device))
        n, d = x.shape
        k = (self.neighbors if self.neighbors is not None
             else 3 * int(cfg.perplexity))
        knn_method, _, _ = resolve_knn_plan(
            n, d, self.knn_method, self.knn_iterations, self.knn_refine,
            k=k, backend=device.type)
        pipe = SpmdPipeline(
            cfg, n, d, k, knn_method=knn_method,
            knn_rounds=self.knn_iterations, knn_refine=self.knn_refine,
            sym_width=self.sym_width, sym_mode=self.sym_mode,
            sym_slack=self.sym_slack, sym_strict=self.sym_strict,
            n_devices=self.devices,
            artifact_cache=(ArtifactCache(self.cache_dir)
                            if self.cache_dir is not None else None),
            device=device, mesh_reduce=self.mesh_reduce,
            matmul_dtype=self._matmul_dtype)
        self.metrics_ = {}
        self.runtime_events_ = []
        self.degradations_ = []
        state, losses = pipe.run_checkpointable(
            x, self.random_state, health_check=self.health_check,
            events=self.runtime_events_, telemetry=self.telemetry)
        tel = pipe._runner.telemetry_
        if self.telemetry and tel is not None:
            from tsne_flink_tpu_torch.models.tsne import TELEMETRY_FIELDS
            self.metrics_["telemetry"] = {"fields": list(TELEMETRY_FIELDS),
                                          "trace": tel.tolist()}
        self._keep_fit(x, state.y[:n], losses, cfg, device)

    def _torch_dtype(self, device):
        from tsne_flink_tpu_torch.ops.metrics import resolve_matmul_dtype
        dtype = resolve_matmul_dtype(self.dtype)[0]
        return ({"float32": torch.float32, "float64": torch.float64}
                [dtype] if dtype is not None
                else torch.float32 if device.type == "cuda" else None)

    def _keep_fit(self, x, y, losses, cfg, device) -> None:
        """The fit's results, and its input (as the fit ran it) for
        transform()."""
        self.embedding_ = y.cpu().numpy()
        self._fit_x = x.cpu().numpy()
        self._fit_cfg, self._fit_device = cfg, device
        self._frozen = None
        self.kl_trace_ = losses.cpu().numpy()
        self.kl_divergence_ = (float(self.kl_trace_[-1])
                               if self.kl_trace_.size else float("nan"))

    def _fit_body(self, x, device, mesh=None) -> None:
        from tsne_flink_tpu_torch.runtime import faults
        from tsne_flink_tpu_torch.runtime.supervisor import (
            Supervisor, is_oom, release_memory, run_plan_from_fit,
            supervised_embed)
        from tsne_flink_tpu_torch.utils.artifacts import ArtifactCache
        from tsne_flink_tpu_torch.utils.cli import _device_count

        cfg = self._config(len(x), device.type)
        x = torch.as_tensor(x, dtype=self._torch_dtype(device), device=device)
        n, d = x.shape
        k = (self.neighbors if self.neighbors is not None
             else 3 * int(cfg.perplexity))
        sup = Supervisor(
            run_plan_from_fit(n, d, k, cfg, self.affinity_assembly or "auto",
                              self.knn_method,
                              knn_rounds=self.knn_iterations,
                              knn_refine=self.knn_refine,
                              sym_width=self.sym_width,
                              mesh=1 if mesh is None else len(mesh),
                              name="estimator-fit", backend=device.type,
                              matmul_dtype=self._matmul_dtype),
            max_retries=self.max_retries, on_oom=self.on_oom,
            health_check=self.health_check)
        embed_kwargs = dict(
            neighbors=self.neighbors, knn_method=self.knn_method,
            knn_blocks=(self.knn_blocks if self.knn_blocks is not None
                        else _device_count(device)),
            knn_iterations=self.knn_iterations, knn_refine=self.knn_refine,
            knn_autotune=self.knn_autotune, seed=self.random_state,
            sym_width=self.sym_width,
            affinity_assembly=self.affinity_assembly, device=device,
            artifact_cache=(ArtifactCache(self.cache_dir)
                            if self.cache_dir is not None else None),
            matmul_dtype=self._matmul_dtype)
        self.metrics_ = {}
        # the supervisor's live record: a fit that raises (the sentinel's
        # DivergenceError) still shows what led there
        self.runtime_events_ = sup.events
        self.degradations_ = []
        run = None
        if (self.health_check or self.telemetry or self.autopilot
                or faults.injector() is not None or mesh is not None):
            run = supervised_embed(x, cfg, supervisor=sup,
                                   telemetry=self.telemetry, mesh=mesh,
                                   mesh_reduce=self.mesh_reduce,
                                   **embed_kwargs)
        else:
            try:
                # the unsupervised fast path: tsne_embed's own bits
                y_emb, losses = tsne_embed(x, cfg, **embed_kwargs)
            except Exception as e:  # noqa: BLE001 — re-raised unless an OOM
                if self.on_oom != "ladder" or not is_oom(e):
                    raise
                sup.events.append({"type": "oom", "stage": "fit",
                                   "error": str(e)[:200]})
            if sup.events:
                # refit through the supervised path, whose stage-granular
                # ladder degrades the plan; the failed attempt's memory
                # goes back first (its traceback is gone)
                sup.releases.append({"stage": "fit", **release_memory()})
                run = supervised_embed(x, cfg, supervisor=sup,
                                       **embed_kwargs)
        if run is not None:
            y_emb, losses = run.state.y, run.losses
            if run.telemetry is not None:
                from tsne_flink_tpu_torch.models.tsne import TELEMETRY_FIELDS
                self.metrics_["telemetry"] = {
                    "fields": list(TELEMETRY_FIELDS),
                    "trace": run.telemetry.cpu().numpy().tolist()}
            if self.autopilot:
                from tsne_flink_tpu_torch.models.autopilot import \
                    policy_report
                self.metrics_["policy"] = policy_report(run.cfg, run.pilot)
        self.runtime_events_ = list(sup.events)
        self.degradations_ = sup.degradations
        self._keep_fit(x, y_emb, losses, cfg, device)

    def fit_transform(self, x, y=None) -> np.ndarray:
        return self.fit(x).embedding_

    def frozen_model(self):
        """This fit as a ``serve/model.FrozenModel`` on the fit's device,
        built on first use and kept: what ``transform`` and a serve daemon
        answer queries from."""
        if self._fit_x is None:
            raise RuntimeError("transform() requires a fitted estimator — "
                               "call fit() first")
        if self._frozen is None:
            from tsne_flink_tpu_torch.serve.model import PlanConfig, from_arrays
            n, d = self._fit_x.shape
            cfg = self._fit_cfg
            k = (self.neighbors if self.neighbors is not None
                 else 3 * int(cfg.perplexity))
            plan = PlanConfig(n=n, d=d, k=k, n_components=cfg.n_components,
                              backend=self._fit_device.type,
                              repulsion=cfg.repulsion, theta=cfg.theta,
                              row_chunk=cfg.row_chunk,
                              name="estimator-serve")
            self._frozen = from_arrays(
                self._fit_x, self.embedding_, plan,
                perplexity=cfg.perplexity, learning_rate=cfg.learning_rate,
                metric=cfg.metric, device=self._fit_device,
                dtype=self._torch_dtype(self._fit_device))
        return self._frozen

    def transform(self, x, *, bucket: int | None = None,
                  iters: int | None = None) -> np.ndarray:
        """Embed NEW rows into the fitted map without moving it: query→base
        kNN, directed affinities at the trained perplexity, interpolation
        init, then a fixed number of iterations over the query rows alone
        against the frozen embedding.  Deterministic, and bit-identical
        across batch splits.  ``bucket``/``iters`` default to 256 / 75."""
        from tsne_flink_tpu_torch.serve.transform import transform
        return transform(self.frozen_model(), x, bucket=bucket, iters=iters)
