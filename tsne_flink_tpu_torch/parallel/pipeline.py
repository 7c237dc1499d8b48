"""The multi-controller job (port of ``tsne_flink_tpu/parallel/
pipeline.py``): the sharded prepare (kNN -> β search -> symmetrized P
rows) and ``models/tsne.optimize`` through ``parallel/mesh
.ShardedOptimizer``, one program a shard.

A shard is a rank: this process's rank of an open ``torch.distributed``
process group (``parallel/mesh.distributed_init``: N processes, one rank
each), or, with no group open, one Python thread a shard on a device
list (the thread mesh).  The two run the same per-shard program over the
same collectives, so a job of N processes gives the in-process job's
bits at the same width.  Every rank holds the input (each slices its own
rows) and, between optimize segments, the tiny [N, m] state.

Stage to collective, as in the JAX module:

==========================  =============================================
reference shuffle            collective here
==========================  =============================================
cross / block-cross kNN      ``ppermute`` ring (``parallel/knn.ring_knn``:
                             kernel B1's cross sweep a hop)
single-task Z-order sort     replicated Morton argsort
                             (``parallel/knn.project_knn_sharded``; the
                             refine on kernel B6)
groupBy(i) beta search       none: rows are shard-local
P + Pᵀ union/reduce shuffle  ``all_gather`` of [N, k] idx/p + the sorted
                             builder, local row slice (``replicated``), or
                             routed transpose edges (``alltoall``,
                             ``parallel/symmetrize``)
ΣP reduce (prepare)          ``psum``
Z / mean / loss (optimize)   the mesh-canonical gathered sums
full-embedding broadcast     ``all_gather`` of [N, m] an iteration
==========================  =============================================

The symmetrization's width and capacity escalate as in the JAX class:
every rank reads the same psum'd counters, so all ranks rerun together.
The kNN graph and the conditional P are computed once and only the
symmetrization reruns (the JAX class reruns its whole prepare program,
whose kNN stage gives the same graph again).  The optimize stage takes
the JAX multi-controller layout (``ShardedOptimizer(pre_padded_valid=,
unpad=False, edge_pad=)``: rows, or the flat edge list from the measured
per-shard edge count) on a thread mesh too, where the JAX class's
single-process branch takes the host-planned layout (CSR allowed): the
two differ by rounding only.  The y init is drawn as [n_padded, m] from
one generator seeded with the job's seed on every rank, then sliced, so
the embedding is the same at every width sharing the padding quantum.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from tsne_flink_tpu_torch.models.tsne import (TsneConfig, TsneState,
                                              init_working_set)
from tsne_flink_tpu_torch.obs import trace as obtrace
from tsne_flink_tpu_torch.ops.affinities import (joint_distribution,
                                                 pairwise_affinities)
from tsne_flink_tpu_torch.parallel.knn import (project_knn_sharded,
                                               ring_knn)
from tsne_flink_tpu_torch.parallel.mesh import (ShardedOptimizer, make_mesh,
                                                pad_rows, padded_rows_for,
                                                process_axis, run_shards)

KNN_METHODS = ("bruteforce", "partition", "project", "precomputed")
SYM_MODES = ("replicated", "alltoall")
KIND_SPMD = "spmd-prepare"


class SpmdPipeline:
    """End-to-end sharded t-SNE: ``__call__(x, seed)`` -> (y, losses).

    ``knn_method``: ``bruteforce`` and ``partition`` both run the exact
    ring, ``project`` the sharded Morton-band path with its refine cycles,
    ``precomputed`` skips the kNN stage (the input is then ``(idx [N, k],
    dist [N, k])``, row-sharded like points: ``--inputDistanceMatrix``).
    ``sym_mode`` ``replicated`` or ``alltoall``; ``sym_width`` /
    ``sym_slack`` None escalate (an overflowing width adopts the measured
    one, at most twice; a capacity overflow doubles the slack, at most
    four times), given values are pinned (drops warn, or raise with
    ``sym_strict``).

    The shards: with a process group open, this process's rank (its
    device ``device``: None the card, ``cuda:(rank % device_count)``);
    else ``n_devices`` (or ``devices``, an explicit list: the test mesh)
    shards of ``parallel/mesh.make_mesh`` on ``device``, one thread each.
    ``artifact_cache`` (``utils/artifacts.ArtifactCache``) keys
    :meth:`prepare`'s outputs, single-controller only, as in the JAX
    class.  ``matmul_dtype`` (None, or ``torch.bfloat16``: mixed
    precision) is the kNN products' operand dtype (``parallel/knn``).
    ``on_graph(axis, idx, valid)``, when given, is called on every shard
    once its kNN stage ends, before the affinities (the CLI's plan
    re-check at the graph's width bound)."""

    def __init__(self, cfg: TsneConfig, n: int, dim: int, k: int,
                 knn_method: str = "bruteforce", knn_rounds: int | None = None,
                 knn_refine: int | None = None,
                 sym_width: int | None = None, sym_mode: str = "replicated",
                 sym_slack: int | None = None, sym_strict: bool = False,
                 n_devices: int | None = None, artifact_cache=None, *,
                 devices=None, device=None, mesh_reduce: str = "canonical",
                 matmul_dtype=None, on_graph=None):
        if sym_mode not in SYM_MODES:
            raise ValueError(f"sym_mode '{sym_mode}' not defined")
        if knn_method not in KNN_METHODS:
            raise ValueError(f"Knn method '{knn_method}' not defined")
        from tsne_flink_tpu_torch.ops.knn import (pick_knn_refine,
                                                  pick_knn_rounds)
        self.cfg = cfg
        self.n = int(n)
        self.dim = int(dim)
        self.k = int(min(k, n - 1))
        self.knn_method = knn_method
        self.knn_rounds = (knn_rounds if knn_rounds is not None
                           else pick_knn_rounds(n))
        self.knn_refine = (knn_refine if knn_refine is not None
                           else pick_knn_refine(n, dim))
        self.sym_mode = sym_mode
        self.sym_strict = sym_strict
        self._sym_slack_pinned = sym_slack is not None
        self.sym_slack = int(sym_slack) if sym_slack is not None else 4
        self._slack_escalations = 0
        self._sym_width_pinned = sym_width is not None
        self.sym_width = (int(sym_width) if sym_width is not None
                          else max(8, (2 * self.k + 7) // 8 * 8))
        self._escalations = 0
        self.mesh_reduce = mesh_reduce
        from tsne_flink_tpu_torch.ops.metrics import check_matmul_dtype
        check_matmul_dtype(matmul_dtype)
        self.matmul_dtype = matmul_dtype
        self.on_graph = on_graph
        self.axis = process_axis(device)
        if self.axis is not None:
            if n_devices is not None and int(n_devices) != self.axis.size:
                raise ValueError(f"n_devices {n_devices} against a process "
                                 f"group of {self.axis.size} ranks")
            self.devices = [self.axis.device]
            self.n_devices = self.axis.size
        else:
            self.devices = make_mesh(list(devices) if devices is not None
                                     else n_devices, device)
            self.n_devices = len(self.devices)
        self.n_padded = padded_rows_for(self.n, self.n_devices)
        self.n_local = self.n_padded // self.n_devices
        self.artifact_cache = artifact_cache
        self._runner = None
        #: the per-shard edge count of the last prepare
        self.nnz_ = None

    # ---- the per-shard program ---------------------------------------------

    @property
    def rank(self) -> int:
        """This process's rank (0 on a thread mesh: one controller)."""
        return 0 if self.axis is None else self.axis.index

    def _ranks(self, fn) -> list:
        """``fn(axis)`` on every shard this process runs, in rank order."""
        if self.axis is not None:
            return [fn(self.axis)]
        return run_shards(self.devices, fn, mesh_reduce=self.mesh_reduce)

    def _width_escalates(self, esc: int) -> bool:
        return not self._sym_width_pinned and esc < 2

    def _slack_escalates(self, sesc: int) -> bool:
        return not self._sym_slack_pinned and sesc < 4

    def _symmetrize(self, axis, idx, p, width: int, slack: int):
        """(jidx, jval, dropped [2], needed, nnz) of the local rows."""
        if self.sym_mode == "alltoall":
            from tsne_flink_tpu_torch.parallel.symmetrize import \
                symmetrize_alltoall
            return symmetrize_alltoall(idx, p, width, slack=slack, axis=axis)
        # replicated: gather the [N, k] graph, run the sorted builder on
        # every shard, keep my row slice
        rows = slice(axis.index * self.n_local,
                     (axis.index + 1) * self.n_local)
        jidx, jval, wdrop, needed, row_deg = joint_distribution(
            axis.all_gather(idx.contiguous()), axis.all_gather(p),
            width, return_dropped=True, return_needed=True,
            return_row_deg=True)
        dev = p.device
        nnz = axis.pmax(torch.sum(row_deg[rows].to(torch.int64)))
        dropped = torch.tensor([0, wdrop], dtype=torch.int64, device=dev)
        return (jidx[rows], jval[rows], dropped,
                torch.tensor(needed, device=dev), nnz)

    def _prepare_rank(self, axis, data, seed: int, knn_draws):
        """kNN -> β search -> symmetrized local P rows on one shard, the
        symmetrization rerun until no escalation is due.  Returns (jidx,
        jval, dropped, nnz, (width, slack, escalations, slack
        escalations))."""
        cfg, nl = self.cfg, self.n_local
        dev = axis.device
        rows = slice(axis.index * nl, (axis.index + 1) * nl)
        valid = (axis.index * nl + torch.arange(nl, device=dev)) < self.n
        if self.knn_method == "precomputed":
            idx = data[0][rows].to(dev).to(torch.int32)
            dist = data[1][rows].to(dev)
        else:
            x_local = data[0][rows].to(dev)
            if self.knn_method in ("bruteforce", "partition"):
                idx, dist = ring_knn(x_local, self.k, self.n, cfg.metric,
                                     axis=axis,
                                     matmul_dtype=self.matmul_dtype)
            else:
                gen = None
                if knn_draws is None:
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(int(seed))
                idx, dist = project_knn_sharded(
                    x_local, self.k, self.n, cfg.metric,
                    rounds=self.knn_rounds, generator=gen, axis=axis,
                    draws=knn_draws, refine_rounds=self.knn_refine,
                    matmul_dtype=self.matmul_dtype)
        if self.on_graph is not None:
            self.on_graph(axis, idx, valid)
        # padding rows contribute no affinity mass
        dist = torch.where(valid[:, None], dist, math.inf)
        p = pairwise_affinities(dist, cfg.perplexity)
        width, slack = self.sym_width, self.sym_slack
        esc, sesc = self._escalations, self._slack_escalations
        loud = axis.index == 0
        while True:
            jidx, jval, dropped, needed, nnz = self._symmetrize(
                axis, idx, p, width, slack)
            cap, wid = (int(v) for v in dropped.tolist())
            if loud and cap + wid > 0:
                wid_note = ("auto-escalating width and rerunning"
                            if self._width_escalates(esc) and wid > 0
                            else "raise --symWidth")
                cap_note = ("auto-doubling slack and rerunning"
                            if self._slack_escalates(sesc) and cap > 0
                            else "raise --symSlack")
                print(f"WARNING: symmetrization dropped {cap} transpose "
                      f"edges (all_to_all capacity cap; {cap_note}) and "
                      f"{wid} merged entries (sym_width row overflow; "
                      f"{wid_note}) — use --symStrict to fail instead",
                      file=sys.stderr)
            rerun = False
            if self._width_escalates(esc) and wid > 0:
                new = max(int(needed), width + 8)
                if loud:
                    print(f"# sym_width {width} overflowed; escalating to "
                          f"{new} and rerunning", file=sys.stderr)
                width, esc, rerun = new, esc + 1, True
            if self._slack_escalates(sesc) and cap > 0:
                slack, sesc, rerun = slack * 2, sesc + 1, True
                if loud:
                    print(f"# all_to_all capacity dropped {cap} transpose "
                          f"edges; raising symSlack to {slack} and "
                          "rerunning", file=sys.stderr)
            if not rerun:
                break
        if self.sym_strict and (cap or wid):
            raise RuntimeError(
                f"symmetrization dropped {cap} transpose edges (capacity cap) "
                f"and {wid} merged entries (sym_width overflow) with "
                "--symStrict set; raise --symSlack / --symWidth")
        return jidx, jval, dropped, int(nnz), (width, slack, esc, sesc)

    def _data(self, x) -> tuple:
        arrs = x if isinstance(x, tuple) else (x,)
        want = 2 if self.knn_method == "precomputed" else 1
        if len(arrs) != want:
            raise ValueError(
                f"knn_method='{self.knn_method}' expects {want} data "
                "array(s) — pass (idx, dist) for precomputed, a single "
                "[n, d] array otherwise")
        npad = self.n_padded - self.n
        return tuple(pad_rows(torch.as_tensor(a), npad) for a in arrs)

    def _prepared(self, x, seed: int, knn_draws) -> list:
        """Every shard's (jidx, jval, dropped, nnz) of this process, the
        escalated width and slack kept."""
        data = self._data(x)
        outs = self._ranks(lambda axis: self._prepare_rank(
            axis, data, seed, knn_draws))
        (self.sym_width, self.sym_slack, self._escalations,
         self._slack_escalations) = outs[0][4]
        self.nnz_ = outs[0][3]
        return outs

    def _init_state(self, seed: int, dtype, y0=None) -> TsneState:
        """The unpadded initial state: [n_padded, m] drawn from one
        generator seeded with ``seed`` (or ``y0`` [n, m]), cut to n."""
        dev = self.devices[0]
        if y0 is not None:
            return init_working_set(None, self.n, self.cfg.n_components,
                                    dtype, dev, y0=y0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        st = init_working_set(gen, self.n_padded, self.cfg.n_components,
                              dtype, dev)
        return TsneState(*(t[:self.n] for t in st))

    @staticmethod
    def _dtype(x):
        arrs = x if isinstance(x, tuple) else (x,)
        return torch.as_tensor(arrs[-1][:0]).dtype

    # ---- the JAX class's entry points ----------------------------------------

    def _artifact_fp(self, x, seed: int) -> str | None:
        if self.artifact_cache is None or self.axis is not None:
            return None
        from tsne_flink_tpu_torch.utils import artifacts as art
        arrs = x if isinstance(x, tuple) else (x,)
        return art.fingerprint({
            "kind": KIND_SPMD,
            "data": "+".join(art.data_fingerprint(a) for a in arrs),
            "n": self.n, "k": self.k, "method": self.knn_method,
            "metric": self.cfg.metric,
            "perplexity": float(self.cfg.perplexity),
            "rounds": self.knn_rounds, "refine": self.knn_refine,
            "sym_mode": self.sym_mode,
            "sym_width": self.sym_width if self._sym_width_pinned else None,
            "sym_slack": self.sym_slack if self._sym_slack_pinned else None,
            "sym_strict": self.sym_strict, "devices": self.n_devices,
            "seed": int(seed), "dtype": str(self._dtype(x)),
            **({} if self.matmul_dtype is None
               else {"matmul_dtype": str(self.matmul_dtype)})},
            self.devices[0])

    def prepare(self, x, seed: int = 0, *, y0=None, knn_draws=None):
        """The data-prep half (kNN -> P rows -> initial state) on every
        shard; returns the UNPADDED global ``(jidx, jval, TsneState)``
        (under a process group every rank gathers them).  With an
        ``artifact_cache`` the outputs are content-addressed on disk and a
        hit skips the sharded program, bit-identical.  ``y0`` [n, m] and
        ``knn_draws`` (``parallel/knn.project_draws``' list) replace the
        init and the project kNN's draws (the parity tests inject the JAX
        package's)."""
        with obtrace.span("spmd.prepare", cat="prepare",
                          devices=int(self.n_devices)) as sp:
            fp = self._artifact_fp(x, seed) if y0 is None else None
            dev = self.devices[0]
            if fp is not None:
                got = self.artifact_cache.load(
                    KIND_SPMD, fp, ("jidx", "jval", "y", "update", "gains",
                                    "nnz"))
                if got is not None:
                    sp.set(cache="warm")
                    self.nnz_ = int(got["nnz"])
                    return (torch.as_tensor(got["jidx"], device=dev),
                            torch.as_tensor(got["jval"], device=dev),
                            TsneState(*(torch.as_tensor(got[f], device=dev)
                                        for f in ("y", "update", "gains"))))
            outs = self._prepared(x, seed, knn_draws)
            if self.axis is not None:
                jidx, jval = (self.axis.all_gather(outs[0][f].contiguous())
                              for f in (0, 1))
            else:
                jidx, jval = (torch.cat([o[f].to(dev) for o in outs])
                              for f in (0, 1))
            state = self._init_state(seed, jval.dtype, y0)
            out = (jidx[:self.n], jval[:self.n], state)
            if fp is not None:
                self.artifact_cache.save(
                    KIND_SPMD, fp, {"jidx": out[0], "jval": out[1],
                                    "y": state.y, "update": state.update,
                                    "gains": state.gains,
                                    "nnz": np.asarray(self.nnz_)})
                sp.set(cache="cold")
            return out

    def host_state(self, state: TsneState) -> TsneState:
        """A (padded or unpadded) global state -> the UNPADDED host numpy
        ``TsneState``, on every rank (every rank holds the global state
        between segments: the JAX ``process_allgather`` is the segment's
        own gather here)."""
        return TsneState(*(t[:self.n].cpu().numpy() for t in state))

    def run_checkpointable(self, x, seed: int = 0, *, start_iter: int = 0,
                           loss_carry=None, resume_state=None,
                           checkpoint_every: int = 0, checkpoint_cb=None,
                           health_check: bool = False,
                           health_retries: int = 3,
                           events: list | None = None,
                           telemetry: bool = False, y0=None, knn_draws=None):
        """prepare + the segmented ``ShardedOptimizer`` on the same shards:
        the JAX multi-controller branch (pre-padded ``valid``,
        ``unpad=False``, ``edge_pad`` from the measured ``nnz``).  Returns
        the PADDED global ``(TsneState, losses)`` on every rank (fetch it
        with :meth:`host_state`).  ``resume_state`` (a host or device
        state of n rows, every rank loading the same checkpoint) replaces
        the init; ``checkpoint_cb(state, next_iter, losses)`` gets the
        unpadded state at each boundary, on rank 0 only."""
        if self._runner is None:
            self._runner = ShardedOptimizer(
                self.cfg, self.n, axis=self.axis,
                devices=None if self.axis is not None else self.devices,
                mesh_reduce=self.mesh_reduce)
        if self.axis is None:
            jidx, jval, state = self.prepare(x, seed, y0=y0,
                                             knn_draws=knn_draws)
            npad = self.n_padded - self.n
            jidx, jval = pad_rows(jidx, npad), pad_rows(jval, npad)
        else:
            with obtrace.span("spmd.prepare", cat="prepare",
                              devices=int(self.n_devices)):
                jidx, jval, *_ = self._prepared(x, seed, knn_draws)[0]
            state = self._init_state(seed, jval.dtype, y0)
        if resume_state is not None:
            from tsne_flink_tpu_torch.convert import state_from_numpy
            state = state_from_numpy(
                *(np.asarray(torch.as_tensor(t).cpu())[:self.n]
                  for t in resume_state), device=self.devices[0],
                dtype=jval.dtype)
        valid = torch.arange(self.n_padded,
                             device=self.devices[0]) < self.n
        cb = None
        if checkpoint_cb is not None:
            def cb(padded, it, losses):
                if self.rank == 0:  # one writer
                    checkpoint_cb(TsneState(*(t[:self.n] for t in padded)),
                                  it, losses)
        e = int(self.nnz_)
        return self._runner(state, jidx, jval, start_iter=start_iter,
                            loss_carry=loss_carry,
                            checkpoint_every=checkpoint_every,
                            checkpoint_cb=cb, pre_padded_valid=valid,
                            unpad=False, edge_pad=max(8, (e + 7) // 8 * 8),
                            health_check=health_check,
                            health_retries=health_retries, events=events,
                            telemetry=telemetry)

    def lower(self, x, seed: int = 0) -> dict:
        """``--executionPlan`` of the job: the sharded prepare and one
        optimize iteration run on this rank (every rank: the collectives
        pair up) under the analysis recorder; returns the plan
        (``program``, ``backend``, ``devices``, ``ops``), which the
        caller's rank 0 alone writes.  The job's configuration and state
        are left as they were."""
        from dataclasses import replace

        from tsne_flink_tpu_torch.analysis.audit.record import (Recorder,
                                                                op_list)
        saved = self.cfg, self._runner
        self.cfg, self._runner = replace(self.cfg, iterations=1), None
        try:
            with Recorder() as rec:
                self.run_checkpointable(x, seed)
        finally:
            self.cfg, self._runner = saved
        return {"program": "tsne_spmd_pipeline",
                "backend": self.devices[0].type,
                "devices": int(self.n_devices), "rank": int(self.rank),
                "ops": op_list(rec.events)}

    def __call__(self, x, seed: int = 0, *, y0=None, knn_draws=None):
        """The whole job: :meth:`run_checkpointable` without checkpoints.
        Returns the UNPADDED ``(y [n, m], losses)`` on every rank."""
        with obtrace.span("spmd.pipeline", cat="pipeline",
                          devices=int(self.n_devices)):
            state, losses = self.run_checkpointable(x, seed, y0=y0,
                                                    knn_draws=knn_draws)
        return state.y[:self.n], losses
