"""The batch job's command line (port of ``tsne_flink_tpu/utils/cli.py``).

The JAX package's flags, with their defaults and choices: read a COO CSV
(or a precomputed neighbour graph, ``--inputDistanceMatrix``), prepare
(kNN, affinities; the artifact cache and the kNN autotune), optimize in
segments of ``--checkpointEvery`` with checkpoints and ``--resume``, and
write the embedding CSV and the loss trace.  It runs on the card;
``main(device="cpu")`` runs the plain PyTorch versions on the CPU.

    python -m tsne_flink_tpu_torch.utils.cli --input in.csv --output \\
        out.csv --dimension 784 --knnMethod project --theta 0.5

The run goes through the run supervisor (``runtime/supervisor.py``), as
in the JAX CLI: prepare and the segmented optimize loop
(``runtime/segments.run_segments``) with the OOM degradation ladder
(``--onOom ladder``, ``--maxRetries``), the divergence sentinel
(``--healthCheck``), the telemetry trace (``--telemetry``; its rows are
summarized on stderr and its last row rides ``--metricsOut``) and the
autopilot (``--autopilot``, its controller pair saved in every
checkpoint and threaded by ``--resume``).  ``--faultPlan`` installs a
fault plan (``runtime/faults.py``); ``--jobTimeout`` / ``--stageTimeout``
arm the watchdog (``runtime/fleet.Watchdog``: exit code 124; stage
heartbeats come at prepare's stage ends and at segment boundaries, so
give ``--checkpointEvery`` for beats inside optimize); ``--trace[=path]``
writes the span trace (``obs/trace.py``, Chrome format, or JSONL for a
``.jsonl`` path), ``--metricsOut`` the metrics snapshot, ``--profile
dir`` a ``torch.profiler`` Chrome trace of the optimize stage;
``--noAotCache`` builds the kernel library into a directory of the
process's own (``kernels/build.set_cache``).  ``--mesh N`` (or
``--devices N``; ``--spmd``, deprecated, over all visible devices) runs
the optimize stage on an N-wide point mesh (``parallel/mesh
.ShardedOptimizer``, with ``--meshReduce``): N distinct CUDA devices, or
a width past the visible count raises before the input is read; without
any of them the run takes the single-device path.  An explicit ``--theta``
past ``EXACT_N_MAX`` runs Barnes-Hut.

A multi-controller job is N processes, each given ``--spmd
--coordinator host:port --numProcesses N --processId r`` (all three
flags or none; ``--numProcesses`` >= 2): each opens the process group
(``parallel/mesh.distributed_init``: NCCL when every rank has a card of
its own, else gloo), runs its row shard of the sharded prepare and the
optimize stage (``parallel/pipeline.SpmdPipeline``, with ``--symWidth``,
``--symMode``, ``--symSlack``, ``--symStrict``), and rank 0 alone writes
the embedding, the loss, the checkpoints, ``--trace`` and
``--metricsOut``.  ``main(device="cpu")`` runs such a rank on the CPU.

``--auditPlan[=warn]`` runs the plan audit (:func:`audit_gate`: the
memory model, a determinism and a comms cross-section) after the input
is read and before the kNN stage, and refuses a predicted OOM; without
``--symWidth`` it checks the plan again once the kNN stage ends, at the
graph's row-width bound (:func:`audit_recheck`), and refuses before the
affinities stage.  ``--executionPlan`` writes ``tsne_executionPlan.json``
after prepare (:func:`execution_plan`, the recorded ops of one iteration
and one KL pass) and no output.

``--dtype bfloat16`` is mixed precision, as in the JAX CLI: the state
stays float32 and the kNN stage's distance and projection products take
bf16 operands (``ops/metrics.matmul_operands``; kernel B1's bf16 form on
the card), on both routes and in ``--transform``'s query sweep.
``--dtype float64`` runs on the card through the kernels' float64 forms
(B1-B6), on every kNN plan.
The port reads no ``TSNE_*`` environment variable.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

#: --repulsion auto: the largest N that runs exact repulsion (kernel B2)
#: per backend.  cuda: the N at which one full iteration with FFT
#: repulsion becomes cheaper than with B2, measured on an NVIDIA H100
#: 80GB HBM3 at 700 W by scripts/exact_fft_crossover_cuda.py (104,823:
#: B2 4.20 ms against FFT 4.70 ms at 100k, 6.09 against 4.52 at 120k;
#: FFT's time moves by ±30% between calls), rounded down to a thousand.
#: Every other backend keeps the JAX package's 32,768.
EXACT_N_MAX = {"cuda": 104_000}
EXACT_N_MAX_DEFAULT = 32_768
#: --repulsion auto at m = 3 with a defaulted theta: the largest N that
#: runs exact repulsion instead of Barnes-Hut, per backend (the JAX
#: package keeps such runs exact on a TPU up to its memory bound).  cuda:
#: one full iteration at m = 3 measured by
#: scripts/exact_fft_crossover_cuda.py on an NVIDIA H100 80GB HBM3 at
#: 700 W — B2 11.53 / 45.18 / 179.69 ms against Barnes-Hut at theta 0.25
#: 1,169.8 / 2,331.8 / 4,653.0 ms at 150k / 300k / 600k; B2 grows as N²
#: and Barnes-Hut as N, so the two meet near N = 15.5M (the fit at 600k),
#: rounded down to a thousand.  No other backend has the clause.
EXACT_3D_N_MAX = {"cuda": 15_536_000}

REPULSION_CHOICES = ("auto", "exact", "bh", "fft")


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser: the same flags, defaults and choices."""
    p = argparse.ArgumentParser(
        prog="tsne-torch",
        description="t-SNE on an NVIDIA GPU (PyTorch + CUDA port of "
                    "tsne_flink_tpu)")
    # --- the reference's flags (names, defaults: Tsne.scala:39-63) ---
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dimension", type=int, required=True)
    p.add_argument("--knnMethod", required=True,
                   choices=["auto", "bruteforce", "partition", "project"])
    p.add_argument("--inputDistanceMatrix", action="store_true",
                   help="--input holds i,j,distance lines: the kNN graph")
    p.add_argument("--executionPlan", action="store_true",
                   help="after prepare, write tsne_executionPlan.json (the "
                        "program, the backend, the devices and ``ops``: the "
                        "recorded kernels and aten ops of one optimize "
                        "iteration and one KL pass) instead of running; no "
                        "output CSV")
    p.add_argument("--metric", default="sqeuclidean",
                   choices=["sqeuclidean", "euclidean", "cosine"])
    p.add_argument("--perplexity", type=float, default=30.0)
    p.add_argument("--nComponents", type=int, default=2)
    p.add_argument("--earlyExaggeration", type=float, default=4.0)
    p.add_argument("--learningRate", type=float, default=1000.0)
    p.add_argument("--iterations", type=int, default=300)
    p.add_argument("--randomState", type=int, default=0,
                   help="seeds the init and the hybrid kNN's draws")
    p.add_argument("--neighbors", type=int, default=None,
                   help="default: 3 * perplexity (Tsne.scala:55)")
    p.add_argument("--initialMomentum", type=float, default=0.5)
    p.add_argument("--finalMomentum", type=float, default=0.8)
    p.add_argument("--theta", type=float, default=None,
                   help="Barnes-Hut accuracy, default 0.25 (Tsne.scala:59); "
                        "given explicitly, --repulsion auto takes "
                        "Barnes-Hut above EXACT_N_MAX; theta 0 always "
                        "means exact")
    p.add_argument("--loss", "--lossFile", dest="loss",
                   default=os.path.join("results", "loss.txt"))
    p.add_argument("--knnIterations", type=int, default=None,
                   help="project kNN: Z-order seed rounds (default auto)")
    p.add_argument("--knnRefine", type=int, default=None,
                   help="project kNN: refine cycles (default auto)")
    p.add_argument("--knnBlocks", type=int, default=None,
                   help="partition kNN blocks; default: the device count "
                        "(Tsne.scala:63)")
    p.add_argument("--knnAutotune", action="store_true",
                   help="time 2-3 refine chunk widths on a row slice before "
                        "the kNN stage and keep the fastest "
                        "(ops/knn_tiles.autotune_knn_tiles); the graph is "
                        "the same")
    p.add_argument("--repulsion", default="auto",
                   choices=list(REPULSION_CHOICES),
                   help="auto: exact when theta == 0 or N <= EXACT_N_MAX, "
                        "else bh for an explicit --theta or "
                        "--nComponents 3, else fft")
    p.add_argument("--attraction", default="auto",
                   choices=["auto", "rows", "edges", "csr"],
                   help="attraction layout: padded [N, S] rows, the flat "
                        "edge list, or the capped-width CSR (fused step); "
                        "auto picks csr on hub-heavy graphs, else rows")
    p.add_argument("--affinityAssembly", default=None,
                   choices=["auto", "sorted", "split", "blocks"],
                   help="symmetrized-P builder; auto (default) builds rows "
                        "when they fit, else blocks")
    p.add_argument("--bhGate", default="vdm", choices=["vdm", "flink"],
                   help="Barnes-Hut acceptance test: vdm (side/sqrt(D) < "
                        "theta) or flink (the reference's halfwidth/D² < "
                        "theta)")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64", "bfloat16"],
                   help="float32 (default), float64, or bfloat16: mixed "
                        "precision, float32 "
                        "state with bf16 operands in the kNN stage's "
                        "distance and projection products")
    # --- multi-device (parallel/mesh) ---
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size over the point axis (as --mesh)")
    p.add_argument("--mesh", type=int, default=None,
                   help="run the optimize stage on an N-wide point mesh "
                        "(parallel/mesh; 1 = the trivial mesh, and widths "
                        "sharing the padding quantum give the same bits, so "
                        "a checkpoint written at --mesh 1 resumes at --mesh "
                        "4 and back).  N distinct CUDA devices; more than "
                        "are visible raises.  Default: one device, the "
                        "single-device path")
    p.add_argument("--symWidth", type=int, default=None,
                   help="(multi-controller jobs) static symmetrized P-row "
                        "width; default auto (2*neighbors, escalated to the "
                        "measured width on overflow).  An explicit value "
                        "drops a wider row's largest-id entries (warns, or "
                        "fails with --symStrict).  Any run: the plan audit "
                        "(--auditPlan) models the rows at this width")
    p.add_argument("--symMode", default="replicated",
                   choices=["replicated", "alltoall"],
                   help="(multi-controller jobs) symmetrization: replicated "
                        "sort of the gathered kNN graph, or all_to_all-"
                        "routed transpose edges (footprint independent of "
                        "the process count)")
    p.add_argument("--symSlack", type=int, default=None,
                   help="(--symMode alltoall) per-destination capacity "
                        "headroom factor; default auto (starts at 4, "
                        "doubles and reruns on overflow).  An explicit value "
                        "pins it: overflow then warns (or fails, "
                        "--symStrict)")
    p.add_argument("--symStrict", action="store_true",
                   help="(multi-controller jobs) fail the run if the "
                        "symmetrization drops any edge (capacity cap or "
                        "width overflow) instead of warning")
    p.add_argument("--spmd", action="store_true",
                   help="DEPRECATED alias of --mesh N: runs the mesh over "
                        "--devices (or all visible) devices, with a "
                        "warning")
    # --- checkpoints ---
    p.add_argument("--checkpoint", default=None,
                   help="path of the v2 checkpoint (y, update, gains, next "
                        "iteration, losses, prepare payload), written at "
                        "every --checkpointEvery boundary and at the end; "
                        "the previous one is kept as <path>.1")
    p.add_argument("--checkpointEvery", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="resume from this checkpoint (or its .1 when it is "
                        "damaged)")
    p.add_argument("--fatCheckpoint", action="store_true",
                   help="embed the joint P in every checkpoint, so that "
                        "--resume runs no kNN or affinity work")
    p.add_argument("--model", default=None,
                   help="a fat v2 checkpoint to serve as a frozen map "
                        "(serve/model.py); pairs with --input (the base "
                        "features it was fit on) and --transform")
    p.add_argument("--transform", default=None,
                   help="COO CSV of query rows (same --dimension as "
                        "--input) to embed into the frozen --model map "
                        "instead of fitting; writes id,y0,y1 rows to "
                        "--output")
    p.add_argument("--aotCache", dest="aotCache", action="store_true",
                   default=None,
                   help="keep and reuse the compiled kernel library across "
                        "processes (the default: kernels/build/, keyed by "
                        "the sources' hash)")
    p.add_argument("--noAotCache", dest="aotCache", action="store_false",
                   help="build the kernel library into a directory of this "
                        "process's own, removed at exit")
    p.add_argument("--cacheDir", default=None,
                   help="prepare-artifact cache root (kNN graph + joint P, "
                        "content-addressed .npz; utils/artifacts.py); "
                        "default: the repository-local .tsne_artifacts")
    p.add_argument("--noCache", action="store_true",
                   help="disable the prepare-artifact cache")
    # --- runtime (runtime/, obs/) ---
    p.add_argument("--maxRetries", type=int, default=2,
                   help="OOM-ladder relaunches per phase (runtime/"
                        "supervisor.py)")
    p.add_argument("--onOom", default="ladder", choices=["ladder", "fail"],
                   help="ladder: on a device out-of-memory error degrade the "
                        "plan (kNN tiles, blocks assembly, repulsion) and "
                        "relaunch the failed stage; fail: propagate it")
    p.add_argument("--healthCheck", action="store_true",
                   help="divergence sentinel: a non-finite segment rolls "
                        "back and retries with half the learning rate, at "
                        "most 3 times (runtime/health.py)")
    p.add_argument("--faultPlan", default=None,
                   help="fault injection plan, kind@site[:trigger] clauses "
                        "(runtime/faults.py), e.g. oom@knn or "
                        "kill@optimize:seg2")
    p.add_argument("--jobTimeout", type=float, default=None,
                   help="wall-clock seconds the run may take; past them the "
                        "watchdog ends the process with exit code 124")
    p.add_argument("--stageTimeout", type=float, default=None,
                   help="seconds between heartbeats (prepare stage ends, "
                        "segment boundaries); past them the watchdog ends "
                        "the process with exit code 124")
    p.add_argument("--auditPlan", nargs="?", const="fail", default=None,
                   choices=["fail", "warn"],
                   help="run the plan audit (the memory model's per-stage "
                        "peak, tsne_flink_tpu_torch/analysis/audit/) after "
                        "the input is read and REFUSE a run predicted to "
                        "exceed the card's memory; --auditPlan=warn prints "
                        "the same report but launches anyway.  The result "
                        "is embedded in v2 checkpoints so a resume can "
                        "detect a config whose predicted footprint drifted")
    p.add_argument("--trace", nargs="?", const="default", default=None,
                   help="record the run's spans and write them as a Chrome "
                        "trace (results/trace.json, or the path given; "
                        "a .jsonl path gets the event log)")
    p.add_argument("--metricsOut", default=None,
                   help="write the metrics snapshot (obs/metrics.py) as "
                        "JSON to this path")
    p.add_argument("--telemetry", action="store_true",
                   help="in-loop telemetry at every KL report (grad norm, "
                        "gains mean/max, embedding bbox), summarized on "
                        "stderr")
    p.add_argument("--autopilot", action="store_true",
                   help="approximation autopilot (models/autopilot.py): "
                        "the repulsion stride driven by the grad-norm "
                        "trend, and a coarse FFT grid during early "
                        "exaggeration")
    p.add_argument("--meshReduce", default="canonical",
                   choices=("canonical", "psum"),
                   help="the mesh's global sums (models/tsne._mesh_sum): "
                        "canonical (default) gathers the per-row partials "
                        "and sums them in one order, bit-identical across "
                        "mesh widths; psum sums each shard and combines the "
                        "scalars, not bit-identical across widths")
    p.add_argument("--profile", default=None,
                   help="run the optimize stage under torch.profiler and "
                        "write its Chrome trace into this directory")
    p.add_argument("--coordinator", default=None,
                   help="multi-controller job: host:port of the process "
                        "group's rendezvous (rank 0 listens there), with "
                        "--numProcesses and --processId and --spmd")
    p.add_argument("--numProcesses", type=int, default=None,
                   help="multi-controller job: the number of processes "
                        "(ranks), >= 2")
    p.add_argument("--processId", type=int, default=None,
                   help="multi-controller job: this process's rank")
    return p


# graftlint: disable=policy-recorded -- the resolved repulsion is the
# run's TsneConfig.repulsion and PlanConfig.repulsion, which
# --auditPlan prints
def pick_repulsion(mode: str, theta: float, n: int, n_components: int = 2,
                   theta_explicit: bool = False,
                   backend: str = "cuda") -> str:
    """``auto``: exact for theta = 0 or N <= ``EXACT_N_MAX[backend]``;
    above it FFT, or Barnes-Hut for an explicit theta (a request for
    theta-gated semantics) or m = 3 (a 3-D grid cannot keep FFT accurate),
    save that a defaulted-theta m = 3 run stays exact up to
    ``EXACT_3D_N_MAX[backend]``; exact for m outside 2-3, which neither
    approximation takes.  Any other
    mode is returned as it is.  ``backend``: ``cuda`` | ``cpu`` (the JAX
    function's answers for ``cpu``)."""
    if mode != "auto":
        return mode
    if theta == 0.0 or n <= EXACT_N_MAX.get(backend, EXACT_N_MAX_DEFAULT):
        return "exact"
    if n_components not in (2, 3):
        return "exact"
    if (n_components == 3 and not theta_explicit
            and n <= EXACT_3D_N_MAX.get(backend, 0)):
        return "exact"
    if theta_explicit or n_components == 3:
        return "bh"
    return "fft"


def _load_resume(path: str, n: int, dtype, device):
    """``(start_iter, loss_carry, state, prepare payload, pilot pair)`` of
    a checkpoint, the state cast to ``dtype`` on ``device``; a damaged
    file falls back to its ``.1``."""
    from tsne_flink_tpu_torch.convert import state_from_numpy
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt

    st, start_iter, losses, payload, used, pilot = ckpt.load_resume(
        path, with_pilot=True)
    if st.y.shape[0] != n:
        raise ValueError(f"checkpoint {used} holds {st.y.shape[0]} points, "
                         f"the input {n}")
    state = state_from_numpy(st.y, st.update, st.gains, device=device,
                             dtype=dtype)
    print(f"resumed from {used} at iteration {start_iter}")
    return (start_iter, torch.as_tensor(losses, dtype=dtype, device=device),
            state, payload, pilot)


def _report_extras(run, events) -> None:
    """The loop extras' summaries on stderr: each sentinel rollback and
    other runtime event, the telemetry trace's last row and finiteness,
    the autopilot's policy."""
    import json

    from tsne_flink_tpu_torch.models.tsne import TELEMETRY_FIELDS
    for ev in events:
        kind = ("sentinel" if ev.get("type") == "sentinel-rollback"
                else "runtime")
        print(f"# {kind} event: {json.dumps(ev)}", file=sys.stderr)
    if run.telemetry is not None:
        tel = run.telemetry.cpu().numpy()
        print(f"# telemetry: {tel.shape[0]} rows, all finite "
              f"{bool(np.isfinite(tel).all())}, last "
              + " ".join(f"{f}={v!r}" for f, v in zip(TELEMETRY_FIELDS,
                                                       tel[-1].tolist())),
              file=sys.stderr)
    if run.pilot is not None:
        from tsne_flink_tpu_torch.models.autopilot import policy_report
        pol = policy_report(run.cfg, run.pilot)
        print(f"# policy: refreshes {pol['repulsion_refreshes']}, final "
              f"stride {pol['final_stride']}, transitions "
              f"{json.dumps(pol['transitions'])}", file=sys.stderr)


def _write_obs_outputs(trace_path, metrics_path, telemetry=None) -> None:
    """End-of-run obs export: the trace (``--trace``), the metrics
    snapshot (``--metricsOut``) and, when telemetry ran, its last row as
    ``telemetry.*`` gauges in the snapshot."""
    from tsne_flink_tpu_torch.models.tsne import TELEMETRY_FIELDS
    from tsne_flink_tpu_torch.obs import metrics as obmetrics
    from tsne_flink_tpu_torch.obs import trace as obtrace
    if telemetry is not None and len(telemetry):
        for f, v in zip(TELEMETRY_FIELDS, telemetry[-1].tolist()):
            obmetrics.gauge(f"telemetry.{f}").set(float(v))
    if trace_path:
        obtrace.write(trace_path)
        print(f"# obs trace written to {trace_path} (load in Perfetto / "
              "chrome://tracing)", file=sys.stderr)
    if metrics_path:
        obmetrics.write_snapshot(metrics_path)
        print(f"# obs metrics snapshot written to {metrics_path}",
              file=sys.stderr)


def run_config(args, n: int, device) -> "TsneConfig":
    """This invocation's ``TsneConfig`` for ``n`` points on ``device``
    (theta defaults to 0.25, ``Tsne.scala:59``; the repulsion resolved by
    :func:`pick_repulsion`)."""
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    theta = args.theta if args.theta is not None else 0.25
    return TsneConfig(
        n_components=args.nComponents, perplexity=args.perplexity,
        early_exaggeration=args.earlyExaggeration,
        learning_rate=args.learningRate, iterations=args.iterations,
        initial_momentum=args.initialMomentum,
        final_momentum=args.finalMomentum, theta=theta, metric=args.metric,
        repulsion=pick_repulsion(args.repulsion, theta, n, args.nComponents,
                                 args.theta is not None,
                                 backend=device.type),
        attraction=args.attraction, bh_gate=args.bhGate,
        autopilot=args.autopilot)


def run_plan(args, cfg, n: int, d: int, assembly: str, neighbors: int,
             backend: str, mesh: int = 1):
    """This invocation as the memory model's PlanConfig (the supervisor's
    ladder input: the same resolved repulsion and assembly; ``mesh`` the
    optimize stage's width, whose row terms are one device's share;
    ``--symWidth``, as in the JAX CLI, the rows' width when the caller
    knows it — a single-controller run's bits do not depend on it).  A
    ``--dtype bfloat16`` run is planned as float32 state, as the JAX
    CLI's plan (its ``_run_plan``), with bf16 operands."""
    from tsne_flink_tpu_torch.analysis.audit import PlanConfig
    from tsne_flink_tpu_torch.ops.metrics import (matmul_dtype_name,
                                                  resolve_matmul_dtype)
    dtype, operands = resolve_matmul_dtype(args.dtype)
    return PlanConfig(
        n=n, d=int(d), k=int(neighbors), backend=backend,
        dtype=dtype or "float32", n_components=cfg.n_components,
        iterations=cfg.iterations,
        knn_method=("precomputed" if args.inputDistanceMatrix
                    else args.knnMethod),
        knn_rounds=args.knnIterations, knn_refine=args.knnRefine,
        repulsion=cfg.repulsion, theta=cfg.theta, assembly=assembly,
        attraction=cfg.attraction, sym_width=args.symWidth,
        row_chunk=cfg.row_chunk, mesh=int(mesh),
        autopilot=bool(cfg.autopilot),
        matmul_dtype=matmul_dtype_name(operands), metric=args.metric,
        name="cli-launch")


def _plan_audit_summary(plan) -> dict:
    """The compact audit record a checkpoint carries (the JAX keys)."""
    from tsne_flink_tpu_torch.analysis.audit.compile import \
        plan_compile_count
    from tsne_flink_tpu_torch.analysis.audit.hbm import plan_hbm_report
    rep = plan_hbm_report(plan)
    return {"peak_hbm_est": rep["peak_hbm_est"],
            "peak_stage": rep["peak_stage"],
            "hbm_budget": rep["hbm_budget"], "ok": rep["ok"],
            "compile_count": plan_compile_count(plan)}


def _determinism_summary() -> dict:
    """The launch gate's determinism cross-section: the tiny case's
    optimize at mesh 1 recorded on the CPU (the tensor code is the card's;
    the kernels hold no atomics) and scanned for unblessed
    order-sensitive reductions (recorded once a process).  The full sweep
    is ``--audit``'s.  Never raises: the gate's job is the OOM refusal."""
    try:
        from tsne_flink_tpu_torch.analysis.audit import cases
        from tsne_flink_tpu_torch.analysis.audit import determinism as det
        findings, blessed = det.scan_events(
            det.optimize_events("cpu", cases.VARIANTS[0], 1),
            "optimize[mesh1]")
        return {"unblessed": len(findings), "blessed_sites": blessed,
                "findings": [f.format() for f in findings]}
    except Exception as e:  # noqa: BLE001 — advisory line, never fatal
        return {"error": f"{type(e).__name__}: {e}"}


def _comms_summary(plan, mode: str) -> dict:
    """The launch gate's comms cross-section: this launch's optimize
    collectives under ``--meshReduce`` at the plan's mesh width (recorded
    on the CPU's tiny case, extrapolated to the plan), priced under the
    card's NVLink model.  Never raises."""
    if int(plan.mesh) <= 1:  # one device: nothing crosses a link
        return {"mode": mode, "mesh": 1, "unblessed": 0, "collectives": 0,
                "per_iter_bytes": 0, "per_iter_reduce_bytes": 0,
                "per_iter_seconds": 0.0}
    try:
        from tsne_flink_tpu_torch.analysis.audit import comms
        rep = comms.plan_comms_report(plan, mode, "cpu")
        rows = rep["collectives"]
        return {"mode": mode, "mesh": rep["mesh"],
                "unblessed": sum(1 for r in rows if r["blessed"] is None),
                "collectives": len(rows),
                "per_iter_bytes": rep["per_iter_bytes"],
                "per_iter_reduce_bytes": rep["per_iter_reduce_bytes"],
                "per_iter_seconds": rep["per_iter_seconds"]}
    except Exception as e:  # noqa: BLE001 — advisory line, never fatal
        return {"error": f"{type(e).__name__}: {e}"}


def audit_gate(args, plan, report: bool = True) -> dict:
    """``--auditPlan``: print the plan audit and refuse a predicted OOM
    (``--auditPlan=warn`` launches anyway).  Runs before the kNN stage
    and launches no kernel.  Returns the summary for the checkpoint.
    ``report=False`` (a multi-controller job's ranks but the first)
    prints nothing and skips the determinism and comms cross-sections,
    but refuses as the reporting rank does."""
    from tsne_flink_tpu_torch.analysis.audit.hbm import plan_hbm_report
    from tsne_flink_tpu_torch.obs import trace as obtrace
    sp = obtrace.begin("cli.audit_plan", cat="cli")
    rep = plan_hbm_report(plan)
    summary = _plan_audit_summary(plan)
    if report:
        _print_gate(args, plan, rep, summary)
        print(f"# auditPlan: gate {sp.end().seconds:.3f} s")
    sp.end()
    if not rep["ok"]:
        _refuse_oom(args, rep, report)
    return summary


def _refuse_oom(args, rep, report: bool) -> None:
    """The JAX gate's refusal of a predicted OOM (``--auditPlan=warn``
    warns and launches)."""
    gib = 1 << 30
    msg = (f"plan predicted to OOM: peak HBM estimate "
           f"{rep['peak_hbm_est_gib']} GiB in the '{rep['peak_stage']}' "
           f"stage exceeds the {rep['hbm_budget'] / gib:.2f} GiB "
           "device budget")
    if args.auditPlan == "warn":
        if report:
            print(f"WARNING: {msg} — launching anyway (--auditPlan=warn)",
                  file=sys.stderr)
        return
    raise SystemExit(
        f"{msg}; shrink the footprint (--affinityAssembly blocks, "
        "a narrower --symWidth, --spmd sharding) or override with "
        "--auditPlan=warn")


def audit_recheck(args, plan, width: int, report: bool = True) -> dict:
    """``--auditPlan`` without ``--symWidth``, once the kNN stage has
    built the graph: the plan charged at the graph's row-width bound
    (``ops/affinities.width_bound``) instead of the pre-read gate's rows
    of 2k, the width and the peak printed, and a predicted OOM refused
    before the affinities stage (the JAX message).  Returns the report."""
    from dataclasses import replace

    from tsne_flink_tpu_torch.analysis.audit.hbm import plan_hbm_report
    rep = plan_hbm_report(replace(plan, sym_width=int(width)))
    if report:
        gib = 1 << 30
        print(f"# auditPlan: after kNN: width bound {int(width)}: peak HBM "
              f"est {rep['peak_hbm_est_gib']} GiB in '{rep['peak_stage']}' "
              + ("(no device budget on this backend)" if rep["hbm_budget"]
                 is None else f"vs {rep['hbm_budget'] / gib:.2f} GiB "
                 "budget"))
    if not rep["ok"]:
        _refuse_oom(args, rep, report)
    return rep


def _print_gate(args, plan, rep, summary) -> None:
    """The gate's ``# auditPlan:`` lines; adds the determinism and comms
    cross-sections to ``summary``."""
    gib = 1 << 30
    print(f"# auditPlan: peak HBM est {rep['peak_hbm_est_gib']} GiB in "
          f"'{rep['peak_stage']}' "
          + ("(no device budget on this backend)" if rep["hbm_budget"]
             is None else f"vs {rep['hbm_budget'] / gib:.2f} GiB budget")
          + f"; ~{summary['compile_count']} compiled programs")
    for stage, terms in rep["stages"].items():
        print(f"# auditPlan:   {stage}: "
              + " ".join(f"{t}={v}" for t, v in terms.items()))
    rounds, refine = plan.resolved_knn()
    print(f"# auditPlan: plan: knn_method={plan.resolved_method()} "
          f"knn_rounds={rounds} knn_refine={refine} "
          f"repulsion={plan.resolved_repulsion()} "
          f"assembly={plan.resolved_assembly()} mesh={plan.mesh}")
    det = _determinism_summary()
    summary["determinism"] = det
    if "error" in det:
        print(f"# auditPlan: determinism: audit unavailable ({det['error']})")
    else:
        print(f"# auditPlan: determinism: {det['unblessed']} unblessed "
              "reduction(s) in optimize[mesh1]; blessed sites: "
              + (", ".join(det["blessed_sites"]) or "none"))
        for line in det["findings"]:
            print(f"# auditPlan:   {line}")
    com = _comms_summary(plan, args.meshReduce)
    summary["comms"] = com
    if "error" in com:
        print(f"# auditPlan: comms: audit unavailable ({com['error']})")
    else:
        secs = com["per_iter_seconds"]
        print(f"# auditPlan: comms: mode {com['mode']}: "
              f"{com['per_iter_bytes']} B/iter sent/device over mesh "
              f"{com['mesh']} (reduce slice "
              f"{com['per_iter_reduce_bytes']} B); "
              f"{com['unblessed']} unblessed collective(s)"
              + ("" if not secs else
                 f"; ~{secs * 1e6:.1f} us/iter on NVLink"))


def check_resumed_audit(args, plan, payload) -> None:
    """A v2 checkpoint carries the original run's plan audit: recompute
    the prediction for THIS run's config and warn on a drifted footprint
    (the resume may be on another device, assembly or width)."""
    import json
    raw = (payload or {}).get("audit")
    if not raw:
        return
    try:
        prev = json.loads(str(raw))
    except ValueError:
        return
    cur = _plan_audit_summary(plan)
    old_peak = float(prev.get("peak_hbm_est") or 0)
    new_peak = float(cur["peak_hbm_est"])
    ratio = new_peak / old_peak if old_peak > 0 else float("inf")
    if prev.get("ok") is not False and cur["ok"] is False:
        print("WARNING: resumed config's predicted footprint "
              f"({new_peak / 2**30:.3g} GiB) now exceeds the device budget "
              "although the original run's did not — the resume is not the "
              "run that was checkpointed", file=sys.stderr)
    elif ratio > 1.5 or ratio < 1 / 1.5:
        print(f"WARNING: resumed config's predicted peak HBM "
              f"({new_peak / 2**30:.3g} GiB) differs {ratio:.2f}x from the "
              f"checkpointed run's ({old_peak / 2**30:.3g} GiB) — config "
              "drift between save and resume", file=sys.stderr)


def plan_assembly(assembly: str) -> str:
    """``--executionPlan``'s assembly: ``auto`` resolves to ``sorted``
    now (its choice is data-dependent), ``blocks`` is refused — the JAX
    CLI's messages."""
    if assembly == "auto":
        print("# --executionPlan: assembly auto resolves to sorted (the "
              "blocks layout has no lowered-plan form)", file=sys.stderr)
        return "sorted"
    if assembly == "blocks":
        raise SystemExit("--affinityAssembly blocks does not lower an "
                         "execution plan; use sorted or split for "
                         "--executionPlan")
    return assembly


def execution_plan(cfg, state, jidx, jval, edges, csr, device) -> dict:
    """``--executionPlan``'s JSON: one optimize iteration and one KL pass
    (Z, then the per-row KL summed) recorded, as ``ops`` — kernels by id
    and aten ops, each with its shapes and dtypes (``section``
    ``iteration`` or ``kl_pass``).  Advances no run state."""
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder, op_list
    from tsne_flink_tpu_torch.models import tsne as mt

    with Recorder() as rec_it:
        out = mt.optimize(state, jidx, jval, cfg, start_iter=0, num_iters=1,
                          edges=edges, edges_extra=False, csr=csr)
    st = out[0]
    fidx, fval, ragged = mt._layout_parts(jidx, jval, st.y.shape[0], edges,
                                          False, csr)
    with Recorder() as rec_kl:
        _rep, z = mt._repulsion(st.y, st.y, cfg)
        mt._mesh_sum(mt._attraction_loss(st.y, st.y, fidx, fval, cfg, 1.0,
                                         z, ragged), None)
    ops = ([{**r, "section": "iteration"} for r in op_list(rec_it.events)]
           + [{**r, "section": "kl_pass"} for r in op_list(rec_kl.events)])
    return {"program": "tsne_optimize", "backend": device.type,
            "devices": 1, "ops": ops}


def check_multihost(args, parser) -> bool:
    """The JAX CLI's checks of the multi-host flags (exit 2 on a misuse);
    True for a multi-controller job."""
    multihost = (args.coordinator, args.numProcesses, args.processId)
    if all(v is None for v in multihost):
        return False
    if any(v is None for v in multihost):
        parser.error(
            "--coordinator, --numProcesses and --processId must be given "
            "together (on every process of the job) or not at all")
    if not args.spmd:
        parser.error(
            "multi-host flags (--coordinator/--numProcesses/--processId) "
            "require --spmd: the host-staged pipeline is single-controller")
    if args.numProcesses < 2:
        parser.error(
            "--numProcesses must be >= 2 for a multi-host job; drop the "
            "multi-host flags entirely for single-process runs")
    return True


def resolve_mesh(args, device, mesh_devices=None):
    """The optimize stage's mesh devices, or None for the single-device
    path (neither --mesh, --devices nor --spmd).  ``mesh_devices`` is an
    explicit device list (the test mesh; --mesh, when given, must match
    its length).  Raises, naming the visible device count, for a width
    the machine does not have — before the input is read."""
    from tsne_flink_tpu_torch.parallel.mesh import make_mesh
    width = args.mesh if args.mesh is not None else args.devices
    if args.spmd:
        print("WARNING: --spmd is deprecated — the pipeline is "
              "mesh-parametric (graftmesh); use --mesh N instead. "
              "Aliasing to --mesh over "
              + (f"{args.devices}" if args.devices else "all")
              + " device(s); --symMode/--symSlack/--symStrict only apply "
              "to multi-controller jobs now", file=sys.stderr)
    if mesh_devices is not None:
        if width is not None and width != len(mesh_devices):
            raise ValueError(f"--mesh {width} against a mesh of "
                             f"{len(mesh_devices)} devices")
        return make_mesh(list(mesh_devices))
    if width is None and not args.spmd:
        return None
    return make_mesh(width, device)


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _serve_transform(args, ids, x_np, neighbors: int, device,
                     operands=None) -> int:
    """The ``--model``/``--transform`` route: open the frozen map
    read-only, embed the query rows (their kNN over ``operands``, the
    run's matmul operand dtype), write them; no fit, no checkpoint
    write, no prepare stage."""
    from tsne_flink_tpu_torch.models.tsne import TsneConfig
    from tsne_flink_tpu_torch.serve.model import PlanConfig, load_frozen
    from tsne_flink_tpu_torch.serve.transform import transform
    from tsne_flink_tpu_torch.utils import io as tio

    theta = args.theta if args.theta is not None else 0.25
    plan = PlanConfig(n=len(ids), d=int(args.dimension), k=int(neighbors),
                      n_components=args.nComponents, backend=device.type,
                      repulsion=pick_repulsion(
                          args.repulsion, theta, len(ids), args.nComponents,
                          args.theta is not None, backend=device.type),
                      theta=theta, row_chunk=TsneConfig.row_chunk,
                      name="cli-launch")
    model = load_frozen(args.model, x_np, plan, perplexity=args.perplexity,
                        learning_rate=args.learningRate, metric=args.metric,
                        device=device,
                        dtype=(torch.float64 if args.dtype == "float64"
                               else None))
    qids, q_np = tio.read_input(args.transform, args.dimension)
    tio.write_embedding(args.output, qids,
                        transform(model, q_np, matmul_dtype=operands))
    print(f"transformed {len(qids)} rows into frozen map {model.model_id} "
          f"-> {args.output}")
    return 0


def main(argv=None, *, device=None, mesh_devices=None) -> int:
    """Parse ``argv`` and run the batch job on ``device`` (None: the
    card); ``mesh_devices``, a device list, is the optimize stage's mesh
    in place of ``--mesh N``'s N first devices (the test mesh: one card
    listed once a shard).  Returns 0; every failure raises.  The process state a run
    sets — the tracer switch, the fault plan, the kernel cache setting,
    the watchdog — is restored or stopped on every exit, so an
    in-process caller inherits none of it."""
    from tsne_flink_tpu_torch.kernels import build as kbuild
    from tsne_flink_tpu_torch.obs import trace as obtrace
    from tsne_flink_tpu_torch.runtime import faults

    prev_trace = obtrace.enabled_override()
    prev_cache = kbuild.cache_enabled()
    state = {"watchdog": None, "group": False}
    sp_run = obtrace.begin("cli.run", cat="cli")
    try:
        return _main(argv, device, sp_run, state, mesh_devices)
    finally:
        sp_run.end()
        if state["watchdog"] is not None:
            state["watchdog"].stop()
        if state["group"]:
            from tsne_flink_tpu_torch.parallel.mesh import close_group
            close_group()
        faults.activate(None)
        kbuild.set_cache(prev_cache)
        obtrace.set_enabled(prev_trace)


def _main(argv, device, sp_run, state, mesh_devices=None) -> int:
    from tsne_flink_tpu_torch.kernels import build as kbuild
    from tsne_flink_tpu_torch.models.tsne import (_plan_layout,
                                                  init_working_set)
    from tsne_flink_tpu_torch.obs import trace as obtrace
    from tsne_flink_tpu_torch.runtime import faults
    from tsne_flink_tpu_torch.runtime.fleet import Watchdog
    from tsne_flink_tpu_torch.runtime.supervisor import Supervisor
    from tsne_flink_tpu_torch.utils import artifacts as art
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    from tsne_flink_tpu_torch.utils import io as tio
    from tsne_flink_tpu_torch.utils.device import resolve_device, timed_stage

    parser = build_parser()
    args = parser.parse_args(argv)
    multi_controller = check_multihost(args, parser)
    if args.transform or args.model:
        if not (args.transform and args.model):
            parser.error("--transform and --model go together: --model is "
                         "the frozen map (fat v2 checkpoint), --transform "
                         "the query rows to embed into it")
        if args.inputDistanceMatrix:
            parser.error("--transform needs raw base features via --input "
                         "(a distance matrix carries no coordinates to run "
                         "query kNN against)")
    trace_path = (os.path.join("results", "trace.json")
                  if args.trace == "default" else args.trace)
    if trace_path:
        obtrace.set_enabled(True)
    kbuild.set_cache(args.aotCache)
    # the fault plan goes in before any instrumented site runs
    faults.activate(args.faultPlan)
    if args.jobTimeout or args.stageTimeout:
        state["watchdog"] = Watchdog(args.jobTimeout, args.stageTimeout,
                                     label="cli.run").start()
    wd = state["watchdog"]
    device = resolve_device(device)
    from tsne_flink_tpu_torch.ops.metrics import resolve_matmul_dtype
    state_dtype, operands = resolve_matmul_dtype(args.dtype)
    dtype, np_dtype = ((torch.float64, np.float64)
                       if state_dtype == "float64"
                       else (torch.float32, np.float32))
    if multi_controller:
        from tsne_flink_tpu_torch.parallel.mesh import distributed_init
        state["group"] = True
        distributed_init(args.coordinator, args.numProcesses, args.processId,
                         device=device)
        return _spmd_job(args, device, sp_run, wd, trace_path, dtype,
                         np_dtype, operands)
    mesh = resolve_mesh(args, device, mesh_devices)
    assembly = args.affinityAssembly or "auto"
    if args.executionPlan:
        assembly = plan_assembly(assembly)
    neighbors = (args.neighbors if args.neighbors is not None
                 else 3 * int(args.perplexity))
    cache = None if args.noCache else art.ArtifactCache(args.cacheDir)
    secs = {}

    sp = obtrace.begin("cli.ingest", cat="cli")
    if args.inputDistanceMatrix:
        ids, idx, dist = tio.read_distance_matrix(args.input)
        neighbors = idx.shape[1]
        data = {"knn": (idx, dist.astype(np_dtype))}
        del idx, dist
    else:
        ids, x64 = tio.read_input(args.input, args.dimension)
        if args.transform:  # the JAX CLI serves the features as read
            sp.end()
            out = _serve_transform(args, ids, x64, neighbors, device,
                                   operands)
            _write_obs_outputs(trace_path, args.metricsOut)
            return out
        # cast on the host, as the JAX CLI does, before the device copy
        data = {"x": x64.astype(np_dtype)}
        del x64
    n = len(ids)
    secs["ingest"] = sp.end().seconds

    cfg = run_config(args, n, device)
    plan = run_plan(args, cfg, n, args.dimension, assembly, neighbors,
                    device.type, 1 if mesh is None else len(mesh))
    # the plan audit BEFORE any expensive stage: a predicted OOM is
    # refused in seconds, before the kNN stage launches anything
    audit_summary = audit_gate(args, plan) if args.auditPlan else None
    runner = None
    if mesh is not None:
        from tsne_flink_tpu_torch.parallel.mesh import ShardedOptimizer
        runner = ShardedOptimizer(cfg, n, devices=mesh,
                                  mesh_reduce=args.meshReduce)
    supervisor = Supervisor(plan, max_retries=args.maxRetries,
                            on_oom=args.onOom, health_check=args.healthCheck)

    start_iter, loss_carry, state0, payload, pilot = 0, None, None, None, None
    prior_events = None
    if args.resume:
        sp = obtrace.begin("cli.resume", cat="cli")
        start_iter, loss_carry, state0, payload, pilot = _load_resume(
            args.resume, n, dtype, device)
        secs["resume"] = timed_stage(device, sp)
        sp.end()
        check_resumed_audit(args, plan, payload)
        raw = (payload or {}).get("events")
        if raw:
            import json
            try:
                prior_events = json.loads(str(raw))
            except ValueError:
                prior_events = None
    prep_kwargs = dict(neighbors=neighbors, knn_method=args.knnMethod,
                       metric=args.metric, knn_rounds=args.knnIterations,
                       knn_refine=args.knnRefine, seed=args.randomState,
                       perplexity=cfg.perplexity, assembly=assembly,
                       matmul_dtype=operands, **data)
    del data

    jidx = extra = label = affinity_fp = None
    sp = obtrace.begin("cli.payload", cat="cli")
    if payload is not None and "jidx" in payload:
        # a fat checkpoint: check its P against this run's data and plan,
        # then skip the kNN and affinity stages
        _, want_fp = art.prepare_fingerprints(**prep_kwargs, device=device)
        have_fp = payload.get("affinity_fp")
        if have_fp is not None and have_fp != want_fp:
            print(f"WARNING: checkpoint prepare payload ({have_fp}) does "
                  f"not match this run's data/plan ({want_fp}); "
                  "recomputing prepare", file=sys.stderr)
        else:
            label = payload.get("label", "sorted")
            jidx = torch.as_tensor(payload["jidx"], device=device)
            jval = torch.as_tensor(payload["jval"], device=device)
            if label == "blocks":
                extra = tuple(torch.as_tensor(payload[nm], device=device)
                              for nm in ("rsrc", "rdst", "rval"))
            affinity_fp = have_fp or want_fp
            secs.update(knn=0.0, affinities=timed_stage(device, sp))
            print("# prepare: skipped (embedded in v2 checkpoint)",
                  file=sys.stderr)
    del payload
    sp.end()
    if jidx is None:
        def with_recheck(observe):
            # the supervisor's width bound, then (--auditPlan without
            # --symWidth) the plan's re-check at it, before the affinities
            if not (args.auditPlan and args.symWidth is None):
                return observe

            def both(idx):
                from tsne_flink_tpu_torch.ops.affinities import width_bound
                if observe is not None:
                    observe(idx)
                audit_recheck(args, plan, supervisor.width_bound
                              if supervisor.width_bound is not None
                              else width_bound(idx))
            return both

        # the supervisor relaunches the failed stage on an OOM with the
        # ladder's overrides (knn_tiles, assembly)
        prep = supervisor.run_prepare(
            lambda on_stage, on_graph=None, **ov: art.prepare(
                **{**prep_kwargs, **ov},
                knn_blocks=args.knnBlocks or _device_count(device),
                device=device, cache=cache, knn_autotune=args.knnAutotune,
                on_stage=on_stage, on_graph=with_recheck(on_graph)),
            on_stage=(lambda st, s_, c_: wd.beat(st)) if wd else None)
        jidx, jval, extra, label = (prep.jidx, prep.jval, prep.extra_edges,
                                    prep.label)
        affinity_fp = prep.affinity_fp
        secs.update(knn=prep.knn_seconds, affinities=prep.affinity_seconds)
        print(f"# prepare: knn {prep.knn_seconds:.2f}s ({prep.knn_cache}) "
              f"affinities {prep.affinity_seconds:.2f}s "
              f"({prep.affinity_cache}) assembly={label}", file=sys.stderr)
        if prep.knn_tiles is not None:
            print(f"# knn tiles: {prep.knn_tiles}"
                  + (f" substages={prep.knn_substages}"
                     if prep.knn_substages else ""), file=sys.stderr)
        del prep
    if affinity_fp is None and args.checkpoint and args.fatCheckpoint:
        _, affinity_fp = art.prepare_fingerprints(**prep_kwargs,
                                                  device=device)
    del prep_kwargs  # the host copy of the input goes before optimize

    # v2 checkpoints carry the prepare provenance; --fatCheckpoint embeds
    # the arrays themselves, so that a resume needs no cache or recompute
    save_payload = {"label": label}
    if audit_summary is not None:
        import json
        save_payload["audit"] = json.dumps(audit_summary)
    if affinity_fp is not None:
        save_payload["affinity_fp"] = affinity_fp
    if args.fatCheckpoint:
        save_payload.update(jidx=jidx, jval=jval)
        if extra is not None:
            save_payload.update(rsrc=extra[0], rdst=extra[1], rval=extra[2])

    def layout():
        # the optimize stage's first step: on the card the CSR build is
        # part of its memory, so an OOM here is the optimize stage's
        sp = obtrace.begin("cli.plan", cat="cli")
        if runner is not None:
            # the mesh plans its layout on its padded rows
            runner.shard_inputs(jidx, jval, extra)
            got = (None, False, None)
        elif extra is not None:
            got = (extra, True, None)
        else:
            edges, csr = _plan_layout(jidx, jval, cfg)
            got = (edges, False, csr)
        secs["plan"] = timed_stage(device, sp)
        sp.end()
        return got

    if state0 is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.randomState)
        state0 = init_working_set(gen, n, cfg.n_components, dtype, device)

    if args.executionPlan:
        return _write_execution_plan(cfg, state0, jidx, jval, layout,
                                     runner, device)

    def save(st, next_iter, losses, pilot):
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # queued iterations: optimize's
        with obtrace.span("cli.checkpoint", cat="cli") as sp:
            ckpt.save(args.checkpoint, st, next_iter, losses,
                      _payload_with_events(save_payload, supervisor,
                                           prior_events), pilot=pilot)
        secs["checkpoint"] = secs.get("checkpoint", 0.0) + sp.seconds

    def boundary(st, next_iter, losses, pilot):
        if wd is not None:
            wd.beat("optimize")
        if args.checkpoint:
            save(st, next_iter, losses, pilot)

    # segments of --checkpointEvery, each followed by a checkpoint but the
    # last (parallel/mesh.py:733 in the JAX package); every gate of the
    # schedule keys off the absolute iteration, so the bits are one run's
    every = (args.checkpointEvery if (args.checkpoint or wd is not None)
             and args.checkpointEvery > 0 else 0)
    sp_opt = obtrace.begin("cli.optimize", cat="cli")
    with _profiled(args.profile, device):
        run = supervisor.run_optimize(
            cfg, state0, jidx, jval, layout=layout, start_iter=start_iter,
            loss_carry=loss_carry, every=every,
            on_boundary=boundary if (args.checkpoint or wd) else None,
            telemetry=args.telemetry,
            pilot_carry=pilot if cfg.autopilot else None, mesh=runner)
        # the checkpoint writes inside the loop are timed on their own
        secs["optimize"] = (timed_stage(device, sp_opt)
                            - secs.get("plan", 0.0)
                            - secs.get("checkpoint", 0.0))
    sp_opt.end()
    state1, losses = run.state, run.losses
    if args.checkpoint:
        save(state1, cfg.iterations, losses, run.pilot)
    _report_extras(run, supervisor.events)

    with obtrace.span("cli.write", cat="cli") as sp:
        tio.write_embedding(args.output, ids, state1.y.cpu().numpy())
        tio.write_loss(args.loss, losses.cpu().numpy())
    secs["write"] = sp.seconds
    print("# stages s: " + " ".join(f"{k}={v:.4f}" for k, v in secs.items()),
          file=sys.stderr)
    sp_run.end()
    _write_obs_outputs(trace_path, args.metricsOut,
                       run.telemetry if args.telemetry else None)
    print(f"embedded {n} points -> {args.output} "
          f"({sp_run.seconds:.2f}s total, backend={device.type})")
    return 0


def _write_execution_plan(cfg, state0, jidx, jval, layout, runner,
                          device) -> int:
    """``--executionPlan`` after prepare: the recorded plan JSON, no
    output CSV, no checkpoint."""
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder, op_list
    edges, edges_extra, csr = layout()
    if runner is not None:
        with Recorder() as rec:
            runner.segment(state0, cfg, start_iter=0, num_iters=1)
        plan = {"program": "tsne_optimize", "backend": device.type,
                "devices": len(runner.devices),
                "ops": [{**r, "section": "iteration"}
                        for r in op_list(rec.events)]}
    else:
        plan = execution_plan(cfg, state0, jidx, jval,
                              None if edges_extra else edges, csr, device)
    return _dump_execution_plan(plan)


def _dump_execution_plan(plan: dict, lead: bool = True) -> int:
    """Write ``tsne_executionPlan.json`` (``lead``: one writer in a
    multi-process job); the route's exit code."""
    import json
    if lead:
        with open("tsne_executionPlan.json", "w") as f:
            json.dump(plan, f)
        print("execution plan written to tsne_executionPlan.json")
    return 0


def _spmd_job(args, device, sp_run, wd, trace_path, dtype, np_dtype,
              operands=None) -> int:
    """The multi-controller route (the JAX CLI's ``multi_controller``
    branch): this rank's shard of ``parallel/pipeline.SpmdPipeline``
    (``operands``: the kNN products' operand dtype); rank 0 alone writes.
    ``--auditPlan`` without ``--symWidth`` re-checks the plan on every
    rank once the sharded kNN stage ends (:func:`_spmd_recheck`)."""
    import json

    from tsne_flink_tpu_torch.ops.knn import resolve_knn_plan
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    from tsne_flink_tpu_torch.runtime.supervisor import Supervisor
    from tsne_flink_tpu_torch.utils import artifacts as art
    from tsne_flink_tpu_torch.utils import checkpoint as ckpt
    from tsne_flink_tpu_torch.utils import io as tio

    assembly = args.affinityAssembly or "auto"
    if assembly in ("sorted", "split"):
        print(f"# --affinityAssembly {assembly} is ignored in "
              "multi-controller jobs (symmetrization is chosen by "
              "--symMode)", file=sys.stderr)
        assembly = "auto"
    if assembly == "blocks":
        raise SystemExit("--affinityAssembly blocks is single-controller "
                         "(the host re-slices the reverse block per shard, "
                         "which no rank of a multi-controller job holds); "
                         "it runs on any single-controller mesh width")
    if args.transform or args.model:
        raise SystemExit("--model/--transform serve a frozen map in one "
                         "process; drop the multi-host flags")
    neighbors = (args.neighbors if args.neighbors is not None
                 else 3 * int(args.perplexity))
    cache = None if args.noCache else art.ArtifactCache(args.cacheDir)
    if args.inputDistanceMatrix:
        ids, idx, dist = tio.read_distance_matrix(args.input)
        n = len(ids)
        neighbors = int(idx.shape[1])
        data = (torch.as_tensor(idx), torch.as_tensor(dist.astype(np_dtype)))
        knn_method = "precomputed"
    else:
        ids, x64 = tio.read_input(args.input, args.dimension)
        n = len(ids)
        data = torch.as_tensor(x64.astype(np_dtype))
        del x64
        knn_method, _, _ = resolve_knn_plan(
            n, int(args.dimension), args.knnMethod, args.knnIterations,
            args.knnRefine, k=neighbors, backend=device.type)
    cfg = run_config(args, n, device)
    plan = run_plan(args, cfg, n, args.dimension, assembly, neighbors,
                    device.type, args.numProcesses)
    lead = args.processId == 0
    # the plan audit before the sharded prepare: every rank refuses a
    # predicted OOM, rank 0 alone prints the report
    save_payload = {}
    if args.auditPlan:
        save_payload["audit"] = json.dumps(
            audit_gate(args, plan, report=lead))
    supervisor = Supervisor(plan, max_retries=args.maxRetries,
                            on_oom=args.onOom, health_check=args.healthCheck)
    width = args.mesh if args.mesh is not None else args.devices
    pipe = SpmdPipeline(cfg, n, args.dimension, neighbors,
                        knn_method=knn_method, knn_rounds=args.knnIterations,
                        knn_refine=args.knnRefine, sym_width=args.symWidth,
                        sym_mode=args.symMode, sym_slack=args.symSlack,
                        sym_strict=args.symStrict, n_devices=width,
                        artifact_cache=cache, device=device,
                        mesh_reduce=args.meshReduce, matmul_dtype=operands,
                        on_graph=(_spmd_recheck(args, plan, lead)
                                  if args.auditPlan and args.symWidth is None
                                  else None))
    if args.executionPlan:
        return _dump_execution_plan(pipe.lower(data, args.randomState), lead)
    with _profiled(args.profile if lead else None, device):
        if (args.resume or args.checkpoint or args.healthCheck
                or args.telemetry):
            # the segmented form: the sentinel's flag and the telemetry
            # trace are read at segment boundaries
            start_iter, loss_carry, resume_state, prior = 0, None, None, None
            if args.resume:
                start_iter, loss_carry, resume_state, payload, _ = \
                    _load_resume(args.resume, n, dtype, device)
                if lead:
                    check_resumed_audit(args, plan, payload)
                raw = (payload or {}).get("events")
                prior = json.loads(str(raw)) if raw else None

            def save(st, next_iter, losses):
                if wd is not None:
                    wd.beat("optimize")
                if args.checkpoint:
                    ckpt.save(args.checkpoint, st, next_iter, losses,
                              _payload_with_events(save_payload, supervisor,
                                                   prior))

            every = (args.checkpointEvery if (args.checkpoint or wd)
                     and args.checkpointEvery > 0 else 0)
            state1, losses = pipe.run_checkpointable(
                data, args.randomState, start_iter=start_iter,
                loss_carry=loss_carry, resume_state=resume_state,
                checkpoint_every=every, checkpoint_cb=save,
                health_check=args.healthCheck, events=supervisor.events,
                telemetry=args.telemetry)
            y = state1.y[:n]
            if args.checkpoint and lead:
                ckpt.save(args.checkpoint,
                          type(state1)(*(t[:n] for t in state1)),
                          cfg.iterations, losses,
                          _payload_with_events(save_payload, supervisor,
                                               prior))
        else:
            y, losses = pipe(data, args.randomState)
    if not lead:
        return 0
    tio.write_embedding(args.output, ids, y.cpu().numpy())
    tio.write_loss(args.loss, losses.cpu().numpy())
    sp_run.end()
    _write_obs_outputs(trace_path, args.metricsOut,
                       pipe._runner.telemetry_ if args.telemetry else None)
    print(f"embedded {n} points -> {args.output} ({sp_run.seconds:.2f}s "
          f"total, spmd over {pipe.n_devices} process(es), "
          f"backend={device.type})")
    return 0


def _spmd_recheck(args, plan, lead: bool):
    """The multi-controller route's ``on_graph`` hook: the global graph's
    width bound (each rank gathers the shards' graphs, padding rows
    dropped), then :func:`audit_recheck` on every rank, rank 0 alone
    printing."""
    def hook(axis, idx, valid):
        from tsne_flink_tpu_torch.ops.affinities import width_bound
        mine = torch.where(valid[:, None], idx.to(torch.int64), -1)
        audit_recheck(args, plan,
                      width_bound(axis.all_gather(mine.contiguous())),
                      report=lead)
    return hook


def _payload_with_events(payload, supervisor, prior):
    """The checkpoint payload with the supervisor's event and degradation
    history serialized in at save time (a resumed run's history chains
    through ``prior``), as the JAX CLI writes it."""
    import json
    out = dict(payload or {})
    summary = supervisor.summary()
    if prior:
        summary["prior"] = prior
    out["events"] = json.dumps(summary)
    return out


class _profiled:
    """``--profile dir``: the optimize stage under ``torch.profiler``
    (the CPU, and the card's activity on ``cuda``), its Chrome trace
    written into ``dir`` on a clean exit; a no-op without a directory."""

    def __init__(self, path, device):
        self.path, self.device, self.prof = path, device, None

    def __enter__(self):
        if self.path:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.prof is None:
            return False
        self.prof.__exit__(exc_type, exc, tb)
        if exc_type is None:
            os.makedirs(self.path, exist_ok=True)
            out = os.path.join(self.path, "optimize_trace.json")
            self.prof.export_chrome_trace(out)
            print(f"# profile written to {out}", file=sys.stderr)
        return False


if __name__ == "__main__":
    sys.exit(main())
