"""comms-audit — the collective-cost model over recorded runs (port of
``tsne_flink_tpu/analysis/audit/comms.py``).

The recorder sees every collective a shard issues (``parallel/mesh``'s
hooks) with its payload bytes, its issuing function and the optimize
loop's iteration.  The audit records one segment of the sharded
optimizer on the thread mesh — iteration 8, a plain one, and iteration
9, a report one — and separates:

* **per-iteration** collectives (issued inside the loop; the plain
  iteration's are what every iteration pays, the report iteration adds
  the KL's and the telemetry's), from
* **per-segment** ones (before the loop: the validity mask's gather, the
  row count; the multi-controller segment's state gather after it).

Payloads of N-scaling collectives (a payload of at least the trace's
rows-per-shard elements) extrapolate to a plan's scale by the
rows-per-shard ratio, as in the JAX model; widths never scale.

Seconds are priced under the card's link model: NVLink on the card's
machine, each GPU's links together (an NVSwitch host: every pair at full
rate), ring-lowered collectives (all_gather forwards a shard D-1 times,
psum moves 2(D-1)/D of its operand, all_to_all keeps 1/D home, ppermute
is one hop).  The constants were read with ``nvidia-smi nvlink
--status`` on the card's machine (PERF.md, PR 15); per-hop latency is
not modelled (not measured).
A gloo route (two ranks sharing a card, or the CPU) is reported in bytes
only: it stages through host memory, at no modelled rate.

``BLESSED_COMMS`` is the per-site registry: every collective's issuing
function (its innermost frame outside the mesh's plumbing) must be on
it, with a rationale; its rows ride the ``--suppressions`` ledger.
"""

from __future__ import annotations

from tsne_flink_tpu_torch.analysis.core import Finding

RULE = "comms-audit"

#: NVLink links per GPU and each link's rate, one direction, as
#: ``nvidia-smi nvlink --status`` reads them on the card's machine (NVIDIA
#: H100 80GB HBM3, 700.00 W: 18 links of 26.562 GB/s); PERF.md, PR 15
NVLINK_LINKS = 18
NVLINK_LINK_BYTES_PER_S = 26.562e9

#: (function, file suffix) -> rationale: a collective is blessed when its
#: INNERMOST issuing frame names a row (per issuing function, so blessing
#: ``optimize`` wholesale is impossible)
BLESSED_COMMS = {
    ("_mesh_sum", "models/tsne.py"):
        "the canonical fixed-order global sum: one [N] all_gather per "
        "global scalar (or one scalar psum under --meshReduce psum)",
    ("optimize", "models/tsne.py"):
        "the per-iteration [N, m] embedding gather every repulsion and "
        "attraction form needs, plus, once a segment, the [N] validity "
        "mask's gather hoisted out of the loop",
    ("_global_mean", "models/tsne.py"):
        "centering: the masked [N, m] rows gathered and summed in one "
        "order (the count is _mesh_count's, once a segment)",
    ("_psum", "models/tsne.py"):
        "scalar psum wrapper: the valid-row count, the gains count, the "
        "health flag — 4-8 bytes a call",
    ("_pmax", "models/tsne.py"):
        "scalar pmax wrapper: telemetry's gains / embedding maxima",
    ("_pmin", "models/tsne.py"):
        "scalar pmin wrapper: telemetry's embedding minima",
    ("segment", "parallel/mesh.py"):
        "a multi-controller rank's segment end: the state gathered so "
        "every rank holds the (tiny) global state between segments",
    ("ring_knn", "parallel/knn.py"):
        "the bruteforce kNN ring: one [n/D, d] feature block a hop, "
        "point to point; total bytes of one all_gather",
    ("project_knn_sharded", "parallel/knn.py"):
        "projected kNN: the [N, d] features gathered once a prepare (every "
        "band needs arbitrary rows) and the final [N, k] graph",
    ("one_round", "parallel/knn.py"):
        "a Z-order round: the band sweep's sorted [N, k] (dist, idx) so "
        "every shard merges the same candidates",
    ("_symmetrize", "parallel/pipeline.py"):
        "replicated symmetrization: the [N, k] graph gathered, sorted the "
        "same way everywhere; scalar width handshakes (pmax)",
    ("symmetrize_alltoall", "parallel/symmetrize.py"):
        "routed symmetrization: one [n/D, W] all_to_all pair a prepare "
        "and scalar drop / width counters",
}


def ring_cost(kind: str, payload_bytes: int, devices: int):
    """(sent bytes a device, hops) of one collective of a ``payload`` a
    shard over ``devices`` ring members (the JAX model's lowerings)."""
    d = max(1, int(devices))
    if d == 1:
        return 0, 0
    b = float(payload_bytes)
    if kind == "all_gather":
        return int(b * (d - 1)), d - 1
    if kind in ("psum", "pmax", "pmin"):
        return int(2.0 * b * (d - 1) / d), 2 * (d - 1)
    if kind == "all_to_all":
        return int(b * (d - 1) / d), d - 1
    return int(b), 1


def link_seconds(sent_bytes: int, route: str = "nvlink") -> float | None:
    """Seconds of ``sent_bytes`` a device over the card's NVLink links
    together; None on a gloo route (bytes only)."""
    if route != "nvlink":
        return None
    return sent_bytes / (NVLINK_LINKS * NVLINK_LINK_BYTES_PER_S)


def _blessed_site(site):
    if not site:
        return None
    path, _line, func = site
    for (bfunc, bfile), _why in BLESSED_COMMS.items():
        if func == bfunc and path.endswith(bfile):
            return f"{bfunc} ({bfile})"
    return None


def collect_rows(events, shard_rows: int, devices: int) -> list:
    """The per-collective inventory of one shard's recorded events."""
    rows = []
    for e in events:
        if e["kind"] != "collective":
            continue
        elems = sum(int(_prod(s)) for s, _dt in e["in"])
        site = e.get("site") or ("?", 1, "?")
        sent, hops = ring_cost(e["name"], e["bytes"], devices)
        rows.append({
            "primitive": e["name"], "payload_bytes": int(e["bytes"]),
            "sent_bytes": sent, "hops": hops, "path": site[0],
            "line": site[1], "func": site[2],
            "blessed": _blessed_site(site),
            "n_scaling": elems >= max(1, shard_rows),
            "iteration": e.get("iteration"),
            "per_iteration": e.get("iteration") is not None,
        })
    return rows


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def scan_rows(rows, label: str) -> list:
    """An unblessed collective whose payload scales with N is the
    finding (O(N) traffic off the registry)."""
    findings = []
    for r in rows:
        if r["blessed"] is not None or not r["n_scaling"]:
            continue
        when = "per-iteration" if r["per_iteration"] else "per-segment"
        findings.append(Finding(
            RULE, r["path"], r["line"], 0,
            f"[{label}] unblessed {when} {r['primitive']} with N-scaling "
            f"payload ({r['payload_bytes']} B a shard at the recorded "
            "shape) — O(N) traffic off the BLESSED_COMMS registry: route "
            "through _mesh_sum, or attest the site with a rationale"))
    return findings


def record_segment(device, mesh: int, mode: str = "canonical"):
    """(shard 0's events, rows a shard) of iterations 8-9 of the tiny
    case (exact, the CSR layout) at ``mesh`` shards under ``mode``."""
    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.analysis.audit.determinism import \
        optimize_events
    from tsne_flink_tpu_torch.parallel.mesh import padded_rows_for
    events = optimize_events(device, cases.VARIANTS[0], mesh,
                             mesh_reduce=mode)
    shard_rows = padded_rows_for(cases.N, mesh) // mesh
    return [e for e in events if e["shard"] in (0, None)], shard_rows


def plan_comms_report(plan, mode: str = "canonical", device="cpu",
                      route: str = "nvlink") -> dict:
    """Predicted traffic of ``plan``'s optimize loop at its mesh width
    under ``mode``: one recorded segment of the tiny case at the same
    width, N-scaling rows extrapolated by the rows-per-shard ratio."""
    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.parallel.mesh import padded_rows_for

    d = max(1, int(plan.mesh))
    events, trace_rows = record_segment(device, d, mode)
    factor = (padded_rows_for(plan.n, d) // d) / trace_rows
    rows = collect_rows(events, trace_rows, d)
    plain = min((r["iteration"] for r in rows if r["per_iteration"]),
                default=None)
    out_rows = []
    per_iter = per_iter_payload = reduce_b = seg = report_extra = 0
    for r in rows:
        payload = (int(r["payload_bytes"] * factor) if r["n_scaling"]
                   else r["payload_bytes"])
        sent, hops = ring_cost(r["primitive"], payload, d)
        out_rows.append({**r, "payload_bytes": payload, "sent_bytes": sent,
                         "hops": hops})
        if not r["per_iteration"]:
            seg += sent
        elif r["iteration"] == plain:
            per_iter += sent
            per_iter_payload += payload
            if r["func"] == "_mesh_sum":
                reduce_b += sent
        else:
            report_extra += sent
    return {
        "plan": plan.name, "mode": mode, "mesh": d,
        "rows_per_shard": padded_rows_for(plan.n, d) // d,
        "recorded_n": cases.N, "route": route,
        "collectives": out_rows,
        "per_iter_bytes": int(per_iter),
        "per_iter_payload_bytes": int(per_iter_payload),
        "per_iter_seconds": link_seconds(per_iter, route),
        "per_iter_reduce_bytes": int(reduce_b),
        "report_iter_extra_bytes": int(report_extra),
        "per_segment_bytes": int(seg),
        "per_run_bytes": int(per_iter * plan.iterations
                             + report_extra * (plan.iterations // 10)
                             + seg),
        "constants": {"nvlink_links": NVLINK_LINKS,
                      "nvlink_link_bytes_per_s": NVLINK_LINK_BYTES_PER_S},
    }


def plan_mode_pair(plan, device="cpu") -> dict:
    """The canonical / psum A/B (``--meshReduce``): both modes' models and
    the reduction slice's collapse."""
    canonical = plan_comms_report(plan, "canonical", device)
    psum = plan_comms_report(plan, "psum", device)
    return {"canonical": canonical, "psum": psum,
            "reduce_bytes_collapse": (canonical["per_iter_reduce_bytes"]
                                      / max(1,
                                            psum["per_iter_reduce_bytes"]))}


def audit_comms(device, plans=None) -> tuple[list, dict]:
    """Record the sharded optimizer (mesh 2 and 4, both reduce modes,
    every variant at mesh 4), the in-process pipeline's prepare, and the
    transform; inventory every collective and flag unblessed N-scaling
    traffic; then the A/B model for every plan with a mesh > 1."""
    import torch

    from tsne_flink_tpu_torch.analysis.audit import cases, determinism
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    from tsne_flink_tpu_torch.parallel.mesh import padded_rows_for
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline

    findings: list = []
    programs: dict = {}

    def scan(label, thunk, devices):
        try:
            events = thunk()
        except Exception as e:  # noqa: BLE001 — a failed run IS a finding
            findings.append(Finding(
                RULE, f"run:{label}", 1, 0,
                f"program '{label}' fails to run: {type(e).__name__}: {e}"))
            programs[label] = {"error": f"{type(e).__name__}: {e}"}
            return
        rows = collect_rows([e for e in events if e["shard"] in (0, None)],
                            padded_rows_for(cases.N, devices) // devices,
                            devices)
        findings.extend(scan_rows(rows, label))
        programs[label] = {
            "collectives": len(rows),
            "unblessed": sum(1 for r in rows if r["blessed"] is None),
            "per_iteration": sum(1 for r in rows if r["per_iteration"]),
            "blessed_sites": sorted({r["blessed"] for r in rows
                                     if r["blessed"]}),
        }

    for d in (2, 4):
        for mode in ("canonical", "psum"):
            scan(f"optimize[mesh{d}:{mode}]",
                 lambda d=d, m=mode: determinism.optimize_events(
                     device, cases.VARIANTS[0], d, mesh_reduce=m), d)
    for variant in cases.VARIANTS[1:]:
        scan(f"optimize[{variant[0]}:mesh4]",
             lambda v=variant: determinism.optimize_events(device, v, 4), 4)

    def pipeline(method, mode):
        cfg = cases.config(iterations=12, repulsion="exact")
        pipe = SpmdPipeline(cfg, cases.N, cases.D, cases.K,
                            knn_method=method, sym_mode=mode,
                            sym_width=4 * cases.K, devices=[device] * 2)
        with Recorder() as rec:
            pipe(torch.as_tensor(cases.blobs(), device=device), 0)
        return rec.events

    for method, mode in (("bruteforce", "alltoall"),
                         ("project", "replicated")):
        scan(f"spmd[{method}:{mode}:mesh2]",
             lambda a=method, b=mode: pipeline(a, b), 2)
    for repulsion in ("exact", "fft"):
        # serving is single-device: the inventory proves no collective
        scan(f"transform[{repulsion}]",
             lambda r=repulsion: determinism.transform_events(device, r), 1)

    plan_reports: dict = {}
    for plan in plans or []:
        if int(plan.mesh) <= 1:
            continue
        plan_reports[plan.name] = plan_mode_pair(plan, device)
    report = {
        "programs": programs,
        "plan_models": plan_reports,
        "blessed_registry": {f"{fn} ({path})": why
                             for (fn, path), why in BLESSED_COMMS.items()},
        "constants": {"nvlink_links": NVLINK_LINKS,
                      "nvlink_link_bytes_per_s": NVLINK_LINK_BYTES_PER_S},
        "unblessed": sum(p.get("unblessed", 0) for p in programs.values()),
        "ok": not findings,
    }
    return findings, report
