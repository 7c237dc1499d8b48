"""determinism-audit — the mesh bit-identity contract over recorded runs
(port of ``tsne_flink_tpu/analysis/audit/determinism.py``).

Mesh D == mesh 1 bit for bit holds because every order-sensitive
floating reduction goes through a FIXED-ORDER site: ``models/tsne
._mesh_sum`` gathers the per-row partials and reduces them in one order
on every width, the FFT field's Z is a replicated global, the counts are
integer-valued.  This analyzer runs the real optimize (mesh 1, 2 and 4;
exact on the CSR layout, the rows, blocks + FFT, Barnes-Hut) and the
transform under the recorder and flags, off the blessed-site registry:

* a ``psum`` of a floating tensor over the mesh axis — per-shard partials
  regroup with the width;
* an unordered scatter-add — ``index_add``, ``scatter_add`` /
  ``scatter_reduce``, ``index_put`` / ``put`` with ``accumulate``, a
  ``bincount`` with floating weights — whose atomics add colliding rows
  in any order on the card.  (``segment_reduce`` sums contiguous
  segments: ordered by construction.)

A finding lands at the innermost frame of the offending call — for a
seeded fixture, the fixture's exact line.
"""

from __future__ import annotations

import functools

from tsne_flink_tpu_torch.analysis.core import Finding

RULE = "determinism-audit"

#: (function, file suffix) -> rationale: a flagged reduction is blessed
#: when ANY frame of its provenance matches a row
BLESSED_SITES = {
    ("_mesh_sum", "models/tsne.py"):
        "THE fixed-order reduction: all_gather the per-row partials, "
        "reduce once in one order on every mesh width (its psum mode is "
        "the opt-in --meshReduce psum, not bit-identical by design)",
    ("_global_mean", "models/tsne.py"):
        "the centering total rides an all_gather of the masked rows; the "
        "count is _mesh_count's",
    ("_mesh_count", "models/tsne.py"):
        "psum of an integer-valued row count (float-exact under any "
        "grouping)",
    ("_telemetry_row", "models/tsne.py"):
        "psum of the gains count — integer-valued, float-exact; the norm "
        "partials ride _mesh_sum",
}

#: aten ops that add into colliding rows (the accumulate flag or float
#: weights decide for index_put / put / bincount)
_SCATTER_OPS = {"aten.index_add", "aten.index_add_", "aten.scatter_add",
                "aten.scatter_add_", "aten.scatter_reduce",
                "aten.scatter_reduce_", "aten.index_reduce",
                "aten.index_reduce_"}
_ACCUMULATING = {"aten.index_put", "aten.index_put_",
                 "aten._index_put_impl_", "aten.put", "aten.put_"}


def _blessed_by(frames):
    for path, _line, func in frames or ():
        for (bfunc, bfile), why in BLESSED_SITES.items():
            if func == bfunc and path.endswith(bfile):
                return f"{bfunc} ({bfile})", why
    return None


def _offense(ev) -> str | None:
    name = ev["name"]
    if ev["kind"] == "collective":
        if name == "psum" and ev.get("floating"):
            return ("float psum over the mesh axis: per-shard partials "
                    "regroup with mesh width")
        return None
    if ev["kind"] != "aten":
        return None
    if name in _SCATTER_OPS:
        return (f"unordered scatter-add ({name}): colliding rows add in "
                "any order on the card")
    if name in _ACCUMULATING and ev.get("accumulate"):
        return (f"accumulating {name}: colliding rows add in any order on "
                "the card")
    if (name == "aten.bincount" and len(ev.get("in", ())) > 1
            and ev["in"][1][1].startswith(("float", "bfloat"))):
        return ("bincount with floating weights: a scatter-add in any "
                "order on the card")
    return None


def scan_events(events, label: str) -> tuple[list, list]:
    """(findings, blessed site names) for one recorded program."""
    findings: list = []
    blessed: list = []
    for ev in events:
        offense = _offense(ev)
        if offense is None:
            continue
        hit = _blessed_by(ev.get("frames"))
        if hit is not None:
            blessed.append(hit[0])
            continue
        site = ev.get("site")
        path, line = (site[0], site[1]) if site else (f"run:{label}", 1)
        findings.append(Finding(
            RULE, path, line, 0,
            f"[{label}] {offense} — not on the blessed-site registry "
            "(route through _mesh_sum or add the site with a rationale)"))
    return findings, sorted(set(blessed))


def optimize_events(device, variant, mesh: int,
                    mesh_reduce: str = "canonical"):
    """The recorded events of one segment of ``variant`` (a
    ``cases.VARIANTS`` row) at ``mesh`` shards, with telemetry:
    iterations 8 and 9, a plain one and a report one.  Recorded once a
    process for each argument set (the determinism, comms and sharding
    audits read the same runs); callers only read them."""
    import torch
    return _optimize_events(str(torch.device(device)), variant, mesh,
                            mesh_reduce)


@functools.lru_cache(maxsize=64)
def _optimize_events(device: str, variant, mesh: int, mesh_reduce: str):
    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    _label, kw, assembly = variant
    prep = cases.prepared(device, assembly=assembly)
    cfg = cases.config(**dict(kw))
    opt = cases.sharded(cfg, prep, device, mesh, mesh_reduce)
    st = cases.state(int(prep.jidx.shape[0]), cfg.n_components, device)
    with Recorder() as rec:
        opt.segment(st, cfg, start_iter=8, num_iters=2, with_telemetry=True)
    return rec.events


def transform_events(device, repulsion: str):
    """The recorded events of one transform bucket of a tiny frozen
    model (``serve/transform``)."""
    import numpy as np

    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    from tsne_flink_tpu_torch.serve.model import from_arrays
    from tsne_flink_tpu_torch.serve.transform import transform

    x = cases.blobs(64, 6)
    y = (0.1 * np.random.default_rng(0).standard_normal((64, 2))).astype(
        np.float32)
    plan = PlanConfig(n=64, d=6, k=12, backend=str(device).split(":")[0],
                      repulsion=repulsion, name=f"audit-serve-{repulsion}")
    model = from_arrays(x, y, plan, perplexity=4.0, learning_rate=100.0,
                        device=device)
    with Recorder() as rec:
        transform(model, x[:8], bucket=8, iters=2)
    return rec.events


def audit_determinism(device) -> tuple[list, dict]:
    """Record optimize (mesh 1, 2, 4; every variant) and the transform
    (exact, FFT) and scan each for unblessed order-sensitive floating
    reductions."""
    from tsne_flink_tpu_torch.analysis.audit import cases

    findings: list = []
    programs: dict = {}

    def scan(label, thunk):
        try:
            events = thunk()
        except Exception as e:  # noqa: BLE001 — a failed run IS a finding
            findings.append(Finding(
                RULE, f"run:{label}", 1, 0,
                f"program '{label}' fails to run: {type(e).__name__}: {e}"))
            programs[label] = {"error": f"{type(e).__name__}: {e}"}
            return
        got, blessed = scan_events(events, label)
        findings.extend(got)
        programs[label] = {"unblessed": len(got), "blessed_sites": blessed,
                           "events": len(events)}

    for variant in cases.VARIANTS:
        for mesh in (1, 2, 4):
            scan(f"optimize[{variant[0]}:mesh{mesh}]",
                 lambda v=variant, d=mesh: optimize_events(device, v, d))
    for repulsion in ("exact", "fft"):
        scan(f"transform[{repulsion}]",
             lambda r=repulsion: transform_events(device, r))
    report = {
        "programs": programs,
        "blessed_registry": {f"{fn} ({path})": why
                             for (fn, path), why in BLESSED_SITES.items()},
        "ok": not findings,
    }
    return findings, report
