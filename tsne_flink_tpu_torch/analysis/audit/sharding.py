"""sharding-contract — every shard's collectives on the live axis, in one
sequence (the port's form of ``tsne_flink_tpu/analysis/audit/
sharding.py``'s "every collective's axis is a live mesh axis").

The JAX programs carry their parallelism in axis-name strings; the port
carries it in handles (``parallel/mesh.MeshAxis`` / ``ProcessAxis``) and
in the ORDER the shards meet: a shard that issues one collective more,
or another kind or shape, than its peers deadlocks the thread mesh's
barrier or a process group's NCCL / gloo call.  So the audit runs the
sharded programs under the recorder and holds:

* every collective to the live axis: the handle's width is the mesh's,
  and its index is the issuing shard's;
* every shard to the same sequence of collectives (kind, shapes,
  dtypes) — at mesh 2 and 4 on the thread mesh (the optimizer's CSR and
  blocks + FFT variants, and the in-process ``SpmdPipeline``: ring kNN,
  symmetrization), and in a two-process gloo job (one rank a process).

A mismatch never hangs the audit: the thread mesh breaks its barrier
when a shard ends while another waits (``CollectiveMismatch``), and the
process job's group has a finite timeout.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

from tsne_flink_tpu_torch.analysis.core import Finding

RULE = "sharding-contract"

#: seconds a rank of the audit's process job waits for its peer
JOB_TIMEOUT_S = 120.0


def analyze(events, mesh: int, label: str) -> tuple[list, dict]:
    """Findings for one recorded sharded run of ``mesh`` shards."""
    findings: list = []
    coll = [e for e in events if e["kind"] == "collective"]
    for e in coll:
        if e["size"] != mesh or (e["shard"] is not None
                                 and e["index"] != e["shard"]):
            site = e.get("site") or (f"run:{label}", 1, "?")
            findings.append(Finding(
                RULE, site[0], site[1], 0,
                f"[{label}] {e['name']} on an axis of width {e['size']} "
                f"index {e['index']} from shard {e['shard']} of a mesh of "
                f"{mesh}: not the live axis"))
    seqs = {}
    for e in coll:
        seqs.setdefault(e["index"], []).append((e["name"], repr(e["in"])))
    findings.extend(compare_sequences(seqs, label, coll))
    report = {"collectives": len(coll), "shards": sorted(seqs),
              "per_shard": len(seqs[min(seqs)]) if seqs else 0}
    return findings, report


def compare_sequences(seqs: dict, label: str, events=()) -> list:
    """A finding at the first collective where a shard's sequence leaves
    shard 0's (or ends before it)."""
    if not seqs:
        return []
    ranks = sorted(seqs)
    ref = seqs[ranks[0]]
    out = []
    for r in ranks[1:]:
        got = seqs[r]
        pos = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                   None if len(ref) == len(got) else min(len(ref), len(got)))
        if pos is None:
            continue
        ev = [e for e in events if e.get("index") == r]
        site = (ev[pos].get("site") if pos < len(ev) else None) \
            or (f"run:{label}", 1, "?")
        want = ref[pos] if pos < len(ref) else ("(end)", "")
        have = got[pos] if pos < len(got) else ("(end)", "")
        out.append(Finding(
            RULE, site[0], site[1], 0,
            f"[{label}] shard {r}'s collective {pos} is {have[0]} "
            f"{have[1]} where shard {ranks[0]} issues {want[0]} {want[1]}: "
            "the shards' sequences differ (a deadlock on the card)"))
    return out


def check_run(thunk, mesh: int, label: str) -> tuple[list, dict]:
    """Run ``thunk`` (a sharded run of ``mesh`` shards) under the
    recorder and hold its collectives; a run that raises — a barrier
    broken by a mismatch included — is a finding."""
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    rec = Recorder()
    try:
        with rec:
            thunk()
    except Exception as e:  # noqa: BLE001 — a failed run IS a finding
        f, rep = analyze(rec.events, mesh, label)
        site = next((ev["site"] for ev in reversed(rec.events)
                     if ev["kind"] == "collective" and ev.get("site")),
                    (f"run:{label}", 1, "?"))
        return [Finding(RULE, site[0], site[1], 0,
                        f"[{label}] the sharded run fails: "
                        f"{type(e).__name__}: {e}")] + f, rep
    return analyze(rec.events, mesh, label)


def _pipeline_run(device, mesh: int):
    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    import torch
    cfg = cases.config(iterations=12, repulsion="exact")
    x = torch.as_tensor(cases.blobs(), device=device)
    pipe = SpmdPipeline(cfg, cases.N, cases.D, cases.K,
                        knn_method="bruteforce", sym_mode="alltoall",
                        sym_width=4 * cases.K, devices=[device] * mesh)
    return lambda: pipe(x, 0)


def _optimizer_events(device, variant, mesh: int) -> list:
    """The determinism audit's recorded segment of ``variant`` at
    ``mesh`` shards (recorded once a process)."""
    from tsne_flink_tpu_torch.analysis.audit.determinism import \
        optimize_events
    return optimize_events(device, variant, mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_job(device) -> tuple[list, dict]:
    """The two-process gloo job: each rank runs the tiny
    ``SpmdPipeline`` under the recorder in a process of its own and
    writes its collective sequence; the sequences must agree."""
    world = 2
    label = f"spmd[gloo:{world} processes]"
    dev = str(device)
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", __name__, "--worker", str(r),
             str(world), str(port), dev, os.path.join(tmp, f"{r}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=JOB_TIMEOUT_S + 60)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
        if any(p.returncode != 0 for p in procs):
            return [Finding(RULE, f"run:{label}", 1, 0,
                            f"[{label}] a rank failed: "
                            + " | ".join(x[-400:] for x in logs))], {}
        seqs = {}
        events = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.json"), encoding="utf-8") as f:
                got = json.load(f)
            seqs[r] = [tuple(s) for s in got["sequence"]]
            events.extend(got["events"])
    findings = []
    for e in events:
        if e["size"] != world:
            findings.append(Finding(
                RULE, e["site"][0], e["site"][1], 0,
                f"[{label}] {e['name']} on a group of {e['size']}"))
    findings.extend(compare_sequences(seqs, label, events))
    return findings, {"collectives": len(events), "ranks": world,
                      "per_rank": len(seqs[0]), "backend": "gloo"}


def _worker(rank: int, world: int, port: int, device: str, out: str) -> int:
    """One rank of :func:`process_job` (``python -m`` this module)."""
    import torch

    from tsne_flink_tpu_torch.analysis.audit import cases
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    from tsne_flink_tpu_torch.parallel.mesh import (close_group,
                                                    distributed_init,
                                                    process_backend)
    from tsne_flink_tpu_torch.parallel.pipeline import SpmdPipeline
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda" and process_backend(dev, world) != "gloo":
        raise RuntimeError("the audit's process job is the gloo route")
    distributed_init(f"127.0.0.1:{port}", world, rank, device=device,
                     timeout_s=JOB_TIMEOUT_S)
    try:
        cfg = cases.config(iterations=12, repulsion="exact")
        pipe = SpmdPipeline(cfg, cases.N, cases.D, cases.K,
                            knn_method="bruteforce", sym_mode="alltoall",
                            sym_width=4 * cases.K, device=device)
        with Recorder() as rec:
            pipe(torch.as_tensor(cases.blobs()), 0)
    finally:
        close_group()
    coll = [{k: e[k] for k in ("name", "size", "index", "in", "bytes",
                               "site")}
            for e in rec.events if e["kind"] == "collective"]
    with open(out, "w", encoding="utf-8") as f:
        json.dump({"sequence": [(e["name"], repr(e["in"])) for e in coll],
                   "events": coll}, f)
    return 0


def audit_sharding(device, *, processes: bool = True) -> tuple[list, dict]:
    """The thread mesh at 2 and 4 (optimizer variants, the in-process
    pipeline) and, with ``processes``, the two-process gloo job."""
    from tsne_flink_tpu_torch.analysis.audit import cases

    findings: list = []
    report: dict = {"runs": {}}
    for mesh in (2, 4):
        for variant in (cases.VARIANTS[0], cases.VARIANTS[2]):
            label = f"optimize[{variant[0]}:mesh{mesh}]"
            f, rep = analyze(_optimizer_events(device, variant, mesh), mesh,
                             label)
            findings.extend(f)
            report["runs"][label] = rep
        label = f"spmd[alltoall:mesh{mesh}]"
        f, rep = check_run(_pipeline_run(device, mesh), mesh, label)
        findings.extend(f)
        report["runs"][label] = rep
    if processes:
        f, rep = process_job(device)
        findings.extend(f)
        report["runs"]["spmd[gloo:2 processes]"] = rep
    report["ok"] = not findings
    return findings, report


if __name__ == "__main__":
    if len(sys.argv) == 7 and sys.argv[1] == "--worker":
        sys.exit(_worker(int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit("usage: python -m tsne_flink_tpu_torch.analysis.audit.sharding "
             "--worker RANK WORLD PORT DEVICE OUT")
