"""dtype-contract — run every registered op on tiny float32 inputs and
hold it to its declared dtypes (port of ``tsne_flink_tpu/analysis/audit/
dtype.py``; recorded runs instead of abstract traces).

Three checks per registry entry (:mod:`.contracts`), on the audit's
device:

1. **output dtypes** — the op's flattened tensor outputs must have
   exactly its declared dtypes;
2. **f64 scan** — no aten op recorded in the float32 run may produce a
   float64 tensor, off :data:`F64_BLESSED` (a float64 value inside a
   float32 run is a silent upcast, or a CPU-only path);
3. **bf16** — no op may produce a bfloat16 tensor at all: the port's
   kernels are float32 and B1 runs 3xTF32 (bf16 operands are a ROADMAP
   §C limit).
"""

from __future__ import annotations

import dataclasses

from tsne_flink_tpu_torch.analysis.core import Finding
from tsne_flink_tpu_torch.analysis.audit.contracts import (REGISTRY,
                                                           OpContract)

RULE = "dtype-contract"

#: (function, file suffix) -> rationale: where a float64 op is by design
F64_BLESSED = {
    ("norm_pairs", "ops/knn_cuda.py"):
        "B1's row norms are summed in float64 and split into an exact "
        "(hi, lo) float32 pair; nothing float64 leaves the function",
}


def flat_dtypes(out) -> list[str]:
    """The dtypes of the tensors in ``out`` (tuples, named tuples,
    dataclasses), in order."""
    import torch
    got: list[str] = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            got.append(str(v.dtype).replace("torch.", ""))
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
    walk(out)
    return got


def _f64_blessed(frames) -> bool:
    return any(func == bf and path.endswith(bp)
               for path, _l, func in frames or ()
               for (bf, bp) in F64_BLESSED)


def scan_events(events, name: str, path: str) -> list:
    """The f64 and bf16 findings of one recorded float32 run."""
    findings = []
    f64 = sorted({e["name"] for e in events if e["kind"] == "aten"
                  and any(dt == "float64" for _s, dt in e.get("out", ()))
                  and not _f64_blessed(e.get("frames"))})
    if f64:
        findings.append(Finding(
            RULE, path, 1, 0,
            f"{name}: float64 values appear in a float32 run (ops: "
            f"{f64[:4]}) — an upcast; thread the computation dtype"))
    bf16 = sorted({e["name"] for e in events if e["kind"] == "aten"
                   and any(dt == "bfloat16" for _s, dt in e.get("out", ()))})
    if bf16:
        findings.append(Finding(
            RULE, path, 1, 0,
            f"{name}: bfloat16 values appear (ops: {bf16[:4]}) — the "
            "port's kernels are float32, bf16 operands are not ported"))
    return findings


def audit_contract(c: OpContract, device) -> tuple[list, dict]:
    """Run all three checks for one registry entry."""
    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    fn, args = c.make(device)
    with Recorder() as rec:
        out = fn(*args)
    got = tuple(flat_dtypes(out))
    findings = []
    if got != tuple(c.out):
        findings.append(Finding(
            RULE, c.path, 1, 0,
            f"{c.name}: output dtypes {got} violate the declared contract "
            f"{tuple(c.out)} (float32 inputs)"))
    findings.extend(scan_events(rec.events, c.name, c.path))
    launched = sorted({e["name"] for e in rec.events
                       if e["kind"] == "kernel"})
    return findings, {"out": list(got), "ops": len(rec.events),
                      "kernels": launched}


def audit_dtype(device, names=None) -> tuple[list, dict]:
    """Audit every (selected) registry entry; report keyed by op name."""
    findings, report = [], {}
    for name, c in sorted(REGISTRY.items()):
        if names is not None and name not in names:
            continue
        try:
            f, rep = audit_contract(c, device)
        except Exception as e:  # noqa: BLE001 — a failed run IS a finding
            f = [Finding(RULE, c.path, 1, 0,
                         f"{name}: fails on its representative inputs: "
                         f"{type(e).__name__}: {e}")]
            rep = {"error": f"{type(e).__name__}: {e}"}
        findings.extend(f)
        report[name] = rep
    return findings, report
