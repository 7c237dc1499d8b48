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
3. **bf16** — in the float32 run no op may produce a bfloat16 tensor:
   bf16 values exist only under bf16 operands, and there only where
   ``ops/metrics.matmul_operands`` rounds (or B1's bf16 form allocates
   the copy its kernel rounds into).  For entries with ``matmul_dim``
   set, the case is recorded again under bf16 operands (``make(device,
   matmul_dtype=torch.bfloat16)``; port of the JAX check,
   ``tsne_flink_tpu/analysis/audit/dtype.py:121-151``), and fails on any
   matrix product that contracts over the ``matmul_dim``-wide feature
   axis with an operand that holds values off the bf16 grid (an operand
   that bypassed ``matmul_operands``: a float32 leak into the bf16
   path), and on any output dtype change (bf16 leaking out past the
   float32 accumulation).
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


#: where a bf16 tensor may appear under bf16 operands: the blessed cast
#: and the bf16 copy B1's bf16 form rounds into (function, file suffix)
BF16_BLESSED = {("matmul_operands", "ops/metrics.py"),
                ("_operand_scratch", "ops/knn_cuda.py")}


def _bf16_blessed(frames) -> bool:
    return any(func == bf and path.endswith(bp)
               for path, _l, func in frames or ()
               for (bf, bp) in BF16_BLESSED)


def scan_events(events, name: str, path: str,
                bf16_operands: bool = False) -> list:
    """The f64 and bf16 findings of one recorded run (float32 inputs;
    ``bf16_operands``: recorded under bf16 operands, where the blessed
    sites may hold bf16 values)."""
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
                   and any(dt == "bfloat16" for _s, dt in e.get("out", ()))
                   and not (bf16_operands and _bf16_blessed(e.get("frames")))})
    if bf16:
        findings.append(Finding(
            RULE, path, 1, 0,
            f"{name}: bfloat16 values appear (ops: {bf16[:4]}) outside "
            "ops/metrics.matmul_operands"
            + (" — bf16 exists under bf16 operands only, where that cast "
               "rounds" if not bf16_operands else "")))
    return findings


def feature_leaks(events, matmul_dim: int) -> list:
    """The matrix products of a run recorded with operand values
    (``Recorder(operand_values=True)``) that contract over a
    ``matmul_dim``-wide axis with an operand off the bf16 grid."""
    from tsne_flink_tpu_torch.analysis.audit.record import PRODUCT_OPS
    leaks = []
    for e in events:
        pos = PRODUCT_OPS.get(e.get("name"))
        if e["kind"] != "aten" or pos is None or "rounded" not in e:
            continue
        ins = e["in"]
        if len(ins) <= pos or not ins[pos][0]:
            continue
        if ins[pos][0][-1] == matmul_dim and not all(e["rounded"]):
            leaks.append(e)
    return leaks


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
    rep = {"out": list(got), "ops": len(rec.events), "kernels": launched,
           "bf16_checked": False}
    if c.matmul_dim is not None:
        findings.extend(_bf16_pass(c, device, rep))
    return findings, rep


def _bf16_pass(c: OpContract, device, rep: dict) -> list:
    """The entry recorded again under bf16 operands: leaks into the bf16
    path, bf16 off the blessed sites, and output dtype changes."""
    import torch

    from tsne_flink_tpu_torch.analysis.audit.record import Recorder
    fn, args = c.make(device, matmul_dtype=torch.bfloat16)
    with Recorder(operand_values=True) as rec:
        out = fn(*args)
    findings = []
    leaks = feature_leaks(rec.events, c.matmul_dim)
    if leaks:
        sites = sorted({f"{e['site'][2]} ({e['site'][0]}:{e['site'][1]})"
                        for e in leaks if e.get("site")})
        findings.append(Finding(
            RULE, c.path, 1, 0,
            f"{c.name}: {len(leaks)} product(s) contract over the "
            f"{c.matmul_dim}-wide feature axis with an operand off the bf16 "
            f"grid under bf16 operands (at {sites[:3]}) — a float32 leak "
            "into the bf16 path (route operands through "
            "ops/metrics.matmul_operands)"))
    findings.extend(scan_events(rec.events, c.name, c.path,
                                bf16_operands=True))
    got16 = tuple(flat_dtypes(out))
    if got16 != tuple(c.out):
        findings.append(Finding(
            RULE, c.path, 1, 0,
            f"{c.name}: output dtypes change to {got16} under bf16 "
            "operands — accumulations must stay at the contract dtypes"))
    rep["bf16_checked"] = True
    rep["bf16_products"] = sum(1 for e in rec.events if "rounded" in e)
    rep["bf16_kernels"] = sorted({e["name"] for e in rec.events
                                  if e["kind"] == "kernel"})
    return findings


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
