"""conc-protocol — the port's filesystem protocols as checkable specs.

The serving/runtime layer's durability story is a handful of FILE
protocols, each with one blessed write primitive:

* **spool request/result/error** (serve/daemon.py): ``<id>.req.npz`` is
  claimed under a FileLock and reaches exactly one terminal —
  ``<id>.res.npz`` + ``<id>.lat.json`` or ``<id>.err.json`` — all written
  through ``utils/io.atomic_write``; the request file is deleted only
  after the terminal lands.
* **swap control** (serve/daemon.py): ``<name>.swap.json`` answered by an
  atomic ``<name>.swap.done.json`` under the control file's lock.
* **checkpoint** (utils/checkpoint.py): tmp + ``os.replace`` with a
  finally-unlink, rotating keep-last-2.
* **artifact cache** (utils/artifacts.py) and the **kernel library**
  (kernels/build.py, the port's counterpart of the JAX package's AOT
  cache): FileLock-guarded tmp + ``os.replace``.
* **job/serve records** (runtime/fleet.py): ``utils/io.atomic_write``.
* **heartbeat / claim-epoch / shed refusal** (serve/replicas.py,
  graftquorum): ``<replica>.beat.json`` liveness, ``<id>.epoch.json``
  claim generations (the exactly-once rename guard's counter), and the
  ``retry_after_ms``-carrying brownout ``.err.json`` — all atomic.

This analyzer declares those protocols as :class:`ProtocolSpec` rows (the
single registry the chaos-coverage test cross-checks against
``runtime/faults.SITES``) and then scans every filesystem mutation in
``runtime//serve//utils/`` for three violation shapes:

* ``conc-protocol-bypass`` — a raw write (``open(..., 'w')``,
  ``np.save``, ``Path.write_*``) whose target names a protocol-governed
  path class without going through the blessed primitive;
* ``conc-protocol-rmw`` — a function that both reads and mutates the
  same governed path class with no FileLock in evidence (a lost-update
  window between two daemons/jobs);
* ``conc-protocol-tmp`` — a tmp-file write (``tempfile.mkstemp``) not
  followed by an atomic ``os.replace`` on all control-flow paths, or
  with no finally-unlink (a crash strands the tmp file, an exception
  skips the rename and readers see nothing — or worse, a torn file if
  the write targeted the final path).

Lexical and conservative by design (same stance as graftlint): path
expressions are classified by the suffix constants / literals they
mention, with one level of local-assignment resolution.  Suppressions use
the graftlint grammar (``# graftlint: disable=conc-protocol-bypass --
rationale``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from tsne_flink_tpu_torch.analysis.core import Module
from tsne_flink_tpu_torch.analysis.rules import (
    _functions_with_parents, _walk_own_body)


@dataclass(frozen=True)
class ProtocolSpec:
    """One filesystem protocol: a governed path class, its blessed write
    primitive(s), and the fault-grammar site whose chaos tests exercise
    it (``chaos_rationale`` documents the ones rehearsed by unit tests
    instead of fault injection)."""

    name: str
    #: tokens (suffix-constant names and literal fragments) that mark a
    #: path expression as belonging to this class
    markers: tuple
    #: callables allowed to mutate the class ("atomic_write", or
    #: "tmp-rename" for the in-function mkstemp + os.replace pattern)
    blessed: tuple
    #: runtime/faults.py site whose injection exercises this protocol
    fault_site: str | None = None
    chaos_rationale: str | None = None
    doc: str = ""


#: the registry: every protocol the serve/runtime layer speaks.  The
#: chaos-coverage test (tests/test_conc.py) asserts each row either maps
#: to an exercised fault-grammar site or carries a rationale.
PROTOCOLS = (
    ProtocolSpec(
        "spool-request", markers=("REQ_SUFFIX", ".req.npz"),
        blessed=("atomic_write",), fault_site="serve",
        doc="client-submitted request; claimed under <path>.lock, deleted "
            "only after a terminal file lands"),
    ProtocolSpec(
        "spool-result", markers=("RES_SUFFIX", ".res.npz",
                                 "LAT_SUFFIX", ".lat.json"),
        blessed=("atomic_write",), fault_site="serve",
        doc="the done marker + latency record; presence means served"),
    ProtocolSpec(
        "spool-error", markers=("ERR_SUFFIX", ".err.json"),
        blessed=("atomic_write",), fault_site="serve",
        doc="the refusal terminal (unknown model, wrong width)"),
    ProtocolSpec(
        "swap-control", markers=("SWAP_SUFFIX", ".swap.json",
                                 "SWAP_DONE_SUFFIX", ".swap.done.json"),
        blessed=("atomic_write",), fault_site="serve",
        doc="hot-swap handshake: <name>.swap.json -> <name>.swap.done.json "
            "under the control file's FileLock"),
    ProtocolSpec(
        "checkpoint", markers=(".ckpt",),
        blessed=("atomic_write", "tmp-rename"), fault_site="checkpoint",
        doc="verified rotating optimizer checkpoint (utils/checkpoint.py)"),
    ProtocolSpec(
        "artifact-cache", markers=(".artifact",),
        blessed=("tmp-rename",), fault_site="affinities",
        doc="content-addressed affinity artifacts, FileLock-guarded "
            "tmp+rename (utils/artifacts.py)"),
    ProtocolSpec(
        "kernel-library", markers=(".so",),
        blessed=("tmp-rename",), fault_site="job",
        chaos_rationale="the library is best-effort cache: a damaged or "
                        "missing file is a rebuild under the build lock "
                        "(kernels/build.library); lock contention is "
                        "exercised by the replica fleet's cold start, not "
                        "the fault grammar",
        doc="the compiled kernel library, keyed by the sources' hash "
            "(kernels/build.py)"),
    ProtocolSpec(
        "job-record", markers=("record_path", ".record.json"),
        blessed=("atomic_write",), fault_site="job",
        doc="fleet job/serve evidence records (runtime/fleet.py)"),
    ProtocolSpec(
        "heartbeat", markers=("BEAT_SUFFIX", ".beat.json"),
        blessed=("atomic_write",), fault_site="serve",
        doc="graftquorum replica liveness: <replica>.beat.json in the "
            "spool (seq + pid + claimed manifest) drives the dead/hung/"
            "slow triage; swept by the supervisor at fleet exit"),
    ProtocolSpec(
        "claim-epoch", markers=("EPOCH_SUFFIX", ".epoch.json"),
        blessed=("atomic_write",), fault_site="serve",
        doc="graftquorum claim generation: <id>.epoch.json bumped under "
            "the claim lock; the result writer's rename guard discards a "
            "zombie's stale-epoch write (serve/replicas.py)"),
    ProtocolSpec(
        "shed-refusal", markers=("retry_after_ms",),
        blessed=("atomic_write",), fault_site="serve",
        doc="graftquorum brownout terminal: a bulk-lane .err.json refusal "
            "carrying retry_after_ms when the backlog exceeds "
            "the daemon's shed depth (runtime/admission.decide_shed)"),
)


# ---- path-expression classification ----------------------------------------

def expr_tokens(node) -> set:
    """Every identifier and string literal lexically inside ``node``."""
    out: set = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.add(sub.value)
    return out


def local_assign_tokens(fn) -> dict:
    """One level of dataflow: local name -> tokens of every expression
    ever assigned to it in ``fn``'s own body."""
    out: dict = {}
    for node in _walk_own_body(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.setdefault(tgt.id, set()).update(
                        expr_tokens(node.value))
    return out


def path_tokens(expr, assigns: dict) -> set:
    """Tokens of ``expr`` plus the tokens of any local name it uses."""
    direct = expr_tokens(expr)
    out = set(direct)
    for name in direct:
        out |= assigns.get(name, set())
    return out


def classify(tokens: set) -> ProtocolSpec | None:
    """The protocol whose markers the token set mentions, if any."""
    for spec in PROTOCOLS:
        for marker in spec.markers:
            # exact identifier match, or the marker appearing inside a
            # longer literal (".ckpt" matches a ".ckpt.tmp" suffix)
            if marker in tokens or any(
                    isinstance(t, str) and marker in t for t in tokens):
                return spec
    return None


# ---- mutation / read extraction ---------------------------------------------

_WRITE_MODES = ("w", "a", "x")


def _call_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _mutations(fn):
    """(node, what, path_expr) for raw filesystem mutations in ``fn``."""
    for node in _walk_own_body(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name == "open" and len(node.args) >= 2:
            mode = node.args[1]
            if (isinstance(mode, ast.Constant)
                    and isinstance(mode.value, str)
                    and any(m in mode.value for m in _WRITE_MODES)):
                yield node, f"open(..., '{mode.value}')", node.args[0]
        elif name in ("save", "savez", "savez_compressed") and node.args:
            yield node, f"np.{name}()", node.args[0]
        elif name in ("write_text", "write_bytes") and isinstance(
                node.func, ast.Attribute):
            yield node, f".{name}()", node.func.value
        elif name in ("replace", "rename") and len(node.args) >= 2:
            yield node, f"os.{name}()", node.args[1]
        elif name in ("copy", "copy2", "copyfile", "move") and len(
                node.args) >= 2:
            yield node, f"shutil.{name}()", node.args[1]


def _deletes(fn):
    for node in _walk_own_body(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name in ("unlink", "remove") and node.args:
            yield node, f"os.{name}()", node.args[0]


def _reads(fn):
    """(node, path_expr) for filesystem reads in ``fn``."""
    for node in _walk_own_body(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name == "open" and node.args:
            if len(node.args) >= 2:
                mode = node.args[1]
                if (isinstance(mode, ast.Constant)
                        and isinstance(mode.value, str)
                        and any(m in mode.value for m in _WRITE_MODES)):
                    continue
            yield node, node.args[0]
        elif name == "load" and node.args:   # np.load / json.load
            yield node, node.args[0]
        elif name == "read_text" and isinstance(node.func, ast.Attribute):
            yield node, node.func.value
        elif name == "exists" and node.args:
            yield node, node.args[0]


def _atomic_write_targets(fn):
    """path exprs handed to the blessed atomic_write primitive."""
    for node in _walk_own_body(fn):
        if (isinstance(node, ast.Call)
                and _call_name(node.func) == "atomic_write" and node.args):
            yield node, node.args[0]


def _calls(fn, names) -> list:
    out = []
    for node in _walk_own_body(fn):
        if isinstance(node, ast.Call) and _call_name(node.func) in names:
            out.append(node)
    return out


def _has_lock_evidence(fn) -> bool:
    """A FileLock is in play in ``fn``: constructed, acquired, released,
    or held via ``with``.  Conservative — any lock-shaped activity counts
    as the protocol's claim discipline being present."""
    for node in _walk_own_body(fn):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in ("FileLock", "acquire", "release"):
                return True
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if any(isinstance(t, str) and "lock" in t.lower()
                       for t in expr_tokens(item.context_expr)):
                    return True
    # an argument or attribute named *lock* counts: the claim was taken
    # by the caller and handed in (daemon terminal writers)
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.args + args.kwonlyargs + args.posonlyargs):
            if "lock" in a.arg.lower():
                return True
    for node in _walk_own_body(fn):
        if isinstance(node, ast.Attribute) and "lock" in node.attr.lower():
            return True
    return False


# ---- the analyzer -----------------------------------------------------------

def analyze_protocol(mod: Module) -> list:
    """All three protocol checks over one module; returns raw findings
    (the runner drops suppressed ones)."""
    findings = []
    for fn, qual in _functions_with_parents(mod.tree):
        assigns = local_assign_tokens(fn)

        # (1) bypass: raw mutation of a governed path class
        uses_tmp_rename = bool(_calls(fn, ("mkstemp", "mktemp")))
        for node, what, path_expr in _mutations(fn):
            spec = classify(path_tokens(path_expr, assigns))
            if spec is None:
                continue
            if "tmp-rename" in spec.blessed and uses_tmp_rename:
                continue
            findings.append(mod.finding(
                "conc-protocol-bypass", node,
                f"raw {what} targets the '{spec.name}' path class in "
                f"'{qual}' without the blessed primitive "
                f"({' | '.join(spec.blessed)}): a crash mid-write leaves "
                "a torn file other processes act on"))

        # (2) read-modify-write of shared state outside a held FileLock
        read_classes = {classify(path_tokens(e, assigns))
                        for _, e in _reads(fn)}
        mut_classes = {classify(path_tokens(e, assigns))
                       for _, _, e in _mutations(fn)}
        mut_classes |= {classify(path_tokens(e, assigns))
                        for _, _, e in _deletes(fn)}
        mut_classes |= {classify(path_tokens(e, assigns))
                        for _, e in _atomic_write_targets(fn)}
        shared = (read_classes & mut_classes) - {None}
        if shared and not _has_lock_evidence(fn):
            spec = sorted(shared, key=lambda s: s.name)[0]
            findings.append(mod.finding(
                "conc-protocol-rmw", fn,
                f"'{qual}' reads AND mutates the '{spec.name}' path class "
                "with no FileLock in evidence: two processes interleave "
                "into a lost update — claim the class's lock around the "
                "read-modify-write"))

        # (3) tmp write not followed by atomic rename on all paths
        tmp_calls = _calls(fn, ("mkstemp", "mktemp"))
        if tmp_calls:
            has_rename = bool(_calls(fn, ("replace", "rename")))
            has_finally_unlink = any(
                isinstance(sub, ast.Try) and sub.finalbody
                and any(isinstance(c, ast.Call)
                        and _call_name(c.func) in ("unlink", "remove")
                        for s in sub.finalbody for c in ast.walk(s))
                for sub in _walk_own_body(fn))
            for node in tmp_calls:
                if not has_rename:
                    findings.append(mod.finding(
                        "conc-protocol-tmp", node,
                        f"tmp file created in '{qual}' but no "
                        "os.replace/os.rename in the function: the write "
                        "is not atomic — readers can observe the partial "
                        "file or never see the final one"))
                elif not has_finally_unlink:
                    findings.append(mod.finding(
                        "conc-protocol-tmp", node,
                        f"tmp file created in '{qual}' with no "
                        "finally-unlink: an exception between mkstemp and "
                        "os.replace strands the tmp file on every error "
                        "path"))
    return findings


def protocol_report() -> list:
    """The registry as JSON-able rows (the report's ``protocols`` key and
    the chaos-coverage test's input)."""
    return [{"name": s.name, "markers": list(s.markers),
             "blessed": list(s.blessed), "fault_site": s.fault_site,
             "chaos_rationale": s.chaos_rationale, "doc": s.doc}
            for s in PROTOCOLS]
