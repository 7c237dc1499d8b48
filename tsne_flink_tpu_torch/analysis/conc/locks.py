"""conc-lock — the per-function FileLock acquire/release discipline.

Three checks over the cross-module lock graph:

* ``conc-lock-release`` — a bare ``lock.acquire(...)`` with no guaranteed
  release: not a ``with`` statement, no ``try/finally`` releasing in the
  same function, and the lock does not ESCAPE the function (returned,
  stored on an object/collection, or passed to a constructor — the
  spool claim hand-off, where the release responsibility transfers to
  the caller by protocol).
* ``conc-lock-order`` — inconsistent cross-module lock ordering: when
  function A nests class-X inside class-Y and function B nests class-Y
  inside class-X, the wait-for graph has a cycle and two processes can
  deadlock statically.  Lock classes are derived from the path
  expression each FileLock is built over (spool-request, swap-control,
  artifact-cache, kernel-library, else per-module generic).
* ``conc-lock-blocking`` — a blocking call (device compute, model load,
  ``sleep``) made while a lock is lexically held.  The spool protocol
  deliberately holds claim locks across compute (the crash-recovery
  story), but those spans are non-lexical hand-offs; a LEXICAL hold
  around a blocking call serializes every other claimant behind device
  work.  Declared sites suppress with the graftlint grammar and a
  rationale (``# graftlint: disable=conc-lock-blocking -- why``).

Held spans are lexical: the body of ``with <lock>``, or the statements
between ``x.acquire(...)`` and ``x.release()`` (end of function when no
release is in scope).
"""

from __future__ import annotations

import ast

from tsne_flink_tpu_torch.analysis.core import Module
from tsne_flink_tpu_torch.analysis.rules import (
    _functions_with_parents, _walk_own_body)
from tsne_flink_tpu_torch.analysis.conc.protocol import (
    expr_tokens, local_assign_tokens, path_tokens)

#: calls that park the caller on something slow while a lock is held:
#: raw sleeps, device materialization, compiles, and model/input loads
BLOCKING_CALLS = ("sleep", "block_until_ready", "device_get", "synchronize",
                  "dispatch_bucket", "warm_stages", "transform",
                  "frozen_from_files", "supervised_embed", "tsne_embed")

#: path-token fragment -> lock class (ordering graph nodes)
_CLASS_MARKERS = (
    ("req", "spool-request"),
    ("swap", "swap-control"),
    ("artifact", "artifact-cache"),
    ("build", "kernel-library"),
    ("ckpt", "checkpoint"),
)


def _call_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def lock_class(tokens, mod: Module) -> str:
    for fragment, cls in _CLASS_MARKERS:
        if any(isinstance(t, str) and fragment in t.lower()
               for t in tokens):
            return cls
    return f"generic:{mod.display}"


def _receiver_name(func) -> str | None:
    """``x`` of ``x.acquire()`` / ``a.b.acquire()`` (dotted joined)."""
    parts = []
    node = func.value if isinstance(func, ast.Attribute) else None
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts)) if parts else None


class _FnLocks:
    """Lock activity of one function: acquisitions with their spans."""

    def __init__(self, mod: Module, fn, qual: str):
        self.mod = mod
        self.fn = fn
        self.qual = qual
        self.assigns = local_assign_tokens(fn)
        # names assigned from FileLock(...) -> constructor path tokens
        self.lock_vars: dict = {}
        for node in _walk_own_body(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _call_name(node.value.func) == "FileLock"):
                toks = set()
                for a in node.value.args:
                    toks |= path_tokens(a, self.assigns)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.lock_vars[tgt.id] = toks
        # (cls, start_line, end_line, acquire_node, via_with)
        self.spans: list = []
        self._collect_spans()

    def _is_lock_expr(self, expr) -> tuple | None:
        """(class, tokens) when ``expr`` denotes a FileLock."""
        if (isinstance(expr, ast.Call)
                and _call_name(expr.func) == "FileLock"):
            toks = set()
            for a in expr.args:
                toks |= path_tokens(a, self.assigns)
            return lock_class(toks, self.mod), toks
        if isinstance(expr, ast.Name) and expr.id in self.lock_vars:
            toks = self.lock_vars[expr.id]
            return lock_class(toks, self.mod), toks
        toks = expr_tokens(expr)
        if any(isinstance(t, str) and "lock" in t.lower() for t in toks):
            return lock_class(path_tokens(expr, self.assigns),
                              self.mod), toks
        return None

    def _collect_spans(self) -> None:
        fn_end = max((getattr(n, "end_lineno", n.lineno)
                      for n in ast.walk(self.fn)
                      if hasattr(n, "lineno")), default=self.fn.lineno)
        for node in _walk_own_body(self.fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    got = self._is_lock_expr(item.context_expr)
                    if got is not None:
                        self.spans.append(
                            (got[0], node.lineno,
                             getattr(node, "end_lineno", fn_end),
                             item.context_expr, True))
            elif (isinstance(node, ast.Call)
                  and _call_name(node.func) == "acquire"):
                recv = _receiver_name(node.func)
                toks = (self.lock_vars.get(recv, {recv or "lock"})
                        if recv else {"lock"})
                # the span runs to this receiver's release() or fn end
                end = fn_end
                for other in _walk_own_body(self.fn):
                    if (isinstance(other, ast.Call)
                            and _call_name(other.func) == "release"
                            and _receiver_name(other.func) == recv
                            and other.lineno > node.lineno):
                        end = min(end, other.lineno)
                self.spans.append(
                    (lock_class(set(toks), self.mod), node.lineno, end,
                     node, False))

    def acquire_guaranteed_release(self, node) -> bool:
        """A bare acquire is fine when the function owns a try/finally
        that releases, or the lock escapes (hand-off)."""
        for sub in _walk_own_body(self.fn):
            if isinstance(sub, ast.Try) and sub.finalbody:
                for s in sub.finalbody:
                    for c in ast.walk(s):
                        if (isinstance(c, ast.Call)
                                and _call_name(c.func) in ("release",
                                                           "abandon")):
                            return True
        recv = _receiver_name(node.func)
        base = recv.split(".")[0] if recv else None
        for sub in _walk_own_body(self.fn):
            if isinstance(sub, ast.Return) and sub.value is not None:
                if base and base in expr_tokens(sub.value):
                    return True
                if base is None and isinstance(sub.value, ast.Name):
                    return True
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    if (isinstance(tgt, (ast.Subscript, ast.Attribute))
                            and base
                            and base in expr_tokens(sub.value)):
                        return True
            if isinstance(sub, ast.Call) and base:
                callee = _call_name(sub.func)
                if callee in ("acquire", "release"):
                    continue
                for a in list(sub.args) + [kw.value for kw in
                                           sub.keywords]:
                    if base in expr_tokens(a):
                        return True
        return False


def analyze_locks(modules) -> tuple:
    """(findings, report) over all scanned modules."""
    findings = []
    edges: dict = {}   # (outer_cls, inner_cls) -> (mod, node)
    n_sites = 0
    for mod in modules:
        for fn, qual in _functions_with_parents(mod.tree):
            info = _FnLocks(mod, fn, qual)
            n_sites += len(info.spans)

            # (1) acquire without guaranteed release
            for cls, start, end, node, via_with in info.spans:
                if via_with or not isinstance(node, ast.Call):
                    continue
                if not info.acquire_guaranteed_release(node):
                    findings.append(mod.finding(
                        "conc-lock-release", node,
                        f"'{qual}' acquires a {cls} lock outside `with` "
                        "with no try/finally release and no hand-off "
                        "(return/store/pass): an exception here wedges "
                        "the lock until the stale-break timeout"))

            # (2) nesting edges for the ordering graph
            for cls_a, s_a, e_a, node_a, _ in info.spans:
                for cls_b, s_b, e_b, node_b, _ in info.spans:
                    if node_a is node_b:
                        continue
                    if s_a < s_b and e_b <= e_a and cls_a != cls_b:
                        edges.setdefault((cls_a, cls_b), (mod, node_b,
                                                          qual))

            # (3) blocking calls under a lexically held lock
            for cls, start, end, _node, _w in info.spans:
                for sub in _walk_own_body(fn):
                    if not isinstance(sub, ast.Call):
                        continue
                    name = _call_name(sub.func)
                    if (name in BLOCKING_CALLS
                            and start < sub.lineno <= end):
                        findings.append(mod.finding(
                            "conc-lock-blocking", sub,
                            f"blocking call {name}() while '{qual}' "
                            f"lexically holds a {cls} lock: every other "
                            "claimant serializes behind this work — "
                            "move it outside the held span, or declare "
                            "the site with a rationale "
                            "(# graftlint: disable=conc-lock-blocking "
                            "-- why)"))

    # cycle detection over the ordering digraph
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    def reachable(src, dst) -> bool:
        seen, stack = set(), [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(graph.get(cur, ()))
        return False

    cycles = []
    for (a, b), (mod, node, qual) in sorted(
            edges.items(), key=lambda kv: (kv[0][0], kv[0][1])):
        if reachable(b, a):
            cycles.append((a, b))
            findings.append(mod.finding(
                "conc-lock-order", node,
                f"lock-order cycle: '{qual}' takes {b} while holding "
                f"{a}, but another function takes {a} while holding {b} "
                "— two processes can deadlock; pick one global order"))
    report = {"lock_sites": n_sites,
              "order_edges": sorted(f"{a}->{b}" for a, b in edges),
              "order_cycles": sorted(f"{a}<->{b}" for a, b in cycles)}
    return findings, report
