"""conc-tick — static checks over the graftsched claim/dispatch tick.

The daemon's request lifecycle is a state machine::

    <id>.req.npz --claim(lock)--> bind model_id --pack--> dispatch
        --materialize--> <id>.res.npz | <id>.err.json  (exactly one)

This checker recognizes *daemon-like modules* — any scanned module that
declares both ``REQ_SUFFIX`` and ``RES_SUFFIX`` string constants (the
real daemon and the seeded fixtures alike) — and verifies the
state-machine shape statically:

* ``conc-tick-terminal`` — every claimed request must reach EXACTLY one
  terminal file: a single function writing both the result and the
  error terminal can emit two; a module with a claim site but no error
  terminal leaves failed requests claimed forever.
* ``conc-tick-protocol`` — a terminal writer must delete the request
  file and release the claim lock, and the terminal must land
  (atomically) BEFORE the request is deleted — deleting first opens the
  window where a crash loses the request without a terminal.  A call to
  a helper of the same module (``self._terminal(...)``) counts as the
  delete / release its own body does, one level deep.
* ``conc-tick-binding`` — the zero-stale hot-swap invariant: the model
  is bound where the request is CLAIMED.  The claiming function must
  reference the binding (``model_id``/``mid``/``active_id``), and a
  dispatch-side function that never claims must not read
  ``self.active_id`` (reading it at dispatch time races the hot-swap).
* ``conc-tick-buffer`` — the double-buffer discipline: a result write
  in a dispatching function must come AFTER the dispatch and only via a
  materialized handle (``np.asarray``/``block_until_ready``); the
  dispatch handle must be kept (assigned), not dropped on the floor.

Lexical like the rest of graftrace: functions are classified by the
suffix constants their path expressions mention, with one level of
local-assignment resolution.
"""

from __future__ import annotations

import ast

from tsne_flink_tpu_torch.analysis.core import Module
from tsne_flink_tpu_torch.analysis.rules import (
    _functions_with_parents, _walk_own_body)
from tsne_flink_tpu_torch.analysis.conc.protocol import (
    _call_name, _atomic_write_targets, local_assign_tokens, path_tokens)

#: tokens that tie a function to the model-binding decision
BINDING_TOKENS = ("model_id", "mid", "active_id", "bound", "model")

#: calls that force an async device handle to a host array
MATERIALIZE_CALLS = ("asarray", "array", "block_until_ready",
                     "device_get", "copy_to_host_async", "cpu", "numpy",
                     "synchronize")

#: the device-dispatch entry point of the serve tick
DISPATCH_CALLS = ("dispatch_bucket",)


def _token_has(tokens, const_name: str, fragment: str) -> bool:
    return any(isinstance(t, str) and (t == const_name or fragment in t)
               for t in tokens)


def is_daemon_like(mod: Module) -> bool:
    """Module declares both REQ_SUFFIX and RES_SUFFIX string constants."""
    seen = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Name)
                        and tgt.id in ("REQ_SUFFIX", "RES_SUFFIX")
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    seen.add(tgt.id)
    return seen == {"REQ_SUFFIX", "RES_SUFFIX"}


class _FnRole:
    """The tick-state-machine role(s) one function plays."""

    def __init__(self, fn, qual: str, helpers: dict | None = None):
        self.fn = fn
        self.qual = qual
        #: the module's functions by name, for one level of helper calls
        self.helpers = helpers or {}
        self.name = fn.name
        self.assigns = local_assign_tokens(fn)
        self.res_writes: list = []   # atomic_write nodes hitting RES/LAT
        self.err_writes: list = []   # atomic_write nodes hitting ERR
        self.claim_nodes: list = []  # .acquire on a req-marked lock
        self.req_deletes: list = []  # unlink/remove of a req-marked path
        self.releases: list = []
        self.dispatches: list = []
        self.materializes: list = []
        self._scan()

    def _scan(self) -> None:
        for node, expr in _atomic_write_targets(self.fn):
            toks = path_tokens(expr, self.assigns)
            if _token_has(toks, "RES_SUFFIX", ".res."):
                self.res_writes.append(node)
            if _token_has(toks, "ERR_SUFFIX", ".err."):
                self.err_writes.append(node)
        for node in _walk_own_body(self.fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node.func)
            if name == "acquire":
                recv = (node.func.value.id
                        if isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        else None)
                toks = self.assigns.get(recv, {recv}) if recv else set()
                if any(isinstance(t, str) and "req" in t.lower()
                       for t in toks):
                    self.claim_nodes.append(node)
            elif name in ("unlink", "remove") and node.args:
                toks = path_tokens(node.args[0], self.assigns)
                # "req" as a name fragment covers REQ_SUFFIX, req_path
                # (the parameter spelling) and ".req.npz" literals alike
                if any(isinstance(t, str) and "req" in t.lower()
                       for t in toks):
                    self.req_deletes.append(node)
            elif name == "release":
                self.releases.append(node)
            elif name in self.helpers and self.helpers[name] is not self.fn:
                deletes, releases = _helper_effects(self.helpers[name])
                if deletes:
                    self.req_deletes.append(node)
                if releases:
                    self.releases.append(node)
            elif name in DISPATCH_CALLS:
                self.dispatches.append(node)
            elif name in MATERIALIZE_CALLS:
                self.materializes.append(node)

    @property
    def terminal(self) -> bool:
        return bool(self.res_writes or self.err_writes)

    def references(self, tokens) -> bool:
        for node in _walk_own_body(self.fn):
            if isinstance(node, ast.Name) and node.id in tokens:
                return True
            if isinstance(node, ast.Attribute) and node.attr in tokens:
                return True
        return False

    def reads_active_id(self) -> bool:
        return any(isinstance(n, ast.Attribute) and n.attr == "active_id"
                   for n in _walk_own_body(self.fn))

    def has_finally_release(self) -> bool:
        for sub in _walk_own_body(self.fn):
            if isinstance(sub, ast.Try) and sub.finalbody:
                for s in sub.finalbody:
                    for c in ast.walk(s):
                        if (isinstance(c, ast.Call) and _call_name(c.func)
                                in ("release", "abandon")):
                            return True
        return False

    def stores_claims(self) -> bool:
        """Claims survive the function: stored into a registry dict /
        list / batcher instead of being released inline."""
        for sub in _walk_own_body(self.fn):
            if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Subscript) for t in sub.targets):
                return True
            if (isinstance(sub, ast.Call)
                    and _call_name(sub.func) in ("add", "append")
                    and sub.args):
                return True
        return False


def _helper_effects(fn) -> tuple:
    """(deletes the request, releases a lock) of a helper's own body."""
    assigns = local_assign_tokens(fn)
    deletes = releases = False
    for node in _walk_own_body(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name in ("unlink", "remove") and node.args:
            toks = path_tokens(node.args[0], assigns)
            deletes = deletes or any(isinstance(t, str)
                                     and "req" in t.lower() for t in toks)
        elif name == "release":
            releases = True
    return deletes, releases


def analyze_statemachine(mod: Module) -> tuple:
    """(findings, summary) for one daemon-like module."""
    findings: list = []
    helpers = {fn.name: fn for fn, _ in _functions_with_parents(mod.tree)}
    roles = [_FnRole(fn, qual, helpers)
             for fn, qual in _functions_with_parents(mod.tree)]
    claim_fn_names = {r.name for r in roles if r.claim_nodes}
    res_writer_names = {r.name for r in roles if r.res_writes}

    for r in roles:
        # t1a: one function, two terminals -> a request can get both
        if r.res_writes and r.err_writes:
            findings.append(mod.finding(
                "conc-tick-terminal", r.fn,
                f"'{r.qual}' writes BOTH the result and the error "
                "terminal: a request must reach exactly one terminal "
                "file — split the success and refusal paths"))

        # t2: terminal writers must delete the request AFTER the
        # terminal lands, and release the claim lock
        if r.terminal:
            first_write = min(n.lineno
                              for n in r.res_writes + r.err_writes)
            if not r.req_deletes:
                findings.append(mod.finding(
                    "conc-tick-protocol", r.fn,
                    f"terminal writer '{r.qual}' never deletes the "
                    "request file: the next daemon re-claims and "
                    "re-serves a finished request"))
            elif min(n.lineno for n in r.req_deletes) < first_write:
                findings.append(mod.finding(
                    "conc-tick-protocol", r.req_deletes[0],
                    f"'{r.qual}' deletes the request BEFORE its terminal "
                    "file lands: a crash in between loses the request "
                    "without any terminal — write the terminal first"))
            if not r.releases:
                findings.append(mod.finding(
                    "conc-tick-protocol", r.fn,
                    f"terminal writer '{r.qual}' never releases the "
                    "claim lock: the slot stays wedged until the "
                    "stale-break timeout"))

        # t3: model binding happens at claim
        if r.claim_nodes and not r.references(BINDING_TOKENS):
            findings.append(mod.finding(
                "conc-tick-binding", r.claim_nodes[0],
                f"'{r.qual}' claims a request without binding a model "
                "(no model_id/active_id in scope): binding later races "
                "the hot-swap and serves the wrong model"))

        # t4: claim consumers must keep or release every claim
        calls_claim = any(_call_name(n.func) in claim_fn_names
                          for n in _walk_own_body(r.fn)
                          if isinstance(n, ast.Call))
        if (calls_claim and not r.has_finally_release()
                and not r.stores_claims()):
            findings.append(mod.finding(
                "conc-tick-protocol", r.fn,
                f"'{r.qual}' obtains claims but neither stores them nor "
                "releases them in a finally: an exception mid-drain "
                "wedges every unserved claim"))

        # t5: dispatch-side functions must not re-read the active model
        if (r.dispatches and not r.claim_nodes and not calls_claim
                and r.reads_active_id()):
            findings.append(mod.finding(
                "conc-tick-binding", r.dispatches[0],
                f"'{r.qual}' reads self.active_id at dispatch time: the "
                "model was bound at claim — a hot-swap between claim and "
                "dispatch serves rows with the wrong model"))

        # t6: the double-buffer discipline around dispatch
        for d in r.dispatches:
            kept = any(isinstance(sub, ast.Assign)
                       and any(c is d for c in ast.walk(sub.value))
                       for sub in _walk_own_body(r.fn))
            if not kept:
                findings.append(mod.finding(
                    "conc-tick-buffer", d,
                    f"'{r.qual}' drops the dispatch handle: the async "
                    "device result is unreachable, so the request can "
                    "never be materialized and finished"))
        if r.dispatches:
            first_dispatch = min(n.lineno for n in r.dispatches)
            for sub in _walk_own_body(r.fn):
                if (isinstance(sub, ast.Call)
                        and _call_name(sub.func) in res_writer_names
                        and sub.lineno < first_dispatch):
                    findings.append(mod.finding(
                        "conc-tick-buffer", sub,
                        f"'{r.qual}' writes a result terminal BEFORE "
                        "dispatching its compute: the depth-2 window "
                        "would publish a result whose batch never ran"))
        # a function that finishes results off a device handle must
        # materialize first — asarray/block_until_ready precedes the
        # terminal call
        finish_calls = [n for n in _walk_own_body(r.fn)
                        if isinstance(n, ast.Call)
                        and _call_name(n.func) in res_writer_names]
        if finish_calls and r.references(("handle",)):
            first_finish = min(n.lineno for n in finish_calls)
            mat_before = any(m.lineno <= first_finish
                             for m in r.materializes)
            if not mat_before:
                findings.append(mod.finding(
                    "conc-tick-buffer", finish_calls[0],
                    f"'{r.qual}' finishes a request straight off the "
                    "dispatch handle without materializing it "
                    "(np.asarray/block_until_ready): the result write "
                    "races the async compute"))

    # t1b: a claim site with no error terminal anywhere in the module
    if claim_fn_names and not any(r.err_writes for r in roles):
        claimer = next(r for r in roles if r.claim_nodes)
        findings.append(mod.finding(
            "conc-tick-terminal", claimer.fn,
            f"module claims requests ('{claimer.qual}') but defines no "
            "error terminal: a failing request never reaches a terminal "
            "file and stays claimed forever"))

    summary = {
        "module": mod.display,
        "claim_fns": sorted(r.qual for r in roles if r.claim_nodes),
        "res_terminals": sorted(r.qual for r in roles if r.res_writes),
        "err_terminals": sorted(r.qual for r in roles if r.err_writes),
        "dispatch_fns": sorted(r.qual for r in roles if r.dispatches),
    }
    return findings, summary
