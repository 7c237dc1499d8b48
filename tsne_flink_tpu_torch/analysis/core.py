"""graftlint core of the port: file loading, suppressions, the rule
registry and the runner (port of ``tsne_flink_tpu/analysis/core.py``,
the same grammar and the same ledger).

Pure stdlib (``ast`` + ``tokenize``): the lint and conc tiers run from a
bare source tree and import no ``torch``.

Vocabulary:

* a **Module** is one parsed ``.py`` file: source, AST, and the suppression
  comments collected from its token stream;
* a **Project** is the set of modules one invocation scans, with the
  cross-module lookups rules need (resolve an imported function, find the
  module of a registry);
* a **rule** is a registered function ``rule(project) -> list[Finding]``;
  findings land at a precise ``(path, line, col)`` so suppressions can be
  matched back to them.

Suppression syntax (the JAX package's, read the same way):

* ``# graftlint: disable=<rule>[,<rule>...]`` — trailing on the offending
  line, or on a standalone comment line directly above it;
* ``# graftlint: disable-file=<rule>`` — anywhere in the file, silences the
  rule for the whole file;
* everything after ``--`` in the comment is a free-form rationale (the
  convention is to always give one).
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass

SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable(?P<whole_file>-file)?="
    r"(?P<rules>[A-Za-z0-9_,-]+)")

#: wildcard accepted in a disable comment: silences every rule
ALL_RULES = "all"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


class Module:
    """One parsed source file plus its suppression map."""

    def __init__(self, path: str, display: str):
        self.path = path
        self.display = display
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.tree = ast.parse(self.source, filename=display)
        self.lines = self.source.splitlines()
        # line -> set of rule names disabled on that line
        self.line_disable: dict[int, set[str]] = {}
        self.file_disable: set[str] = set()
        self._collect_suppressions()

    def _collect_suppressions(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            if m.group("whole_file"):
                self.file_disable |= rules
                continue
            line = tok.start[0]
            self.line_disable.setdefault(line, set()).update(rules)
            before = self.lines[line - 1][:tok.start[1]]
            if not before.strip():
                # standalone comment: covers the next CODE line, skipping
                # the rest of its own comment block (a multi-line rationale
                # is the convention, not the exception)
                nxt = line + 1
                while nxt <= len(self.lines):
                    stripped = self.lines[nxt - 1].strip()
                    if stripped and not stripped.startswith("#"):
                        break
                    nxt += 1
                self.line_disable.setdefault(nxt, set()).update(rules)

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disable or ALL_RULES in self.file_disable:
            return True
        disabled = self.line_disable.get(line, ())
        return rule in disabled or ALL_RULES in disabled

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.display,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


class Project:
    """All modules of one analyzer invocation."""

    def __init__(self, modules: list[Module]):
        self.modules = modules
        # dotted-ish name (path with / -> . and .py stripped) -> Module,
        # for resolving `from tsne_flink_tpu_torch.x.y import f` to a
        # scanned file
        self.by_dotted: dict[str, Module] = {}
        for mod in modules:
            dotted = mod.display.replace(os.sep, "/")
            dotted = dotted[:-3] if dotted.endswith(".py") else dotted
            self.by_dotted[dotted.replace("/", ".")] = mod

    def module_with_suffix(self, suffix: str) -> Module | None:
        """The scanned module whose display path ends with ``suffix``
        (e.g. ``"kernels/build.py"``)."""
        norm = suffix.replace("/", os.sep)
        for mod in self.modules:
            if mod.display.endswith(suffix) or mod.display.endswith(norm):
                return mod
        return None

    def resolve_function(self, module: Module,
                         name: str) -> ast.FunctionDef | None:
        """Best-effort resolution of ``name`` to a FunctionDef: the module's
        own top-level defs first, then one hop through its
        ``from X import name`` statements into other scanned modules."""
        for node in module.tree.body:
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return node
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ImportFrom) or node.module is None:
                continue
            for alias in node.names:
                if (alias.asname or alias.name) != name:
                    continue
                target = self._module_for(node.module)
                if target is None:
                    continue
                for sub in target.tree.body:
                    if (isinstance(sub, ast.FunctionDef)
                            and sub.name == alias.name):
                        return sub
        return None

    def _module_for(self, dotted: str) -> Module | None:
        for known, mod in self.by_dotted.items():
            if known == dotted or known.endswith("." + dotted):
                return mod
        return None


# ---- rule registry ---------------------------------------------------------

RULES: dict = {}


def rule(name: str, doc: str):
    """Register ``fn(project) -> list[Finding]`` as a named rule."""

    def deco(fn):
        fn.rule_name = name
        fn.rule_doc = doc
        RULES[name] = fn
        return fn

    return deco


# ---- runner ----------------------------------------------------------------

def iter_py_files(paths) -> list[str]:
    """Expand files/directories into a sorted list of ``.py`` files."""
    out = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(dirpath, f) for f in filenames
                           if f.endswith(".py"))
        elif path.endswith(".py"):
            out.append(path)
    return sorted(set(out))


def load_project(paths, root: str | None = None) -> Project:
    root = root or os.getcwd()
    modules = []
    for path in iter_py_files(paths):
        display = os.path.relpath(path, root)
        if display.startswith(".."):
            display = path
        modules.append(Module(path, display))
    return Project(modules)


def _blessed_comms_rows(display: str, source: str) -> list[dict]:
    """Ledger rows for the comms-audit attestation registry: each
    ``BLESSED_COMMS`` entry (audit/comms.py) is a reviewed exception to
    'no collectives' exactly like a disable comment, so it rides the same
    ledger and the same pinned count.  Scanned with stdlib ``ast`` — core
    must NOT import the audit subpackage (that path imports torch, and
    comms imports core for Finding)."""
    import ast

    rows: list[dict] = []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return rows
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if "BLESSED_COMMS" not in targets:
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        for key, val in zip(node.value.keys, node.value.values):
            try:
                func, file_suffix = ast.literal_eval(key)
                rationale = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                continue
            rows.append({
                "path": display, "line": key.lineno,
                "rules": ["comms-audit"],
                "scope": f"site:{func} ({file_suffix})",
                "rationale": str(rationale),
            })
    return rows


def collect_suppressions(paths, root: str | None = None) -> list[dict]:
    """The suppression ledger: every ``graftlint: disable`` comment under
    ``paths`` with its rules, scope and rationale (the text after ``--``,
    plus any continuation comment lines below a standalone disable), plus
    the comms-audit ``BLESSED_COMMS`` attestations (same review bar).
    ``python -m tsne_flink_tpu_torch.analysis --suppressions`` renders
    this; the tests pin the count so a new suppression is a deliberate
    diff."""
    root = root or os.getcwd()
    rows: list[dict] = []
    for path in iter_py_files(paths):
        display = os.path.relpath(path, root)
        if display.startswith(".."):
            display = path
        with open(path, encoding="utf-8") as f:
            source = f.read()
        lines = source.splitlines()
        if path.replace(os.sep, "/").endswith("analysis/audit/comms.py"):
            rows.extend(_blessed_comms_rows(display, source))
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(source).readline))
        except tokenize.TokenError:
            continue
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rationale = ""
            rest = tok.string[m.end():]
            if "--" in rest:
                rationale = rest.split("--", 1)[1].strip()
            standalone = not lines[tok.start[0] - 1][:tok.start[1]].strip()
            if standalone:
                # a multi-line rationale continues on the comment lines
                # directly below (the repo convention)
                nxt = tok.start[0] + 1
                while nxt <= len(lines):
                    stripped = lines[nxt - 1].strip()
                    if (not stripped.startswith("#")
                            or SUPPRESS_RE.search(stripped)):
                        break
                    rationale = (rationale + " "
                                 + stripped.lstrip("#").strip()).strip()
                    nxt += 1
            rows.append({
                "path": display, "line": tok.start[0],
                "rules": sorted(r.strip()
                                for r in m.group("rules").split(",")
                                if r.strip()),
                "scope": "file" if m.group("whole_file") else "line",
                "rationale": rationale,
            })
    rows.sort(key=lambda r: (r["path"], r["line"]))
    return rows


def run(paths, root: str | None = None,
        rules: list[str] | None = None) -> tuple[list[Finding], int]:
    """Run (selected) rules over ``paths``; returns (findings, n_files).
    Suppressed findings are dropped here, so rules stay suppression-blind."""
    # rules are registered on import; keep this import local so core stays
    # importable by rules.py without a cycle
    from tsne_flink_tpu_torch.analysis import rules as _rules  # noqa: F401

    project = load_project(paths, root)
    by_display = {m.display: m for m in project.modules}
    selected = rules or list(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise SystemExit(f"unknown rule(s) {unknown}; known: "
                         f"{sorted(RULES)}")
    findings: list[Finding] = []
    for name in selected:
        for f in RULES[name](project):
            mod = by_display.get(f.path)
            if mod is not None and mod.is_suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, len(project.modules)


def render_human(findings: list[Finding], n_files: int) -> str:
    lines = [f.format() for f in findings]
    lines.append(f"graftlint: {len(findings)} finding(s) in {n_files} "
                 "file(s)")
    return "\n".join(lines)


def render_json(findings: list[Finding], n_files: int) -> str:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return json.dumps({"findings": [f.as_dict() for f in findings],
                       "counts": counts, "files_scanned": n_files,
                       "ok": not findings}, indent=2)
