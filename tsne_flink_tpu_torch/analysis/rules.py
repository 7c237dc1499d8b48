"""graftlint rules of the port (port of ``tsne_flink_tpu/analysis/rules.py``).

The JAX package's thirteen rules, each either ported or declared not
applicable (ROADMAP §A16 names the reasons):

* ported as they are — ``cli-api-parity``, ``exception-hygiene``,
  ``resource-hygiene``, ``timing-hygiene``, ``policy-recorded``: the same
  checks, the same findings on the JAX package's fixtures
  (``tests/lint_fixtures/``);
* ported in the port's idiom —

  - ``env-registry``: no ``os.environ`` / ``os.getenv`` read of a
    ``TSNE_*`` name (or of a key the rule cannot read) anywhere in the
    port, whose registry is empty;
  - ``host-sync``: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``.numpy()`` / ``torch.cuda.synchronize`` and ``float()`` /
    ``int()`` / ``bool()`` of a tensor (:func:`_tensor_valued`; never of
    a Python scalar) in ``ops/`` and in ``models/tsne.py``'s step and loop
    functions, and a call there to a helper outside that scope whose own
    body reads the device (one level);
  - ``dtype-drift``: ``torch.float64``, ``.double()`` and a dtype-less
    ``torch.tensor`` of float literals in ``ops/``, and ``torch.bfloat16``
    or ``.bfloat16()`` there outside ``ops/metrics.py``, the operand
    policy whose ``matmul_operands`` is the one blessed bf16 cast;
  - ``mesh-hygiene``: ``torch.distributed`` calls and ``MeshAxis`` /
    ``ProcessAxis`` construction outside ``parallel/``;
  - ``audit-contract``: every function of ``ops/`` that launches a kernel
    counted in ``kernels/build.KERNELS``, and every ``ops/`` function the
    main path (``models/tsne.py``, ``utils/artifacts.py``) calls, declares
    a contract in ``analysis/audit/contracts.py``;
* not applicable — ``jit-hygiene`` and ``carry-hygiene`` (the port has no
  ``jit``, no ``fori_loop`` / ``scan``) and ``bench-record-contract`` (the
  port emits no bench record).

Rules are pure-AST project passes registered with :func:`core.rule`; they
never import the code under analysis, and this module imports no torch.
"""

from __future__ import annotations

import ast
import os
import re

from tsne_flink_tpu_torch.analysis.core import Finding, Module, Project, rule

ENV_NAME_RE = re.compile(r"TSNE_[A-Z0-9_]+\Z")
ENV_PREFIX = "TSNE_"

#: the JAX rules the port declares not applicable, with the reason
NOT_APPLICABLE = {
    "jit-hygiene": "the port has no jit: eager PyTorch and hand-written "
                   "kernels, no traced control arguments, no donation",
    "carry-hygiene": "the port has no fori_loop/scan: optimize is a Python "
                     "loop whose state is rebound each iteration",
    "bench-record-contract": "the port emits no bench record (no "
                             "RECORD_BASE_KEYS, no _emit site)",
}


# ---- shared AST helpers ----------------------------------------------------

def _import_aliases(tree: ast.AST, module_name: str) -> set[str]:
    """Local names bound to ``module_name`` by any import in the file
    (``import os``, ``import os as _os``, nested function imports too)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module_name:
                    names.add(alias.asname or module_name)
    return names


def _from_import_aliases(tree: ast.AST, func_name: str) -> set[str]:
    """Local names bound to ``func_name`` via ``from X import func_name``."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == func_name:
                    names.add(alias.asname or func_name)
    return names


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_name_in(node, names: set[str]) -> bool:
    return isinstance(node, ast.Name) and node.id in names


def _literal(node):
    """ast.literal_eval that returns a sentinel instead of raising."""
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return _literal  # unmistakable sentinel


def _functions_with_parents(tree: ast.AST):
    """Yield (funcdef, qualname) for every def/lambda-free function."""
    stack = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield child, qual
                stack.append((child, qual + "."))
            else:
                stack.append((child, prefix))


def _walk_own_body(fn: ast.FunctionDef):
    """Walk ``fn`` without descending into nested defs (those are visited
    under their own qualname by :func:`_functions_with_parents`)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(ast.iter_child_nodes(node))


def _norm(mod: Module) -> str:
    return mod.display.replace(os.sep, "/")


def _in_dir(norm: str, d: str) -> bool:
    return f"/{d}/" in norm or norm.startswith(f"{d}/")


def _in_package(norm: str) -> bool:
    """The port's package scope (scripts and tests compose freely); the
    JAX package's own spelling too, so the JAX fixtures keep their
    findings."""
    return ("tsne_flink_tpu_torch/" in norm or "tsne_flink_tpu/" in norm
            or norm.startswith("tsne_flink_tpu"))


def _torch_aliases(tree: ast.AST) -> set[str]:
    return _import_aliases(tree, "torch") | {"torch"}


def _attr_root(node) -> str | None:
    """``a`` of ``a.b.c`` (None for a non-name root)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node) -> str | None:
    """``a.b.c`` of an attribute chain over a name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# ---- rule: env-registry ----------------------------------------------------

def _environ_read_key(node: ast.Call | ast.Subscript, os_names: set[str]):
    """The key expression of a raw environment READ, or None.

    Reads: ``os.environ.get(k)``, ``os.environ.setdefault(k, v)``,
    ``os.environ.pop(k)``, ``os.getenv(k)``, ``os.environ[k]`` in load
    context.  Writes (``os.environ[k] = v``) are allowed, and so is
    copying the whole environment (``dict(os.environ)``) for a child."""
    if isinstance(node, ast.Call):
        func = node.func
        if not isinstance(func, ast.Attribute):
            return None
        if (func.attr in ("get", "setdefault", "pop")
                and isinstance(func.value, ast.Attribute)
                and func.value.attr == "environ"
                and _is_name_in(func.value.value, os_names) and node.args):
            return node.args[0]
        if (func.attr == "getenv" and _is_name_in(func.value, os_names)
                and node.args):
            return node.args[0]
        return None
    if isinstance(node, ast.Subscript):
        if (isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "environ"
                and _is_name_in(node.value.value, os_names)):
            return node.slice
    return None


@rule("env-registry",
      "no TSNE_* environment read anywhere in the port (its registry is "
      "empty): configuration is flags and keyword arguments")
def env_registry(project: Project):
    findings = []
    for mod in project.modules:
        os_names = _import_aliases(mod.tree, "os")
        read_keys: set[int] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Call, ast.Subscript)):
                continue
            key = _environ_read_key(node, os_names)
            if key is None:
                continue
            lit = _const_str(key)
            if lit is None:
                findings.append(mod.finding(
                    "env-registry", node,
                    "raw environment read with a non-literal key — the "
                    "rule cannot verify it is not a TSNE_* knob; pass the "
                    "value as an argument, or suppress with the rationale"))
            elif lit.startswith(ENV_PREFIX):
                read_keys.add(id(key))
                findings.append(mod.finding(
                    "env-registry", node,
                    f"environment read of {lit}: the port reads no TSNE_* "
                    "variable — make it a flag / keyword argument"))
        for node in ast.walk(mod.tree):
            name = _const_str(node)
            if (name is not None and ENV_NAME_RE.fullmatch(name)
                    and id(node) not in read_keys):
                findings.append(mod.finding(
                    "env-registry", node,
                    f"environment variable name {name}: the port's registry "
                    "is empty, so nothing may name a TSNE_* knob"))
    return findings


def env_table_markdown() -> str:
    """The port's environment registry as the JAX package's markdown
    table: a header and no rows (the port reads no ``TSNE_*``)."""
    return ("| variable | type | default | meaning |\n"
            "|---|---|---|---|\n\n"
            "(the port reads no TSNE_* environment variable: every knob is "
            "a flag of utils/cli.py or a keyword argument)")


# ---- rule: host-sync -------------------------------------------------------

#: models/tsne.py functions that run inside (or per-iteration around) the
#: optimize loop; the rest of the module is host orchestration
TSNE_HOT_FUNCS = {
    "optimize", "_repulsion", "_attraction_forces", "_attraction_loss",
    "_layout_parts", "_update_embedding", "_center", "_global_mean",
    "_mesh_sum", "_mesh_count", "_psum", "_pmax", "_pmin",
    "_telemetry_row", "center_input",
}

#: tensor methods whose result is a Python value, not a tensor
_HOST_VALUE_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                       "stride", "is_contiguous", "nelement", "ndimension",
                       "get_device", "storage_offset", "is_floating_point",
                       "is_complex", "type", "item", "tolist"}
#: tensor attributes that are Python values (``x.shape[0]`` is an int)
_HOST_VALUE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                     "layout", "requires_grad", "itemsize", "nbytes"}
#: torch functions that return no tensor
_TORCH_HOST_FUNCS = {"is_tensor", "device", "Generator", "Size", "finfo",
                     "iinfo", "get_default_dtype", "is_floating_point",
                     "numel", "cuda", "backends", "float32", "float64",
                     "int32", "int64", "bool", "dtype"}
_SYNC_METHODS = {"item": ".item()", "tolist": ".tolist()",
                 "cpu": ".cpu()", "numpy": ".numpy()"}
_SCALAR_CASTS = ("float", "int", "bool")


class _TensorNames:
    """Which local names of one function hold tensors: parameters
    annotated ``torch.Tensor``, and names assigned (anywhere in the
    function's own body) from a tensor-valued expression.  A fixed point
    over the assignments, so ``a = torch.sum(x); b = a * 2`` marks both."""

    def __init__(self, fn, torch_names: set[str]):
        self.torch = torch_names
        self.names: set[str] = set()
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None and any(
                    isinstance(s, ast.Attribute) and s.attr == "Tensor"
                    for s in ast.walk(a.annotation)):
                self.names.add(a.arg)
        assigns = [n for n in _walk_own_body(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                if node.value is None or not self.valued(node.value):
                    continue
                for t in targets:
                    if isinstance(t, ast.Name) and t.id not in self.names:
                        self.names.add(t.id)
                        changed = True

    def valued(self, e) -> bool:
        """True when ``e`` is (statically) a tensor."""
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Subscript):
            return self.valued(e.value)
        if isinstance(e, ast.Attribute):
            if e.attr in _HOST_VALUE_ATTRS:
                return False
            return e.attr in ("T", "mT", "real", "imag", "data") \
                and self.valued(e.value)
        if isinstance(e, ast.BinOp):
            return self.valued(e.left) or self.valued(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.valued(e.operand)
        if isinstance(e, ast.Call):
            func = e.func
            if isinstance(func, ast.Attribute):
                if (isinstance(func.value, ast.Name)
                        and func.value.id in self.torch):
                    return func.attr not in _TORCH_HOST_FUNCS
                if func.attr in _HOST_VALUE_METHODS:
                    return False
                return self.valued(func.value)
        return False


def _host_reads(fn, torch_names: set[str]):
    """(node, what) for each device->host read in ``fn``'s own body."""
    tensors = _TensorNames(fn, torch_names)
    for node in _walk_own_body(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS and not node.args:
                yield node, _SYNC_METHODS[func.attr]
            elif (func.attr == "synchronize"
                  and _dotted(func.value) in {f"{t}.cuda"
                                              for t in torch_names}):
                yield node, "torch.cuda.synchronize"
        elif (isinstance(func, ast.Name) and func.id in _SCALAR_CASTS
              and len(node.args) == 1 and tensors.valued(node.args[0])):
            yield node, f"{func.id}() of a tensor"


def _hot_scope(mod: Module):
    """(in_ops, is_tsne) for the host-sync scope."""
    norm = _norm(mod)
    return _in_dir(norm, "ops"), norm.endswith("models/tsne.py")


def _module_imports(mod: Module) -> dict[str, str]:
    """Local name -> dotted module for ``from pkg import module [as m]``
    and ``import pkg.module as m`` anywhere in the file."""
    out = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
    return out


def _callee(project: Project, mod: Module, call: ast.Call, imports):
    """(module, FunctionDef) of a call's target in the scanned project:
    a name imported ``from X import f``, or ``m.f`` of an imported
    module ``m``; None otherwise."""
    func = call.func
    if isinstance(func, ast.Name):
        dotted = imports.get(func.id)
        if dotted is None or "." not in dotted:
            return None
        modname, name = dotted.rsplit(".", 1)
    elif isinstance(func, ast.Attribute) and isinstance(func.value,
                                                        ast.Name):
        modname = imports.get(func.value.id)
        name = func.attr
        if modname is None:
            return None
    else:
        return None
    target = project._module_for(modname)
    if target is None:
        return None
    for node in target.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return target, node
    return None


@rule("host-sync",
      ".item()/.tolist()/.cpu()/.numpy()/torch.cuda.synchronize and "
      "float()/int() of a tensor in ops/ and the models/tsne.py step/loop "
      "functions (and a helper call there that reads the device)")
def host_sync(project: Project):
    findings = []
    for mod in project.modules:
        in_ops, is_tsne = _hot_scope(mod)
        if not (in_ops or is_tsne):
            continue
        torch_names = _torch_aliases(mod.tree)
        imports = _module_imports(mod)
        for fn, qual in _functions_with_parents(mod.tree):
            if is_tsne and qual.split(".")[0] not in TSNE_HOT_FUNCS:
                continue
            for node, what in _host_reads(fn, torch_names):
                findings.append(mod.finding(
                    "host-sync", node,
                    f"{what} in hot path '{qual}': a device->host read "
                    "stalls the launch queue; hoist it out of the hot path "
                    "or suppress with the rationale (a report boundary's "
                    "one read qualifies)"))
            # one level of helper calls out of the rule's own scope
            for node in _walk_own_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                got = _callee(project, mod, node, imports)
                if got is None:
                    continue
                target, callee = got
                t_ops, t_tsne = _hot_scope(target)
                if t_ops or (t_tsne and callee.name in TSNE_HOT_FUNCS):
                    continue  # flagged at its own site
                reads = list(_host_reads(callee,
                                         _torch_aliases(target.tree)))
                if reads:
                    findings.append(mod.finding(
                        "host-sync", node,
                        f"call of {callee.name}() in hot path '{qual}': it "
                        f"reads the device ({reads[0][1]} at "
                        f"{target.display}:{reads[0][0].lineno}); hoist "
                        "it or suppress with the rationale"))
    return findings


# ---- rule: dtype-drift -----------------------------------------------------

def _has_float_literal(node) -> bool:
    return any(isinstance(sub, ast.Constant) and isinstance(sub.value, float)
               for sub in ast.walk(node))


#: the operand policy module: its ``matmul_operands`` is the one blessed
#: bf16 cast, and it alone names the bf16 dtype
OPERAND_POLICY_SUFFIX = "ops/metrics.py"
#: the policy module's one function that may name float64: the test the
#: kernel wrappers dispatch their float64 forms on
FLOAT64_POLICY_FN = "kernel_float64"


def _fn_lines(tree, name: str) -> set[int]:
    """The source lines of the top-level function ``name`` in ``tree``."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return set(range(node.lineno, node.end_lineno + 1))
    return set()


@rule("dtype-drift",
      "torch.float64 (outside ops/metrics.kernel_float64), .double() and "
      "dtype-less torch.tensor of float literals in ops/ (a run computes "
      "in its own dtype), and bf16 outside ops/metrics.matmul_operands")
def dtype_drift(project: Project):
    findings = []
    for mod in project.modules:
        if not _in_dir(_norm(mod), "ops"):
            continue
        torch_names = _torch_aliases(mod.tree)
        policy = _norm(mod).endswith(OPERAND_POLICY_SUFFIX)
        blessed = (_fn_lines(mod.tree, FLOAT64_POLICY_FN) if policy
                   else set())
        for node in ast.walk(mod.tree):
            if (not policy and isinstance(node, ast.Attribute)
                    and node.attr == "bfloat16"
                    and _is_name_in(node.value, torch_names)):
                findings.append(mod.finding(
                    "dtype-drift", node,
                    "torch.bfloat16 in ops/: bf16 operands come from "
                    "ops/metrics.matmul_operands alone; thread "
                    "matmul_dtype= to the product"))
            if (isinstance(node, ast.Attribute)
                    and node.attr in ("float64", "double")
                    and _is_name_in(node.value, torch_names)
                    and node.lineno not in blessed):
                findings.append(mod.finding(
                    "dtype-drift", node,
                    f"torch.{node.attr} in ops/: a float64 value in a "
                    "float32 run; thread the computation dtype, or suppress "
                    "with the rationale"))
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (not policy and isinstance(func, ast.Attribute)
                    and func.attr == "bfloat16" and not node.args
                    and not _is_name_in(func.value, torch_names)):
                findings.append(mod.finding(
                    "dtype-drift", node,
                    ".bfloat16() in ops/: bf16 operands come from "
                    "ops/metrics.matmul_operands alone; thread "
                    "matmul_dtype= to the product"))
            if (isinstance(func, ast.Attribute) and func.attr == "double"
                    and not node.args
                    and not _is_name_in(func.value, torch_names)):
                findings.append(mod.finding(
                    "dtype-drift", node,
                    ".double() in ops/: a float64 copy in a float32 run; "
                    "thread the computation dtype, or suppress with the "
                    "rationale"))
            elif (isinstance(func, ast.Attribute) and func.attr == "tensor"
                  and _is_name_in(func.value, torch_names) and node.args
                  and not any(kw.arg == "dtype" for kw in node.keywords)
                  and _has_float_literal(node.args[0])):
                findings.append(mod.finding(
                    "dtype-drift", node,
                    "dtype-less torch.tensor of a float literal: it takes "
                    "the default dtype, not the computation's — pass "
                    "dtype= explicitly"))
    return findings


# ---- rule: cli-api-parity --------------------------------------------------

#: flag -> kwarg spellings the camelCase->snake_case transform cannot derive
FLAG_TO_KWARG = {"iterations": "n_iter"}

#: job I/O and process-control flags: meaningful only for a CLI invocation,
#: deliberately absent from the in-process estimator surface (the JAX
#: package's list)
CLI_ONLY_FLAGS = {
    "input", "output", "dimension", "inputDistanceMatrix", "executionPlan",
    "loss", "checkpoint", "checkpointEvery", "resume", "fatCheckpoint",
    "noCache", "profile", "coordinator", "numProcesses", "processId",
    "noAotCache", "auditPlan", "trace", "metricsOut",
    "jobTimeout", "stageTimeout", "model", "transform",
}
# (--faultPlan is not CLI-only in the port: TSNE(fault_plan=) is its twin)

#: estimator-only kwargs with no CLI counterpart, each a reviewed decision:
#: ``device`` — the CLI runs on the card and its in-process caller passes
#: ``main(argv, device=...)``; a flag would let a command line fall back
#: to the CPU, which the port's entry points never do unasked
API_ONLY_KWARGS: set = {"device"}


def _camel_to_snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])([A-Z])",
                  lambda m: "_" + m.group(1).lower(), name)


def _parser_flags(fn: ast.FunctionDef):
    """{flag_name: (default_literal_or_sentinel, required, lineno)} from the
    ``add_argument`` calls of a parser-building function."""
    flags = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument" and node.args):
            continue
        name = _const_str(node.args[0])
        if not name or not name.startswith("--"):
            continue
        name = name[2:]
        default = _literal  # sentinel: no literal default
        required = False
        for kw in node.keywords:
            if kw.arg == "default":
                default = _literal(kw.value)
            elif kw.arg == "required":
                required = _literal(kw.value) is True
            elif (kw.arg == "action"
                  and _const_str(kw.value) in ("store_true", "store_false")):
                default = _const_str(kw.value) == "store_false"
        flags[name] = (default, required, node.lineno)
    return flags


def _init_kwargs(cls: ast.ClassDef):
    """{kwarg: (default_literal_or_sentinel, lineno)} from ``__init__``."""
    for node in cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__init__":
            args = node.args
            pos = list(args.posonlyargs) + list(args.args)
            pos = [a for a in pos if a.arg != "self"]
            defaults = ([None] * (len(pos) - len(args.defaults))
                        + list(args.defaults))
            out = {}
            for a, d in zip(pos, defaults):
                out[a.arg] = (_literal if d is None else _literal(d),
                              a.lineno)
            for a, d in zip(args.kwonlyargs, args.kw_defaults):
                out[a.arg] = (_literal if d is None else _literal(d),
                              a.lineno)
            return out
    return {}


@rule("cli-api-parity",
      "argparse flags in build_parser match TSNE estimator kwargs "
      "(presence and defaults)")
def cli_api_parity(project: Project):
    parser_mod = parser_fn = None
    api_mod = api_cls = None
    for mod in project.modules:
        for node in mod.tree.body:
            if (isinstance(node, ast.FunctionDef)
                    and node.name == "build_parser"):
                parser_mod, parser_fn = mod, node
            if isinstance(node, ast.ClassDef) and node.name == "TSNE":
                api_mod, api_cls = mod, node
    if parser_fn is None or api_cls is None:
        return []  # nothing to cross-check in this scan set
    findings = []
    flags = _parser_flags(parser_fn)
    kwargs = _init_kwargs(api_cls)
    seen_kwargs = set()
    for flag, (default, required, lineno) in sorted(flags.items()):
        if flag in CLI_ONLY_FLAGS:
            continue
        kwarg = FLAG_TO_KWARG.get(flag, _camel_to_snake(flag))
        if kwarg not in kwargs:
            findings.append(Finding(
                "cli-api-parity", parser_mod.display, lineno, 0,
                f"CLI flag --{flag} has no TSNE kwarg counterpart "
                f"('{kwarg}'): add it to models/api.py, or add --{flag} "
                "to CLI_ONLY_FLAGS with the rationale"))
            continue
        seen_kwargs.add(kwarg)
        kw_default, _kw_line = kwargs[kwarg]
        if required or default is _literal or kw_default is _literal:
            continue
        if default != kw_default or (isinstance(default, bool)
                                     != isinstance(kw_default, bool)):
            findings.append(Finding(
                "cli-api-parity", parser_mod.display, lineno, 0,
                f"default mismatch: CLI --{flag} defaults to {default!r} "
                f"but TSNE(..., {kwarg}={kw_default!r}) — align them, or "
                "state the continuity rationale in a suppression"))
    for kwarg, (_, kw_line) in sorted(kwargs.items()):
        if kwarg in seen_kwargs or kwarg in API_ONLY_KWARGS:
            continue
        findings.append(Finding(
            "cli-api-parity", api_mod.display, kw_line, 0,
            f"TSNE kwarg '{kwarg}' has no CLI flag counterpart: add the "
            "flag to utils/cli.py, or add it to API_ONLY_KWARGS with the "
            "rationale"))
    return findings


# ---- rule: exception-hygiene -----------------------------------------------

#: attribute/function names whose call inside a handler counts as logging
#: the failure (print to stderr, warnings.warn, any logging-level method)
_LOG_CALL_NAMES = {"print"}
_LOG_ATTR_NAMES = {"warn", "warning", "error", "exception", "critical",
                   "info", "debug"}


def _is_broad_handler(node: ast.ExceptHandler) -> bool:
    """bare ``except:`` or ``except (Base)Exception`` — including tuple
    forms that contain one."""
    t = node.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(isinstance(nm, ast.Name)
               and nm.id in ("Exception", "BaseException") for nm in names)


def _handler_surfaces(node: ast.ExceptHandler) -> bool:
    """True when the handler re-raises or logs the failure somewhere a
    human (or the supervisor) can see it."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Raise):
            return True
        if not isinstance(sub, ast.Call):
            continue
        func = sub.func
        if isinstance(func, ast.Name) and func.id in _LOG_CALL_NAMES:
            return True
        if isinstance(func, ast.Attribute) and func.attr in _LOG_ATTR_NAMES:
            return True
    return False


@rule("exception-hygiene",
      "broad except handlers in ops//models//runtime/ must re-raise, log, "
      "or carry a rationale'd suppression (no try fallback on CUDA)")
def exception_hygiene(project: Project):
    findings = []
    for mod in project.modules:
        norm = _norm(mod)
        if not any(_in_dir(norm, d) for d in ("ops", "models", "runtime")):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad_handler(node) or _handler_surfaces(node):
                continue
            what = ("bare except:" if node.type is None
                    else "except Exception")
            findings.append(mod.finding(
                "exception-hygiene", node,
                f"{what} swallows the failure (no re-raise, no log): a "
                "silent catch here hides real errors from the runtime "
                "recovery layer (supervisor/ladder) and from operators — "
                "narrow the exception, re-raise, log it, or suppress with "
                "the rationale"))
    return findings


# ---- rule: audit-contract --------------------------------------------------

CONTRACTS_SUFFIX = "analysis/audit/contracts.py"
KERNELS_SUFFIX = "kernels/build.py"
#: the modules whose ops/ calls are the main path
MAIN_PATH_SUFFIXES = ("models/tsne.py", "utils/artifacts.py")
#: ops/ functions of these prefixes are host-side policy (resolvers, limit
#: checks, the autotune), not tensor ops: policy-recorded covers them
_POLICY_PREFIXES = ("pick_", "resolve_", "check_", "autotune_", "backend_")


def _parse_sibling(project: Project, suffix: str, *parts):
    """The scanned module ending in ``suffix``, or the file shipped with
    this package (fixture runs); None when neither exists."""
    mod = project.module_with_suffix(suffix)
    if mod is not None:
        return mod.tree
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), *parts)
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except OSError:
        return None


def _declared_contract_names(project: Project) -> set[str]:
    """Bare function names declared via ``contract("...", ...)`` calls in
    the registry — parsed, never imported (the registry imports torch)."""
    tree = _parse_sibling(project, CONTRACTS_SUFFIX, "analysis", "audit",
                          "contracts.py")
    declared = set()
    for node in ast.walk(tree) if tree is not None else ():
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "contract" and node.args):
            name = _const_str(node.args[0])
            if name:
                declared.add(name.rsplit(".", 1)[-1].split("[")[0])
    return declared


def _kernel_ids(project: Project) -> set[str]:
    """The keys of ``KERNELS = {...}`` in ``kernels/build.py``."""
    tree = _parse_sibling(project, KERNELS_SUFFIX, "kernels", "build.py")
    for node in tree.body if tree is not None else ():
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "KERNELS"
                        for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    return set()


def _launched_kernels(fn) -> set[str]:
    """Kernel ids ``fn``'s own body subscripts out of ``KERNELS``."""
    out = set()
    for node in _walk_own_body(fn):
        if (isinstance(node, ast.Subscript)
                and _is_name_in(node.value, {"KERNELS"})):
            key = _const_str(node.slice)
            if key:
                out.add(key)
    return out


def _main_path_ops(project: Project) -> set[tuple[str, str]]:
    """(ops module display, function name) of every ops/ function the
    main-path modules call: imported by name, or as ``m.f`` of an
    imported ops module."""
    out = set()
    for mod in project.modules:
        norm = _norm(mod)
        if not any(norm.endswith(s) for s in MAIN_PATH_SUFFIXES):
            continue
        imports = _module_imports(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            got = _callee(project, mod, node, imports)
            if got is None:
                continue
            target, fn = got
            if (_in_dir(_norm(target), "ops")
                    and not fn.name.startswith(_POLICY_PREFIXES)):
                out.add((target.display, fn.name))
    return out


@rule("audit-contract",
      "every ops/ launcher of a KERNELS kernel and every ops/ function on "
      "the main path declares a contract in analysis/audit/contracts.py")
def audit_contract(project: Project):
    findings = []
    declared = _declared_contract_names(project)
    kernel_ids = _kernel_ids(project)
    main = _main_path_ops(project)
    for mod in project.modules:
        if not _in_dir(_norm(mod), "ops"):
            continue
        for fn, qual in _functions_with_parents(mod.tree):
            if "." in qual or fn.name in declared:
                continue
            launched = _launched_kernels(fn) & (kernel_ids or {None})
            if launched:
                findings.append(mod.finding(
                    "audit-contract", fn,
                    f"'{fn.name}' launches kernel(s) {sorted(launched)} but "
                    "has no contract: add a contract(...) entry to "
                    "tsne_flink_tpu_torch/analysis/audit/contracts.py"))
            elif (mod.display, fn.name) in main:
                findings.append(mod.finding(
                    "audit-contract", fn,
                    f"'{fn.name}' is on the main path (called from "
                    "models/tsne.py or utils/artifacts.py) but has no "
                    "contract: add a contract(...) entry to "
                    "tsne_flink_tpu_torch/analysis/audit/contracts.py"))
    return findings


# ---- rule: resource-hygiene ------------------------------------------------

#: tempfile functions that hand the caller a resource to clean up
_TEMPFILE_ACQS = ("mkstemp", "mkdtemp")


def _resource_acquisitions(nodes, tempfile_names: set[str],
                           from_tmp_names: set[str], fcntl_names: set[str]):
    """(node, what) for each resource-acquiring call among ``nodes``."""
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            if (func.attr in _TEMPFILE_ACQS
                    and _is_name_in(func.value, tempfile_names)):
                yield node, f"tempfile.{func.attr}()"
            elif (func.attr == "NamedTemporaryFile"
                  and _is_name_in(func.value, tempfile_names)
                  and any(kw.arg == "delete"
                          and _literal(kw.value) is False
                          for kw in node.keywords)):
                yield node, "tempfile.NamedTemporaryFile(delete=False)"
            elif func.attr == "acquire":
                yield node, ".acquire()"
            elif (func.attr in ("flock", "lockf")
                  and _is_name_in(func.value, fcntl_names)):
                yield node, f"fcntl.{func.attr}()"
        elif isinstance(func, ast.Name) and func.id in from_tmp_names:
            yield node, f"{func.id}()"


@rule("resource-hygiene",
      "locks/semaphores/tempfiles acquired in runtime/, serve/ and "
      "utils/ are released via a context manager or try/finally")
def resource_hygiene(project: Project):
    """A lock or temp resource acquired on a path a fault can interrupt
    (the fleet SIGKILLs jobs; the watchdog ends the process on timeout)
    must have a structured release: either the acquisition is a ``with``
    context expression, or the enclosing function carries a
    ``try/finally`` that owns the cleanup.  Lexical by design."""
    findings = []
    for mod in project.modules:
        norm = _norm(mod)
        if not any(_in_dir(norm, d) for d in ("runtime", "serve", "utils")):
            continue
        tempfile_names = _import_aliases(mod.tree, "tempfile")
        fcntl_names = _import_aliases(mod.tree, "fcntl")
        from_tmp_names = set()
        for acq in _TEMPFILE_ACQS:
            from_tmp_names |= _from_import_aliases(mod.tree, acq)
        with_exprs = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        with_exprs.add(id(sub))

        def check(scope_walker, owner_has_finally, where):
            for node, what in scope_walker:
                if id(node) in with_exprs or owner_has_finally:
                    continue
                findings.append(mod.finding(
                    "resource-hygiene", node,
                    f"{what} in {where} without a try/finally release "
                    "path: a fault (SIGKILL chaos, watchdog exit, "
                    "exception) would leak the lock/tempfile — release "
                    "via a context manager or try/finally, or suppress "
                    "with the rationale"))

        for fn, qual in _functions_with_parents(mod.tree):
            has_finally = any(isinstance(sub, ast.Try) and sub.finalbody
                              for sub in _walk_own_body(fn))
            check(_resource_acquisitions(_walk_own_body(fn),
                                         tempfile_names, from_tmp_names,
                                         fcntl_names),
                  has_finally, f"'{qual}'")
        mod_level = [n for n in mod.tree.body
                     if not isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))]
        has_finally = any(isinstance(sub, ast.Try) and sub.finalbody
                          for n in mod_level for sub in ast.walk(n))
        for n in mod_level:
            check(_resource_acquisitions(ast.walk(n), tempfile_names,
                                         from_tmp_names, fcntl_names),
                  has_finally, "module scope")
    return findings


# ---- rule: mesh-hygiene ----------------------------------------------------

_AXIS_CLASSES = ("MeshAxis", "ProcessAxis")
#: the torch.distributed API a call through an alias of the module is
#: matched against (``dist`` is also a common name for distances)
_DIST_API = {
    "is_available", "is_initialized", "init_process_group",
    "destroy_process_group", "get_rank", "get_world_size", "get_backend",
    "new_group", "barrier", "monitored_barrier", "broadcast", "all_reduce",
    "reduce", "all_gather", "all_gather_into_tensor", "gather", "scatter",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp", "all_gather_object",
    "broadcast_object_list",
}


@rule("mesh-hygiene",
      "torch.distributed calls or MeshAxis/ProcessAxis construction "
      "outside parallel/ — the mesh and its collectives live there")
def mesh_hygiene(project: Project):
    findings = []
    for mod in project.modules:
        norm = _norm(mod)
        if not _in_package(norm) or _in_dir(norm, "parallel"):
            continue
        dist_names = _import_aliases(mod.tree, "torch.distributed")
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and (
                    node.module or "").startswith("torch.distributed"):
                dist_names |= {a.asname or a.name for a in node.names}
        torch_names = _torch_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            dotted = _dotted(func) or ""
            attr = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if attr in _DIST_API and (
                    _attr_root(func) in dist_names
                    or any(dotted.startswith(f"{t}.distributed.")
                           for t in torch_names)):
                findings.append(mod.finding(
                    "mesh-hygiene", node,
                    f"torch.distributed call {dotted or '?'}() outside "
                    "parallel/: the process group and its collectives are "
                    "parallel/mesh.py's (distributed_init, ProcessAxis, "
                    "process_axis)"))
            name = (func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None)
            if name in _AXIS_CLASSES:
                findings.append(mod.finding(
                    "mesh-hygiene", node,
                    f"{name} constructed outside parallel/: a shard's axis "
                    "comes from parallel/mesh (run_shards, process_axis)"))
    return findings


# ---- rule: timing-hygiene --------------------------------------------------

#: time-module attributes whose call is a raw wall-clock read (sleep,
#: strftime etc. are not timing and never flagged)
_CLOCK_ATTRS = ("time", "perf_counter", "perf_counter_ns", "monotonic",
                "monotonic_ns")


@rule("timing-hygiene",
      "raw time.time/perf_counter/monotonic inside the package (outside "
      "obs/) — timing must flow through obs spans")
def timing_hygiene(project: Project):
    findings = []
    for mod in project.modules:
        norm = _norm(mod)
        if not _in_package(norm) or "/obs/" in norm or _in_dir(norm, "obs"):
            continue
        time_mods = _import_aliases(mod.tree, "time")
        from_names = set()
        for attr in _CLOCK_ATTRS:
            from_names |= _from_import_aliases(mod.tree, attr)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            what = None
            if (isinstance(func, ast.Attribute)
                    and func.attr in _CLOCK_ATTRS
                    and _is_name_in(func.value, time_mods)):
                what = f"time.{func.attr}()"
            elif isinstance(func, ast.Name) and func.id in from_names:
                what = f"{func.id}()"
            if what is None:
                continue
            findings.append(mod.finding(
                "timing-hygiene", node,
                f"raw clock {what} inside the package: timing must flow "
                "through obs spans (obs/trace.py — `with trace.span(...) "
                "as sp:` then sp.seconds; obs.trace.walltime() for "
                "deadlines) so the measurement lands in the trace schema; "
                "suppress with the rationale if a raw clock is genuinely "
                "required"))
    return findings


# ---- rule: policy-recorded -------------------------------------------------

#: keys the JAX package's final bench record carries beyond RECORD_BASE_KEYS
EXTRA_RECORD_KEYS = ("attraction", "attraction_kernel", "attraction_pairs",
                     "sym_width")

#: the JAX package's bench RECORD_BASE_KEYS (frozen: the port has no bench
#: record of its own yet; a resolver's stamp names the record field its
#: decision belongs in, and the port's own report of it)
_RECORD_KEYS_FALLBACK = (
    "metric", "unit", "backend", "devices", "n", "iterations", "repulsion",
    "theta", "knn_method", "knn_rounds", "knn_refine", "data", "data_seed",
    "peak_flops", "peak_flops_basis", "assembly", "cache", "matmul_dtype",
    "knn_tiles", "audit", "degradations", "aot_cache", "memory",
    "host_calib", "fleet", "mesh", "kl", "repulsion_stride",
    "effective_seconds_per_iter", "repulsion_refreshes", "policy",
    "serve",
)

#: record keys that describe the WORKLOAD, not a resolved decision
_CONTEXT_KEYS = ("metric", "unit", "backend", "devices", "n", "iterations",
                 "theta", "data", "data_seed")

#: the serve-side record keys (the JAX package's serve bench record and
#: per-request latency record fields, which the port's daemon writes)
_SERVE_KEYS_FALLBACK = (
    "fit_iters", "model_id", "aot_cache", "bucket", "iters", "eta",
    "sched", "admission", "serve", "serve_mixed", "quality", "smoke",
    "deadline_ms", "starve_ms", "poll_ms", "queue_ms", "compute_ms",
    "write_ms", "batch_fill", "lane", "slices", "spool", "promoted",
    "batches", "residency", "seconds",
    "replica", "epoch", "replicas", "stale_ms", "shed", "shed_depth",
    "retry_after_ms", "redispatched",
)

_BACKTICK_KEY_RE = re.compile(r"``([A-Za-z0-9_]+)``")


def _module_named(project: Project, filename: str) -> Module | None:
    """The scanned module whose display path IS ``filename`` or ends in
    ``/filename`` as a whole path segment."""
    for mod in project.modules:
        norm = _norm(mod)
        if norm == filename or norm.endswith("/" + filename):
            return mod
    return None


def _live_tuple(mod: Module, name: str) -> set[str] | None:
    """A top-level ``NAME = (...)`` tuple/list of strings in ``mod``, or
    None when absent/not-literal."""
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            val = _literal(node.value)
            if isinstance(val, (tuple, list)):
                return set(val)
    return None


def _bench_record_keys(project: Project) -> set[str]:
    keys = None
    mod = _module_named(project, "bench.py")
    if mod is not None:
        keys = _live_tuple(mod, "RECORD_BASE_KEYS")
    if keys is None:
        keys = set(_RECORD_KEYS_FALLBACK)
    return (keys | set(EXTRA_RECORD_KEYS)) - set(_CONTEXT_KEYS)


def _serve_record_keys(project: Project) -> set[str]:
    keys: set[str] = set()
    mod = _module_named(project, "serve_bench.py")
    if mod is not None:
        keys |= _live_tuple(mod, "RECORD_BASE_KEYS") or set()
    mod = _module_named(project, "sched.py")
    if mod is not None:
        keys |= _live_tuple(mod, "SCHED_RECORD_KEYS") or set()
    if not keys:
        keys = set(_SERVE_KEYS_FALLBACK)
    return keys - set(_CONTEXT_KEYS)


@rule("policy-recorded",
      "pick_* resolvers in ops//models//utils//serve/ stamp the record key "
      "their decision lands in, or carry a rationale'd suppression")
def policy_recorded(project: Project):
    """A ``pick_*`` function resolves a choice (method, kernel, width,
    stride) that changes the program, so its docstring names, in double
    backticks, the record key its resolved value lands in — or a
    rationale'd suppression says why the record already pins it."""
    bench_keys = _bench_record_keys(project)
    serve_keys = bench_keys | _serve_record_keys(project)
    findings = []
    for mod in project.modules:
        norm = _norm(mod)
        in_serve = _in_dir(norm, "serve")
        if not in_serve and not any(_in_dir(norm, d)
                                    for d in ("ops", "models", "utils")):
            continue
        keys = serve_keys if in_serve else bench_keys
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.FunctionDef)
                    and node.name.startswith("pick_")):
                continue
            doc = ast.get_docstring(node) or ""
            if set(_BACKTICK_KEY_RE.findall(doc)) & keys:
                continue
            where = ("RECORD_BASE_KEYS, SCHED_RECORD_KEYS or the final "
                     "record's extra keys" if in_serve else
                     "RECORD_BASE_KEYS or the final record's extra keys")
            findings.append(mod.finding(
                "policy-recorded", node,
                f"policy resolver {node.name}() names no record key "
                "in its docstring: stamp the key the resolved choice "
                f"lands in (double-backticked, from {where}), or "
                "suppress with the rationale that the record already "
                "pins the decision"))
    return findings
