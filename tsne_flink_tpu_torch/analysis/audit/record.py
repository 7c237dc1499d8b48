"""The dispatch recorder — the port's counterpart of ``jax.make_jaxpr``.

PyTorch has no abstract trace of this code: ``optimize`` reads the host
at report boundaries, and ``build_csr`` and the kNN have data-dependent
shapes.  So the port's audits RUN a tiny concrete case and record what
it issues, in order:

* every aten op, through a ``TorchDispatchMode``, with its input and
  output shapes and dtypes and its Python provenance (the port's frames,
  innermost first; the optimize loop's iteration where there is one);
* every hand-written kernel launch, by a hook where
  ``kernels/build.KERNELS`` counts it (ctypes launches never reach the
  dispatcher), with the launch's integer shape arguments;
* every collective, by a hook on ``parallel/mesh.MeshAxis`` /
  ``ProcessAxis``, with its kind, shape, dtype, payload bytes and shard.

``Recorder(operand_values=True)`` (the dtype audit's bf16 pass) also
notes, for every matrix product (:data:`PRODUCT_OPS`), whether each
floating operand holds bf16 values only (``rounded``): what an operand
that passed through ``ops/metrics.matmul_operands`` holds.

Dispatch modes are per thread, so a :class:`Recorder` also registers a
shard context with ``parallel/mesh.SHARD_CONTEXTS``: each shard thread of
the thread mesh enters the recorder itself, and its events carry its
shard index.  On the CPU the kernels' wrappers run their plain versions;
an aten op issued inside one carries ``plain_of`` (the kernel id: the
float64 form's, ``B1_f64`` .. ``B6_f64``, when the plain version's first
tensor argument is a float64 tensor, B2-B5's wide form past m = 8 and
B6's unstaged form past 12,288 features, as the wrappers choose on the
card), so an op list names the kernel steps on either device.
"""

from __future__ import annotations

import sys
import threading

#: plain-version functions (ops/) -> the kernel id they stand in for
PLAIN_OF = {
    "knn_sweep_plain": "B1", "knn_cross_plain": "B1",
    "exact_repulsion": "B2", "fused_step_plain": "B3",
    "attraction_loss_plain": "B4", "attraction_forces_plain": "B5",
    "refine_keep_plain": "B6", "refine_final_plain": "B6",
}
#: the kernels with a float64 form (``kernels/build.KERNELS[id + "_f64"]``)
F64_FORMS = ("B1", "B2", "B3", "B4", "B5", "B6")

#: aten matrix products -> the position of the input whose last axis is
#: the contraction
PRODUCT_OPS = {"aten.mm": 0, "aten.bmm": 0, "aten.mv": 0, "aten.dot": 0,
               "aten.vdot": 0, "aten.addmm": 1, "aten.baddbmm": 1,
               "aten.addmv": 1, "aten.addbmm": 1}

_PKG = "tsne_flink_tpu_torch/"
_SKIP = ("tsne_flink_tpu_torch/analysis/",)
#: the mesh's collective plumbing: a collective's site is its caller
_MESH_PLUMBING = {"_note", "all_gather", "psum", "pmax", "pmin",
                  "ppermute", "all_to_all", "_stacked", "_parts",
                  "exchange"}
#: aten ops whose ``accumulate`` flag is positional, by its position
_ACCUMULATE_ARG = {"aten.index_put": 3, "aten.index_put_": 3,
                   "aten._index_put_impl_": 3, "aten.put_": 3,
                   "aten.put": 3}


def _plain_form(f) -> str:
    """The kernel id a plain version's frame stands in for
    (``kernels/build.form_id``): by the frame's first tensor argument
    (``refine_final_plain``'s follows the metric's name), its float64
    form's when that tensor is float64, B2-B5's wide form's when it is an
    [N, m] embedding past ``M_NARROW``, B6's unstaged form's when it is
    an [N, F] base past ``B6_STAGED_F_MAX``."""
    import torch
    from tsne_flink_tpu_torch.kernels.build import form_id
    kid = PLAIN_OF[f.f_code.co_name]
    code = f.f_code
    first = next((v for v in map(f.f_locals.get,
                                 code.co_varnames[:code.co_argcount])
                  if isinstance(v, torch.Tensor)), None)
    if first is None:
        return kid
    return form_id(kid, kid in F64_FORMS and first.dtype == torch.float64,
                   first.shape[1] if first.dim() == 2 else 0)


def _frames(limit: int = 12) -> tuple[list, int | None, str | None]:
    """(the port's frames innermost first as (path, line, function), the
    optimize loop's iteration ``i`` when a frame is in it, the kernel id
    of the innermost plain version on the stack or None)."""
    out, it, plain = [], None, None
    f = sys._getframe(2)
    while f is not None and len(out) < limit:
        path = f.f_code.co_filename.replace("\\", "/")
        if plain is None and f.f_code.co_name in PLAIN_OF and _PKG in path:
            plain = _plain_form(f)
        if _PKG in path:
            rel = _PKG + path.split(_PKG, 1)[1]
            plumbing = (rel.endswith("parallel/mesh.py")
                        and f.f_code.co_name in _MESH_PLUMBING)
            if not rel.startswith(_SKIP) and not plumbing:
                out.append((rel, f.f_lineno, f.f_code.co_name))
                if (it is None and f.f_code.co_name == "optimize"
                        and rel.endswith("models/tsne.py")):
                    i = f.f_locals.get("i")
                    it = i if isinstance(i, int) else None
        elif "/tests/" in path:
            out.append(("tests/" + path.split("/tests/", 1)[1], f.f_lineno,
                        f.f_code.co_name))
        f = f.f_back
    return out, it, plain


def _bf16_valued(t) -> bool:
    """Every value of ``t`` is a bf16 value (NaN included)."""
    import torch
    r = t.to(torch.bfloat16).to(t.dtype)
    return bool(torch.all((r == t) | torch.isnan(t)))


def _meta(x):
    """[[shape, dtype], ...] of the tensors in ``x`` (nested)."""
    import torch
    out = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.append([list(v.shape), str(v.dtype).replace("torch.", "")])
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)
    walk(x)
    return out


class Recorder:
    """``with Recorder() as rec:`` records what the block issues on this
    thread and on every shard thread it starts (:attr:`events`)."""

    def __init__(self, operand_values: bool = False):
        self.operand_values = operand_values
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._mode = None

    # ---- the hooks ---------------------------------------------------

    def _add(self, ev: dict) -> None:
        ev["shard"] = getattr(self._tls, "shard", None)
        frames, it, plain = _frames()
        ev["frames"] = frames
        ev["site"] = frames[0] if frames else None
        ev["iteration"] = it
        if plain is not None and ev["kind"] == "aten":
            ev["plain_of"] = plain
        with self._lock:
            ev["seq"] = len(self.events)
            self.events.append(ev)

    def _on_launch(self, kernel, symbol, args) -> None:
        from tsne_flink_tpu_torch.kernels.build import SIGNATURES, _I
        sig = SIGNATURES.get(symbol, [])
        ints = [int(a) for a, t in zip(args, sig)
                if t is _I and a is not None]
        self._add({"kind": "kernel", "name": kernel.kid or symbol,
                   "symbol": symbol, "ints": ints})

    def _on_collective(self, kind, axis, x) -> None:
        nbytes = int(x.numel() * x.element_size())
        self._add({"kind": "collective", "name": kind,
                   "axis": type(axis).__name__,
                   "index": int(axis.index), "size": int(axis.size),
                   "in": _meta(x), "bytes": nbytes,
                   "floating": bool(x.is_floating_point())})

    def _shard_context(self, index: int):
        rec = self

        class _Ctx:
            def __enter__(self):
                self.prev = getattr(rec._tls, "shard", None)
                rec._tls.shard = index
                self.mode = None
                if not getattr(rec._tls, "active", False):
                    self.mode = rec._new_mode()
                    self.mode.__enter__()
                    rec._tls.active = True
                return self

            def __exit__(self, *exc):
                if self.mode is not None:
                    self.mode.__exit__(*exc)
                    rec._tls.active = False
                rec._tls.shard = self.prev
                return False

        return _Ctx()

    def _new_mode(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        rec = self

        class _Mode(TorchDispatchMode):
            @classmethod
            def _should_skip_dynamo(cls):
                # the port compiles nothing: without this, the mode's first
                # op imports torch._dynamo to wrap it (seconds, cold)
                return False

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ev = {"kind": "aten", "name": str(func.overloadpacket),
                      "in": _meta(args), "out": _meta(out)}
                if kwargs:
                    ev["kwargs"] = sorted(kwargs)
                acc = (kwargs or {}).get("accumulate")
                if acc is None and ev["name"] in _ACCUMULATE_ARG:
                    pos = _ACCUMULATE_ARG[ev["name"]]
                    acc = args[pos] if len(args) > pos else False
                if acc is True:
                    ev["accumulate"] = True
                if rec.operand_values and ev["name"] in PRODUCT_OPS:
                    ev["rounded"] = [_bf16_valued(a) for a in args
                                     if isinstance(a, torch.Tensor)
                                     and a.is_floating_point()]
                rec._add(ev)
                return out

        return _Mode()

    # ---- the context ----------------------------------------------------

    def __enter__(self) -> "Recorder":
        from tsne_flink_tpu_torch.kernels import build
        from tsne_flink_tpu_torch.parallel import mesh
        build.LAUNCH_HOOKS.append(self._on_launch)
        mesh.COLLECTIVE_HOOKS.append(self._on_collective)
        mesh.SHARD_CONTEXTS.append(self._shard_context)
        self._mode = self._new_mode()
        self._mode.__enter__()
        self._tls.active = True
        return self

    def __exit__(self, *exc) -> bool:
        from tsne_flink_tpu_torch.kernels import build
        from tsne_flink_tpu_torch.parallel import mesh
        self._mode.__exit__(*exc)
        self._tls.active = False
        build.LAUNCH_HOOKS.remove(self._on_launch)
        mesh.COLLECTIVE_HOOKS.remove(self._on_collective)
        mesh.SHARD_CONTEXTS.remove(self._shard_context)
        return False


def op_list(events) -> list[dict]:
    """The execution plan's ``ops``: kernels by id and aten ops, in
    order, each with its shapes and dtypes (an aten op inside a kernel's
    plain version carries ``plain_of``)."""
    out = []
    for e in events:
        if e["kind"] == "kernel":
            out.append({"kernel": e["name"], "ints": e["ints"],
                        "iteration": e.get("iteration")})
        elif e["kind"] == "collective":
            out.append({"collective": e["name"], "in": e["in"],
                        "iteration": e.get("iteration")})
        else:
            row = {"op": e["name"], "in": e["in"], "out": e["out"],
                   "iteration": e.get("iteration")}
            if "plain_of" in e:
                row["plain_of"] = e["plain_of"]
            out.append(row)
    return out


def kernel_steps(ops) -> list[str]:
    """The kernel ids an op list runs, in order, a run of plain-version
    ops counted once (what names B2, B3, B4 in a CSR iteration)."""
    steps: list[str] = []
    last_plain = None
    for row in ops:
        kid = row.get("kernel")
        if kid is not None:
            steps.append(kid)
            last_plain = None
            continue
        plain = row.get("plain_of")
        if plain is not None and plain != last_plain:
            steps.append(plain)
        last_plain = plain
    return steps
