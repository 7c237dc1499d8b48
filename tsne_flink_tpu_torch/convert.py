"""Carry the JAX package's configuration, state and prepared P across.

t-SNE has no weights: what the two packages must share is the
configuration, the optimizer state and the prepared joint P (its row
layout, its CSR head + tail, its edge list or its blocks).  Arrays cross
as numpy arrays, so this module imports nothing of JAX.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from tsne_flink_tpu_torch.models.tsne import TsneConfig, TsneState
from tsne_flink_tpu_torch.utils.device import resolve_device


def config_from_jax(cfg) -> TsneConfig:
    """The port's config from a JAX ``TsneConfig`` (same field names)."""
    return TsneConfig(**{f.name: getattr(cfg, f.name)
                         for f in fields(TsneConfig)})


def to_numpy(a) -> np.ndarray:
    """A numpy array of a tensor (copied to the host), an array or a
    scalar."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device, dtype=None):
    # a copy: arrays handed over by JAX are read-only
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


def state_from_numpy(y, update=None, gains=None, *, device=None,
                     dtype=None) -> TsneState:
    """A ``TsneState``; a missing update is zeros, missing gains ones."""
    device = resolve_device(device)
    yt = _tensor(y, device, dtype)
    upd = (torch.zeros_like(yt) if update is None
           else _tensor(update, device, yt.dtype))
    g = torch.ones_like(yt) if gains is None else _tensor(gains, device,
                                                          yt.dtype)
    return TsneState(y=yt, update=upd, gains=g)


def rows_from_numpy(jidx, jval, *, device=None):
    """A prepared [N, S] row layout: (jidx int32, jval)."""
    device = resolve_device(device)
    return _tensor(jidx, device, torch.int32), _tensor(jval, device)


def csr_from_numpy(head, tail, *, device=None):
    """A prepared CSR layout ``((hidx, hval), (tsrc, tdst, tval))`` ->
    the 5-tuple ``optimize(csr=...)`` takes."""
    device = resolve_device(device)
    hidx, hval = head
    tsrc, tdst, tval = tail
    return (_tensor(hidx, device, torch.int32), _tensor(hval, device),
            _tensor(tsrc, device, torch.int32),
            _tensor(tdst, device, torch.int32), _tensor(tval, device))


def edges_from_numpy(src, dst, val, *, device=None):
    """A prepared flat edge list -> the ``(src, dst, val)`` that
    ``optimize(edges=...)`` takes."""
    device = resolve_device(device)
    return (_tensor(src, device, torch.int32),
            _tensor(dst, device, torch.int32), _tensor(val, device))


def blocks_from_numpy(jidx, jval, extra, *, device=None):
    """A prepared blocks layout ``(jidx, jval, (rsrc, rdst, rval))`` ->
    ``(jidx, jval, edges)`` for ``optimize(jidx, jval, edges=edges,
    edges_extra=True)``."""
    return (*rows_from_numpy(jidx, jval, device=device),
            edges_from_numpy(*extra, device=device))


def frozen_from_jax(jm, *, device=None):
    """The port's ``serve/model.FrozenModel`` of a JAX ``FrozenModel``:
    the same base arrays, plan fields, identity and, for fft serving, the
    JAX field's potentials, spacing and origin (so the port's gather can
    be held to the JAX field)."""
    from tsne_flink_tpu_torch.ops.repulsion_fft import FftField
    from tsne_flink_tpu_torch.serve.model import FrozenModel, PlanConfig

    device = resolve_device(device)
    # the port's own fields (the bf16 operand dtype) keep their defaults
    plan = PlanConfig(**{f.name: getattr(jm.plan, f.name)
                         for f in fields(PlanConfig)
                         if hasattr(jm.plan, f.name)})
    x = _tensor(jm.x, device)
    field = None
    if jm.field is not None:
        f = jm.field
        field = FftField(pot=_tensor(f.pot, device), h=_tensor(f.h, device),
                         origin=_tensor(f.origin, device), grid=int(f.grid),
                         interp=int(f.interp))
    return FrozenModel(x=x, y=_tensor(jm.y, device, x.dtype), plan=plan,
                       perplexity=jm.perplexity,
                       learning_rate=jm.learning_rate, metric=jm.metric,
                       repulsion=jm.repulsion, model_id=jm.model_id,
                       ckpt_hash=jm.ckpt_hash, field=field)
