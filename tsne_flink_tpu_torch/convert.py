"""Carry the JAX package's configuration, state and prepared P across.

t-SNE has no weights: what the two packages must share is the
configuration, the optimizer state and the prepared joint P (its row
layout or its CSR head + tail).  Arrays cross as numpy arrays, so this
module imports nothing of JAX.
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
