"""Checkpoint / resume of the optimizer working set (port of
``tsne_flink_tpu/utils/checkpoint.py``), in the JAX package's v2 format.

One ``.npz`` holds the working set (y, update, gains), the next iteration
and the loss trace so far, a sha256 content hash over every array, and an
optional prepare payload (``prep_``-prefixed: the affinity fingerprint,
the assembly label and, in a "fat" checkpoint, the joint P itself), so a
resume can skip the kNN and affinity stages.  The magic, keys, payload
and hash are the JAX package's, so each package loads the other's files;
v1 files load too.  Writes are atomic (tmp + rename) and rotating: the
previous file survives as ``<path>.1``, and :func:`load_fallback` takes
it when the newest one is damaged.

:func:`save` takes torch tensors (or numpy arrays) and writes numpy;
:func:`load` returns numpy, which ``convert.state_from_numpy`` puts on
the device.  The autopilot's controller pair rides along as
``pilot_state``/``pilot_trace`` (``save(pilot=)``, :func:`load_pilot`),
so a resumed autopilot run makes the uninterrupted run's decisions.
:func:`load_model` is the serving path's strict read of a frozen model.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import zipfile
import zlib

import numpy as np

from tsne_flink_tpu_torch.convert import to_numpy
from tsne_flink_tpu_torch.models.tsne import TsneState

MAGIC_V1 = "tsne_flink_tpu-ckpt-v1"
MAGIC = "tsne_flink_tpu-ckpt-v2"
_MAGICS = (MAGIC_V1, MAGIC)

#: names a prepare payload may carry (stored as ``prep_<name>``):
#: ``affinity_fp``, ``label``, ``audit`` and ``events`` are strings, the
#: rest the joint P (``jidx``/``jval``, and the blocks layout's reverse
#: triple when label == "blocks")
PREPARE_KEYS = ("affinity_fp", "label", "audit", "events", "jidx", "jval",
                "rsrc", "rdst", "rval")


class NotACheckpoint(ValueError):
    pass


class CheckpointCorrupt(NotACheckpoint):
    """The file claims to be a checkpoint but its bytes are damaged
    (truncation, bit-flip, torn write); names the path and, when the
    trailer could be read, the expected content hash."""

    def __init__(self, path: str, expected: str | None = None,
                 detail: str = ""):
        self.path = path
        self.expected_hash = expected
        msg = f"checkpoint {path} is corrupt"
        if expected:
            msg += f" (expected content hash {expected})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


def _content_hash(arrays: dict) -> str:
    """sha256 over every saved array's (name, dtype, shape, bytes) in
    sorted-name order: the verification trailer."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(repr((name, a.dtype.str, a.shape)).encode())
        h.update(a.view(np.uint8).reshape(-1).data)
    return h.hexdigest()


def save(path: str, state: TsneState, next_iter: int, losses,
         prepare: dict | None = None, keep: int = 2, pilot=None) -> None:
    """Atomic, verified, rotating write: the arrays and their content hash
    go to a tmp file; with ``keep=2`` the existing ``path`` moves to
    ``<path>.1``, then the tmp file becomes ``path``.  ``prepare`` is the
    v2 payload, any subset of :data:`PREPARE_KEYS`; ``pilot`` the
    autopilot's ``(state vector, policy trace)`` at this boundary.  The
    ``checkpoint`` fault site fires after the write."""
    extras = {}
    for k, v in (prepare or {}).items():
        if k not in PREPARE_KEYS:
            raise ValueError(f"unknown prepare payload key '{k}' "
                             f"({' | '.join(PREPARE_KEYS)})")
        extras["prep_" + k] = to_numpy(v)
    if pilot is not None:
        extras["pilot_state"] = to_numpy(pilot[0])
        extras["pilot_trace"] = to_numpy(pilot[1])
    payload = {"magic": np.asarray(MAGIC), "y": to_numpy(state.y),
               "update": to_numpy(state.update),
               "gains": to_numpy(state.gains),
               "next_iter": np.asarray(int(next_iter)),
               "losses": to_numpy(losses), **extras}
    digest = _content_hash(payload)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, content_hash=digest, **payload)
        if keep > 1 and os.path.exists(path):
            os.replace(path, path + ".1")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # the checkpoint fault site: corrupt@checkpoint flips a bit of the file
    # just written (runtime/faults.py); loading it raises CheckpointCorrupt
    from tsne_flink_tpu_torch.runtime import faults
    inj = faults.injector()
    if inj is not None:
        inj.fire("checkpoint", path=path, point="boundary")


def _stored_hash(z) -> str | None:
    """The content hash a damaged file still names, when its own entry
    reads back (the zip's CRC of another entry caught the damage)."""
    try:
        return str(z["content_hash"])
    except (ValueError, KeyError, OSError, EOFError, zipfile.BadZipFile,
            zlib.error):
        return None


def _read_verified(path: str) -> dict:
    """Every array of a checkpoint (``content_hash`` among them when the
    file carries one), each read once, its magic and content hash
    checked.  Foreign files raise :class:`NotACheckpoint`, damaged
    ones :class:`CheckpointCorrupt`."""
    try:
        z = np.load(path)
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        raise CheckpointCorrupt(path, detail=f"unreadable ({e})") from e
    with z:
        try:
            if str(z["magic"]) not in _MAGICS:
                raise NotACheckpoint(
                    f"{path} is not a tsne_flink_tpu checkpoint")
            arrays = {name: z[name] for name in z.files}
        except NotACheckpoint:
            raise
        except (ValueError, KeyError, OSError, EOFError, zipfile.BadZipFile,
                zlib.error) as e:
            raise CheckpointCorrupt(path, _stored_hash(z),
                                    f"payload unreadable ({e})") from e
    expected = arrays.get("content_hash")
    if expected is not None and _content_hash(
            {k: v for k, v in arrays.items() if k != "content_hash"}
    ) != str(expected):
        raise CheckpointCorrupt(path, str(expected), "content hash mismatch")
    return arrays


def _state(path: str, arrays: dict):
    try:
        state = TsneState(y=arrays["y"], update=arrays["update"],
                          gains=arrays["gains"])
        return state, int(arrays["next_iter"]), arrays["losses"]
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointCorrupt(path, detail=f"missing or bad {e}") from e


def _payload(arrays: dict) -> dict | None:
    out = {}
    for k in PREPARE_KEYS:
        v = arrays.get("prep_" + k)
        if v is not None:
            out[k] = str(v) if v.dtype.kind == "U" else v
    return out or None


def load(path: str):
    """``(TsneState of numpy arrays, next_iter, losses)`` of a v1 or v2
    file, its content hash verified when it carries one."""
    return _state(path, _read_verified(path))


def _pilot(arrays: dict):
    if "pilot_state" not in arrays:
        return None
    return arrays["pilot_state"], arrays["pilot_trace"]


def load_resume(path: str, with_pilot: bool = False):
    """``(state, next_iter, losses, prepare payload, used_path)`` in one
    verified read (a fat checkpoint's joint P is read and hashed once),
    falling back with a warning to the rotated ``<path>.1`` when ``path``
    is damaged.  ``with_pilot`` appends the autopilot pair (or None)."""
    try:
        arrays, used = _read_verified(path), path
    except CheckpointCorrupt as e:
        prev = path + ".1"
        if not os.path.exists(prev):
            raise
        print(f"WARNING: {e}; falling back to the previous checkpoint "
              f"{prev}", file=sys.stderr)
        arrays, used = _read_verified(prev), prev
    out = (*_state(used, arrays), _payload(arrays), used)
    return (*out, _pilot(arrays)) if with_pilot else out


def load_fallback(path: str):
    """:func:`load`, falling back to ``<path>.1`` as :func:`load_resume`
    does.  Returns ``(state, next_iter, losses, used_path)``."""
    state, next_iter, losses, _, used = load_resume(path)
    return state, next_iter, losses, used


def load_prepare(path: str) -> dict | None:
    """The v2 prepare payload of ``path`` (strings for ``affinity_fp``,
    ``label``, ``audit`` and ``events``, numpy arrays otherwise), or None
    for a file without one."""
    return _payload(_read_verified(path))


def load_pilot(path: str):
    """The autopilot's ``(state vector, policy trace)`` saved at this
    boundary (numpy), or None when the file has none (autopilot off, or
    an older file).  Feed it back as ``pilot_carry``."""
    return _pilot(_read_verified(path))


def load_model(path: str):
    """Strict frozen-model read for serving: one verified ``np.load``
    returning ``(state, next_iter, losses, prepare, content_hash)``.
    Read-only (no rotation, no tmp file: the directory is byte-identical
    after a model load); a v1 file or one without a content hash is
    refused with :class:`NotACheckpoint`, since a daemon answers queries
    from this state for hours and must know exactly what it loaded (the
    hash is part of ``serve/model.FrozenModel.model_id``)."""
    arrays = _read_verified(path)
    if str(arrays["magic"]) != MAGIC:
        raise NotACheckpoint(
            f"{path} is not a v2 checkpoint — serving requires the "
            "content-verified fat format (re-save with the current writer)")
    if "content_hash" not in arrays:
        raise NotACheckpoint(f"{path} carries no content hash — refusing to "
                             "serve an unverifiable model")
    return (*_state(path, arrays), _payload(arrays),
            str(arrays["content_hash"]))
