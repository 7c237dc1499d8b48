"""Cross-process file locks (port of ``tsne_flink_tpu/utils/locks.py``).

The serve daemon claims each spooled request with a :class:`FileLock`,
the JAX package's protocol with the same lock-file body, so a port daemon
and a JAX daemon respect each other's claims:

* **acquire** = ``os.open(path, O_CREAT | O_EXCL)``, atomic on every POSIX
  filesystem; the body holds ``pid=<pid>`` and any caller ``payload`` as
  ``key=value`` lines (:func:`read_lock_payload`);
* **stale break** — a holder that died mid-hold leaves its lock behind;
  an acquirer that finds one older than ``stale_s`` (60 s, the JAX
  package's ``TSNE_LOCK_STALE_S`` default) breaks it.  ``stale_fn(path,
  age)`` refines the verdict: True breaks now, False never, None falls
  back to the age rule;
* **bounded wait** — :meth:`FileLock.acquire` polls up to ``timeout_s``
  and then returns False instead of raising.
"""

from __future__ import annotations

import os
import time

from tsne_flink_tpu_torch.obs.trace import walltime

#: default bounded wait of :meth:`FileLock.acquire` (seconds)
DEFAULT_TIMEOUT_S = 5.0
#: age (seconds) past which a lock counts as abandoned
DEFAULT_STALE_S = 60.0


def read_lock_payload(path: str) -> dict:
    """The ``key=value`` lines of a lock file as a dict; empty when the
    lock is gone or torn (both mean "no live claim to honour")."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return {}
    out: dict = {}
    for line in text.splitlines():
        key, sep, val = line.partition("=")
        if sep:
            out[key.strip()] = val.strip()
    return out


class FileLock:
    """One advisory cross-process lock backed by an O_EXCL lock file.

    A ``payload`` adds ``key=value`` lines to the body and makes the lock
    claim-style: :meth:`release` removes only a body that still names this
    pid, so a holder whose claim was broken and taken never deletes the
    new owner's lock."""

    def __init__(self, path: str, stale_s: float = DEFAULT_STALE_S,
                 poll_s: float = 0.02, payload: dict | None = None,
                 stale_fn=None):
        self.path = path
        self.stale_s = float(stale_s)
        self.poll_s = float(poll_s)
        self.payload = dict(payload) if payload else None
        self.stale_fn = stale_fn
        self._held = False

    def _body(self) -> bytes:
        lines = [f"pid={os.getpid()}\n"]
        for key in sorted(self.payload or {}):
            lines.append(f"{key}={self.payload[key]}\n")
        return "".join(lines).encode()

    def _try_once(self) -> bool:
        try:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            # held by another (FileExistsError), or an unwritable root:
            # either way not acquired this time
            return False
        try:
            os.write(fd, self._body())
        finally:
            os.close(fd)
        self._held = True
        return True

    def write_payload(self, extra: dict) -> None:
        """Rewrite the held lock's body with ``extra`` added (the claim
        epoch is stamped after acquisition).  Readers parse line-wise and
        take a torn body as an anonymous claim."""
        if not self._held:
            return
        self.payload = {**(self.payload or {}), **extra}
        try:
            with open(self.path, "wb") as f:
                f.write(self._body())
        except OSError:
            pass  # the body is advisory; the lock file is the lock

    def _break_if_stale(self) -> None:
        try:
            age = walltime() - os.path.getmtime(self.path)
        except OSError:
            return  # released between our attempt and the stat
        verdict = (None if self.stale_fn is None
                   else self.stale_fn(self.path, age))
        if verdict is False:
            return
        if verdict is True or age > self.stale_s:
            try:
                os.remove(self.path)
            except OSError:
                pass  # another waiter broke it first

    def acquire(self, timeout_s: float | None = None) -> bool:
        """True when the lock is held; False after ``timeout_s`` of
        polling (the holder is alive and working)."""
        deadline = walltime() + (DEFAULT_TIMEOUT_S if timeout_s is None
                                  else float(timeout_s))
        while True:
            if self._try_once():
                return True
            self._break_if_stale()
            if walltime() >= deadline:
                return False
            time.sleep(self.poll_s)

    def release(self) -> None:
        if not self._held:
            return
        self._held = False
        if self.payload is not None:
            owner = read_lock_payload(self.path).get("pid")
            if owner is not None and owner != str(os.getpid()):
                return  # broken and re-acquired: the new owner's lock
        try:
            os.remove(self.path)
        except OSError:
            pass  # broken as stale by a waiter: already gone
