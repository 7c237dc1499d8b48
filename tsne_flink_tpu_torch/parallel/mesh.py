"""The single-controller point mesh: mesh plans, padding, and the sharded
optimizer (port of ``tsne_flink_tpu/parallel/mesh.py``).

The rows of every per-point array — y, update, gains, the P rows and the
attraction layout — are split over a 1-D mesh of D devices.  One process
drives it: each shard runs the one per-shard program,
``models/tsne.optimize`` with ``axis_name`` set to the shard's
:class:`MeshAxis`, in a Python thread of its own (PyTorch's current
device is per thread).  The JAX package's ``shard_map`` collectives
become the handle's methods:

* ``all_gather`` — the tiled gather of every shard's rows, in shard order,
  onto the caller's device (the gathered y once an iteration, the
  ``[N_padded]`` per-row partials of a mesh-canonical sum);
* ``psum`` / ``pmin`` / ``pmax`` of per-shard scalars, combined in shard
  order.

The shards meet in a :class:`threading.Barrier`, once an exchange.  A
shard publishes its tensor with a CUDA event recorded behind it; the
readers make their stream wait on that event before they copy it.  The
slots alternate between two sets, so a shard that publishes exchange
k + 2 has passed exchange k + 1's barrier, which no shard reaches before
it has queued its reads of exchange k.  An exception in one shard
aborts the barrier, so every other shard ends too, and the caller gets
that exception (a CUDA OOM included: the supervisor's ladder reads it).

N is padded to a multiple of ``lcm(D, PAD_QUANTUM)``; the padded rows carry
``valid=False``, which removes them from Z, the loss and the centering
statistics.  Every mesh width that divides :data:`PAD_QUANTUM` pads to the
same length, and every quantity that enters a row's result is the same on
each of them — the gathered y and its FFT grid, the mesh-canonical sums
(``models/tsne._mesh_sum``), the row-chunk clamp, B2's column-split count
(``split_rows``: the quantum-wide local size), Barnes-Hut's chunk blocks
and the layout decision, taken on global counts — so a D-device run is
bit-identical to the 1-device run.  The portable checkpoint rides on this.

One device (``devices=1``) is the trivial mesh: the same program, run in
the calling thread.  A mesh may list one device several times (the test
mesh: D shards on ``cuda:0``, or on the CPU), as the JAX tests run eight
virtual CPU devices.

The multi-controller job runs the same per-shard program with one
process a shard.  :func:`distributed_init` opens the
``torch.distributed`` process group (``tcp://<coordinator>``, a finite
timeout, :data:`PROCESS_GROUP_TIMEOUT_S`), and a :class:`ProcessAxis`
gives this process's rank the methods of :class:`MeshAxis`.  The backend
follows from the devices, with no flag of its own
(:func:`process_backend`): NCCL when every rank has a CUDA device of its
own (rank r takes ``cuda:(r % device_count)``, all ranks on one host),
gloo otherwise — on the CPU, or two ranks sharing one card, whose CUDA
tensors a collective then stages through host memory (the work stays on
the card).  ``psum``/``pmin``/``pmax`` combine the all-gathered parts in
rank order on every rank, never by ``all_reduce`` (NCCL fixes no order
for its sums), so every rank, thread or process, holds the same bits.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import threading
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from tsne_flink_tpu_torch.models.tsne import TsneConfig, TsneState, optimize

AXIS = "points"

#: canonical row-padding quantum: every mesh pads N to a multiple of
#: ``lcm(devices, PAD_QUANTUM)``, so all widths dividing it (1, 2, 4, 8)
#: run shards of identical shapes and, with the mesh-canonical
#: reductions, identical bits
PAD_QUANTUM = 8

MESH_REDUCE_MODES = ("canonical", "psum")

#: seconds a rank of a multi-controller job waits in a collective for its
#: peers: a rank that raises ends (its peers' next collective then fails
#: at once on the closed connection, or after this timeout), so no job
#: hangs
PROCESS_GROUP_TIMEOUT_S = 300.0

#: callables ``(kind, axis, x)`` told of every collective a shard issues
#: (``analysis/audit/record``'s hook); empty, at no cost, otherwise
COLLECTIVE_HOOKS: list = []
#: context factories ``(shard index) -> context manager`` each shard
#: thread enters around its work (the recorder's per-thread dispatch
#: mode: PyTorch's modes are per thread); empty otherwise
SHARD_CONTEXTS: list = []


def _note(kind: str, axis, x) -> None:
    for hook in COLLECTIVE_HOOKS:
        hook(kind, axis, x)


class CollectiveMismatch(RuntimeError):
    """A shard issued a collective after another shard had ended: the
    shards' sequences of collectives differ."""


def padded_rows_for(n: int, n_devices: int) -> int:
    """The canonical padded row count for ``n`` points on an
    ``n_devices``-wide mesh (see :data:`PAD_QUANTUM`)."""
    q = math.lcm(max(1, int(n_devices)), PAD_QUANTUM)
    return math.ceil(n / q) * q


def visible_devices() -> int:
    """The CUDA devices this process sees (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@dataclass(frozen=True)
class MeshPlan:
    """One mesh choice, statically described.  ``devices=None`` means all
    visible devices (one on a machine without a card); ``devices=1`` is
    the trivial mesh.  Threads from the CLI (``--mesh``) and the estimator
    (``TSNE(mesh=...)``) into the sharded optimizer, and stamps records
    via :meth:`as_record`."""

    devices: int | None = None

    def n_devices(self) -> int:
        if self.devices is not None:
            return int(self.devices)
        return max(1, visible_devices())

    def n_padded(self, n: int) -> int:
        return padded_rows_for(n, self.n_devices())

    def n_local(self, n: int) -> int:
        return self.n_padded(n) // self.n_devices()

    def as_record(self) -> dict:
        """JSON-safe identity for records and cache keys."""
        return {"devices": self.n_devices(), "axis": AXIS,
                "pad_quantum": PAD_QUANTUM}


def make_mesh(devices=None, device=None) -> list[torch.device]:
    """The mesh's devices, one a shard.

    ``devices`` is a width N, None (all visible devices), or an explicit
    list of devices, where a device may repeat (the test mesh).  On a CPU
    ``device`` a width N is N shards on the CPU; on the card it is the N
    first CUDA devices, and a width past the visible count raises, naming
    it."""
    if isinstance(devices, (list, tuple)):
        mesh = [torch.device(d) for d in devices]
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        if any(d.type == "cuda" for d in mesh):
            if not torch.cuda.is_available():
                raise RuntimeError("the mesh lists CUDA devices and no card "
                                   "is available")
            # a shard thread makes its device current: it needs an index
            mesh = [torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d
                    for d in mesh]
        return mesh
    base = torch.device("cuda" if device is None else device)
    if base.type == "cpu":
        return [base] * (1 if devices is None else int(devices))
    if base.type != "cuda":
        raise ValueError(f"unsupported device '{base}' (cuda | cpu)")
    visible = visible_devices()
    want = visible if devices is None else int(devices)
    if want < 1:
        raise ValueError(f"mesh width {want} must be >= 1")
    if want > visible:
        raise ValueError(
            f"a mesh of {want} devices needs {want} CUDA devices and "
            f"{visible} {'is' if visible == 1 else 'are'} visible; on one "
            "card, list the device once a shard (the test mesh, "
            "devices=['cuda:0'] * D)")
    return [torch.device("cuda", i) for i in range(want)]


def rank_device(process_id: int, device=None) -> torch.device:
    """The device of rank ``process_id``: ``cuda:(process_id %
    device_count)`` on the card (every rank on one host), the CPU for
    ``device="cpu"``."""
    base = torch.device("cuda" if device is None else device)
    if base.type == "cpu":
        return base
    if base.type != "cuda":
        raise ValueError(f"unsupported device '{base}' (cuda | cpu)")
    count = visible_devices()
    if count == 0:
        raise RuntimeError("a rank on the card needs a CUDA device and none "
                           "is visible; pass device='cpu' for a CPU job")
    return torch.device("cuda", int(process_id) % count)


def process_backend(device: torch.device, num_processes: int) -> str:
    """The process group's backend: ``nccl`` when every rank has a CUDA
    device of its own (``device_count >= num_processes``), else ``gloo``
    (the CPU, or ranks sharing a card, whose collectives then stage
    their CUDA tensors through host memory; NCCL refuses two ranks on one
    device)."""
    device = torch.device(device)
    if device.type == "cuda" and visible_devices() >= int(num_processes):
        return "nccl"
    return "gloo"


def distributed_init(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device=None,
                     timeout_s: float = PROCESS_GROUP_TIMEOUT_S):
    """Multi-process bring-up: open the ``torch.distributed`` process group
    of ``num_processes`` ranks at ``tcp://<coordinator>`` (``host:port``)
    as rank ``process_id``, with the backend of :func:`process_backend`
    and a collective timeout of ``timeout_s``, and make the rank's device
    current.  Returns the rank's device; does nothing (returns None) for
    ``num_processes`` <= 1, as the JAX function."""
    if num_processes is None or int(num_processes) <= 1:
        return None
    import torch.distributed as dist
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        process_backend(dev, num_processes),
        init_method=f"tcp://{coordinator}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def group_size() -> int:
    """The ranks of the open process group (1 with none)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def close_group() -> None:
    """Close this process's process group, if one is open."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def pad_rows(a: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    """``a`` with ``n_pad`` rows of ``fill`` appended."""
    if n_pad == 0:
        return a
    return torch.cat([a, a.new_full((n_pad,) + tuple(a.shape[1:]), fill)])


# ---- the collectives -------------------------------------------------------

class _Rendezvous:
    """Where the D shard threads of one segment meet."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size)
        self._slots = ([None] * self.size, [None] * self.size)
        self._count = [0] * self.size  # each shard's exchanges so far
        # a shard that ends while another has entered an exchange it will
        # never join breaks the barrier, so shards whose collectives
        # differ raise instead of hanging
        self._state = threading.Lock()
        self._done: set = set()

    def abort(self) -> None:
        self._barrier.abort()

    def depart(self, rank: int) -> None:
        """Shard ``rank`` has ended after its exchanges: a shard that has
        entered a later exchange can no longer meet all the others."""
        with self._state:
            self._done.add(rank)
            stranded = max(self._count) > self._count[rank]
        if stranded:
            self._barrier.abort()

    def _check_ended(self, rank: int) -> None:
        """Raise :class:`CollectiveMismatch` when a shard has ended with
        fewer exchanges than ``rank`` has entered."""
        with self._state:
            ended = sorted(d for d in self._done
                           if self._count[d] < self._count[rank])
        if ended:
            self._barrier.abort()
            raise CollectiveMismatch(
                f"shard {rank} issued exchange {self._count[rank]} after "
                f"shard(s) {ended} had ended with fewer")

    def exchange(self, rank: int, t: torch.Tensor) -> list:
        """Every shard's ``t``, in shard order, on shard ``rank``'s
        device."""
        if self.size == 1:
            return [t]
        ev = None
        if t.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
        with self._state:
            slots = self._slots[self._count[rank] % 2]
            self._count[rank] += 1
        slots[rank] = (t, ev)
        self._check_ended(rank)
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            self._check_ended(rank)
            raise
        dev = self.devices[rank]
        parts = []
        for src, src_ev in slots:
            if src_ev is not None and dev.type == "cuda":
                torch.cuda.current_stream(dev).wait_event(src_ev)
            parts.append(src.to(dev))
        return parts


class MeshAxis:
    """One shard's collectives handle: what ``models/tsne.optimize`` takes
    as ``axis_name`` under a mesh.  ``mesh_reduce`` selects
    ``models/tsne._mesh_sum``'s route; ``split_rows`` is the quantum-wide
    local size that B2's split count and Barnes-Hut's chunk blocks are
    computed for."""

    def __init__(self, rendezvous: _Rendezvous, index: int, *,
                 mesh_reduce: str = "canonical", split_rows: int = 1):
        self._rv = rendezvous
        self.index = index
        self.size = rendezvous.size
        self.device = rendezvous.devices[index]
        self.mesh_reduce = mesh_reduce
        self.split_rows = split_rows

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's rows, concatenated in shard order (tiled)."""
        _note("all_gather", self, x)
        parts = self._rv.exchange(self.index, x)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _stacked(self, x):
        return torch.stack(self._rv.exchange(self.index, x))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        _note("psum", self, x)
        return torch.sum(self._stacked(x), dim=0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        _note("pmax", self, x)
        return torch.amax(self._stacked(x), dim=0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        _note("pmin", self, x)
        return torch.amin(self._stacked(x), dim=0)

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        """The next shard's ``x`` (a ring step: every shard sends its
        tensor to the one before it)."""
        _note("ppermute", self, x)
        parts = self._rv.exchange(self.index, x)
        return parts[(self.index + 1) % self.size]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [size, ...]: row r goes to shard r; returns [size, ...]
        whose row r came from shard r (the JAX ``all_to_all`` with split
        and concat axis 0, tiled)."""
        _note("all_to_all", self, x)
        parts = self._rv.exchange(self.index, x)
        return torch.stack([p[self.index] for p in parts])


class ProcessAxis:
    """This process's rank of the ``torch.distributed`` process group as a
    mesh axis: :class:`MeshAxis`'s methods over the group's collectives.
    Every shard's tensor has one shape (equal shards).  Under gloo a CUDA
    tensor is staged through host memory for the collective and its
    result copied back to ``device``."""

    def __init__(self, device=None, *, group=None,
                 mesh_reduce: str = "canonical", split_rows: int = 1):
        import torch.distributed as dist
        self.group = group
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = (rank_device(self.index) if device is None
                       else torch.device(device))
        self.backend = str(dist.get_backend(group))
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.mesh_reduce = mesh_reduce
        self.split_rows = split_rows

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu().contiguous() if self.staged else t.contiguous()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def _parts(self, x: torch.Tensor) -> list:
        # a group of one rank still runs its collectives (the NCCL route
        # on a one-GPU machine)
        import torch.distributed as dist
        h = self._out(x.reshape(1) if x.dim() == 0 else x)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather(parts, h, group=self.group)
        return [self._back(p).reshape(x.shape) for p in parts]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        _note("all_gather", self, x)
        parts = self._parts(x)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        _note("psum", self, x)
        return torch.sum(torch.stack(self._parts(x)), dim=0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        _note("pmax", self, x)
        return torch.amax(torch.stack(self._parts(x)), dim=0)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        _note("pmin", self, x)
        return torch.amin(torch.stack(self._parts(x)), dim=0)

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        _note("ppermute", self, x)
        if self.size == 1:
            return x
        import torch.distributed as dist
        h = self._out(x)
        got = torch.empty_like(h)
        ops = [dist.P2POp(dist.isend, h, (self.index - 1) % self.size,
                          group=self.group),
               dist.P2POp(dist.irecv, got, (self.index + 1) % self.size,
                          group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(got)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        _note("all_to_all", self, x)
        import torch.distributed as dist
        h = self._out(x)
        got = torch.empty_like(h)
        dist.all_to_all_single(got, h, group=self.group)
        return self._back(got)


def process_axis(device=None) -> ProcessAxis | None:
    """This process's :class:`ProcessAxis` when a process group is open
    (of any size: the NCCL route runs at world size 1 too), else None."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return ProcessAxis(device)


def _shard_context(index: int):
    """The :data:`SHARD_CONTEXTS` of shard ``index``, entered together."""
    stack = contextlib.ExitStack()
    for make in SHARD_CONTEXTS:
        stack.enter_context(make(index))
    return stack


def run_shards(devices, fn, *, mesh_reduce: str = "canonical",
               split_rows: int = 1) -> list:
    """``[fn(axis) for each shard]``: one thread a shard (the calling
    thread for a one-device mesh), each with its device current.  The
    first exception a shard raises aborts the others' barrier and is
    raised here once every thread has ended."""
    rv = _Rendezvous(devices)
    axes = [MeshAxis(rv, r, mesh_reduce=mesh_reduce, split_rows=split_rows)
            for r in range(rv.size)]
    if rv.size == 1:
        with _shard_context(0):
            return [fn(axes[0])]
    results = [None] * rv.size
    errors: list = []
    lock = threading.Lock()

    def work(r):
        try:
            if rv.devices[r].type == "cuda":
                torch.cuda.set_device(rv.devices[r])
            with _shard_context(r):
                results[r] = fn(axes[r])
            rv.depart(r)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            with lock:
                errors.append(e)
            rv.abort()

    threads = [threading.Thread(target=work, args=(r,), daemon=True,
                                name=f"mesh-shard-{r}")
               for r in range(rv.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return results


# ---- the sharded optimizer --------------------------------------------------

class _Shard(NamedTuple):
    """One shard's inputs to ``optimize``, on its device."""

    jidx: torch.Tensor | None
    jval: torch.Tensor | None
    valid: torch.Tensor
    edges: tuple | None
    edges_extra: bool
    csr: tuple | None


class ShardedOptimizer:
    """``models/tsne.optimize`` over a 1-D point mesh.  One device is the
    trivial mesh: the identical program, so a D-device run gives the
    1-device run's bits for widths sharing the padding quantum.

    ``n_devices`` (or ``mesh``, a :class:`MeshPlan`) is the width, resolved
    by :func:`make_mesh` on ``device``; ``devices`` an explicit device
    list instead (the test mesh).  ``mesh_reduce`` is the global sums'
    route (``canonical`` | ``psum``); ``fused_step`` as ``optimize``'s.

    Call it as the JAX class: ``(state, losses) = opt(state, jidx, jval,
    ...)`` runs iterations [start_iter, cfg.iterations) in segments
    through ``runtime/segments.run_segments`` (checkpoints with the
    unpadded state, the sentinel's rollback, telemetry, the autopilot
    pair).  The supervisor and the command line drive it the same way:
    :meth:`shard_inputs` once, then :meth:`segment` a segment.

    ``axis`` (a :class:`ProcessAxis`) makes it one rank of the
    multi-controller job: this process runs its own shard and the
    segments meet through the process group; every rank holds the
    (tiny) global state between segments.  The JAX class's
    multi-controller call is ``pre_padded_valid`` (the padded rows'
    mask), ``unpad=False`` (return the padded state) and ``edge_pad``
    (the measured per-shard edge count): the layout is then the rows or
    the flat edge list assembled on each shard (:meth:`shard_local`),
    in-process on a thread mesh alike, so a job's ranks give the same
    bits as threads or processes.
    """

    def __init__(self, cfg: TsneConfig, n: int, n_devices: int | None = None,
                 *, mesh: MeshPlan | None = None, devices=None, device=None,
                 axis: ProcessAxis | None = None,
                 mesh_reduce: str = "canonical", fused_step=None):
        if mesh_reduce not in MESH_REDUCE_MODES:
            raise ValueError(f"mesh_reduce '{mesh_reduce}' not defined "
                             f"({' | '.join(MESH_REDUCE_MODES)})")
        self.n = int(n)
        if axis is not None:
            self.devices = [axis.device]
            self.plan = MeshPlan(devices=axis.size)
        elif devices is not None:
            self.devices = make_mesh(list(devices))
            self.plan = MeshPlan(devices=len(self.devices))
        else:
            self.plan = mesh if mesh is not None else MeshPlan(n_devices)
            self.devices = make_mesh(self.plan.devices, device)
        self.n_devices = axis.size if axis is not None else len(self.devices)
        self.n_padded = padded_rows_for(self.n, self.n_devices)
        self.n_local = self.n_padded // self.n_devices
        #: the quantum-wide local size (B2's split rows, BH's chunk block)
        self.split_rows = max(1, self.n_padded // PAD_QUANTUM)
        self.mesh_reduce = mesh_reduce
        self.axis = (None if axis is None else ProcessAxis(
            axis.device, group=axis.group, mesh_reduce=mesh_reduce,
            split_rows=self.split_rows))
        self.fused_step = fused_step
        self.cfg = self.clamp(cfg)
        self._shards: list | None = None
        #: the telemetry trace of the last ``__call__(telemetry=True)``
        #: (host numpy ``[n_slots, 5]``)
        self.telemetry_ = None
        #: the autopilot pair of the last ``cfg.autopilot`` run (host
        #: numpy), refreshed before each checkpoint callback
        self.pilot_ = None

    def clamp(self, cfg: TsneConfig) -> TsneConfig:
        """``cfg`` with ``row_chunk`` clamped to the quantum-wide local
        size: a row tile's row count must be the same on every width (the
        plain versions' [c, N] tiles)."""
        if cfg.row_chunk > self.split_rows:
            return replace(cfg, row_chunk=self.split_rows)
        return cfg

    # ---- host planning (the JAX class's methods) --------------------------

    def _padded(self, a, fill=0):
        a = torch.as_tensor(a)
        return (a if a.shape[0] == self.n_padded
                else pad_rows(a, self.n_padded - a.shape[0], fill))

    def attraction_plan(self, jidx, jval):
        """``(layout, launched_pairs, param)`` of the attraction layout this
        optimizer launches for the (padded or unpadded) global rows:
        ``layout`` in rows | edges | csr and ``param`` the per-shard edge
        padding (edges), the head width W (csr) or 0.  The decision is
        taken on global counts, so every width takes the same layout."""
        from tsne_flink_tpu_torch.ops.affinities import (edge_count,
                                                         edges_beneficial,
                                                         plan_edges)
        from tsne_flink_tpu_torch.ops.attraction_cuda import (csr_tail_pad,
                                                              pick_csr_width)
        mode = self.cfg.attraction
        jidx, jval = self._padded(jidx), self._padded(jval)
        s = int(jidx.shape[1])
        if mode == "rows":
            return "rows", self.n_padded * s, 0
        e_global = int(edge_count(jval, multiple=1024))
        if mode in ("auto", "csr") and (
                mode == "csr" or edges_beneficial(e_global, self.n_padded, s)):
            w = pick_csr_width(e_global, self.n_padded, s)
            deg = torch.sum(jval > 0, dim=1)
            tail = int(torch.sum(torch.clamp(deg - w, min=0)))
            return "csr", self.n_padded * w + csr_tail_pad(tail), w
        if mode == "auto":
            return "rows", self.n_padded * s, 0
        nl = self.n_local
        e_local = max(plan_edges(jidx[d * nl:(d + 1) * nl],
                                 jval[d * nl:(d + 1) * nl], "edges")[1]
                      for d in range(self.n_devices))
        return "edges", e_local * self.n_devices, e_local

    def _build_edges(self, jidx, jval):
        """Per-shard flat edge lists with LOCAL row ids, of equal length,
        concatenated in shard order; None unless the plan picks the
        (explicitly requested) edge layout."""
        from tsne_flink_tpu_torch.ops.affinities import assemble_edges
        layout, _, e_pad = self.attraction_plan(jidx, jval)
        if layout != "edges":
            return None
        jidx, jval = self._padded(jidx), self._padded(jval)
        nl = self.n_local
        parts = [assemble_edges(jidx[d * nl:(d + 1) * nl],
                                jval[d * nl:(d + 1) * nl], e_pad)
                 for d in range(self.n_devices)]
        return tuple(torch.cat([p[c] for p in parts]) for c in range(3))

    def _build_csr(self, jidx, jval):
        """The CSR layout of the padded rows: the ``[N_padded, W]`` head
        (split by rows as it is) and the overflow tail re-sliced into
        equal-length per-shard LOCAL blocks (:meth:`_shard_reverse_block`);
        ``ops/attraction_cuda.build_csr`` runs on the rows' device.  None
        when the plan picks another layout."""
        layout, _, w = self.attraction_plan(jidx, jval)
        if layout != "csr":
            return None
        from tsne_flink_tpu_torch.ops.attraction_cuda import build_csr
        (hidx, hval), tail = build_csr(self._padded(jidx), self._padded(jval),
                                       w)
        return (hidx, hval) + self._shard_reverse_block(tail)

    def blocks_plan(self, jidx, extra_edges) -> int:
        """Launched attraction pairs of the blocks layout: the forward
        block's rows x k plus the re-padded per-shard reverse blocks."""
        s = int(jidx.shape[1])
        shards = self._shard_reverse_block(extra_edges)
        return self.n_padded * s + int(shards[0].shape[0])

    def _shard_reverse_block(self, extra_edges):
        """A src-sorted global edge list (the blocks layout's reverse
        block, a CSR tail) -> equal-length per-shard blocks with LOCAL
        sources, concatenated in shard order.  Pad entries are
        ``(n_local - 1, 0, 0)``: no force, no loss, and each block's
        sources stay ascending.  The length is the largest shard's count
        rounded up to 1,024 (at least 1,024).  Tensor code on the list's
        device, one host read of the counts."""
        rsrc, rdst, rval = (torch.as_tensor(a) for a in extra_edges)
        nl, d_ = self.n_local, self.n_devices
        bounds = torch.searchsorted(
            rsrc, torch.arange(0, self.n_padded + 1, nl, dtype=rsrc.dtype,
                               device=rsrc.device)).tolist()
        keep_all = rval > 0  # the global padding re-pads per shard
        csum = torch.zeros(keep_all.shape[0] + 1, dtype=torch.int64,
                           device=rsrc.device)
        torch.cumsum(keep_all, 0, out=csum[1:])
        edge = csum[bounds].tolist()
        counts = [edge[d + 1] - edge[d] for d in range(d_)]
        e_max = max(1024, (max(counts) + 1023) // 1024 * 1024)
        src = torch.full((d_, e_max), nl - 1, dtype=torch.int32,
                         device=rsrc.device)
        dst = torch.zeros((d_, e_max), dtype=torch.int32, device=rsrc.device)
        val = torch.zeros((d_, e_max), dtype=rval.dtype, device=rsrc.device)
        for d in range(d_):
            seg = slice(bounds[d], bounds[d + 1])
            keep = keep_all[seg]
            c = counts[d]
            src[d, :c] = rsrc[seg][keep] - d * nl
            dst[d, :c] = rdst[seg][keep]
            val[d, :c] = rval[seg][keep]
        return src.reshape(-1), dst.reshape(-1), val.reshape(-1)

    def _pad_inputs(self, state: TsneState, jidx, jval):
        """``(state, jidx, jval, valid)`` padded to ``n_padded`` rows: y
        and update with zeros, gains with ones, P with zeros; ``valid``
        the real rows."""
        npad = self.n_padded - self.n
        state = TsneState(y=pad_rows(state.y, npad),
                          update=pad_rows(state.update, npad),
                          gains=pad_rows(state.gains, npad, fill=1.0))
        dev = state.y.device
        valid = torch.arange(self.n_padded, device=dev) < self.n
        jidx = None if jidx is None else self._padded(jidx)
        jval = None if jval is None else self._padded(jval)
        return state, jidx, jval, valid

    def _unpad(self, state: TsneState) -> TsneState:
        return TsneState(*(t[:self.n] for t in state))

    def shard_inputs(self, jidx, jval, extra_edges=None) -> None:
        """Plan the attraction layout of the global rows (or shard the
        blocks layout's reverse block ``extra_edges``, beside the forward
        rows ``jidx``/``jval``) and place each shard's rows on its device,
        once a run."""
        jidx, jval = torch.as_tensor(jidx), torch.as_tensor(jval)
        edges = csr = None
        if extra_edges is not None:
            edges = self._shard_reverse_block(extra_edges)
        else:
            csr = self._build_csr(jidx, jval)
            if csr is None:
                edges = self._build_edges(jidx, jval)
        jidx_p, jval_p = self._padded(jidx), self._padded(jval)
        valid = torch.arange(self.n_padded, device=jidx.device) < self.n
        nl = self.n_local

        def part(t, d, length=nl):
            return t[d * length:(d + 1) * length].to(self.devices[d])

        shards = []
        for d in range(self.n_devices):
            e_sh = (None if edges is None else
                    tuple(part(a, d, a.shape[0] // self.n_devices)
                          for a in edges))
            c_sh = None
            if csr is not None:
                c_sh = ((part(csr[0], d), part(csr[1], d))
                        + tuple(part(a, d, a.shape[0] // self.n_devices)
                                for a in csr[2:]))
            rows = (csr is None and (extra_edges is not None
                                     or edges is None))
            shards.append(_Shard(
                jidx=part(jidx_p, d) if rows else None,
                jval=part(jval_p, d) if rows else None,
                valid=part(valid, d), edges=e_sh,
                edges_extra=extra_edges is not None, csr=c_sh))
        self._shards = shards

    def prepadded_layout(self, s: int, edge_pad) -> str:
        """The layout of a pre-padded (multi-controller) run, the JAX
        class's rule on global counts: the flat edge list when
        ``edge_pad`` (the largest shard's edge count) is given and the
        mode asks for it or :func:`edges_beneficial` holds on a shard's
        rows, else the rows (the CSR layout needs the global rows' tail,
        which no rank holds)."""
        from tsne_flink_tpu_torch.ops.affinities import edges_beneficial
        mode = self.cfg.attraction
        if (mode != "rows" and edge_pad and self.n_local * s < 2 ** 31
                and (mode == "edges"
                     or edges_beneficial(edge_pad, self.n_local, s))):
            return "edges"
        if mode == "edges":
            import sys
            print("WARNING: attraction='edges' needs the measured edge_pad "
                  "in multi-controller runs (none given, or the per-shard "
                  "conversion would overflow int32 slots); running the rows "
                  "layout", file=sys.stderr)
        return "rows"

    def shard_local(self, jidx, jval, valid, edge_pad=None) -> None:
        """Place pre-padded P rows: on a thread mesh the padded global rows
        ``[n_padded, S]``; under a process axis this rank's
        ``[n_local, S]`` (or the global rows, sliced).  ``valid`` is the
        padded rows' mask ``[n_padded]``.  The layout is
        :meth:`prepadded_layout`'s, the flat edge list assembled from each
        shard's own rows with ``edge_pad`` slots."""
        from tsne_flink_tpu_torch.ops.affinities import assemble_edges
        jidx, jval = torch.as_tensor(jidx), torch.as_tensor(jval)
        valid = torch.as_tensor(valid)
        layout = self.prepadded_layout(int(jidx.shape[1]), edge_pad)
        nl = self.n_local
        ranks = ([self.axis.index] if self.axis is not None
                 else range(self.n_devices))
        shards = []
        for i, r in enumerate(ranks):
            dev = self.devices[i]
            rows = (slice(0, nl) if jidx.shape[0] == nl
                    and self.axis is not None else slice(r * nl,
                                                         (r + 1) * nl))
            ji, jv = jidx[rows].to(dev), jval[rows].to(dev)
            va = valid[r * nl:(r + 1) * nl].to(dev)
            if layout == "edges":
                shards.append(_Shard(None, None, va,
                                     assemble_edges(ji, jv, int(edge_pad)),
                                     False, None))
            else:
                shards.append(_Shard(ji, jv, va, None, False, None))
        self._shards = shards

    @property
    def layout(self) -> str:
        """The armed layout: csr | edges | rows | blocks (after
        :meth:`shard_inputs`)."""
        sh = self._shards[0]
        return ("csr" if sh.csr is not None else "blocks" if sh.edges_extra
                else "edges" if sh.edges is not None else "rows")

    # ---- running ------------------------------------------------------------

    def segment(self, state: TsneState, cfg: TsneConfig, *,
                start_iter: int, num_iters: int, loss_carry=None,
                with_health: bool = False, with_telemetry: bool = False,
                telemetry_carry=None, pilot_carry=None):
        """One segment over every shard: ``optimize``'s return tuple, with
        the unpadded state gathered onto the first shard's device and the
        replicated values taken from shard 0.  ``state`` is unpadded; its
        padded rows start each segment at the origin (no valid row reads
        them)."""
        if self._shards is None:
            raise RuntimeError("shard_inputs() first: the sharded optimizer "
                               "has no rows")
        cfg = self.clamp(cfg)
        padded = self._pad_inputs(state, None, None)[0]
        nl = self.n_local

        def on(dev, a):
            return None if a is None else torch.as_tensor(a).to(dev)

        def shard_fn(axis):
            r, dev = axis.index, axis.device
            sh = self._shards[0 if self.axis is not None else r]
            st = TsneState(*(t[r * nl:(r + 1) * nl].to(dev) for t in padded))
            pilot = (None if pilot_carry is None
                     else tuple(on(dev, p) for p in pilot_carry))
            return optimize(st, sh.jidx, sh.jval, cfg, axis_name=axis,
                            row_offset=r * nl, valid=sh.valid,
                            start_iter=start_iter, num_iters=num_iters,
                            loss_carry=on(dev, loss_carry), edges=sh.edges,
                            edges_extra=sh.edges_extra, csr=sh.csr,
                            fused_step=self.fused_step,
                            with_health=with_health,
                            with_telemetry=with_telemetry,
                            telemetry_carry=on(dev, telemetry_carry),
                            pilot_carry=pilot)

        if self.axis is not None:
            out = shard_fn(self.axis)
            st = TsneState(*(self.axis.all_gather(t) for t in out[0]))
            return (self._unpad(st),) + tuple(out[1:])
        outs = run_shards(self.devices, shard_fn,
                          mesh_reduce=self.mesh_reduce,
                          split_rows=self.split_rows)
        home = self.devices[0]
        st = TsneState(*(torch.cat([o[0][f].to(home) for o in outs])
                         for f in range(3)))
        return (self._unpad(st),) + tuple(outs[0][1:])

    def __call__(self, state: TsneState, jidx, jval, *, start_iter: int = 0,
                 loss_carry=None, checkpoint_every: int = 0,
                 checkpoint_cb=None, extra_edges=None,
                 pre_padded_valid=None, unpad: bool = True,
                 edge_pad: int | None = None,
                 health_check: bool = False, health_retries: int = 3,
                 events: list | None = None, telemetry: bool = False,
                 telemetry_carry=None, pilot_carry=None):
        """Run iterations [start_iter, cfg.iterations); with
        ``checkpoint_every`` and ``checkpoint_cb``,
        ``checkpoint_cb(state, next_iter, losses)`` fires at each segment
        boundary but the last with the UNPADDED state (the padded one with
        ``unpad=False``).  Returns ``(state, losses)``; a sentinel
        rollback halves ``self.cfg``'s eta as in the JAX class.
        ``pre_padded_valid``/``edge_pad`` take the multi-controller
        layout (:meth:`shard_local`); ``state`` may then be padded (its
        padded rows restart at the origin each segment, as always)."""
        from tsne_flink_tpu_torch.runtime.segments import run_segments
        if pre_padded_valid is not None:
            if extra_edges is not None:
                raise NotImplementedError(
                    "split-blocks attraction is single-controller: no rank "
                    "holds the global reverse block")
            self.shard_local(jidx, jval, pre_padded_valid, edge_pad)
            state = TsneState(*(t[:self.n] for t in state))
        else:
            if self.axis is not None:
                raise ValueError("a rank of a multi-controller job takes "
                                 "pre-padded P rows (pre_padded_valid)")
            self.shard_inputs(jidx, jval, extra_edges)
        every = (checkpoint_every if checkpoint_every and checkpoint_cb
                 is not None else 0)

        def out(st):
            return st if unpad else self._pad_inputs(st, None, None)[0]

        def boundary(st, next_iter, losses, pilot):
            if pilot is not None:
                self.pilot_ = tuple(p.cpu().numpy() for p in pilot)
            checkpoint_cb(out(st), next_iter, losses)

        run = run_segments(state, None, None, self.cfg,
                           start_iter=start_iter, every=every,
                           loss_carry=loss_carry, health_check=health_check,
                           health_retries=health_retries, events=events,
                           telemetry=telemetry,
                           telemetry_carry=telemetry_carry,
                           pilot_carry=pilot_carry,
                           on_boundary=boundary if every else None,
                           runner=self)
        self.cfg = self.clamp(run.cfg)
        if run.telemetry is not None:
            self.telemetry_ = run.telemetry.cpu().numpy()
        if run.pilot is not None:
            self.pilot_ = tuple(np.asarray(p.cpu()) for p in run.pilot)
        return out(run.state), run.losses


def shard_pipeline(cfg: TsneConfig, n: int, n_devices: int | None = None,
                   **kw) -> ShardedOptimizer:
    return ShardedOptimizer(cfg, n, n_devices, **kw)
