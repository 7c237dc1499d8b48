"""B2: exact Student-t repulsion through the hand-written kernel.

Replaces ``tsne_flink_tpu/ops/repulsion_pallas.py::_kernel`` (driven by
``pallas_exact_repulsion``).  The kernel is ``csrc/repulsion.cu``; its
header says what bounds it on an H100 (~9 FP32 operations and one
reciprocal per pair, N² pairs) and how its design fills the card: rows
register-blocked per thread, and the columns split over a second grid
dimension into :func:`column_splits` ranges whose partial rep and Z the
wrapper sums in a fixed order (no atomics, so a run is deterministic).
The partials' slab is rounded up to a multiple of :data:`PART_ROW_MULTIPLE`
rows: on the card PyTorch's sum over the splits takes another order for
a row count whose outputs do not fill its 4-wide vectors, and a mesh
shard's rows must get the bits of the same rows in a launch over all of
them.

:func:`cuda_exact_repulsion` is the wrapper: the plain
``ops/repulsion_exact.exact_repulsion`` on a CPU tensor, the kernel on a
CUDA tensor (or it raises).  Same ``row_offset``/``col_valid``/``row_z``
contract as the JAX function.  Without ``col_valid`` the rows may lie
past ``y_full`` (``row_offset >= len(y_full)``): the serving path's query
rows against a frozen base, where no pair is a self-pair.

Float64 operands launch B2's float64 form (``KERNELS["B2_f64"]``: the
same template at float64, an IEEE reciprocal a pair), with the same
column splits and slab rounding, so a mesh shard keeps its bits at
float64 too.  The wrapper casts nothing: both operands are float32, or
both float64.
"""

from __future__ import annotations

import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.ops.metrics import kernel_float64
from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion

#: rows one block of the kernel owns (128 threads x 4 rows: ROWS in
#: csrc/repulsion.cu)
ROWS_PER_BLOCK = 512
#: columns the kernel stages per tile (TJ there); a split spans at least one
COLS_PER_TILE = 512
#: blocks of 128 threads an SM keeps resident
BLOCKS_PER_SM = 16
#: waves of blocks the column splits aim for
WAVES = 2
#: the widest embedding the kernel takes (the JAX package's MPAD)
M_MAX = 8
#: the partials' slab rows are a multiple of this (see the module text)
PART_ROW_MULTIPLE = 4


def column_splits(nloc: int, nfull: int, sms: int) -> int:
    """S, the column ranges of one launch: enough blocks for ``WAVES``
    waves on ``sms`` SMs, but no range narrower than one tile.  A function
    of the shapes and the card alone, so a run's summation order is fixed."""
    row_blocks = -(-nloc // ROWS_PER_BLOCK)
    want = -(-WAVES * sms * BLOCKS_PER_SM // row_blocks)
    return max(1, min(want, -(-nfull // COLS_PER_TILE)))


def _check_rows(y, y_full, col_valid, row_offset):
    """The row range and the mask, on either device."""
    if row_offset < 0:
        raise ValueError(f"row_offset {row_offset} is negative")
    if col_valid is None:
        return
    if col_valid.shape != (y_full.shape[0],) or col_valid.device != y.device:
        raise ValueError("col_valid must be a [N_full] mask on y's device")
    # each row's own validity is read from the mask
    if row_offset + y.shape[0] > y_full.shape[0]:
        raise ValueError(f"row_offset {row_offset} puts {y.shape[0]} rows "
                         f"outside y_full's {y_full.shape[0]}, where "
                         "col_valid has no entry for them")


def _check_cuda(y, y_full):
    for name, t in (("y", y), ("y_full", y_full)):
        if not t.is_cuda:
            raise TypeError(f"B2 kernel takes CUDA tensors; {name} is on "
                            f"{t.device}")
        kernel_float64(t)
        if t.dtype != y.dtype:
            raise TypeError(f"B2 kernel takes one dtype; y is {y.dtype}, "
                            f"y_full {y_full.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"B2 kernel takes a contiguous [N, m] {name}")
    m = y.shape[1]
    if not 1 <= m <= M_MAX or y_full.shape[1] != m:
        raise ValueError(f"B2 kernel takes 1 <= m <= {M_MAX} on both "
                         f"operands; got {tuple(y.shape)} and "
                         f"{tuple(y_full.shape)}")
    if y.device != y_full.device:
        raise ValueError("y and y_full lie on different devices")


def cuda_exact_repulsion(y: torch.Tensor, y_full: torch.Tensor | None = None,
                         *, row_offset: int = 0,
                         col_valid: torch.Tensor | None = None,
                         row_z: bool = False, row_chunk: int = 2048,
                         split_rows: int | None = None):
    """(rep [len(y), m], Z) — Z summed, or per-row with ``row_z``.

    ``split_rows`` (None: ``len(y)``) is the row count the column-split
    count is computed for.  A row's sums depend on the split count, so a
    sharded optimizer passes the quantum-wide local size
    (``parallel/mesh``: ``n_padded // PAD_QUANTUM``) for every mesh width,
    and a shard's rows get the same bits as in the mesh-1 launch."""
    if y_full is None:
        y_full = y
    _check_rows(y, y_full, col_valid, row_offset)
    if y.device.type == "cpu":
        return exact_repulsion(y, y_full, row_offset=row_offset,
                               col_valid=col_valid, row_chunk=row_chunk,
                               row_z=row_z)
    _check_cuda(y, y_full)
    nloc, m = y.shape
    nfull = y_full.shape[0]
    valid = (None if col_valid is None
             else col_valid.to(torch.uint8).contiguous())
    if not nloc:
        return y.new_zeros((0, m)), (y.new_zeros((0,)) if row_z
                                     else y.new_zeros(()))
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    splits = column_splits(nloc if split_rows is None else split_rows,
                           nfull, sms)
    rows = -(-nloc // PART_ROW_MULTIPLE) * PART_ROW_MULTIPLE
    part = torch.empty((splits, rows, m + 1), device=y.device,
                       dtype=y.dtype)
    kernel = KERNELS["B2_f64"] if kernel_float64(y) else KERNELS["B2"]
    kernel(y.data_ptr(), y_full.data_ptr(),
           None if valid is None else valid.data_ptr(), nloc, nfull, m,
           row_offset, splits, rows, part.data_ptr())
    # a fixed order for a fixed split count (rows past nloc are dropped)
    total = torch.sum(part, dim=0)[:nloc]
    zrow = total[:, m].contiguous()
    return total[:, :m].contiguous(), (zrow if row_z else torch.sum(zrow))
