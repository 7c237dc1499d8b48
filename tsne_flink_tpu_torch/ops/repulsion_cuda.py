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

The register-blocked instances take m = 1 .. :data:`M_NARROW`; a wider
embedding launches the wide form, which takes any m: at float32
``KERNELS["B2w"]`` (d² once a pair: up to m = 16 two rows a thread in
registers, a pair's differences giving its d² and its force; past it
tiles of 4,096 pairs, the force from the tile's q² held on chip;
:func:`wide_rows` rows a block), at float64 ``KERNELS["B2w_f64"]`` (d²
once a pair too: up to m = 16 a row a thread in registers, its
differences giving d² and the force; past it tiles of 32 rows x 32
columns, the force in product form from the tile's q² held on chip, its
Σq²·y_j on the FP64 tensor cores).
Its column splits (:func:`column_splits` with ``m``) and the slab's
rounding follow the same rule, so a shard keeps its bits there too.
"""

from __future__ import annotations

import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS, M_NARROW, form_id
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
#: rows one block of the float64 wide form owns, by its width class
#: (:func:`wide_class64`): 128 threads x 1 row at m <= 16, a tile's 32 rows
#: past it (RT64 and TR64 in csrc/repulsion.cu;
#: :func:`kernel_wide_config` reads the kernel's own)
WIDE64_ROWS = {16: 128, 64: 32}
#: the float64 wide form's blocks the split rule counts an SM to hold, by
#: its width class: a heuristic, not the occupancy (3 blocks of each are
#: resident, ``__launch_bounds__(128, 3)``): at m <= 16 counting 4 gives
#: 60,000 rows 3 column splits, 3.55 waves of blocks rather than 2 splits'
#: 2.37, whose last wave would leave most of the card idle.  The split
#: count, and so a row's bits, follow from it: changing it changes every
#: wide run's bits.
WIDE64_BLOCKS_PER_SM = {16: 4, 64: 3}
#: pairs a tile of the float32 wide form past m = 16 (TPAIRS in
#: csrc/repulsion.cu): a block owns TILE_PAIRS / :func:`wide_class` rows;
#: at m <= 16 a block owns 256 rows too (128 threads x 2 rows)
TILE_PAIRS = 4096
#: the float32 wide form's blocks the split rule counts an SM to hold: 4
#: of the m <= 16 path (``__launch_bounds__(128, 4)``), 2 of the tiles
#: (``__launch_bounds__(256, 2)``)
TILE_BLOCKS_PER_SM = {16: 4, 32: 2, 64: 2}
#: the partials' slab rows are a multiple of this (see the module text)
PART_ROW_MULTIPLE = 4


def wide_class(m: int) -> int:
    """The float32 wide form's width class (``wide_class`` in
    csrc/repulsion.cu): 16, 32 or 64 (64 past it too: the width walked in
    blocks of 64 dims)."""
    return 16 if m <= 16 else 32 if m <= 32 else 64


def wide_class64(m: int) -> int:
    """The float64 wide form's width class (``wide_class64`` in
    csrc/repulsion.cu): 16 (rows in registers) or 64 (tiles; past it the
    width walked in blocks of 64 dims)."""
    return 16 if m <= 16 else 64


def wide_rows(m: int, float64: bool) -> int:
    """Rows one block of the wide form owns at width ``m``:
    :data:`WIDE64_ROWS` at float64 (128 or 32), :data:`TILE_PAIRS` /
    :func:`wide_class` at float32 (256, 128 or 64)."""
    return (WIDE64_ROWS[wide_class64(m)] if float64
            else TILE_PAIRS // wide_class(m))


def wide_chunk(m: int, float64: bool) -> int:
    """The dims the wide form's force takes at once: its width class
    (:func:`wide_class64` at float64, :func:`wide_class` at float32)."""
    return wide_class64(m) if float64 else wide_class(m)


def kernel_wide_config(m: int, float64: bool) -> tuple[int, int, int]:
    """``(M_NARROW, rows a block, dims the force takes at once)`` of the
    wide form at width ``m`` as the kernel library states them
    (``tsne_repulsion_wide_config``; builds the library): what
    :data:`M_NARROW`, :func:`wide_rows` and :func:`wide_chunk` mirror for
    the memory model on any device."""
    import ctypes
    from tsne_flink_tpu_torch.kernels.build import library
    rows, chunk = ctypes.c_int(), ctypes.c_int()
    narrow = library().tsne_repulsion_wide_config(
        m, int(float64), ctypes.byref(rows), ctypes.byref(chunk))
    return narrow, rows.value, chunk.value


def column_splits(nloc: int, nfull: int, sms: int, m: int,
                  float64: bool) -> int:
    """S, the column ranges of one launch: enough blocks for ``WAVES``
    waves on ``sms`` SMs, but no range narrower than one tile.  A function
    of the shapes, the width, the dtype and the card alone, so a run's
    summation order is fixed.  Past :data:`M_NARROW` the wide form's
    blocks: :func:`wide_rows` rows each."""
    if m <= M_NARROW:
        row_blocks = -(-nloc // ROWS_PER_BLOCK)
        want = -(-WAVES * sms * BLOCKS_PER_SM // row_blocks)
    elif float64:
        row_blocks = -(-nloc // wide_rows(m, True))
        want = -(-WAVES * sms * WIDE64_BLOCKS_PER_SM[wide_class64(m)]
                 // row_blocks)
    else:
        row_blocks = -(-nloc // wide_rows(m, False))
        want = -(-WAVES * sms * TILE_BLOCKS_PER_SM[wide_class(m)]
                 // row_blocks)
    return max(1, min(want, -(-nfull // COLS_PER_TILE)))


def partials_shape(nloc: int, nfull: int, m: int, float64: bool, sms: int,
                   split_rows: int | None = None) -> tuple[int, int, int]:
    """``(S, rows, m + 1)``: one launch's partials slab, its rows rounded
    up to :data:`PART_ROW_MULTIPLE` and S counted for ``split_rows``
    (None: ``nloc``)."""
    splits = column_splits(nloc if split_rows is None else split_rows,
                           nfull, sms, m, float64)
    return splits, -(-nloc // PART_ROW_MULTIPLE) * PART_ROW_MULTIPLE, m + 1


def partials_bytes(nloc: int, nfull: int, m: int, itemsize: int,
                   sms: int) -> int:
    """The bytes of the slab :func:`cuda_exact_repulsion` allocates beside
    its outputs."""
    s, rows, cols = partials_shape(nloc, nfull, m, itemsize == 8, sms)
    return s * rows * cols * itemsize


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
    if m < 1 or y_full.shape[1] != m:
        raise ValueError(f"B2 kernel takes one width m >= 1 on both "
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
    f64 = kernel_float64(y)
    splits, rows, _ = shape = partials_shape(nloc, nfull, m, f64, sms,
                                             split_rows)
    part = torch.empty(shape, device=y.device, dtype=y.dtype)
    KERNELS[form_id("B2", f64, m)](y.data_ptr(), y_full.data_ptr(),
           None if valid is None else valid.data_ptr(), nloc, nfull, m,
           row_offset, splits, rows, part.data_ptr())
    # a fixed order for a fixed split count (rows past nloc are dropped)
    total = torch.sum(part, dim=0)[:nloc]
    zrow = total[:, m].contiguous()
    return total[:, :m].contiguous(), (zrow if row_z else torch.sum(zrow))
