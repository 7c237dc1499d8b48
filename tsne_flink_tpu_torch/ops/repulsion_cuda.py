"""B2: exact Student-t repulsion through the hand-written kernel.

Replaces ``tsne_flink_tpu/ops/repulsion_pallas.py::_kernel`` (driven by
``pallas_exact_repulsion``).  The kernel is ``csrc/repulsion.cu``; its
header says what bounds it on an H100 (~20 FP32 operations per pair, N²
pairs) and how its design keeps the sweep deterministic (per-row partial
Z, summed outside in a fixed order, no atomics).

:func:`cuda_exact_repulsion` is the wrapper: the plain
``ops/repulsion_exact.exact_repulsion`` on a CPU tensor, the kernel on a
CUDA tensor (or it raises).  Same ``row_offset``/``col_valid``/``row_z``
contract as the JAX function.
"""

from __future__ import annotations

import torch

from tsne_flink_tpu_torch.kernels.build import KERNELS
from tsne_flink_tpu_torch.ops.repulsion_exact import exact_repulsion


def _check_cuda(y, y_full, col_valid, row_offset):
    for name, t in (("y", y), ("y_full", y_full)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"B2 kernel takes float32 CUDA tensors; {name} is "
                            f"{t.dtype} on {t.device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"B2 kernel takes a contiguous [N, m] {name}")
    m = y.shape[1]
    if m not in (2, 3) or y_full.shape[1] != m:
        raise ValueError(f"B2 kernel takes m = 2 or 3 on both operands; got "
                         f"{tuple(y.shape)} and {tuple(y_full.shape)}")
    if not 0 <= row_offset <= y_full.shape[0] - y.shape[0]:
        raise ValueError(f"row_offset {row_offset} puts {y.shape[0]} rows "
                         f"outside y_full's {y_full.shape[0]}")
    if y.device != y_full.device:
        raise ValueError("y and y_full lie on different devices")
    if col_valid is not None and (col_valid.shape != (y_full.shape[0],)
                                  or col_valid.device != y.device):
        raise ValueError("col_valid must be a [N_full] mask on y's device")


def cuda_exact_repulsion(y: torch.Tensor, y_full: torch.Tensor | None = None,
                         *, row_offset: int = 0,
                         col_valid: torch.Tensor | None = None,
                         row_z: bool = False, row_chunk: int = 2048):
    """(rep [len(y), m], Z) — Z summed, or per-row with ``row_z``."""
    if y_full is None:
        y_full = y
    if y.device.type == "cpu":
        return exact_repulsion(y, y_full, row_offset=row_offset,
                               col_valid=col_valid, row_chunk=row_chunk,
                               row_z=row_z)
    _check_cuda(y, y_full, col_valid, row_offset)
    nloc, m = y.shape
    rep = torch.empty_like(y)
    zrow = torch.empty(nloc, device=y.device, dtype=torch.float32)
    valid = (None if col_valid is None
             else col_valid.to(torch.uint8).contiguous())
    if nloc:
        KERNELS["B2"](y.data_ptr(), y_full.data_ptr(),
                      None if valid is None else valid.data_ptr(), nloc,
                      y_full.shape[0], m, row_offset, rep.data_ptr(),
                      zrow.data_ptr())
    return rep, (zrow if row_z else torch.sum(zrow))
