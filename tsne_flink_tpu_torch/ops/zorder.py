"""Z-order (Morton) curve utilities (port of ``tsne_flink_tpu/ops/zorder.py``).

Coordinates are min-max quantized to ``bits`` bits per dimension and the
bits are interleaved into one int32 key, so the curve order is one stable
``argsort`` of the keys.  Key resolution only affects which candidates the
project kNN sees, never a distance: candidates are re-ranked exactly
downstream (``ops/knn.knn_project``).

Keys stay within int32: 1 dim x 30 bits, 2 dims x 15 bits or 3 dims x 10
bits.
"""

from __future__ import annotations

import torch

#: bits per dimension so that m * bits <= 30 (int32-safe)
BITS_FOR_DIMS = {1: 30, 2: 15, 3: 10}


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread 15-bit ints: insert one zero bit between each bit."""
    x = x & 0x7FFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10-bit ints: insert two zero bits between each bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def quantize(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Min-max quantize float coords [N, m] to int32 in [0, 2^bits)."""
    lo = torch.amin(coords, dim=0, keepdim=True)
    hi = torch.amax(coords, dim=0, keepdim=True)
    span = torch.clamp(hi - lo, min=torch.finfo(coords.dtype).tiny)
    scale = (2**bits - 1) / span
    q = torch.floor((coords - lo) * scale)
    return torch.clamp(q, 0, 2**bits - 1).to(torch.int32)


def morton_keys(q: torch.Tensor) -> torch.Tensor:
    """Interleave quantized int coords [N, m] (m in 1..3) into int32 keys."""
    m = q.shape[1]
    if m == 1:
        return q[:, 0]
    if m == 2:
        return (_part1by1(q[:, 1]) << 1) | _part1by1(q[:, 0])
    if m == 3:
        return ((_part1by2(q[:, 2]) << 2) | (_part1by2(q[:, 1]) << 1)
                | _part1by2(q[:, 0]))
    raise ValueError(f"morton_keys supports 1-3 dims, got {m}")


def zorder_permutation(coords: torch.Tensor) -> torch.Tensor:
    """The int32 permutation that sorts points [N, m<=3] along the Z-curve;
    equal keys keep their input order (a stable sort)."""
    m = coords.shape[1]
    keys = morton_keys(quantize(coords, BITS_FOR_DIMS[m]))
    return torch.argsort(keys, stable=True).to(torch.int32)
