"""Row gather as a CUDA kernel (``csrc/token_gather.cu``).

Replaces ``gather_rows`` of ``repro/kernels/token_gather/kernel.py``,
whose scalar-prefetched index vector steers one row DMA per grid step.
:func:`gather_rows_cuda` launches from the spec: one block per grid step
(output row), each reading its own index from global memory and copying
the row in the widest piece (16, 8, 4, 2 or 1 bytes) that divides its bytes
(:func:`row_piece`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["gather_rows_cuda", "row_piece"]


@functools.cache
def _fn():
    v = ctypes.c_void_p
    return _build.bind(
        "token_gather", "gather_rows_launch",
        [v, v, v, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, v])


def row_piece(row_bytes: int) -> int:
    """The bytes a copy of the kernel moves for rows of ``row_bytes``: the
    widest of 16, 8, 4, 2 and 1 that divides them (``row_piece`` of the
    source)."""
    return next(p for p in (16, 8, 4, 2, 1) if row_bytes % p == 0)


def gather_rows_cuda(spec: LaunchSpec, table: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather on CUDA tensors: ``table`` [N, D], ``idx`` [M]
    int32 -> [M, D].  An index outside [0, N) traps in the kernel, so the
    launch fails (raised at the next synchronize) as PyTorch's own
    indexing does on the card."""
    if not _build.on_card(table, idx):
        raise ValueError("gather_rows_cuda takes CUDA tensors")
    m = spec.grid[0]
    n_rows, d = spec.operand("table").shape
    row_bytes = d * table.element_size()
    if (table.shape != (n_rows, d) or idx.dtype != torch.int32
            or idx.shape != (m,) or not table.is_contiguous()
            or not idx.is_contiguous()
            or table.data_ptr() % row_piece(row_bytes)):
        raise ValueError("gather_rows_cuda: expected a contiguous [N, D] "
                         "table aligned to its row piece and [M] int32 "
                         "indices (strided or unaligned views: ROADMAP.md, "
                         "queue 2)")
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    err = _fn()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, m,
                row_bytes, _build.stream_ptr(table))
    _build.check("token_gather", err)
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0
