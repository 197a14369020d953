"""Row gather as a CUDA kernel (``csrc/token_gather.cu``).

Replaces ``gather_rows`` of ``repro/kernels/token_gather/kernel.py``,
whose scalar-prefetched index vector steers one row DMA per grid step.
:func:`gather_rows_cuda` launches from the spec: one block per grid step
(output row), each reading its own index from global memory and copying
the row in the widest piece (16, 8, 4, 2 or 1 bytes) that divides its
bytes, the table's row stride and its address (:func:`row_piece`).  A
table whose rows lie apart (a column slice, a view off 16 bytes) is read
where it lies; one whose rows are not contiguous inside (a transposed
view) is read through one dense copy (``_build.dense``, counted on
``gather_rows_cuda.copies``), as is an index vector that is not dense.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["gather_rows_cuda", "row_piece", "row_view"]


@functools.cache
def _fn():
    v = ctypes.c_void_p
    return _build.bind(
        "token_gather", "gather_rows_launch",
        [v, v, v, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, v])


def row_piece(row_bytes: int, stride_bytes: int = 0, address: int = 0) -> int:
    """The bytes a copy of the kernel moves for rows of ``row_bytes`` that
    lie ``stride_bytes`` apart in a table at ``address``: the widest of 16,
    8, 4, 2 and 1 that divides all three (``row_piece`` of the source)."""
    step = row_bytes | stride_bytes | address
    return next(p for p in (16, 8, 4, 2, 1) if step % p == 0)


def row_view(table: torch.Tensor) -> bool:
    """Whether the kernel reads ``table`` [N, D] where it lies: each row's
    elements contiguous (the rows any distance apart)."""
    return table.shape[1] <= 1 or table.stride(1) == 1


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
    if (table.shape != (n_rows, d) or idx.dtype != torch.int32
            or idx.shape != (m,)):
        raise ValueError("gather_rows_cuda: expected an [N, D] table and [M] "
                         "int32 indices")
    if not row_view(table):
        table = _build.dense(table, gather_rows_cuda)
    idx = _build.dense(idx, gather_rows_cuda)
    size = table.element_size()
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    err = _fn()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, m,
                d * size, table.stride(0) * size, _build.stream_ptr(table))
    _build.check("token_gather", err)
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0
gather_rows_cuda.copies = 0
