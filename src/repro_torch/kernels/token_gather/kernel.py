"""Row gather as a CUDA kernel (``csrc/token_gather.cu``).

Replaces ``gather_rows`` of ``repro/kernels/token_gather/kernel.py``,
whose scalar-prefetched index vector steers one row DMA per grid step.
:func:`gather_rows` launches from the spec: one block per grid step
(output row), each reading its own index from global memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["gather_rows"]


@functools.cache
def _fn():
    v = ctypes.c_void_p
    return _build.bind(
        "token_gather", "gather_rows_launch",
        [v, v, v, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, v])


def gather_rows(spec: LaunchSpec, table: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather on CUDA tensors: ``table`` [N, D], ``idx`` [M]
    int32 -> [M, D].  An index outside [0, N) traps in the kernel, so the
    launch fails (raised at the next synchronize) as PyTorch's own
    indexing does on the card."""
    if not _build.on_card(table, idx):
        raise ValueError("gather_rows takes CUDA tensors")
    m = spec.grid[0]
    n_rows, d = spec.operand("table").shape
    if (table.dim() != 2 or idx.dtype != torch.int32 or idx.shape != (m,)
            or not table.is_contiguous() or not idx.is_contiguous()
            or (d * table.element_size()) % 16 or table.data_ptr() % 16):
        raise ValueError("gather_rows: expected a contiguous, 16-byte "
                         "aligned [N, D] table with 16-byte rows and [M] "
                         "int32 indices")
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    err = _fn()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, m,
                d * table.element_size(), _build.stream_ptr(table))
    _build.check("token_gather", err)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
