"""The simulator's window count as a CUDA kernel (``csrc/window_scan.cu``).

Replaces the reference's jitted ``jax.numpy`` window count
(``_jax_window_kernel`` / ``_jax_window_counts``,
``repro/core/cachesim_vec.py:307-352``), its one accelerator scan that is
not a ``pallas_call``.  :func:`window_count_cuda` launches one warp a row
over a grid of at most 16 blocks an SM (8 rows a block at once).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["window_count_cuda"]

BLOCKS_PER_SM = 16
ROWS_PER_BLOCK = 8   # warps of a 256-thread block


@functools.cache
def _fn():
    v, i64 = ctypes.c_void_p, ctypes.c_int64
    return _build.bind("window_scan", "window_count_launch",
                       [v, i64, v, i64, i64, v, ctypes.c_int, ctypes.c_int, v])


def window_count_cuda(q: torch.Tensor, rows: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """Launch the window count on CUDA tensors: ``q`` [m] and ``rows``
    [3, R] (lo, thr, span), both int32 or both int64 -> counts [R] of that
    type.  Every lo must lie in [0, m)."""
    if not _build.on_card(q, rows):
        raise ValueError("window_count_cuda takes CUDA tensors")
    if (q.dtype not in (torch.int32, torch.int64) or rows.dtype != q.dtype
            or q.dim() != 1 or rows.dim() != 2 or rows.shape[0] != 3
            or not q.is_contiguous() or not rows.is_contiguous()
            or q.numel() == 0):
        raise ValueError("window_count_cuda: expected a non-empty contiguous "
                         "[m] q and [3, R] rows of one dtype, int32 or int64")
    n_rows = rows.shape[1]
    out = torch.empty(n_rows, dtype=q.dtype, device=q.device)
    grid = max(1, min(-(-n_rows // ROWS_PER_BLOCK),
                      BLOCKS_PER_SM * _build.sm_count(q)))
    err = _fn()(q.data_ptr(), q.numel(), rows.data_ptr(), n_rows, int(chunk),
                out.data_ptr(), q.element_size(), grid, _build.stream_ptr(q))
    _build.check("window_scan", err)
    window_count_cuda.launches += 1
    return out


window_count_cuda.launches = 0
