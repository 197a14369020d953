"""The simulator's window count as a CUDA kernel (``csrc/window_scan.cu``).

Replaces the reference's jitted ``jax.numpy`` window count
(``_jax_window_kernel`` / ``_jax_window_counts``,
``repro/core/cachesim_vec.py:307-352``), its one accelerator scan that is
not a ``pallas_call``.  :func:`window_count_cuda` launches it as
:func:`~.plan.window_plan` lays it out: a lane segment a row walking its
window in steps, tiles of rows staged through shared memory, a persistent
grid of as many blocks as the card's occupancy query fits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .plan import lanes_for, steps_for, window_plan

__all__ = ["launch_plan", "window_count_cuda"]


@functools.cache
def _fn():
    v, i64 = ctypes.c_void_p, ctypes.c_int64
    c_int = ctypes.c_int
    return _build.bind("window_scan", "window_count_launch",
                       [v, i64, v, i64, i64, v, c_int, c_int, c_int, c_int,
                        v])


@functools.cache
def _resident(itemsize: int, lanes: int, steps: int) -> int:
    """Blocks of the (itemsize, lanes, steps) kernel that fit on an SM at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = _build.bind("window_scan", "window_count_occupancy",
                     [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    _build.check("window_scan", fn(itemsize, lanes, steps,
                                   ctypes.byref(blocks)))
    return blocks.value


def launch_plan(q: torch.Tensor, n_rows: int, chunk: int) -> dict:
    """The :func:`~.plan.window_plan` that :func:`window_count_cuda`
    launches with for ``n_rows`` rows at ``chunk`` on ``q``'s card."""
    return window_plan(n_rows, int(chunk), q.element_size(),
                       n_sm=_build.sm_count(q),
                       resident=_resident(q.element_size(),
                                          lanes_for(int(chunk)),
                                          steps_for(int(chunk))))


def window_count_cuda(q: torch.Tensor, rows: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """Launch the window count on CUDA tensors: ``q`` [m] and ``rows``
    [3, R] (lo, thr, span), both int32 or both int64 -> counts [R] of that
    type.  Every lo must lie in [0, m).  A strided or unaligned input is
    read through one dense copy, counted on ``window_count_cuda.copies``."""
    if not _build.on_card(q, rows):
        raise ValueError("window_count_cuda takes CUDA tensors")
    if (q.dtype not in (torch.int32, torch.int64) or rows.dtype != q.dtype
            or q.dim() != 1 or rows.dim() != 2 or rows.shape[0] != 3
            or q.numel() == 0):
        raise ValueError("window_count_cuda: expected a non-empty [m] q and "
                         "[3, R] rows of one dtype, int32 or int64")
    q = _build.dense(q, window_count_cuda)
    rows = _build.dense(rows, window_count_cuda)
    n_rows = rows.shape[1]
    out = torch.empty(n_rows, dtype=q.dtype, device=q.device)
    if n_rows == 0:
        return out                            # nothing to launch
    plan = launch_plan(q, n_rows, chunk)
    err = _fn()(q.data_ptr(), q.numel(), rows.data_ptr(), n_rows, int(chunk),
                out.data_ptr(), q.element_size(), plan["lanes"],
                plan["steps"], plan["grid"], _build.stream_ptr(q))
    _build.check("window_scan", err)
    window_count_cuda.launches += 1
    return out


window_count_cuda.launches = 0
window_count_cuda.copies = 0
