"""Capture hook: a STREAM launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.stream.capture``).

Strong scaling follows the kernel's natural parallelization: the row-tile
grid is partitioned across cores, so a thread's capture is the launch over
its ``n_elems / cores`` slice, at least one tile.  The hook runs the real
launcher on seeded inputs of that size and walks the spec it launched.
"""

from __future__ import annotations

import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from . import ops
from .ops import DEFAULT_BLOCK_ROWS, LANES, STREAM_OPS

__all__ = ["capture", "STREAM_OPS", "LANES", "DEFAULT_BLOCK_ROWS"]


def capture(op: str, n_elems: int, *, cores: int = 1,
            block_rows: int = DEFAULT_BLOCK_ROWS,
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread launch geometry for one STREAM op over ``n_elems``."""
    if op not in STREAM_OPS:
        raise ValueError(f"unknown stream op {op!r}; expected {set(STREAM_OPS)}")
    tile_elems = block_rows * LANES
    if n_elems % tile_elems:
        raise ValueError(f"n_elems {n_elems} not a multiple of {tile_elems}")
    n_thread = max(tile_elems,
                   n_elems // max(1, cores) // tile_elems * tile_elems)
    dev = resolve_device(device)
    return memoized(("stream", op, n_thread, block_rows, str(dev)),
                    lambda: _launch(op, n_thread, block_rows, dev))


def _launch(op: str, n: int, block_rows: int,
            dev: torch.device) -> GridCapture:
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, generator=gen, device=dev)
    b = torch.randn(n, generator=gen, device=dev)
    q = 1.5
    calls = {
        "copy": lambda: ops.stream_copy(a, block_rows=block_rows),
        "scale": lambda: ops.stream_scale(a, q, block_rows=block_rows),
        "add": lambda: ops.stream_add(a, b, block_rows=block_rows),
        "triad": lambda: ops.stream_triad(a, b, q, block_rows=block_rows),
    }
    return capture_launch(calls[op], dev)
