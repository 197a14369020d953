"""Capture hook: a token-gather launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.token_gather.capture``).

Each core gathers its own slice of the global index stream, so a thread's
capture is ``m`` gathered rows with thread-private random indices over the
shared table.  ``rng`` supplies the indices exactly as the reference hook
draws them, so the trace is deterministic per (workload, seed).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from .ops import gather_rows

__all__ = ["capture"]


def capture(n_rows: int, d: int, m: int, *, rng: np.random.Generator,
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread geometry: gather ``m`` of ``n_rows`` rows of width ``d``."""
    if d % 128:
        raise ValueError(f"d {d} must be a multiple of 128 (lane dim)")
    idx = rng.integers(0, n_rows, size=m, dtype=np.int64)
    dev = resolve_device(device)
    return memoized(("gather", n_rows, d, m, idx.tobytes(), str(dev)),
                    lambda: _launch(n_rows, d, idx, dev))


def _launch(n_rows: int, d: int, idx: np.ndarray,
            dev: torch.device) -> GridCapture:
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(n_rows, d, generator=gen, device=dev)
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(dev)
    return capture_launch(lambda: gather_rows(table, idx_t), dev)
