"""Window-count entry point of the simulator's ``cuda`` scan backend
(counterpart of ``_jax_window_counts``, ``repro/core/cachesim_vec.py:336``).

``_contested_sd`` puts the set-major ``q`` array on the card once per scan
(:func:`to_device`) and calls :func:`window_counts` once for each chunk
step's ending rows and once for its full-chunk rows: the step's (lo,
threshold, span) go in as one copy and the counts come out as one.  The
reference pads the rows to a power of two to bound jax's recompiles; a
CUDA launch needs no padding.  A CUDA ``q`` launches the kernel; a CPU
``q`` (tests only) runs the plain version.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import numpy as np
import torch

from .. import _build
from .kernel import window_count_cuda
from .ref import window_counts_ref

__all__ = ["to_device", "window_counts", "record"]

_SINKS: list[list] = []
_SINKS_LOCK = threading.Lock()


def to_device(q: np.ndarray, device: torch.device) -> torch.Tensor:
    """The scan's ``q`` (int32, or int64 from 2^31 slots) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(q)).to(device)


def window_counts(q: torch.Tensor, lo: np.ndarray, thr: np.ndarray,
                  span: np.ndarray, chunk: int) -> np.ndarray:
    """Window-first counts of one chunk step's rows (see
    :func:`~.ref.window_counts_ref`) as int64; no rows, no launch."""
    n_rows = int(lo.size)
    if n_rows == 0:
        return np.zeros(0, dtype=np.int64)
    packed = np.empty((3, n_rows),
                      dtype=np.int32 if q.dtype == torch.int32 else np.int64)
    packed[0], packed[1], packed[2] = lo, thr, span
    rows = torch.from_numpy(packed).to(q.device)
    if _build.on_card(q, rows):
        out = window_count_cuda(q, rows, chunk)
    else:
        out = window_counts_ref(q, rows[0], rows[1], rows[2], chunk)
    if _SINKS:
        with _SINKS_LOCK:
            for sink in _SINKS:
                sink.append((q, rows, int(chunk)))
    return out.cpu().numpy().astype(np.int64)


@contextlib.contextmanager
def record() -> Iterator[list[tuple[torch.Tensor, torch.Tensor, int]]]:
    """Collect ``(q, rows, chunk)`` of every window count made inside the
    block, from any thread (``rows`` is the [3, R] lo/thr/span tensor)."""
    sink: list = []
    with _SINKS_LOCK:
        _SINKS.append(sink)
    try:
        yield sink
    finally:
        with _SINKS_LOCK:
            _SINKS.remove(sink)
