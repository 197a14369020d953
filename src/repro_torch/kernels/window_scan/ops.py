"""The ``cuda`` scan backend's step loop and its window count (counterpart
of ``_jax_window_counts`` and the chunk loop of ``_contested_sd``,
``repro/core/cachesim_vec.py:336-454``).

``_contested_sd`` puts the set-major ``q`` array on the card once per scan
(:func:`to_device`) and hands the queries' windows to :func:`scan`, which
runs the whole chunk loop on ``q``'s device: the queries' (lo, threshold,
hi) go in as one copy at its start, each chunk step is one window count
over the live rows (:func:`window_counts`) and a few torch ops that drop
the rows that ended or reached the cap, and the stack distances come back
as one copy at its end.  The only read back inside the loop is the live
count.  The reference pads the rows to a power of two to bound jax's
recompiles; a CUDA launch needs no padding.  A CUDA ``q`` launches the
kernel; a CPU ``q`` (tests only) runs the plain version.
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

__all__ = ["to_device", "window_counts", "scan", "record"]

_SINKS: list[list] = []
_SINKS_LOCK = threading.Lock()


def to_device(q: np.ndarray, device: torch.device) -> torch.Tensor:
    """The scan's ``q`` (int32, or int64 from 2^31 slots) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(q)).to(device)


def window_counts(q: torch.Tensor, rows: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """Window-first counts (see :func:`~.ref.window_counts_ref`) of the
    [3, R] (lo, thr, span) ``rows``, on ``q``'s device and in its dtype."""
    if _build.on_card(q, rows):
        out = window_count_cuda(q, rows, chunk)
    else:
        out = window_counts_ref(q, rows[0], rows[1], rows[2], chunk)
    if _SINKS:
        with _SINKS_LOCK:
            for sink in _SINKS:
                sink.append((q, rows, int(chunk)))
    return out


def scan(q: torch.Tensor, win_lo: np.ndarray, threshold: np.ndarray,
         win_hi: np.ndarray, skip_below: int, cap: int) -> np.ndarray:
    """Capped stack distances of the query windows ``[win_lo, win_hi)`` of
    the set-major ``q`` (``_contested_sd``'s chunk loop, its counts
    identical): windows shorter than ``skip_below`` count 0; every other
    one is counted in chunks growing 4x from ``max(skip_below, 1)`` until
    it ends or its count reaches ``cap``.  Returns int64 counts."""
    dev, m = q.device, q.numel()
    host = np.empty((3, win_lo.size),
                    dtype=np.int32 if q.dtype == torch.int32 else np.int64)
    host[0], host[1], host[2] = win_lo, threshold, win_hi
    lth = torch.from_numpy(host).to(dev)          # lo, thr, hi of each query
    live = torch.nonzero(lth[2] - lth[0] >= skip_below).squeeze(1)
    # state rows: lo, thr, span (the kernel's [3, R] rows), hi, count so far
    state = torch.zeros((5, live.numel()), dtype=q.dtype, device=dev)
    state[[0, 1, 3]] = lth.index_select(1, live)
    sd = torch.zeros(win_lo.size, dtype=q.dtype, device=dev)
    chunk = max(int(skip_below), 1)
    while state.shape[1]:
        # span capped at chunk: a row that ends in this step counts its
        # remainder, the others a full chunk (a remainder is below m, so
        # capping chunk at m changes nothing and keeps it in q's dtype)
        step = min(chunk, m)
        rem = state[3] - state[0]
        torch.clamp(rem, max=step, out=state[2])
        state[4] += window_counts(q, state[:3], chunk)
        sd[live] = state[4]
        # keep the rows that go on and are still below cap (monotone:
        # >= cap is a miss at every requested associativity); nonzero's
        # size is the step's one read back
        keep = torch.nonzero((rem > step) & (state[4] < cap)).squeeze(1)
        live, state = live.index_select(0, keep), state.index_select(1, keep)
        state[0] += step
        chunk *= 4
    return sd.cpu().numpy().astype(np.int64)


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
        with _SINKS_LOCK:   # by identity: a nested block's list may be equal
            _SINKS[:] = [s for s in _SINKS if s is not sink]
