"""Architecture-independent locality metrics (DAMOV Step 2; counterpart
of ``repro.core.locality``, copied verbatim).

Implements the spatial- and temporal-locality definitions of DAMOV §2.3
(following Weinberg et al. [166] / Shao & Brooks [167]) at *word*
granularity, exactly as the paper specifies:

Spatial locality (Eq. 1)
    For every window of ``W`` memory references, compute the minimum
    absolute distance (stride, in words) between any two addresses in the
    window.  Build a histogram ``stride_profile`` over those strides and
    return ``sum_i stride_profile(i) / i`` where ``stride_profile(i)`` is
    the *fraction* of windows whose stride is ``i``.  A fully sequential
    trace scores 1.0; large/random strides score ~0.

Temporal locality (Eq. 2)
    For every window of ``L`` references, count how many times each address
    repeats.  An address reused ``N >= 1`` extra times increments reuse bin
    ``floor(log2(N))``.  The metric is
    ``sum_i 2^i * reuse_profile(i) / total_accesses``; 0 means no reuse and
    values near 1 mean the same word is touched continuously.

Both metrics operate on integer word addresses and use only properties of
the application trace (no cache parameters), which is what makes them
architecture-independent.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "spatial_locality",
    "temporal_locality",
    "locality_profile",
    "WORD_BYTES",
]

# The paper computes locality at word granularity (8 B on x86-64).
WORD_BYTES = 8
# Paper default window lengths (W = L = 32); §2.3 reports conclusions are
# stable for {8, 16, 32, 64, 128}.
DEFAULT_WINDOW = 32


def _as_word_addresses(addresses: np.ndarray) -> np.ndarray:
    addr = np.asarray(addresses, dtype=np.int64)
    if addr.ndim != 1:
        raise ValueError(f"trace must be 1-D, got shape {addr.shape}")
    return addr


def spatial_locality(addresses: np.ndarray, window: int = DEFAULT_WINDOW) -> float:
    """DAMOV Eq. 1 over a 1-D trace of word addresses.

    Single pass: the trace is reshaped to ``(n_windows, window)`` and every
    window's minimum positive stride — the minimum adjacent difference of
    the sorted window — is extracted with one row-wise sort and one masked
    row-min, instead of a per-window Python loop.
    """
    addr = _as_word_addresses(addresses)
    n = addr.size
    if n < 2:
        return 0.0
    window = max(2, int(window))
    n_windows = n // window
    if n_windows == 0:
        # Single short window: use the whole trace.
        rows = addr[np.newaxis, :]
        n_windows = 1
    else:
        rows = addr[: n_windows * window].reshape(n_windows, window)

    d = np.diff(np.sort(rows, axis=1), axis=1)
    # Minimum *positive* adjacent difference per window; all-identical
    # windows (no positive diff) yield stride 0.
    sentinel = np.iinfo(np.int64).max
    strides = np.where(d > 0, d, sentinel).min(axis=1)
    strides[strides == sentinel] = 0

    # stride 0 (all-identical window) carries no *spatial* information; the
    # paper's stride profile bins start at 1.
    strides = strides[strides > 0]
    if strides.size == 0:
        return 0.0
    uniq, counts = np.unique(strides, return_counts=True)
    frac = counts / float(n_windows)
    return float(np.sum(frac / uniq))


def temporal_locality(addresses: np.ndarray, window: int = DEFAULT_WINDOW) -> float:
    """DAMOV Eq. 2 over a 1-D trace of word addresses."""
    addr = _as_word_addresses(addresses)
    n = addr.size
    if n == 0:
        return 0.0
    window = max(2, int(window))
    n_windows = max(1, n // window)
    if n >= window:
        flat = np.sort(
            addr[: n_windows * window].reshape(n_windows, window), axis=1
        ).ravel()
        row_len = window
    else:
        flat = np.sort(addr)
        row_len = n

    # Per-window occurrence counts in one pass: sort each window (row-wise),
    # flatten, and measure run lengths — forcing a run break at every row
    # boundary so runs never leak across windows.
    start = np.ones(flat.size, dtype=bool)
    np.not_equal(flat[1:], flat[:-1], out=start[1:])
    start[::row_len] = True
    idx = np.flatnonzero(start)
    counts = np.diff(idx, append=flat.size)

    # reuse_profile[i] accumulates addresses reused N times with
    # floor(log2(N)) == i (N >= 1 extra occurrences beyond the first).
    max_bins = int(np.ceil(np.log2(window))) + 2
    repeats = counts - 1  # N: times an address is *re*-used
    repeats = repeats[repeats > 0]
    if repeats.size:
        bins = np.floor(np.log2(repeats)).astype(np.int64)
        reuse_profile = np.bincount(bins, minlength=max_bins)
    else:
        reuse_profile = np.zeros(max_bins, dtype=np.int64)

    total = float(addr[: n_windows * window].size if n >= window else n)
    weights = 2.0 ** np.arange(max_bins)
    return float(np.minimum(np.sum(weights * reuse_profile) / total, 1.0))


def locality_profile(
    addresses: np.ndarray, windows: tuple[int, ...] = (8, 16, 32, 64, 128)
) -> dict[int, tuple[float, float]]:
    """(spatial, temporal) per window length — the paper's sensitivity sweep."""
    return {
        w: (spatial_locality(addresses, w), temporal_locality(addresses, w))
        for w in windows
    }
