"""How the paged decode kernel splits the page table over blocks.

Flash decoding: ``paged_split`` (``csrc/paged_kv_decode.cu``) takes one
range of consecutive table entries a block and writes f32 partials (m, l
and the unnormalized acc); ``paged_combine`` folds them in split order.
The card needs ~2.3 MB of loads in flight (3.35 TB/s x ~0.7 us), ~18 KB on
each of its SMs, so the plan asks for two splits per SM: as many blocks as
fit on the card at once (two an SM), so that every split runs in the first
wave and a block keeps a stage of 32 KB (f32, D = 128) in flight.  A split is
never smaller than ``MIN_SPLIT_BYTES`` of K and V, nor smaller than
``PARTIAL_RATIO`` times the partials it writes, so the combine's traffic
stays small beside the pages'.  A short sequence (the serving roster's 32
rows) gets one split, which writes the output itself in one launch.
"""

from __future__ import annotations

__all__ = ["split_plan", "SPLITS_PER_SM", "MIN_SPLIT_BYTES",
           "PARTIAL_RATIO"]

SPLITS_PER_SM = 2
MIN_SPLIT_BYTES = 32 * 1024
PARTIAL_RATIO = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(n_active: int, page: int, d: int, h: int, itemsize: int, *,
               n_sm: int) -> tuple[int, int]:
    """Pages per split and the number of splits for one decode step over
    ``n_active`` pages of ``page`` rows of width ``d`` (``h`` heads,
    ``itemsize`` bytes an element) on a card of ``n_sm`` SMs.  Every split but the last holds
    exactly ``pages per split`` table entries, and none is empty."""
    if n_active < 1:
        raise ValueError(f"n_active must be >= 1, got {n_active}")
    page_bytes = 2 * page * d * itemsize             # K and V of one page
    partial_bytes = h * (d + 2) * 4                  # f32 acc, m and l
    least = max(MIN_SPLIT_BYTES, PARTIAL_RATIO * partial_bytes)
    per = max(_cdiv(least, page_bytes), _cdiv(n_active, SPLITS_PER_SM * n_sm))
    per = min(per, n_active)
    return per, _cdiv(n_active, per)
