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

The kernel takes every head width D % 8 == 0 up to ``MAX_HEAD_DIM``, a lane
holding :func:`lanes_vec` columns (D rounded up to 32 of them), and every
group of H heads, cut into :func:`head_groups` of at most
:func:`head_cap` heads, one block a (split, head group); the plan counts
those blocks.  A stage holds :func:`stage_rows` rows of K and of V.
"""

from __future__ import annotations

__all__ = ["split_plan", "lanes_vec", "head_cap", "head_groups",
           "stage_rows", "SPLITS_PER_SM", "MIN_SPLIT_BYTES", "PARTIAL_RATIO",
           "MAX_HEAD_DIM", "LANE_VECS", "STAGE_ELEMS"]

SPLITS_PER_SM = 2
MIN_SPLIT_BYTES = 32 * 1024
PARTIAL_RATIO = 16
MAX_HEAD_DIM = 512
LANE_VECS = (1, 2, 4, 8, 12, 16)   # columns a lane holds, by instance
STAGE_ELEMS = 4096                 # K elements a stage buffer holds


def lanes_vec(d: int) -> int:
    """Columns of a head one lane holds at head width ``d``: the least of
    ``LANE_VECS`` with 32 of them covering D (the kernel's padded width
    DP = 32 x that; lanes past D read zeros).  Raises on a width no
    instance takes."""
    if not (8 <= d <= MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"paged decode kernel takes D % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}, got D={d} (other widths: "
                         f"ROADMAP.md, queue 2)")
    return next(v for v in LANE_VECS if 32 * v >= d)


def head_cap(vec: int) -> int:
    """Most heads one block holds at ``vec`` columns a lane: a lane keeps
    q and the accumulator of each, 2 x heads x vec registers."""
    return 16 if vec <= 4 else 8 if vec <= 8 else 4


def head_groups(h: int, d: int) -> tuple[int, int]:
    """(head groups, heads a group) of a group of ``h`` query heads at head
    width ``d``: equal groups of at most :func:`head_cap` heads (the last
    may hold fewer), one block each along the grid's second dimension."""
    if h < 1:
        raise ValueError(f"paged decode takes H >= 1, got H={h}")
    cap = head_cap(lanes_vec(d))
    n = _cdiv(h, cap)
    return n, _cdiv(h, n)


def stage_rows(d: int, page: int) -> int:
    """Rows of K (and of V) one stage holds at head width ``d``: whole
    pages while one fits ``STAGE_ELEMS`` elements at the padded width, one
    page up to twice that, else chunks of ``STAGE_ELEMS / DP`` rows of a
    page, so that any page size fits shared memory."""
    dp = 32 * lanes_vec(d)
    rows = STAGE_ELEMS // dp
    if page <= rows:
        return rows // page * page
    if page * dp <= 2 * STAGE_ELEMS:
        return page
    return rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(n_active: int, page: int, d: int, h: int, itemsize: int, *,
               n_sm: int) -> tuple[int, int]:
    """Pages per split and the number of splits for one decode step over
    ``n_active`` pages of ``page`` rows of width ``d`` (``h`` heads,
    ``itemsize`` bytes an element) on a card of ``n_sm`` SMs, each split
    one block a head group (:func:`head_groups`).  Every split but the
    last holds exactly ``pages per split`` table entries, and none is
    empty."""
    if n_active < 1:
        raise ValueError(f"n_active must be >= 1, got {n_active}")
    groups = head_groups(h, d)[0]
    page_bytes = 2 * page * d * itemsize             # K and V of one page
    partial_bytes = h * (d + 2) * 4                  # f32 acc, m and l
    least = max(MIN_SPLIT_BYTES, PARTIAL_RATIO * partial_bytes)
    blocks = _cdiv(SPLITS_PER_SM * n_sm, groups)     # splits the card wants
    per = max(_cdiv(least, page_bytes), _cdiv(n_active, blocks))
    per = min(per, n_active)
    return per, _cdiv(n_active, per)
