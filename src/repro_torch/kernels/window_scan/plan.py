"""How the window count (``csrc/window_scan.cu``) lays rows over the card.

A row's window is ``min(span, chunk)`` slots of ``q``, 8-32 at the scan's
first chunks.  A row gets ``lanes`` = the next power of two at or above
``chunk``, at most ``LANE_CAP``, which walk its window in ``steps`` steps
of ``lanes`` slots, so a warp walks ``32 / lanes`` rows at once; each
segment of ``lanes`` lanes walks ``rows_in_flight`` rows with all their
loads (at most ``LOADS`` a lane) issued together.  Few lanes a row keep
each warp instruction busy with many rows: on the card 4 lanes beat 8,
16 and 32 at chunk 32, and tied at chunk 8.  Chunks past ``LANE_CAP x
MAX_STEPS`` slots take 32 lanes in steps, and past ``32 x MAX_STEPS``
the full-warp walk (32 lanes, ``steps`` 1) with ``LONG_STEPS`` 32-slot
steps loaded at once.

A block of ``THREADS`` threads takes tiles of ``rows_per_tile`` rows:
their ``lo``, ``thr`` and ``span`` arrive as three coalesced ``cp.async``
streams into a double-buffered shared tile (tile t+1's while tile t's
windows are read), and the tile's counts leave as one coalesced store.
The grid is persistent: as many blocks an SM as fit at once (at most
``BLOCKS_PER_SM``; fewer where the card's occupancy query, set by
registers, or the int64 tiles' shared memory says so), each taking every
``grid``-th tile.
"""

from __future__ import annotations

__all__ = ["THREADS", "BLOCKS_PER_SM", "LANE_CAP", "MAX_STEPS", "LOADS",
           "LONG_STEPS", "MAX_TILE_ROWS", "SMEM_PER_SM", "lanes_for",
           "steps_for", "rows_in_flight", "window_plan"]

THREADS = 256           # a block: 8 warps
BLOCKS_PER_SM = 8       # 2048 threads, the SM's limit
LANE_CAP = 4            # lanes a row below 32 x MAX_STEPS slots
MAX_STEPS = 8           # steps of a row's lanes with their loads in flight
LOADS = 16              # window loads in flight a lane
LONG_STEPS = 4          # 32-slot steps in flight on the full-warp walk
MAX_TILE_ROWS = 512     # 7 x 512 x 8 B = 28 KB of shared memory (int64)
SMEM_PER_SM = 233_472   # 228 KB an SM, of which a block reserves 1 KB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int) -> int:
    """The next power of two >= ``n`` (1 for ``n`` <= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def lanes_for(chunk: int) -> int:
    """Lanes a row: the next power of two >= ``chunk``, at most
    ``LANE_CAP``; 32 when that takes more than ``MAX_STEPS`` steps."""
    p = _pow2(chunk)
    return min(LANE_CAP, p) if p <= LANE_CAP * MAX_STEPS else 32


def steps_for(chunk: int) -> int:
    """Steps a row's lanes take to cover ``chunk`` slots, or 1 for the
    full-warp walk (32 lanes, chunks past ``32 x MAX_STEPS``)."""
    p, lanes = _pow2(chunk), lanes_for(chunk)
    return p // lanes if p <= lanes * MAX_STEPS else 1


def rows_in_flight(lanes: int, steps: int) -> int:
    """Rows each lane segment walks with their loads issued together: at
    most ``LOADS`` loads a lane and ``MAX_TILE_ROWS`` rows a tile."""
    return max(1, min(MAX_TILE_ROWS * lanes // THREADS, LOADS // steps))


def window_plan(n_rows: int, chunk: int, itemsize: int, *, n_sm: int,
                resident: int | None = None) -> dict:
    """The launch of one window count over ``n_rows`` rows at ``chunk``
    (q, rows and counts of ``itemsize`` bytes, 4 or 8) on a card of
    ``n_sm`` SMs: ``lanes``, ``steps``, ``rows_per_tile``, ``tiles``, the
    block's ``smem_bytes`` (two staging buffers of three rows each, plus
    the counts), ``blocks_per_sm`` and ``grid`` (0 for no rows: no
    launch).  ``resident``: the blocks the card's occupancy query lets an
    SM hold, so that every block of the grid starts at once."""
    if (n_rows < 0 or chunk < 0 or itemsize not in (4, 8) or n_sm < 1
            or (resident is not None and resident < 1)):
        raise ValueError(f"window_plan: bad n_rows={n_rows} chunk={chunk} "
                         f"itemsize={itemsize} n_sm={n_sm} "
                         f"resident={resident}")
    lanes, steps = lanes_for(chunk), steps_for(chunk)
    tile = THREADS // lanes * rows_in_flight(lanes, steps)
    tiles = _cdiv(n_rows, tile)
    smem = 7 * tile * itemsize
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024),
                 resident or BLOCKS_PER_SM)
    return {"lanes": lanes, "steps": steps, "rows_per_tile": tile,
            "tiles": tiles, "smem_bytes": smem, "blocks_per_sm": per_sm,
            "grid": min(tiles, per_sm * n_sm)}
