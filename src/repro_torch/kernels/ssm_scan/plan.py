"""How the two scan kernels lay their work over the card.

State-expanded scan (``scan_plan``).
``ssm_chunked_kernel`` and ``ssm_chunked_general`` (the reference's
shapes, and the rest; ``csrc/ssm_chunked_scan.cu``) give each thread
``rows`` state rows of one channel, in registers for the whole sequence,
and each block ``channels`` channels (``channels * NP / rows`` threads);
the grid is ``ceil(D / channels)`` blocks a part of the state, and the
last block of a D that it does not divide has idle channels.  The state's
N rows come in ``parts`` of at most 256 (:func:`state_split`), each padded
in shared memory to ``state_rows`` (NP, the next of 16 ... 256) with zero
rows of b and c, which add nothing to y; a state of more than 256 rows is
split over ``parts`` blocks a channel tile, whose y partials a second pass
adds in part order.  Every step of a thread issues 4
instructions per state row plus a fixed cost (its loads of x, dt, b and c
and its y partial), so more rows a thread amortize that cost, and fewer
rows give more warps to fill the card's ``4 * n_sm`` schedulers.  The plan
takes the most rows (16, 8, 4) that still give every scheduler a warp, and
then the widest block that still leaves at least ``n_sm`` blocks (every SM
busy), within ``MAX_THREADS`` threads and the shared memory a block may
use; where the channels are too few for that, blocks of ``MIN_THREADS``
(4 warps, one a scheduler), which timed faster on the card than more
blocks of one warp.  A block width divides D where D is a multiple of 128;
elsewhere it leaves at most D / 8 channels of the last block idle
(:func:`fits`).  Each block reads all of b and c (2 T N values) from
L2, so a block no narrower than that keeps the traffic small: 224 blocks
at full width (Zamba2-7B, T 4096, D 7168, N 64: 470 MB over the scan),
32 or 64 blocks of 4 channels at the main paths' D 128 and 256.  The
copies into the ring are 16 bytes where a row's bytes allow, else the
widest of 8 and 4 bytes that divides them, else plain loads
(:func:`copy_piece`).

Gated EMA scan (``ema_plan``).  ``ssm_ema_kernel``
(``csrc/ssm_ema_scan.cu``) gives each block ``channels`` channels (CH, one
consumer thread each, walking time in order) and one producer warp that
keeps a ring of ``ring`` stages of TMA loads in flight, each stage an
[S, CH] tile of x, dt and g.  CH is the widest power of two (at most
``EMA_MAX_CHANNELS``) that still leaves ``n_sm`` blocks, or, where D is too
narrow for that, the narrowest block whose rows are 16 bytes (TMA's
least): 224 blocks of 32 channels at full width (Zamba2-7B, D 7168), 32 or
64 blocks of 4 f32 channels at the main paths' D 128 and 256.  The rings
hold ``EMA_FLIGHT_BYTES`` across the card, about what Little's law asks of
3.35 TB/s over ~1.6 us; more in flight timed slower on the card (ring
depths 2-8 at full width, ``PERF.md``): 2 stages of 32 f32 or 64 bf16
steps a block at full width.  A D that no block width divides leaves the
last block's channels past D idle.  The tiles come by TMA where a row of
x is a multiple of 16 bytes (``piece`` 16), else by ``cp.async`` of the
widest of 8 and 4 bytes that divides the row, else by plain loads, from
``EMA_COPY_WARPS`` producer warps in place of one, through a ring as deep
as the shared memory allows (more in flight timed faster there).  A stage is as long as the ring's share
allows with two stages, at most 1/``EMA_MIN_STAGES`` of the sequence
(fewer, longer stages cost fewer waits; a short sequence still starts on
a small first stage), and the ring as deep as its share, the shared memory
of the blocks an SM holds and ``EMA_MAX_RING`` allow: the main paths' rings
hold the whole sequence.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["ScanPlan", "scan_plan", "smem_bytes", "state_split",
           "copy_piece", "fits", "ROWS_PER_THREAD", "MAX_STATE_ROWS",
           "MAX_THREADS", "MIN_THREADS", "MAX_SMEM_BYTES", "RING", "EmaPlan",
           "ema_plan", "ema_smem_bytes", "EMA_MAX_CHANNELS", "EMA_MAX_RING",
           "EMA_STEPS", "EMA_COPY_WARPS", "EMA_FLIGHT_BYTES", "SM_SMEM_BYTES",
           "BLOCK_RESERVED_SMEM"]

ROWS_PER_THREAD = (16, 8, 4)   # the kernel's template instances, most first
MAX_STATE_ROWS = 256           # state rows a block holds (a part of N)
MAX_THREADS = 256              # the kernel's __launch_bounds__
MIN_THREADS = 128              # a block of 4 warps, one for each scheduler
MAX_SMEM_BYTES = 232_448       # dynamic shared memory one Hopper block may use
RING = 3                       # cp.async stages in the ring
WARPS_PER_SM = 4               # schedulers an SM has, each wanting a warp

EMA_MAX_CHANNELS = 128         # consumer threads an EMA block may have
EMA_FLIGHT_BYTES = 5_505_024   # bytes the rings of all blocks hold
EMA_MIN_STAGES = 8             # stages a long enough sequence spans at least
EMA_MAX_RING = 8               # stages of the EMA ring
EMA_STEPS = (16, 256)          # steps a stage holds (TMA boxes: <= 256 rows)
EMA_COPY_WARPS = 4             # producer warps of a ring without TMA
SM_SMEM_BYTES = 233_472        # shared memory of one SM (228 KB)
BLOCK_RESERVED_SMEM = 1024     # of it, what the runtime keeps for each block


class ScanPlan(NamedTuple):
    rows: int          # state rows a thread holds (R)
    channels: int      # channels a block holds (CH), a power of two
    stage_steps: int   # time steps a ring stage holds (S)
    state_rows: int    # state rows a block holds, padded (NP)
    parts: int         # blocks a channel tile's state is split over

    def blocks(self, d: int) -> int:
        return -(-d // self.channels) * self.parts

    def threads(self) -> int:
        return self.channels * (self.state_rows // self.rows)


def state_split(n: int) -> tuple[int, int, int]:
    """(parts, rows a part, rows a part padded) of an N-row state: parts of
    at most ``MAX_STATE_ROWS`` rows, as even as they go, each padded to the
    next power of two of at least 16."""
    parts = -(-n // MAX_STATE_ROWS)
    per = -(-n // parts)
    return parts, per, max(16, 1 << (per - 1).bit_length())


def copy_piece(row_elems: int, itemsize: int, offset_elems: int = 0) -> int:
    """Bytes of the copies that bring rows of ``row_elems`` elements, which
    start ``offset_elems`` into a row, into shared memory: 16, 8 or 4 where
    they divide the row's and the offset's bytes (``cp.async``), else the
    element's own size (plain loads)."""
    step = (row_elems * itemsize) | (offset_elems * itemsize)
    return next((p for p in (16, 8, 4) if step % p == 0), itemsize)


def fits(d: int, ch: int) -> bool:
    """Whether blocks of ``ch`` channels may tile D: dividing it where D is
    a multiple of 128 (the plans of the main paths and full widths), else
    leaving at most D / 8 channels of the last block idle."""
    if d % 128 == 0:
        return d % ch == 0
    return 8 * (-d % ch) <= d


def stage_steps(n: int) -> int:
    """Time steps a stage holds: 32, or 16 for 256 padded state rows
    (three stages of b and c must fit beside the partials)."""
    return 32 if n <= 128 else 16


def smem_bytes(plan: ScanPlan, itemsize: int) -> int:
    """Shared memory the kernel asks for (``smem_bytes`` of the source):
    the ring of b, c and the x, dt windows, then two stages of y
    partials."""
    window = max(plan.channels, 16 // itemsize)
    partial_stride = plan.threads() + 4
    return (RING * plan.stage_steps * (2 * plan.state_rows + 2 * window)
            * itemsize + 2 * plan.stage_steps * partial_stride * 4)


def scan_plan(t: int, d: int, n: int, itemsize: int, *,
              n_sm: int) -> ScanPlan:
    """The plan for a scan over ``t`` steps of ``d >= 1`` channels with
    state width ``n >= 1`` and elements of ``itemsize`` bytes, on a card
    of ``n_sm`` SMs."""
    if n < 1 or d < 1 or t < 0:
        raise ValueError(f"ssm chunked kernel takes N >= 1 and D >= 1; got "
                         f"N={n}, D={d}")
    parts, _, np_ = state_split(n)
    warps_wanted = WARPS_PER_SM * n_sm
    rows = next((r for r in ROWS_PER_THREAD
                 if d * np_ * parts // r >= 32 * warps_wanted),
                ROWS_PER_THREAD[-1])
    steps = stage_steps(np_)
    ch = 1
    while True:   # widest power of two that keeps n_sm blocks, or 4 warps
        wider = ScanPlan(rows, 2 * ch, steps, np_, parts)
        if (not fits(d, wider.channels) or wider.threads() > MAX_THREADS
                or smem_bytes(wider, itemsize) > MAX_SMEM_BYTES
                or (wider.blocks(d) < n_sm
                    and ScanPlan(rows, ch, steps, np_, parts).threads()
                    >= MIN_THREADS)):
            break
        ch *= 2
    return ScanPlan(rows, ch, steps, np_, parts)


class EmaPlan(NamedTuple):
    channels: int      # channels a block holds (CH), a power of two
    stage_steps: int   # time steps a ring stage holds (S)
    ring: int          # stages of the ring
    piece: int         # bytes a copy moves: 16 by TMA, 8 or 4 by cp.async,
                       # the element's size by plain loads

    def blocks(self, d: int) -> int:
        return -(-d // self.channels)

    def threads(self) -> int:
        """Consumer warps for the channels, and the producer warps."""
        producers = 1 if self.piece == 16 else EMA_COPY_WARPS
        return 32 * (-(-self.channels // 32) + producers)

    def stage_bytes(self, itemsize: int) -> int:
        return 3 * self.stage_steps * self.channels * itemsize


def ema_smem_bytes(plan: EmaPlan, itemsize: int) -> int:
    """Shared memory the EMA kernel asks for (``smem_bytes`` of the
    source): the ring, a full and an empty mbarrier a stage, and 128 bytes
    to align the ring."""
    return plan.ring * (plan.stage_bytes(itemsize) + 16) + 128


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def ema_plan(t: int, d: int, itemsize: int, *, n_sm: int) -> EmaPlan:
    """The plan for an EMA scan over ``t`` steps of ``d >= 1`` channels of
    ``itemsize``-byte elements (4: float32; 2: bfloat16 or float16) on a
    card of ``n_sm`` SMs."""
    if d < 1 or t < 0 or itemsize not in (2, 4):
        raise ValueError(f"ssm EMA kernel takes D >= 1 and float32, "
                         f"bfloat16 or float16; got D={d}, "
                         f"itemsize={itemsize}")
    ch = 16 // itemsize   # rows of 16 bytes, TMA's least
    while (2 * ch <= EMA_MAX_CHANNELS and fits(d, 2 * ch)
           and -(-d // (2 * ch)) >= n_sm):
        ch *= 2
    lo, hi = EMA_STEPS
    row = 3 * ch * itemsize                  # bytes of one step of a stage
    blocks = -(-d // ch)
    # the ring's share of what the blocks an SM holds may use, less its
    # barriers and alignment
    budget = (min(MAX_SMEM_BYTES, SM_SMEM_BYTES // -(-blocks // n_sm)
                  - BLOCK_RESERVED_SMEM) - 16 * EMA_MAX_RING - 128)
    ring_bytes = min(budget, max(EMA_FLIGHT_BYTES // blocks, 2 * lo * row))
    steps = min(_pow2_floor(ring_bytes // (2 * row)),
                _pow2_floor(t // EMA_MIN_STAGES))
    steps = max(lo, min(hi, steps))
    stage = steps * row
    piece = copy_piece(d, itemsize)
    # cp.async copies keep up only with more stages in flight than TMA's
    # (ring depths 2-8 at D 7166 on the card, PERF.md)
    ring = min(EMA_MAX_RING, -(-t // steps),
               (ring_bytes if piece == 16 else budget) // stage)
    return EmaPlan(ch, steps, max(1, ring), piece)
