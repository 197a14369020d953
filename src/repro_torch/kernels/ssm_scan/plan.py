"""How the two scan kernels lay their work over the card.

State-expanded scan (``scan_plan``).
``ssm_chunked_kernel`` (``csrc/ssm_chunked_scan.cu``) gives each thread
``rows`` state rows of one channel, in registers for the whole sequence,
and each block ``channels`` channels (``channels * N / rows`` threads);
the grid is ``D / channels`` blocks.  Every step of a thread issues 4
instructions per state row plus a fixed cost (its loads of x, dt, b and c
and its y partial), so more rows a thread amortize that cost, and fewer
rows give more warps to fill the card's ``4 * n_sm`` schedulers.  The plan
takes the most rows (16, 8, 4) that still give every scheduler a warp, and
then the widest block that still leaves at least ``n_sm`` blocks (every SM
busy), within ``MAX_THREADS`` threads and the shared memory a block may
use; where the channels are too few for that, blocks of ``MIN_THREADS``
(4 warps, one a scheduler), which timed faster on the card than more
blocks of one warp.  Each block reads all of b and c (2 T N values) from
L2, so a block no narrower than that keeps the traffic small: 224 blocks
at full width (Zamba2-7B, T 4096, D 7168, N 64: 470 MB over the scan),
32 or 64 blocks of 4 channels at the main paths' D 128 and 256.

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
steps a block at full width.  A stage is as long as the ring's share
allows with two stages, at most 1/``EMA_MIN_STAGES`` of the sequence
(fewer, longer stages cost fewer waits; a short sequence still starts on
a small first stage), and the ring as deep as its share, the shared memory
of the blocks an SM holds and ``EMA_MAX_RING`` allow: the main paths' rings
hold the whole sequence.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["ScanPlan", "scan_plan", "smem_bytes", "ROWS_PER_THREAD",
           "MAX_THREADS", "MIN_THREADS", "MAX_SMEM_BYTES", "RING", "EmaPlan",
           "ema_plan", "ema_smem_bytes", "EMA_MAX_CHANNELS", "EMA_MAX_RING",
           "EMA_STEPS", "EMA_FLIGHT_BYTES", "SM_SMEM_BYTES",
           "BLOCK_RESERVED_SMEM"]

ROWS_PER_THREAD = (16, 8, 4)   # the kernel's template instances, most first
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
SM_SMEM_BYTES = 233_472        # shared memory of one SM (228 KB)
BLOCK_RESERVED_SMEM = 1024     # of it, what the runtime keeps for each block


class ScanPlan(NamedTuple):
    rows: int          # state rows a thread holds (R)
    channels: int      # channels a block holds (CH), a power of two
    stage_steps: int   # time steps a ring stage holds (S)

    def blocks(self, d: int) -> int:
        return d // self.channels

    def threads(self, n: int) -> int:
        return self.channels * (n // self.rows)


def stage_steps(n: int) -> int:
    """Time steps a stage holds: 32, or 16 for N = 256 (three stages of b
    and c must fit beside the partials)."""
    return 32 if n <= 128 else 16


def smem_bytes(plan: ScanPlan, n: int, itemsize: int) -> int:
    """Shared memory the kernel asks for (``smem_bytes`` of the source):
    the ring of b, c and the x, dt windows, then two stages of y
    partials."""
    window = max(plan.channels, 16 // itemsize)
    partial_stride = plan.channels * (n // plan.rows) + 4
    return (RING * plan.stage_steps * (2 * n + 2 * window) * itemsize
            + 2 * plan.stage_steps * partial_stride * 4)


def scan_plan(t: int, d: int, n: int, itemsize: int, *,
              n_sm: int) -> ScanPlan:
    """The plan for a scan over ``t`` steps of ``d`` channels with state
    width ``n`` (a power of two in [16, 256]; ``d`` a multiple of 128) and
    elements of ``itemsize`` bytes, on a card of ``n_sm`` SMs."""
    if n < 16 or n > 256 or n & (n - 1) or d < 1 or d % 128 or t < 0:
        raise ValueError(f"ssm chunked kernel takes N a power of two in "
                         f"[16, 256] and D % 128 == 0; got N={n}, D={d}")
    warps_wanted = WARPS_PER_SM * n_sm
    rows = next((r for r in ROWS_PER_THREAD
                 if d * n // r >= 32 * warps_wanted), ROWS_PER_THREAD[-1])
    steps = stage_steps(n)
    ch = 1
    while True:   # widest power of two that keeps n_sm blocks, or 4 warps
        wider = ScanPlan(rows, 2 * ch, steps)
        if (d % wider.channels or wider.threads(n) > MAX_THREADS
                or smem_bytes(wider, n, itemsize) > MAX_SMEM_BYTES
                or (wider.blocks(d) < n_sm
                    and ScanPlan(rows, ch, steps).threads(n)
                    >= MIN_THREADS)):
            break
        ch *= 2
    return ScanPlan(rows, ch, steps)


class EmaPlan(NamedTuple):
    channels: int      # channels a block holds (CH), a power of two
    stage_steps: int   # time steps a ring stage holds (S)
    ring: int          # stages of the ring

    def blocks(self, d: int) -> int:
        return d // self.channels

    def threads(self) -> int:
        """Consumer warps for the channels, and the producer warp."""
        return 32 * (-(-self.channels // 32) + 1)

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
    """The plan for an EMA scan over ``t`` steps of ``d`` channels (a
    multiple of 128) of ``itemsize``-byte elements (4 or 2) on a card of
    ``n_sm`` SMs."""
    if d < 1 or d % 128 or t < 0 or itemsize not in (2, 4):
        raise ValueError(f"ssm EMA kernel takes D % 128 == 0 and float32 or "
                         f"bf16; got D={d}, itemsize={itemsize}")
    ch = 16 // itemsize   # rows of 16 bytes, TMA's least
    while (2 * ch <= EMA_MAX_CHANNELS and d % (2 * ch) == 0
           and d // (2 * ch) >= n_sm):
        ch *= 2
    lo, hi = EMA_STEPS
    row = 3 * ch * itemsize                  # bytes of one step of a stage
    blocks = d // ch
    # the ring's share of what the blocks an SM holds may use, less its
    # barriers and alignment
    budget = (min(MAX_SMEM_BYTES, SM_SMEM_BYTES // -(-blocks // n_sm)
                  - BLOCK_RESERVED_SMEM) - 16 * EMA_MAX_RING - 128)
    ring_bytes = min(budget, max(EMA_FLIGHT_BYTES // blocks, 2 * lo * row))
    steps = min(_pow2_floor(ring_bytes // (2 * row)),
                _pow2_floor(t // EMA_MIN_STAGES))
    steps = max(lo, min(hi, steps))
    stage = steps * row
    ring = min(EMA_MAX_RING, -(-t // steps), ring_bytes // stage)
    return EmaPlan(ch, steps, max(1, ring))
