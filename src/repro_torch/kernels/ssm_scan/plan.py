"""How the state-expanded scan kernel lays its [N, D] state over the card.

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
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["ScanPlan", "scan_plan", "smem_bytes", "ROWS_PER_THREAD",
           "MAX_THREADS", "MIN_THREADS", "MAX_SMEM_BYTES", "RING"]

ROWS_PER_THREAD = (16, 8, 4)   # the kernel's template instances, most first
MAX_THREADS = 256              # the kernel's __launch_bounds__
MIN_THREADS = 128              # a block of 4 warps, one for each scheduler
MAX_SMEM_BYTES = 232_448       # dynamic shared memory one Hopper block may use
RING = 3                       # cp.async stages in the ring
WARPS_PER_SM = 4               # schedulers an SM has, each wanting a warp


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
