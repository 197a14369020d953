"""How the flash kernels tile a launch and how the f32 one cuts the kv
axis over blocks.

``flash_fwd_kernel`` (``csrc/flash_attention.cu``) takes one 128-row q tile
of one (batch, head) a block; alone, that grid is ``B * H * Sq / 128``
blocks.  At full width that is 1280 blocks on 132 SMs, but every launch of
the main paths is one head with 128 or 256 query rows: 1-2 blocks, each
walking up to 20480 kv rows alone.  Flash decoding cuts the kv axis into
ranges of consecutive rows, one block a (q tile, range), each writing f32
partials (m, l and the unnormalized acc) that ``flash_combine`` folds in
range order.  The plan asks for ``SPLITS_PER_SM`` blocks an SM, so every
range runs in the first or second wave; a range holds a whole number of the
kernel's 64-row chunks, so the K and V it reads (2 x 64 rows x D floats at
least) are about as many bytes as the partials it writes (128 rows x
(D + 2) floats).  A grid that already fills the card gets one range,
which writes the output itself in one launch.

Both tiled kernels are instantiated for the padded widths
``TILED_HEAD_DIMS`` alone and take every ``D % 8 == 0`` up to
``MAX_HEAD_DIM`` at run time: a launch at D runs the kernel built for
:func:`padded_head_dim` (D rounded up to a whole 64-column panel), whose
shared-memory rows hold D real columns and zeros up to DP, while every
global read and write stays at the real D (each DP has a second instance
for D = DP itself, compiled as a kernel of that fixed width).  Their tiles
shrink above DP = 128, where the tiles of DP = 128 do not fit a block's
shared memory (:func:`f32_tiles`, :func:`sm90_kv_rows`); every function
here takes DP.

Above ``TILED_MAX_HEAD_DIM`` (DP 320 to 1024) two other kernels take the
launch, ``flash_fwd_wide`` (f32) and ``flash_fwd_wide_sm90`` (bf16): a
thread there would hold more than the DP = 256 instances' accumulators, so
the head's 64-column panels are dealt to ``ceil(DP / 256)`` blocks along
the grid's z (:func:`wide_panels`, 3 + 2 at DP 320), each writing its own
columns of O.  In f32 (:func:`wide_f32_plan`, up to ``MAX_HEAD_DIM`` =
1024) those blocks are a thread-block cluster that splits S as well, over
runs of Q and K dealt the other way round (:func:`wide_s_panels`, 2 + 3
at DP 320): block r loads only its own columns of Q, K and V, computes
its partial S_r = Q[:, s_cols_r] K[:, s_cols_r]^T each kv step, reads its
peers' through distributed shared memory and sums S_0 + S_1 + ... in rank
order, so every block holds the same S (and m, l) and S is computed once
a step.  In bf16 (:func:`wide_sm90_plan`, up to ``SM90_MAX_HEAD_DIM`` =
512) the two blocks each compute S over the whole head: exchanging the
partial S would cost more on the SM-to-SM network than the tensor cores
take to recompute it (PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["split_plan", "padded_head_dim", "f32_tiles", "sm90_kv_rows",
           "sm90_smem_bytes", "wide_f32_plan", "wide_sm90_plan", "wide_panels",
           "wide_s_panels", "WidePlan", "BLOCK_Q", "KV_CHUNK", "SPLITS_PER_SM",
           "TILED_HEAD_DIMS",
           "TILED_MAX_HEAD_DIM", "MAX_HEAD_DIM", "PANEL", "WIDE_PANEL",
           "WIDE_MAX_CLUSTER", "WIDE_SM90_BLOCKS", "SM90_MAX_HEAD_DIM",
           "SMEM_PER_BLOCK"]

BLOCK_Q = 128        # q rows one block holds (DP <= 128)
KV_CHUNK = 64        # kv rows one stage of the block's ring holds (DP <= 128)
SPLITS_PER_SM = 2
PANEL = 64           # columns of one 128-byte bf16 row of a TMA box
TILED_HEAD_DIMS = (64, 128, 192, 256)   # the padded widths DP built
TILED_MAX_HEAD_DIM = 256   # the widest head the tiled kernels take
# The widest head any kernel takes: f32's cluster of WIDE_MAX_CLUSTER blocks
# of WIDE_PANEL columns each.  A block's buffers hold its own columns alone,
# so they fit at any width; the cluster is what grows: every block reads
# each of its peers' partial score tiles every kv step, through the SM-to-SM
# network (2.0-2.2 us a step at four blocks against 1.0 at two, PERF.md).
# bf16 keeps the whole 128-row Q tile in each of its two blocks beside a V
# ring of the block's panels: 230 504 bytes at DP 512, 263 272 at 576 (a
# third block would buy 576 alone: at 640 the Q tile, the K ring and a V
# ring of three panels take 246 888).  The reference's mha has no cap;
# wider heads raise (ROADMAP.md).
WIDE_MAX_CLUSTER = 4
WIDE_SM90_BLOCKS = 2
MAX_HEAD_DIM = 1024
SM90_MAX_HEAD_DIM = 512
SMEM_PER_BLOCK = 232_448   # bytes of shared memory a block may use
SM90_BLOCK_Q = 128
SM90_STAGES = 2
# Columns of the head one block of a wide kernel holds at most: the
# accumulators of the DP = 256 instances (f32 4 rows x 64 columns a thread,
# bf16 a 64 x 256 wgmma accumulator of 128 registers a thread), and wgmma's
# widest N.
WIDE_PANEL = 256
WIDE_F32_SLOTS = 4      # flash_fwd_wide: ring slots of one 32 x 128 unit each
WIDE_F32_UNIT = 2 * PANEL  # ... columns of a unit: two 64-column panels
WIDE_SM90_K_STAGES = 4  # flash_fwd_wide_sm90: ring of 64 x 64 K panels
WIDE_SM90_V_STAGES = 2  # ... and of 64-row V tiles of the block's columns
WIDE_STAGES = 2         # f32 exchange slots a block holds: its partial S


def padded_head_dim(d: int) -> int:
    """The padded width DP a kernel takes head width ``d`` at: ``d``
    rounded up to a whole ``PANEL``, one of ``TILED_HEAD_DIMS`` up to
    ``TILED_MAX_HEAD_DIM`` (the tiled kernels' instance), else 320 to 1024
    (the wide kernels' panels); raises on a width no kernel takes: D % 8 !=
    0 or D above ``MAX_HEAD_DIM``."""
    if not (8 <= d <= MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"flash kernels take D % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}, got D={d}")
    return _cdiv(d, PANEL) * PANEL


class WidePlan(NamedTuple):
    """How a wide kernel tiles a launch at one padded width DP."""

    block_q: int      # q rows a block holds
    kv_rows: int      # kv rows of a step (f32) or a kv tile (bf16)
    blocks: int       # blocks along the grid's z that split the head
    cluster: int      # ... of them in one thread-block cluster (1: none)
    panel_cols: int   # most columns of O a block holds (x 64)
    smem_bytes: int   # dynamic shared memory of the widest block


def wide_panels(dp: int) -> list[tuple[int, int]]:
    """(first 64-column panel, panels) of each of a wide kernel's blocks
    along the grid's z at padded width ``dp``: the DP / 64 panels of the
    head dealt to ``ceil(DP / WIDE_PANEL)`` blocks in contiguous runs,
    evenly, the first taking one more (3 + 2 at DP 320, 4 + 4 at 512,
    3 + 3 + 3 at 576).  Block r writes panels p0 .. p0 + n - 1 of O and
    reads those columns of V (f32: its columns of Q and K are
    :func:`wide_s_panels`')."""
    _wide(dp)
    n_panels = dp // PANEL
    n = _cdiv(dp, WIDE_PANEL)
    base, extra = divmod(n_panels, n)
    return [(r * base + min(r, extra), base + (r < extra)) for r in range(n)]


def wide_s_panels(dp: int) -> list[tuple[int, int]]:
    """(first 64-column panel, panels) of the columns of Q and K each rank
    of ``flash_fwd_wide``'s cluster computes its part of S over: the runs
    of :func:`wide_panels` dealt the other way round, the last ranks taking
    one more (2 + 3 at DP 320), so that a block's S and O columns add up to
    the same count, or one more, in every block.  The cluster sums the
    parts in this rank order."""
    sizes = [n for _, n in wide_panels(dp)][::-1]
    starts = [sum(sizes[:r]) for r in range(len(sizes))]
    return list(zip(starts, sizes))


def wide_f32_plan(dp: int) -> WidePlan:
    """``flash_fwd_wide``'s tiles at padded width ``dp`` (320 to 1024): 64
    q rows (4 a thread, as at DP 256) against 32 kv rows a step, a block
    holding its :func:`wide_panels` run of the head.  K and V pass through a
    ring of ``WIDE_F32_SLOTS`` units, a unit being 32 rows of two 64-column
    panels of the block's K (its part of S's sum) or V (its columns of O).
    Shared memory: ``WIDE_STAGES`` slots of the 64 x 32 partial S it
    publishes, P, the ring, the block's Q columns."""
    _wide(dp)
    block_q, kv_rows = 64, 32
    cols = max(n for _, n in wide_panels(dp)) * PANEL
    smem = 4 * (WIDE_STAGES * block_q * kv_rows + block_q * kv_rows
                + WIDE_F32_SLOTS * kv_rows * WIDE_F32_UNIT + block_q * cols)
    n = _cdiv(dp, WIDE_PANEL)
    return WidePlan(block_q, kv_rows, n, n, cols, smem)


def wide_sm90_plan(dp: int) -> WidePlan:
    """``flash_fwd_wide_sm90``'s tiles at padded width ``dp`` (320 to
    ``SM90_MAX_HEAD_DIM``): 128 q rows (two consumer warpgroups of 64)
    against 64 kv rows, ``WIDE_SM90_BLOCKS`` blocks, no cluster, each
    computing S over the whole head and P V over its :func:`wide_panels`
    run.  Shared memory: alignment slack, the whole Q tile (DP / 64
    panels), a ring of ``WIDE_SM90_K_STAGES`` 64-column K panels and one of
    ``WIDE_SM90_V_STAGES`` V tiles of the widest block's columns, the
    mbarriers."""
    _wide(dp)
    if dp > SM90_MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd_wide_sm90 takes padded widths up to "
                         f"{SM90_MAX_HEAD_DIM}; got DP={dp}")
    kv_rows = 64
    cols = max(n for _, n in wide_panels(dp)) * PANEL
    smem = (1024 + SM90_BLOCK_Q * dp * 2
            + WIDE_SM90_K_STAGES * kv_rows * PANEL * 2
            + WIDE_SM90_V_STAGES * kv_rows * cols * 2
            + 8 * (1 + 2 * WIDE_SM90_K_STAGES + 2 * WIDE_SM90_V_STAGES))
    return WidePlan(SM90_BLOCK_Q, kv_rows, WIDE_SM90_BLOCKS, 1, cols, smem)


def _wide(dp: int) -> None:
    if not (TILED_MAX_HEAD_DIM < dp <= MAX_HEAD_DIM and dp % PANEL == 0):
        raise ValueError(f"the wide flash kernels take padded widths above "
                         f"{TILED_MAX_HEAD_DIM} up to {MAX_HEAD_DIM} in steps "
                         f"of {PANEL}; got DP={dp}")


def f32_tiles(dp: int) -> tuple[int, int]:
    """(q rows a block holds, kv rows a stage holds) of ``flash_fwd_kernel``
    at padded width ``dp``: 16 row groups of 8 rows and 16 lanes of 4
    columns, or 4 rows and 2 columns above DP = 128, where a 128-row f32 Q
    tile alone takes 96 KB or more."""
    return (64, 32) if dp > 128 else (BLOCK_Q, KV_CHUNK)


def sm90_smem_bytes(dp: int, kv_rows: int) -> int:
    """``flash_fwd_sm90``'s shared memory at padded width ``dp``: alignment
    slack, the bf16 Q tile, two stages of K and V tiles, the mbarriers."""
    return (1024 + SM90_BLOCK_Q * dp * 2 + 2 * SM90_STAGES * kv_rows * dp * 2
            + 8 * (1 + 3 * SM90_STAGES))


def sm90_kv_rows(dp: int) -> int:
    """K/V tile rows of ``flash_fwd_sm90`` at padded width ``dp``: 128
    where the buffers fit a block's shared memory, else 64 (DP 192 and
    256)."""
    for rows in (128, 64):
        if sm90_smem_bytes(dp, rows) <= SMEM_PER_BLOCK:
            return rows
    raise ValueError(f"flash_fwd_sm90 fits no K/V tile at DP={dp}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(b: int, h: int, sq: int, sk: int, *, n_sm: int,
               d: int = 128) -> tuple[int, int]:
    """kv rows per range and the number of ranges for one launch over
    ``b * h`` heads of ``sq`` query and ``sk`` kv rows (any Sq, Sk >= 1;
    the padded width's tiles are :func:`f32_tiles`', 128 and 64 up to
    DP = 128, above ``TILED_MAX_HEAD_DIM`` :func:`wide_f32_plan`'s, whose
    clusters multiply the blocks; a partial last q tile counts as a tile)
    on a card of ``n_sm`` SMs.  Every range but the last holds exactly
    ``rows per range`` rows, a multiple of the kv tile; the last ends at
    Sk, inside a tile where Sk is not a multiple of it; none is empty."""
    cluster = 1
    if d > TILED_MAX_HEAD_DIM:
        block_q, chunk, cluster = wide_f32_plan(d)[:3]
    else:
        block_q, chunk = f32_tiles(d)
    if sq < 1 or sk < 1:
        raise ValueError(f"flash f32 kernel takes Sq, Sk >= 1; got Sq={sq}, "
                         f"Sk={sk}")
    whole = _cdiv(sk, chunk) * chunk   # Sk rounded up to whole kv tiles
    blocks = b * h * _cdiv(sq, block_q) * cluster
    if blocks >= n_sm:
        return whole, 1
    want = _cdiv(SPLITS_PER_SM * n_sm, blocks)
    per = min(_cdiv(_cdiv(sk, want), chunk) * chunk, whole)
    return per, _cdiv(sk, per)
