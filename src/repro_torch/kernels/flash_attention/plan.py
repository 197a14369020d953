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

Above ``TILED_MAX_HEAD_DIM`` (DP 320 to 512) two other kernels take the
launch, ``flash_fwd_wide`` (f32) and ``flash_fwd_wide_sm90`` (bf16): a
thread there would hold more than the DP = 256 instances' accumulators, so
O is cut into column panels of at most ``WIDE_PANEL`` columns, one block a
panel (a grid axis), each block recomputing S over the whole head, and S
is summed over 64-column panels of Q and K streamed through a ring, so
that a block holds the Q tile and a few 64-column panels beside it
(:func:`wide_f32_plan`, :func:`wide_sm90_plan`).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["split_plan", "padded_head_dim", "f32_tiles", "sm90_kv_rows",
           "sm90_smem_bytes", "wide_f32_plan", "wide_sm90_plan", "WidePlan",
           "BLOCK_Q", "KV_CHUNK", "SPLITS_PER_SM", "TILED_HEAD_DIMS",
           "TILED_MAX_HEAD_DIM", "MAX_HEAD_DIM", "PANEL", "WIDE_PANEL",
           "SMEM_PER_BLOCK"]

BLOCK_Q = 128        # q rows one block holds (DP <= 128)
KV_CHUNK = 64        # kv rows one stage of the block's ring holds (DP <= 128)
SPLITS_PER_SM = 2
PANEL = 64           # columns of one 128-byte bf16 row of a TMA box
TILED_HEAD_DIMS = (64, 128, 192, 256)   # the padded widths DP built
TILED_MAX_HEAD_DIM = 256   # the widest head the tiled kernels take
# The widest head any kernel takes: the widest padded width at which
# flash_fwd_wide_sm90's 128-row bf16 Q tile, kept whole in shared memory
# beside its K and V rings, fits a block (DP 512: 230 504 bytes; DP 576
# would take 246 888).  The reference's mha has no cap; wider heads raise
# (ROADMAP.md).
MAX_HEAD_DIM = 512
SMEM_PER_BLOCK = 232_448   # bytes of shared memory a block may use
SM90_BLOCK_Q = 128
SM90_STAGES = 2
# Output columns one block of a wide kernel holds: the accumulators of the
# DP = 256 instances (f32 4 rows x 64 columns a thread, bf16 a 64 x 256
# wgmma accumulator of 128 registers a thread), and wgmma's widest N.
WIDE_PANEL = 256
WIDE_F32_SLOTS = 4      # flash_fwd_wide: ring slots of one 32 x 64 unit each
WIDE_SM90_K_STAGES = 4  # flash_fwd_wide_sm90: ring of 64 x 64 K panels
WIDE_SM90_V_STAGES = 2  # ... and of 64 x 256 V tiles


def padded_head_dim(d: int) -> int:
    """The padded width DP a kernel takes head width ``d`` at: ``d``
    rounded up to a whole ``PANEL``, one of ``TILED_HEAD_DIMS`` up to
    ``TILED_MAX_HEAD_DIM`` (the tiled kernels' instance), else 320, 384,
    448 or 512 (the wide kernels' Q rows in shared memory); raises on a
    width no kernel takes: D % 8 != 0 or D above ``MAX_HEAD_DIM``."""
    if not (8 <= d <= MAX_HEAD_DIM and d % 8 == 0):
        raise ValueError(f"flash kernels take D % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}, got D={d}")
    return _cdiv(d, PANEL) * PANEL


class WidePlan(NamedTuple):
    """How a wide kernel tiles a launch at one padded width DP."""

    block_q: int      # q rows a block holds
    kv_rows: int      # kv rows of a K panel (and a V tile)
    panels: int       # output column panels: blocks along the grid's z
    panel_cols: int   # output columns a block holds (a multiple of 64)
    smem_bytes: int   # dynamic shared memory of a block


def wide_f32_plan(dp: int) -> WidePlan:
    """``flash_fwd_wide``'s tiles at padded width ``dp`` (320 to 512): 64
    q rows (4 a thread, as at DP 256) against 32 kv rows a step.  Its ring
    has ``WIDE_F32_SLOTS`` slots of one unit each, a unit being 32 rows of
    64 columns of K (a panel of S's sum) or of V (a panel of O); the DP / 64
    V panels are dealt to as few blocks as hold at most ``WIDE_PANEL``
    columns each, evenly.  Shared memory: the Q tile, the ring, P."""
    _wide(dp)
    block_q, kv_rows = 64, 32
    v_panels = dp // PANEL
    panels = _cdiv(v_panels, WIDE_PANEL // PANEL)
    smem = 4 * (block_q * dp + WIDE_F32_SLOTS * kv_rows * PANEL
                + block_q * kv_rows)
    return WidePlan(block_q, kv_rows, panels,
                    _cdiv(v_panels, panels) * PANEL, smem)


def wide_sm90_plan(dp: int) -> WidePlan:
    """``flash_fwd_wide_sm90``'s tiles at padded width ``dp`` (320 to
    512): 128 q rows (two consumer warpgroups of 64) against 64 kv rows,
    O in two panels of ``WIDE_PANEL`` columns (a panel's columns past D are
    zeros in V).  Shared memory: alignment slack, the Q tile (DP / 64
    panels), a ring of ``WIDE_SM90_K_STAGES`` 64-column K panels and one of
    ``WIDE_SM90_V_STAGES`` V tiles of ``WIDE_PANEL`` columns, the
    mbarriers."""
    _wide(dp)
    kv_rows = 64
    smem = (1024 + SM90_BLOCK_Q * dp * 2
            + WIDE_SM90_K_STAGES * kv_rows * PANEL * 2
            + WIDE_SM90_V_STAGES * kv_rows * WIDE_PANEL * 2
            + 8 * (1 + 2 * WIDE_SM90_K_STAGES + 2 * WIDE_SM90_V_STAGES))
    return WidePlan(SM90_BLOCK_Q, kv_rows, _cdiv(dp, WIDE_PANEL), WIDE_PANEL,
                    smem)


def _wide(dp: int) -> None:
    if not (TILED_MAX_HEAD_DIM < dp and dp % PANEL == 0):
        raise ValueError(f"the wide flash kernels take padded widths above "
                         f"{TILED_MAX_HEAD_DIM} in steps of {PANEL}; got "
                         f"DP={dp}")


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
    ``b * h`` heads of ``sq`` query and ``sk`` kv rows (multiples of the
    padded width's tiles, :func:`f32_tiles`: 128 and 64 up to DP = 128;
    above ``TILED_MAX_HEAD_DIM`` :func:`wide_f32_plan`'s, whose output
    panels multiply the blocks) on a card of ``n_sm`` SMs.  Every range but
    the last holds exactly ``rows per range`` rows, a multiple of the kv
    tile, and none is empty."""
    panels = 1
    if d > TILED_MAX_HEAD_DIM:
        block_q, chunk, panels = wide_f32_plan(d)[:3]
    else:
        block_q, chunk = f32_tiles(d)
    if sq < 1 or sq % block_q or sk < 1 or sk % chunk:
        raise ValueError(f"flash f32 kernel takes Sq a multiple of {block_q} "
                         f"and Sk of {chunk}; got Sq={sq}, Sk={sk}")
    blocks = b * h * (sq // block_q) * panels
    if blocks >= n_sm:
        return sk, 1
    want = _cdiv(SPLITS_PER_SM * n_sm, blocks)
    per = min(_cdiv(_cdiv(sk, want), chunk) * chunk, sk)
    return per, _cdiv(sk, per)
