"""How the f32 flash kernel cuts the kv axis over blocks.

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
"""

from __future__ import annotations

__all__ = ["split_plan", "BLOCK_Q", "KV_CHUNK", "SPLITS_PER_SM"]

BLOCK_Q = 128        # q rows one block holds
KV_CHUNK = 64        # kv rows one stage of the block's ring holds
SPLITS_PER_SM = 2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(b: int, h: int, sq: int, sk: int, *,
               n_sm: int) -> tuple[int, int]:
    """kv rows per range and the number of ranges for one launch over
    ``b * h`` heads of ``sq`` query and ``sk`` kv rows (multiples of 128 and
    64) on a card of ``n_sm`` SMs.  Every range but the last holds exactly
    ``rows per range`` rows, a multiple of ``KV_CHUNK``, and none is
    empty."""
    if sq < 1 or sq % BLOCK_Q or sk < 1 or sk % KV_CHUNK:
        raise ValueError(f"flash f32 kernel takes Sq a multiple of {BLOCK_Q} "
                         f"and Sk of {KV_CHUNK}; got Sq={sq}, Sk={sk}")
    blocks = b * h * (sq // BLOCK_Q)
    if blocks >= n_sm:
        return sk, 1
    want = _cdiv(SPLITS_PER_SM * n_sm, blocks)
    per = min(_cdiv(_cdiv(sk, want), KV_CHUNK) * KV_CHUNK, sk)
    return per, _cdiv(sk, per)
