"""The MoE kernel's tile list, in plain PyTorch (a mirror of the pre-pass
``moe_tile_list`` of ``csrc/moe_dispatch.cu``).

The pre-pass cuts the sorted stream into M-tiles: a run of one expert
starts at ``i == 0`` or wherever ``eid[i] != eid[i - 1]``, and a tile starts
at every run start and every ``bm`` rows into a run.  Each tile is
``(first sorted row, rows, expert)``, in stream order.  Runs are cut
wherever ``eid`` changes, so an unsorted ``eid`` gives more, shorter tiles
and still the right product.  A tile holds at least one row, so there are
at most ``T`` of them: :func:`tile_capacity` is what the wrapper allocates.

The plan also sizes each launch (:func:`launch_shape`): the rows of an
M-tile and the blocks of the persistent GEMM, which the kernels take as
given.  The tests and ``chip_smoke.py`` use the mirror to check the list
the card builds; the card path calls only :func:`launch_shape` and
:func:`tile_capacity`.
"""

from __future__ import annotations

import torch

__all__ = ["BM", "SMALL_BM", "BN", "BLOCKS_PER_SM", "block_rows",
           "launch_shape", "tile_list", "tile_capacity"]

BM = 128         # sorted rows per M-tile: bf16 and f16 always, f32 at scale
SMALL_BM = 32    # f32 M-tile of a small dispatch
# columns per N-tile (bf16 and f16 run one tensor-core GEMM)
BN = {torch.float32: 128, torch.bfloat16: 256, torch.float16: 256}
# Blocks of each GEMM one SM holds at once (moe_gemm_f32 is built for two,
# __launch_bounds__(256, 2); moe_gemm_sm90 takes most of the shared memory).
BLOCKS_PER_SM = {torch.float32: 2, torch.bfloat16: 1, torch.float16: 1}


def block_rows(dtype: torch.dtype, n_tokens: int, f: int, *,
               n_sm: int) -> int:
    """Rows of an M-tile for one dispatch on a card of ``n_sm`` SMs:
    ``BM`` for bf16 and f16 (two wgmma M of 64); for f32 ``BM`` when even the
    fewest 128-row items (one tile a ``BM`` rows) fill every block the
    card holds, else ``SMALL_BM``, so that a small dispatch's items, 4x
    lighter, spread over more SMs."""
    if dtype != torch.float32:
        return BM
    items = -(-n_tokens // BM) * -(-f // BN[dtype])
    return BM if items >= BLOCKS_PER_SM[dtype] * n_sm else SMALL_BM


def launch_shape(dtype: torch.dtype, n_tokens: int, f: int, *,
                 n_sm: int) -> tuple[int, int]:
    """(rows of an M-tile, blocks of the persistent GEMM) for one dispatch:
    as many blocks as the card holds at once, or fewer when the dispatch
    cannot have that many items (at most one M-tile a row)."""
    items = n_tokens * -(-f // BN[dtype])
    return (block_rows(dtype, n_tokens, f, n_sm=n_sm),
            min(items, BLOCKS_PER_SM[dtype] * n_sm))


def tile_capacity(n_tokens: int) -> int:
    """Tile records the wrapper allocates for ``n_tokens`` sorted rows."""
    return n_tokens


def tile_list(eid: torch.Tensor, bm: int = BM) -> torch.Tensor:
    """eid [T] (the expert of each sorted row) -> int64 [n_tiles, 3] of
    ``(row0, rows, expert)`` in stream order."""
    eid = eid.long().cpu()
    t = eid.numel()
    if t == 0:
        return torch.zeros(0, 3, dtype=torch.long)
    pos = torch.arange(t)
    run_start = torch.ones(t, dtype=torch.bool)
    run_start[1:] = eid[1:] != eid[:-1]
    # the run open at each position: the latest run start at or before it
    open_at = torch.cummax(torch.where(run_start, pos, 0), dim=0).values
    starts = pos[(pos - open_at) % bm == 0]
    ends = torch.cat([starts[1:], torch.tensor([t])])
    return torch.stack([starts, ends - starts, eid[starts]], dim=1)

