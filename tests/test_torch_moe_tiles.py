"""The MoE kernel's tile list (``repro_torch.kernels.moe_dispatch.plan``,
the plain mirror of the pre-pass ``moe_tile_list`` in
``csrc/moe_dispatch.cu``) on the CPU.

The list must cut the sorted stream into M-tiles that cover every row
exactly once, never span two experts and hold at most ``bm`` rows, within
the allocation the wrapper makes; and a product computed tile by tile from
it must equal the plain version and the reference Pallas kernel in
interpret mode at ``tests/test_kernels.py``'s MoE tolerance (f32 atol
2e-5, rtol 1e-4).  The card's own list is held to this mirror by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch import moe_dispatch_sorted as jax_moe_sorted
from repro_torch.kernels.moe_dispatch import moe_dispatch_sorted_ref
from repro_torch.kernels.moe_dispatch.kernel import (_tiles_scratch,
                                                     tile_list_on_card)
from repro_torch.kernels.moe_dispatch.plan import (BM, SMALL_BM, block_rows,
                                                   launch_shape, tile_capacity,
                                                   tile_list)

MOE_TOL = dict(atol=2e-5, rtol=1e-4)
H100_SMS = 132   # streaming multiprocessors of an H100 SXM
MOE_CASES = [
    # (T, d, f, E), as tests/test_torch_moe_ssm.py
    (32, 128, 128, 4),
    (64, 128, 256, 16),
    (16, 256, 128, 2),
    (8, 128, 128, 8),
]


def dispatch_by_tiles(x: torch.Tensor, w: torch.Tensor, tok: torch.Tensor,
                      tiles: torch.Tensor) -> torch.Tensor:
    """y [T, F] computed tile by tile from a tile list, as the kernels walk
    it: ``y[tok[row0 + r]] = x[tok[row0 + r]] @ w[expert]`` for r < rows, in
    float32.  Rows no tile covers stay NaN."""
    y = torch.full((x.shape[0], w.shape[2]), float("nan"))
    tok = tok.long()
    for row0, rows, expert in tiles.tolist():
        dst = tok[row0:row0 + rows]
        y[dst] = x[dst] @ w[expert]
    return y


def _naive_tiles(eid: np.ndarray, bm: int) -> list[tuple[int, int, int]]:
    """Walk the stream row by row: a new tile at a new expert or a full
    tile."""
    tiles = []
    for i, e in enumerate(eid.tolist()):
        if tiles and tiles[-1][2] == e and tiles[-1][1] < bm:
            row0, rows, _ = tiles[-1]
            tiles[-1] = (row0, rows + 1, e)
        else:
            tiles.append((i, 1, e))
    return tiles


def _eids(kind: str, rng: np.random.Generator) -> np.ndarray:
    if kind == "sorted":
        return np.sort(rng.integers(0, 16, 1000))
    if kind == "unsorted":
        return rng.integers(0, 16, 1000)
    if kind == "single expert":
        return np.full(300, 3)
    if kind == "one row per expert":
        return np.arange(64)
    if kind == "experts absent":   # experts 0-9 and 20-29 never routed
        return np.sort(np.concatenate([rng.integers(10, 20, 200),
                                       rng.integers(30, 40, 200)]))
    if kind == "T < BM":
        return np.sort(rng.integers(0, 4, 37))
    if kind == "T = 24576, top-6 of 64":
        choice = rng.random((4096, 64)).argsort(axis=1)[:, :6].reshape(-1)
        return np.sort(choice, kind="stable")
    if kind == "runs of bm - 1, bm, bm + 1":
        return np.repeat(np.arange(3), [BM - 1, BM, BM + 1])
    raise ValueError(kind)


KINDS = ["sorted", "unsorted", "single expert", "one row per expert",
         "experts absent", "T < BM", "T = 24576, top-6 of 64",
         "runs of bm - 1, bm, bm + 1"]


@pytest.mark.parametrize("bm", [BM, SMALL_BM])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_list_cuts_runs_into_tiles(kind, bm):
    eid = _eids(kind, np.random.default_rng(len(kind)))
    t = len(eid)
    tiles = tile_list(torch.from_numpy(eid).to(torch.int32), bm)
    assert tiles.dtype == torch.long and tiles.shape[1] == 3
    row0, rows, expert = (tiles[:, i].numpy() for i in range(3))
    # every sorted row lies in exactly one tile, in stream order
    assert row0[0] == 0 and (row0[1:] == row0[:-1] + rows[:-1]).all()
    assert row0[-1] + rows[-1] == t
    assert (rows >= 1).all() and (rows <= bm).all()
    # no tile spans two experts
    for r0, n, e in tiles.tolist():
        assert (eid[r0:r0 + n] == e).all()
    assert len(tiles) <= tile_capacity(t)
    assert [tuple(x) for x in tiles.tolist()] == _naive_tiles(eid, bm)


def test_tile_capacity_bounds_every_list():
    """At most T tiles (each holds a row), within ceil(T/BM) + T (every run
    cut into tiles of BM), even when every row starts a run."""
    rng = np.random.default_rng(5)
    for t in (1, 2, 127, 128, 129, 1000):
        for eid in (np.arange(t) % 2, rng.integers(0, 3, t), np.zeros(t)):
            n = len(tile_list(torch.from_numpy(eid)))
            assert n <= tile_capacity(t) <= -(-t // BM) + t


@pytest.mark.parametrize("bm", [BM, SMALL_BM, 4, 7])
@pytest.mark.parametrize("case", MOE_CASES)
def test_dispatch_by_tiles_matches_reference(case, bm):
    """y computed tile by tile (the kernels' walk) equals the plain version
    and the reference kernel, sorted and unsorted."""
    t, d, f, e = case
    rng = np.random.default_rng(t * 131 + e)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    eids = rng.integers(0, e, size=t).astype(np.int32)
    for sort in (True, False):
        tok = (np.argsort(eids, kind="stable") if sort
               else rng.permutation(t)).astype(np.int32)
        eid = eids[tok]
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
        ttok, teid = torch.from_numpy(tok), torch.from_numpy(eid)
        got = dispatch_by_tiles(tx, tw, ttok, tile_list(teid, bm))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(
            got.numpy(), moe_dispatch_sorted_ref(tx, tw, ttok, teid).numpy(),
            **MOE_TOL)
        want = jax_moe_sorted(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tok),
                              jnp.asarray(eid), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


def test_dispatch_by_tiles_leaves_uncovered_rows_nan():
    """A list that misses a row leaves it NaN, as the card's NaN-filled
    outputs show an unwritten row."""
    x, w = torch.ones(4, 128), torch.ones(1, 128, 128)
    tok = torch.arange(4)
    y = dispatch_by_tiles(x, w, tok, torch.tensor([[0, 3, 0]]))
    assert torch.isfinite(y[:3]).all() and torch.isnan(y[3]).all()


def test_card_tile_list_takes_cuda_tensors_only():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tile_list_on_card(ids, ids, 2, BM)


def test_tile_scratch_holds_the_list_and_refuses_an_oversized_bitmap():
    """The header and records, then room for the pre-pass's bitmap, which
    it keeps in global memory where a block's shared memory cannot hold it
    (above 1 859 584 tokens), so no token count is refused."""
    buf = _tiles_scratch(1000, torch.device("cpu"))
    assert buf.dtype == torch.int32 and buf.numel() == 4 + 4 * 1000 + 32
    buf = _tiles_scratch(2_000_000, torch.device("cpu"))
    assert buf.numel() == 4 + 4 * 2_000_000 + 62_500


@pytest.mark.parametrize("t, f, want", [
    (24576, 1408, BM),     # DeepSeek-MoE-16B's routed layer: 2112 items
    (64, 128, SMALL_BM),   # the captured roster's cold dispatch
    (512, 256, SMALL_BM),  # its warm one
    (8, 128, SMALL_BM),    # the serving roster's
])
def test_block_rows_fits_the_tiles_to_the_dispatch(t, f, want):
    """f32 takes 128-row tiles only when they give every SM two items;
    bf16 always 128 (two wgmma M of 64)."""
    assert block_rows(torch.float32, t, f, n_sm=H100_SMS) == want
    assert block_rows(torch.bfloat16, t, f, n_sm=H100_SMS) == BM


@pytest.mark.parametrize("dtype, t, f, want", [
    (torch.float32, 24576, 1408, (BM, 264)),      # two blocks an SM
    (torch.bfloat16, 24576, 1408, (BM, 132)),     # one block an SM
    (torch.float32, 64, 128, (SMALL_BM, 64)),     # at most one item a row
    (torch.bfloat16, 8, 128, (BM, 8)),            # one N-tile of 256
    (torch.bfloat16, 100, 384, (BM, 132)),        # 2 N-tiles a row
])
def test_launch_shape_sizes_the_grid_to_the_card(dtype, t, f, want):
    """The persistent grid is as many blocks as the card holds at once
    (two an SM in f32, one in bf16), or fewer when the dispatch cannot
    have that many (M-tile, N-tile) items."""
    assert launch_shape(dtype, t, f, n_sm=H100_SMS) == want
