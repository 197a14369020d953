"""The window count's launch plan (``repro_torch.kernels.window_scan.plan``).

``lanes`` x ``steps`` covers the chunk (or the full-warp walk takes it),
every (lanes, steps) the plan picks has a kernel template, the source's
constants are the plan's, tiles cover every row once, the persistent grid
fits the card and the block's shared memory fits the SM, over chunks
1-4096, row counts 0-4M and both dtypes.  The kernel's walk
(``csrc/window_scan.cu``: each block's tiles, each lane segment's rows,
each lane's window slots) is written out in NumPy from the plan and held
exactly against the plain version on seeded rows at every (lanes, steps),
with ragged last tiles, int32 and int64."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.window_scan import window_counts_ref
from repro_torch.kernels.window_scan import plan as window_plan_module
from repro_torch.kernels.window_scan.plan import (BLOCKS_PER_SM, LANE_CAP,
                                                  LOADS, LONG_STEPS,
                                                  MAX_STEPS, SMEM_PER_SM,
                                                  THREADS, lanes_for,
                                                  rows_in_flight, steps_for,
                                                  window_plan)

SOURCE = (Path(window_plan_module.__file__).resolve().parents[2] / "csrc"
          / "window_scan.cu").read_text()
CHUNKS = [1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64, 128, 129, 256, 257, 1024,
          4096]
ROW_COUNTS = [0, 1, 2, 31, 32, 33, 127, 128, 129, 511, 512, 513, 100_000,
              684_957, 1_336_395, 3_215_561, 4 << 20]


def _shapes_in_source() -> set[tuple[int, int]]:
    return {(int(a), int(b)) for a, b in
            re.findall(r"REPRO_WINDOW_SHAPE\((\d+), (\d+)\)", SOURCE)}


def test_lanes_and_steps_cover_the_chunk():
    assert (lanes_for(0), steps_for(0)) == (1, 1)
    shapes = _shapes_in_source()
    picked = set()
    for chunk in range(1, 4097):
        lanes, steps = lanes_for(chunk), steps_for(chunk)
        picked.add((lanes, steps))
        for n in (lanes, steps):
            assert n & (n - 1) == 0
        if lanes == 32 and steps == 1 and chunk > 32:
            assert chunk > 32 * MAX_STEPS          # the full-warp walk
            continue
        assert chunk <= lanes * steps < 2 * chunk
        assert steps <= MAX_STEPS
        assert lanes <= LANE_CAP or lanes == 32
        assert lanes == 32 or lanes == min(LANE_CAP, lanes * steps)
    assert picked == shapes         # a template for each, none unused


def test_source_constants_are_the_plan_s():
    for name, value in (("kThreads", THREADS), ("kLongSteps", LONG_STEPS),
                        ("kLoads", LOADS),
                        ("kMaxTileRows", window_plan_module.MAX_TILE_ROWS)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE), name


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_plan_covers_the_rows_and_fits_the_card(chunk, itemsize):
    for n_rows in ROW_COUNTS:
        for n_sm in (1, 132):
            p = window_plan(n_rows, chunk, itemsize, n_sm=n_sm)
            tile, lanes, steps = p["rows_per_tile"], p["lanes"], p["steps"]
            assert (lanes, steps) == (lanes_for(chunk), steps_for(chunk))
            k = rows_in_flight(lanes, steps)
            assert tile == THREADS // lanes * k
            assert k * steps <= LOADS or k == 1
            assert tile & (tile - 1) == 0 and tile <= 512
            assert (p["tiles"] - 1) * tile < n_rows <= p["tiles"] * tile \
                or n_rows == p["tiles"] == 0
            assert p["smem_bytes"] == 7 * tile * itemsize <= 48 * 1024
            assert 1 <= p["blocks_per_sm"] <= BLOCKS_PER_SM
            assert p["blocks_per_sm"] * (p["smem_bytes"] + 1024) \
                <= SMEM_PER_SM
            assert p["grid"] == min(p["tiles"], p["blocks_per_sm"] * n_sm)
            assert (p["grid"] == 0) == (n_rows == 0)


def test_resident_blocks_cap_the_grid():
    free = window_plan(1 << 20, 8, 4, n_sm=132)
    assert free["blocks_per_sm"] == BLOCKS_PER_SM
    for resident in (1, 5, 6, BLOCKS_PER_SM, 16):
        p = window_plan(1 << 20, 8, 4, n_sm=132, resident=resident)
        assert p["blocks_per_sm"] == min(resident, BLOCKS_PER_SM)
        assert p["grid"] == 132 * p["blocks_per_sm"]
        assert {k: v for k, v in p.items()
                if k not in ("blocks_per_sm", "grid")} == \
            {k: v for k, v in free.items()
             if k not in ("blocks_per_sm", "grid")}


def test_bad_plans_raise():
    for args in ((-1, 8, 4), (4, -1, 4), (4, 8, 2)):
        with pytest.raises(ValueError):
            window_plan(*args, n_sm=132)
    with pytest.raises(ValueError):
        window_plan(4, 8, 4, n_sm=0)
    with pytest.raises(ValueError):
        window_plan(4, 8, 4, n_sm=132, resident=0)


def _rows(m: int, n_rows: int, chunk: int, seed: int, dtype):
    """Seeded q and (lo, thr, span) rows: ragged spans in [0, chunk + 3]
    (the kernel caps them at chunk), windows ending at m - 1 and past it."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, max(m // 4, 1), m)
    q[rng.random(m) < 0.2] = -1
    lo = rng.integers(0, m, n_rows)
    span = rng.integers(0, chunk + 4, n_rows)
    span[: n_rows // 4] = chunk
    k = n_rows // 8
    lo[-k:] = np.maximum(m - span[-k:], 0)
    lo[-2 * k:-k] = m - 1
    thr = rng.integers(-2, max(m // 4, 1), n_rows)
    return q.astype(dtype), np.stack([lo, thr, span]).astype(dtype)


def _walk(q: np.ndarray, rows: np.ndarray, chunk: int, plan: dict):
    """The kernel's walk from its plan: block b takes tiles b, b + grid,
    ...; slot i of a tile is row r0 + i, walked by segment i % segs as its
    (i // segs)-th row in flight; its lanes read offsets 0..lanes x steps
    - 1 when chunk <= lanes x steps, else the warp's LONG_STEPS x 32-slot
    steps until the window ends.  Returns the counts and how often each
    row was written."""
    lanes, steps = plan["lanes"], plan["steps"]
    tile, grid = plan["rows_per_tile"], plan["grid"]
    segs, m, n_rows = THREADS // lanes, q.size, rows.shape[1]
    out = np.zeros(n_rows, dtype=np.int64)
    writes = np.zeros(n_rows, dtype=np.int64)
    i = np.arange(tile)
    assert (i // segs < rows_in_flight(lanes, steps)).all()
    for b in range(grid):
        for t in range(b, plan["tiles"], grid):
            r = t * tile + i
            r = r[r < n_rows]
            n = np.minimum(rows[2, r].astype(np.int64), chunk)
            if chunk <= lanes * steps:
                reach = np.full(r.size, lanes * steps)
            else:
                step = 32 * LONG_STEPS
                reach = -(-n // step) * step
            offs = np.arange(max(int(reach.max(initial=0)), 1))
            seen = (offs < n[:, None]) & (offs < reach[:, None])
            idx = np.minimum(rows[0, r].astype(np.int64)[:, None] + offs,
                             m - 1)
            out[r] = ((q[idx] <= rows[1, r][:, None]) & seen).sum(axis=1)
            writes[r] += 1
    return out, writes


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64,
                                   128, 129, 256, 1024])
def test_walk_equals_the_plain_version(chunk, dtype):
    probe = window_plan(1, chunk, np.dtype(dtype).itemsize, n_sm=1)
    n_rows = 5 * probe["rows_per_tile"] + 7          # a ragged last tile
    q, rows = _rows(3_000, n_rows, chunk, chunk, dtype)
    plan = window_plan(n_rows, chunk, q.itemsize, n_sm=1)
    plan["grid"] = 2                  # two blocks, several tiles each
    got, writes = _walk(q, rows, chunk, plan)
    assert (writes == 1).all()
    t = torch.from_numpy(rows)
    want = window_counts_ref(torch.from_numpy(q), t[0], t[1], t[2], chunk)
    assert want.dtype == torch.from_numpy(q).dtype
    assert np.array_equal(got, want.numpy())
