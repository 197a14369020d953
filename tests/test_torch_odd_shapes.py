"""The scans, the token gather and MoE dispatch at shapes beyond the
reference's kernel route, on the CPU.

- The reference's dispatchers (``ema_scan``, ``chunked_scan``, ``gather``,
  ``dispatch``) and the port's on numpy-seeded inputs at D 1, 3, 96 and
  100, N 1, 24 and 384, MoE D 40 with F 24, at the tolerances of
  ``tests/test_torch_dispatchers.py`` (f32 atol 2e-5, rtol 1e-4; the
  chunked scan 1e-4).
- The plans at odd shapes: every channel covered once (the last block
  partial), shared memory within a block's, N padded to a power of two
  and split into parts of at most 256 rows, the copies' widths.
- The kernels' arithmetic at those shapes, emulated in
  ``tests/_torch_scan_emulation.py``: the chunked scan's padded and split
  state (bit for bit the plain version's), its y within the card's
  tolerance; the EMA walk bit for bit; MoE's zero-filled K tail and
  dropped N tail.
- The gather's copy width (``kernel.row_piece``) at every row size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_scan_emulation import (H100_SMS, chunked_split_emulation,
                                   ema_walk_emulation, moe_tiled_emulation)
from repro.kernels.moe_dispatch import dispatch as jax_dispatch
from repro.kernels.ssm_scan import chunked_scan as jax_chunked_scan
from repro.kernels.ssm_scan import ema_scan as jax_ema_scan
from repro.kernels.token_gather import gather as jax_gather
from repro_torch.capture.launch import record
from repro_torch.kernels.moe_dispatch import dispatch, moe_dispatch_ref
from repro_torch.kernels.ssm_scan import (chunked_scan, ema_scan,
                                          ssm_chunked_ref, ssm_ema_ref)
from repro_torch.kernels.ssm_scan.plan import (BLOCK_RESERVED_SMEM,
                                               EMA_COPY_WARPS, MAX_SMEM_BYTES,
                                               MAX_STATE_ROWS, MAX_THREADS,
                                               SM_SMEM_BYTES, copy_piece,
                                               ema_plan, ema_smem_bytes, fits,
                                               scan_plan, smem_bytes,
                                               state_split)
from repro_torch.kernels.token_gather import gather
from repro_torch.kernels.token_gather.kernel import row_piece

F32 = dict(atol=2e-5, rtol=1e-4)
CHUNKED = dict(atol=1e-4, rtol=1e-4)
CARD_RTOL, CARD_ATOL_RMS = 1e-4, 1e-4    # chip_smoke.py's chunked limit
ODD_D = (1, 3, 96, 100)
ODD_N = (1, 24, 384)


def _scan_inputs(t: int, d: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    dt = rng.uniform(0.5, 0.99, (t, d)).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)
    b = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    c = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, g, b, c


# --------------------------------------------------------------------------
# the dispatchers against the reference's at the new shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", ODD_D)
def test_ema_scan_matches_reference_at_odd_widths(d):
    x, dt, g, _, _ = _scan_inputs(96, d, 1, d)
    want = np.asarray(jax_ema_scan(*(jnp.asarray(a) for a in (x, dt, g))))
    with record() as launched:
        got = ema_scan(*(torch.from_numpy(a) for a in (x, dt, g)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert launched == []     # the reference's oracle route


@pytest.mark.parametrize("n", ODD_N)
@pytest.mark.parametrize("d", ODD_D)
def test_chunked_scan_matches_reference_at_odd_shapes(d, n):
    x, dt, _, b, c = _scan_inputs(64, d, n, d + n)
    want = np.asarray(jax_chunked_scan(
        *(jnp.asarray(a) for a in (x, dt, b, c))))
    with record() as launched:
        got = chunked_scan(*(torch.from_numpy(a) for a in (x, dt, b, c)))
    np.testing.assert_allclose(got.numpy(), want, **CHUNKED)
    assert launched == []


@pytest.mark.parametrize("d", ODD_D)
def test_gather_matches_reference_at_odd_widths(d):
    rng = np.random.default_rng(d)
    table = rng.standard_normal((50, d)).astype(np.float32)
    idx = rng.integers(0, 50, 77).astype(np.int32)
    want = np.asarray(jax_gather(jnp.asarray(table), jnp.asarray(idx)))
    with record() as launched:
        got = gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert launched == []


@pytest.mark.parametrize("t", [32, 37])   # a multiple of an M-tile and not
def test_dispatch_matches_reference_at_odd_widths(t):
    d, f, n_exp = 40, 24, 3
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((n_exp, d, f)) / np.sqrt(d)).astype(np.float32)
    eid = rng.integers(0, n_exp, t).astype(np.int32)
    want = np.asarray(jax_dispatch(*(jnp.asarray(a) for a in (x, w, eid))))
    with record() as launched:
        got = dispatch(*(torch.from_numpy(a) for a in (x, w, eid)))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert launched == []


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------
SCAN_SHAPES = [(4096, 7166, 96), (300, 1, 1), (300, 3, 24), (300, 100, 384),
               (300, 200, 96), (64, 96, 16), (64, 64, 1000), (64, 129, 257)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("t,d,n", SCAN_SHAPES)
def test_scan_plan_covers_odd_shapes(t, d, n, itemsize):
    plan = scan_plan(t, d, n, itemsize, n_sm=H100_SMS)
    ch = plan.channels
    tiles = -(-d // ch)
    assert plan.blocks(d) == tiles * plan.parts
    assert (tiles - 1) * ch < d <= tiles * ch      # every channel, once
    assert 8 * (tiles * ch - d) <= d or ch == 1    # few idle channels
    assert 1 <= plan.threads() <= MAX_THREADS
    assert smem_bytes(plan, itemsize) <= MAX_SMEM_BYTES
    parts, per, np_ = state_split(n)
    assert (plan.parts, plan.state_rows) == (parts, np_)
    assert parts * per >= n > (parts - 1) * per     # every state row, once
    assert per <= np_ <= max(16, 2 * per - 1) and np_ <= MAX_STATE_ROWS
    assert np_ & (np_ - 1) == 0 and np_ % plan.rows == 0


@pytest.mark.parametrize("n,want", [(1, (1, 1, 16)), (24, (1, 24, 32)),
                                    (96, (1, 96, 128)), (256, (1, 256, 256)),
                                    (257, (2, 129, 256)),
                                    (384, (2, 192, 256)),
                                    (1000, (4, 250, 256))])
def test_state_split_pads_and_splits(n, want):
    assert state_split(n) == want


def test_plans_keep_their_shapes_at_the_reference_widths():
    """D % 128 == 0 and N a power of two 16-256: the blocks divide D and
    the state is one unpadded part, as before the odd shapes."""
    for t, d, n in ((4096, 7168, 64), (512, 128, 128), (512, 256, 16)):
        plan = scan_plan(t, d, n, 4, n_sm=H100_SMS)
        assert d % plan.channels == 0
        assert (plan.parts, plan.state_rows) == (1, n)
    assert scan_plan(4096, 7168, 64, 4, n_sm=H100_SMS)[:3] == (16, 32, 32)
    assert ema_plan(4096, 7168, 4, n_sm=H100_SMS).piece == 16


@pytest.mark.parametrize("d,ch,ok", [(384, 256, False), (512, 256, True),
                                     (7166, 128, True), (100, 32, False),
                                     (100, 16, True), (1, 2, False)])
def test_fits_divides_multiples_of_128_and_bounds_idle_channels(d, ch, ok):
    assert fits(d, ch) == ok


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [1, 3, 64, 96, 100, 200, 7166])
def test_ema_plan_covers_odd_widths(d, itemsize):
    plan = ema_plan(300, d, itemsize, n_sm=H100_SMS)
    tiles = plan.blocks(d)
    assert (tiles - 1) * plan.channels < d <= tiles * plan.channels
    smem = ema_smem_bytes(plan, itemsize)
    assert smem <= MAX_SMEM_BYTES
    per_sm = -(-tiles // H100_SMS)     # the blocks an SM holds at once
    assert per_sm * (smem + BLOCK_RESERVED_SMEM) <= SM_SMEM_BYTES
    assert (plan.stage_steps * plan.channels * itemsize) % 128 == 0
    row = d * itemsize
    assert row % plan.piece == 0
    assert (plan.piece == 16) == (row % 16 == 0)   # TMA needs 16-byte rows
    copiers = 1 if plan.piece == 16 else EMA_COPY_WARPS
    assert plan.threads() == 32 * (-(-plan.channels // 32) + copiers)


@pytest.mark.parametrize("elems,itemsize,offset,want", [
    (64, 4, 0, 16), (7166, 4, 0, 8), (7166, 2, 0, 4), (3, 4, 0, 4),
    (3, 2, 0, 2), (100, 2, 0, 8), (384, 4, 192, 16), (257, 4, 129, 4),
    (24, 2, 0, 16)])
def test_copy_piece_is_the_widest_copy_a_row_allows(elems, itemsize, offset,
                                                    want):
    assert copy_piece(elems, itemsize, offset) == want


@pytest.mark.parametrize("row_bytes,want", [(512, 16), (20472, 8),
                                            (10236, 4), (12, 4), (6, 2),
                                            (2, 2), (3, 1), (200, 8)])
def test_gather_copies_the_widest_piece_that_divides_a_row(row_bytes, want):
    assert row_piece(row_bytes) == want


# --------------------------------------------------------------------------
# the kernels' arithmetic at the new shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("t,d,n", [(40, 3, 24), (40, 5, 1), (24, 6, 300),
                                   (24, 100, 40)])
def test_chunked_split_emulation_matches_the_plain_version(t, d, n):
    x, dt, _, b, c = _scan_inputs(t, d, n, 7 * n + d)
    got, _ = chunked_split_emulation(x, dt, b, c)
    want = ssm_chunked_ref(*(torch.from_numpy(a) for a in (x, dt, b, c)))
    want = want.numpy()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    np.testing.assert_allclose(got, want, rtol=CARD_RTOL,
                               atol=CARD_ATOL_RMS * rms)


@pytest.mark.parametrize("n", [24, 300])
def test_chunked_split_state_is_the_plain_versions_bit_for_bit(n):
    """Padding and splitting the state leave each row's recurrence alone:
    with c_t the unit vector of row t mod N the plain version's y_t is that
    row of its state, equal to the emulation's bit for bit."""
    t, d = 2 * n if n < 100 else 310, 5
    x, dt, _, b, _ = _scan_inputs(t, d, n, n)
    c = np.zeros((t, n), dtype=np.float32)
    c[np.arange(t), np.arange(t) % n] = 1.0
    _, states = chunked_split_emulation(x, dt, b, c)
    got = states[np.arange(t), np.arange(t) % n]
    want = ssm_chunked_ref(*(torch.from_numpy(a) for a in (x, dt, b, c)))
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("d", [1, 3, 100, 200])
def test_ema_walk_is_the_plain_version_bit_for_bit_at_odd_widths(d):
    x, dt, g, _, _ = _scan_inputs(70, d, 1, d)
    got = ema_walk_emulation(x, dt, g)
    want = ssm_ema_ref(*(torch.from_numpy(a) for a in (x, dt, g))).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("d,f", [(40, 24), (3, 5), (100, 200), (33, 129)])
def test_moe_tails_zero_filled_and_dropped_match_the_plain_version(d, f):
    rng = np.random.default_rng(d * f)
    t, n_exp = 20, 3
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((n_exp, d, f)) / np.sqrt(d)).astype(np.float32)
    eid = rng.integers(0, n_exp, t)
    got = moe_tiled_emulation(x, w, eid)
    want = moe_dispatch_ref(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(eid)).numpy()
    np.testing.assert_allclose(got, want, **F32)
