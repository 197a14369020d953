"""The gated EMA scan kernel's design on the CPU: its plan
(``repro_torch.kernels.ssm_scan.plan.ema_plan``) and the walk of
``ssm_ema_kernel``'s consumers (``csrc/ssm_ema_scan.cu``) emulated in
numpy float32.

A block holds CH channels; its producer brings [S, CH] tiles of x, dt and
g into a ring of stages (TMA reads the rows past T of the last box as
zeros), and each consumer thread walks its channel's column of every
stage in time order, ``h = fl(fl(dt h) + x)``, ``y = fl(g h)``.  The
emulation is held to the plain version bit for bit, as ``chip_smoke.py``
holds the kernel in float32, and to the reference Pallas kernel in
interpret mode at ``tests/test_torch_moe_ssm.py``'s EMA tolerance.  A
design that splits time into chunks scanned apart and joins them by a
carry (``cumprod(dt)`` times the previous chunk's last state) rounds in
another order and misses the float32 limit ``chip_smoke.py`` held the old
kernel to (``test_chunk_split_with_a_carry_misses_the_f32_limit``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_ema_scan as jax_ema
from repro_torch.kernels.ssm_scan import ssm_ema_ref
from repro_torch.kernels.ssm_scan.plan import (BLOCK_RESERVED_SMEM,
                                               EMA_MAX_CHANNELS,
                                               EMA_MAX_RING, EMA_STEPS,
                                               MAX_SMEM_BYTES, SM_SMEM_BYTES,
                                               ema_plan, ema_smem_bytes)

H100_SMS = 132                      # streaming multiprocessors of an H100 SXM
EMA_TOL = dict(atol=1e-3, rtol=1e-3)        # tests/test_torch_moe_ssm.py
STREAM_TOL = dict(rtol=1e-5, atol=1e-6)     # chip_smoke.py, float32
FULL_WIDTH = (4096, 7168)           # Zamba2-7B: T, d_inner
# (T, D) of every distinct EMA launch of the captured roster
# (chip_smoke.py phase 8).
ROSTER = [(1024, 128), (512, 256), (256, 128), (128, 128), (128, 256),
          (64, 256)]
GEOMETRIES = {"full": FULL_WIDTH,
              **{f"roster T={t} D={d}": (t, d) for t, d in ROSTER}}


def _inputs(t: int, d: int, seed: int):
    """chip_smoke.py's distribution: x, g standard normal, dt in
    (0.95, 0.999)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    dt = (0.95 + 0.049 * rng.random((t, d))).astype(np.float32)
    g = rng.standard_normal((t, d)).astype(np.float32)
    return x, dt, g


def kernel_walk(x, dt, g, *, itemsize: int = 4) -> np.ndarray:
    """y [T, D] as ssm_ema_kernel computes it at the plan for this card:
    blocks of CH channels, each walking ring stages of S steps in order."""
    t_len, d = x.shape
    plan = ema_plan(t_len, d, itemsize, n_sm=H100_SMS)
    ch, s = plan.channels, plan.stage_steps
    n_blocks, n_stages = plan.blocks(d), -(-t_len // s)

    def stage_tiles(a: np.ndarray, i: int) -> np.ndarray:
        """Every block's [S, CH] box at stage i, rows past T zero."""
        box = np.zeros((s, d), dtype=np.float32)
        rows = a[i * s:(i + 1) * s]
        box[:len(rows)] = rows
        return box.reshape(s, n_blocks, ch).transpose(1, 0, 2)

    h = np.zeros((n_blocks, ch), dtype=np.float32)
    y = np.full((t_len, d), np.nan, dtype=np.float32)
    for i in range(n_stages):
        tx, tdt, tg = (stage_tiles(a, i) for a in (x, dt, g))
        for k in range(min(s, t_len - i * s)):
            h = tdt[:, k] * h + tx[:, k]
            y[i * s + k] = (tg[:, k] * h).reshape(d)
    return y


def chunk_split_with_carry(x, dt, g, chunk: int) -> np.ndarray:
    """The time-split design in float32: each chunk scanned from a zero
    state, then ``cumprod(dt)`` times the carry added in."""
    t_len, d = x.shape
    y = np.empty((t_len, d), dtype=np.float32)
    carry = np.zeros(d, dtype=np.float32)
    for c0 in range(0, t_len, chunk):
        h = np.zeros(d, dtype=np.float32)
        decay = np.ones(d, dtype=np.float32)
        for t in range(c0, c0 + chunk):
            h = dt[t] * h + x[t]
            decay = decay * dt[t]
            y[t] = g[t] * (h + decay * carry)
        carry = h + decay * carry
    return y


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_ema_plan_covers_the_channels(name, itemsize):
    t, d = GEOMETRIES[name]
    plan = ema_plan(t, d, itemsize, n_sm=H100_SMS)
    ch = plan.channels
    assert ch & (ch - 1) == 0 and ch <= EMA_MAX_CHANNELS
    channels = (np.arange(plan.blocks(d))[:, None] * ch
                + np.arange(ch)[None, :]).ravel()
    np.testing.assert_array_equal(np.sort(channels), np.arange(d))
    assert len(np.unique(channels)) == d
    assert plan.threads() == 32 * (-(-ch // 32) + 1)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_ema_plan_fits_shared_memory(name, itemsize):
    t, d = GEOMETRIES[name]
    plan = ema_plan(t, d, itemsize, n_sm=H100_SMS)
    smem = ema_smem_bytes(plan, itemsize)
    per_sm = -(-plan.blocks(d) // H100_SMS)
    assert smem <= MAX_SMEM_BYTES
    assert per_sm * (smem + BLOCK_RESERVED_SMEM) <= SM_SMEM_BYTES
    lo, hi = EMA_STEPS
    assert lo <= plan.stage_steps <= hi       # a TMA box has <= 256 rows
    assert plan.stage_steps & (plan.stage_steps - 1) == 0
    assert (plan.stage_steps * plan.channels * itemsize) % 128 == 0
    assert 1 <= plan.ring <= EMA_MAX_RING
    assert plan.ring <= -(-t // plan.stage_steps)   # no stage stays empty


@pytest.mark.parametrize("itemsize", [4, 2])
def test_ema_plan_at_full_width_and_main_paths(itemsize):
    t, d = FULL_WIDTH
    plan = ema_plan(t, d, itemsize, n_sm=H100_SMS)
    assert plan.blocks(d) >= H100_SMS
    # the walk outpaces the loads, so every stage of a ring is loading
    per_sm = -(-plan.blocks(d) // H100_SMS)
    in_flight = plan.ring * plan.stage_bytes(itemsize) * per_sm
    assert in_flight >= 32 * 1024
    assert plan.ring >= 2
    for t, d in ROSTER:
        plan = ema_plan(t, d, itemsize, n_sm=H100_SMS)
        assert plan.channels * itemsize == 16      # 16-byte rows
        assert plan.blocks(d) < H100_SMS


def test_ema_plan_refuses_what_the_kernel_cannot_take():
    # every D >= 1 is taken (tests/test_torch_odd_shapes.py)
    for d, itemsize in ((-3, 4), (0, 4), (128, 8)):
        with pytest.raises(ValueError):
            ema_plan(64, d, itemsize, n_sm=H100_SMS)


@pytest.mark.parametrize("t,d", [*ROSTER, (1000, 256)])  # short last stage
def test_walk_is_the_plain_version_bit_for_bit(t, d):
    x, dt, g = _inputs(t, d, seed=t + d)
    got = kernel_walk(x, dt, g)
    want = ssm_ema_ref(*(torch.from_numpy(a) for a in (x, dt, g))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,d,chunk", [(1024, 128, 128), (512, 256, 64)])
def test_walk_matches_the_reference_kernel(t, d, chunk):
    x, dt, g = _inputs(t, d, seed=7)
    want = jax_ema(*(jnp.asarray(a) for a in (x, dt, g)), chunk=chunk,
                   interpret=True)
    np.testing.assert_allclose(kernel_walk(x, dt, g),
                               np.asarray(want, dtype=np.float32), **EMA_TOL)


def test_chunk_split_with_a_carry_misses_the_f32_limit():
    # Why the kernel walks time in order: the split design's roundings,
    # where |h| is small, exceed the limit the in-order walk meets exactly.
    x, dt, g = _inputs(512, 256, seed=0)
    want = ssm_ema_ref(*(torch.from_numpy(a) for a in (x, dt, g))).numpy()
    split = chunk_split_with_carry(x, dt, g, chunk=64)
    np.testing.assert_allclose(split, want, **EMA_TOL)   # right, but ...
    assert not np.allclose(split, want, **STREAM_TOL)    # ... not to f32
    np.testing.assert_array_equal(kernel_walk(x, dt, g), want)
