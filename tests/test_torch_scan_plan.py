"""The state-expanded scan kernel's design on the CPU: its plan
(``repro_torch.kernels.ssm_scan.plan``) and the arithmetic of
``ssm_chunked_kernel`` (``csrc/ssm_chunked_scan.cu``) emulated in numpy
float32.

A thread holds R state rows of one channel and updates them op by op as
the plain version rounds them, ``h = fl(fl(dt h) + fl(b x))``; its part of
y_t is four fused multiply-add chains (rows j = q mod 4) added pairwise,
and the block adds the N / R row groups' parts as four running sums
(groups g = q mod 4), added pairwise.  The emulation's state is held to the plain version's bit for bit, and its y to
the reference Pallas kernel in interpret mode at the chunked tolerance of
``tests/test_torch_moe_ssm.py`` and to the plain version at the tolerance
``chip_smoke.py`` holds the kernel to (rtol 1e-4, atol 1e-4 of the rms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_chunked_scan as jax_chunked
from repro_torch.capture import kernels as cap
from repro_torch.kernels.ssm_scan import ssm_chunked_ref
from repro_torch.kernels.ssm_scan.plan import (MAX_SMEM_BYTES, MAX_THREADS,
                                               MIN_THREADS, ROWS_PER_THREAD,
                                               scan_plan, smem_bytes)

H100_SMS = 132   # streaming multiprocessors of an H100 SXM
CHUNKED_TOL = dict(atol=2e-3, rtol=2e-3)   # tests/test_torch_moe_ssm.py
CARD_RTOL, CARD_ATOL_RMS = 1e-4, 1e-4      # chip_smoke.py, f32
FULL_WIDTH = (4096, 7168, 64)              # Zamba2-7B: T, d_inner, ssm_state


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf in float32: the product is exact in float64, one rounding of
    the sum (to float64, then float32; both round to nearest)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def kernel_emulation(x, dt, b, c, rows: int):
    """y [T, D] and the state after every step [T, N, D] of the kernel at
    ``rows`` state rows a thread, in float32."""
    t_len, d = x.shape
    n = b.shape[1]
    groups = n // rows
    h = np.zeros((n, d), dtype=np.float32)
    y = np.empty((t_len, d), dtype=np.float32)
    states = np.empty((t_len, n, d), dtype=np.float32)
    for t in range(t_len):
        h = (dt[t][None, :] * h) + (b[t][:, None] * x[t][None, :])
        states[t] = h
        acc = np.zeros((groups, 4, d), dtype=np.float32)
        for j in range(rows):
            rows_j = np.arange(groups) * rows + j
            acc[:, j % 4] = _fma(c[t, rows_j][:, None], h[rows_j],
                                 acc[:, j % 4])
        part = (acc[:, 0] + acc[:, 1]) + (acc[:, 2] + acc[:, 3])
        sums = np.zeros((4, d), dtype=np.float32)
        for g in range(groups):
            sums[g % 4] = sums[g % 4] + part[g]
        y[t] = (sums[0] + sums[1]) + (sums[2] + sums[3])
    return y, states


def _inputs(t, d, n, seed=0):
    rng = np.random.default_rng(seed + t + d + n)
    x = rng.standard_normal((t, d)).astype(np.float32)
    dt = rng.uniform(0.95, 0.999, (t, d)).astype(np.float32)
    b = (rng.standard_normal((t, n)) / np.sqrt(n)).astype(np.float32)
    c = rng.standard_normal((t, n)).astype(np.float32)
    return x, dt, b, c


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
def _main_path_scans() -> dict[str, tuple[int, int, int]]:
    """(T, D, N) of the captured roster's state-expanded scans, at every
    core count the roster launches them (T / 4 and T / 8 a thread too)."""
    out = {}
    for tag, _, geo in cap._GEO_SSM:
        if geo["op"] == "expand":
            for t in (geo["seq_len"], geo["seq_len"] // 4,
                      geo["seq_len"] // 8):
                out[f"{tag} T={t}"] = (t, geo["d"], geo["n"])
    return out


GEOMETRIES = {"full width": FULL_WIDTH, **_main_path_scans(),
              "N=16": (256, 128, 16), "N=256": (64, 128, 256),
              "N=32 wide": (1024, 4096, 32)}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plan_covers_the_channels(name, itemsize):
    t, d, n = GEOMETRIES[name]
    plan = scan_plan(t, d, n, itemsize, n_sm=H100_SMS)
    assert plan.rows in ROWS_PER_THREAD and n % plan.rows == 0
    ch = plan.channels
    assert ch & (ch - 1) == 0 and d % ch == 0
    assert plan.blocks(d) * ch == d          # every channel, once
    assert 1 <= plan.threads(n) <= MAX_THREADS
    assert smem_bytes(plan, n, itemsize) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plan_fills_the_card(name):
    """At least one block an SM, each of at least 4 warps; where the
    channels cannot give both, blocks of 4 warps (one a scheduler), which
    the chip timings preferred to more blocks of fewer warps."""
    t, d, n = GEOMETRIES[name]
    plan = scan_plan(t, d, n, 4, n_sm=H100_SMS)
    assert plan.threads(n) >= MIN_THREADS
    assert plan.blocks(d) >= H100_SMS or plan.threads(n) == MIN_THREADS
    # every scheduler of the card gets a warp, or each thread holds the
    # fewest rows
    warps = plan.blocks(d) * plan.threads(n) // 32
    assert warps >= 4 * H100_SMS or plan.rows == min(ROWS_PER_THREAD)


def test_plan_at_full_width_and_main_path():
    full = scan_plan(*FULL_WIDTH, 4, n_sm=H100_SMS)
    assert (full.rows, full.channels, full.blocks(7168)) == (16, 32, 224)
    assert scan_plan(*FULL_WIDTH, 2, n_sm=H100_SMS) == full
    for t, d, n in _main_path_scans().values():
        plan = scan_plan(t, d, n, 4, n_sm=H100_SMS)
        assert (plan.rows, plan.channels, plan.blocks(d)) == (4, 4, d // 4)


def test_plan_refuses_what_the_kernel_cannot_take():
    for d, n in ((100, 64), (128, 48), (128, 512), (128, 8)):
        with pytest.raises(ValueError, match="ssm chunked kernel takes"):
            scan_plan(64, d, n, 4, n_sm=H100_SMS)


# --------------------------------------------------------------------------
# the kernel's arithmetic against the references
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rows", ROWS_PER_THREAD)
@pytest.mark.parametrize("case", [(128, 128, 128, 64), (96, 128, 64, 32),
                                  (64, 256, 16, 64)])
def test_emulated_y_matches_the_references(case, rows):
    t, d, n, chunk = case
    x, dt, b, c = _inputs(t, d, n)
    got, _ = kernel_emulation(x, dt, b, c, rows)
    want_jax = np.asarray(jax_chunked(*(jnp.asarray(a) for a in (x, dt, b, c)),
                                      chunk=chunk, interpret=True))
    np.testing.assert_allclose(got, want_jax, **CHUNKED_TOL)
    want = ssm_chunked_ref(*(torch.from_numpy(a) for a in (x, dt, b, c)))
    want = want.numpy()
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    np.testing.assert_allclose(got, want, rtol=CARD_RTOL,
                               atol=CARD_ATOL_RMS * rms)


@pytest.mark.parametrize("rows", ROWS_PER_THREAD)
def test_emulated_state_is_the_plain_versions_bit_for_bit(rows):
    """With c_t the unit vector of row t mod N, the plain version's y_t is
    exactly row t mod N of its state (a sum of zeros and that row), so its
    whole state trajectory can be read off and compared bit for bit."""
    t, d, n = 96, 128, 32
    x, dt, b, _ = _inputs(t, d, n, seed=3)
    c = np.zeros((t, n), dtype=np.float32)
    c[np.arange(t), np.arange(t) % n] = 1.0
    _, states = kernel_emulation(x, dt, b, c, rows)
    got = states[np.arange(t), np.arange(t) % n]
    want = ssm_chunked_ref(*(torch.from_numpy(a) for a in (x, dt, b, c)))
    assert np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))
