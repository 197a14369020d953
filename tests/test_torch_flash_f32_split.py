"""The f32 flash kernel's split design on the CPU: the split plan
(``repro_torch.kernels.flash_attention.plan``) and the arithmetic of
``flash_fwd_kernel`` + ``flash_combine`` (``csrc/flash_attention.cu``)
emulated in float32.

The emulation (``tests/_torch_flash_emulation.py``): each range of kv
rows runs the reference's online softmax over its own 64-row chunks, in
the log2 domain (``scale * log2(e)`` folded into one multiply, masked
scores -1e30, chunks wholly above the causal diagonal skipped), with a
row's sum kept as 16 lanes' shares of 4 columns each and added at the
end; the combine takes M = max m_s, L = sum l_s 2^(m_s - M)
and o = sum acc_s 2^(m_s - M) / max(L, 1e-30), in range order.  One range
writes acc / max(l, 1e-30) itself.  The emulation is held to the reference
Pallas kernel in interpret mode and to the port's plain version at the f32
tolerance ``chip_smoke.py`` holds the kernel to (atol 2e-5, rtol 1e-4):
causal launches whose later ranges lie wholly above the diagonal for the
first q tiles, extreme logits, D 64, 128 and 256 (whose tiles are 64 q
rows and 32 kv rows, ``plan.f32_tiles``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_emulation import NEG_INF, kernel_emulation, split_partials
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.capture import kernels as cap
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.plan import (BLOCK_Q, KV_CHUNK,
                                                      SPLITS_PER_SM,
                                                      f32_tiles, split_plan)
from repro_torch.serving import scenario as srv

F32 = dict(atol=2e-5, rtol=1e-4)
H100_SMS = 132   # streaming multiprocessors of an H100 SXM


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
# (sq, sk, d) of every distinct main-path flash launch, one head each
# (``capture.launch.record`` over the captured roster and the serving
# roster): the roster's q-partitioned d128.kv2k at 1 and 4 cores and
# kv-partitioned d64.kv20k at 1, 4, 16, 80 and 160 cores; serving's
# context lengths.
MAIN_PATH = {
    "roster d128.kv2k sq=256": (256, 2048, 128),
    "roster d128.kv2k sq=128": (128, 2048, 128),
    **{f"roster d64.kv20k sk={sk}": (256, sk, 64)
       for sk in (20480, 5120, 1280, 256, 128)},
    **{f"serving sk={sk}": (128, sk, 128) for sk in (128, 256, 640, 896,
                                                     1024)},
}


def test_main_path_list_is_the_captured_geometry():
    g = dict(srv._GEO_FLASH)
    assert (g["sq"], g["base_sk"], g["d"]) == MAIN_PATH["serving sk=1024"]
    geos = {tag: geo for tag, _, _, _, geo in cap._GEO_FLASH}
    assert (geos["d128.kv2k"]["sq"], geos["d128.kv2k"]["sk"],
            geos["d128.kv2k"]["d"]) == MAIN_PATH["roster d128.kv2k sq=256"]
    assert (geos["d64.kv20k"]["sq"], geos["d64.kv20k"]["sk"],
            geos["d64.kv20k"]["d"]) == MAIN_PATH["roster d64.kv20k sk=20480"]


FULL_WIDTH = (1, 40, 4096, 4096)    # qwen2.5-14b: B, H, Sq, Sk


@pytest.mark.parametrize("geo", [FULL_WIDTH, (1, 1, 256, 2048),
                                 (1, 1, 256, 20480), (1, 1, 128, 128),
                                 (2, 4, 1024, 1024), (1, 2, 512, 512),
                                 (1, 1, 128, 192), (4, 8, 512, 4096)])
def test_plan_covers_the_kv_axis(geo):
    b, h, sq, sk = geo
    per, n_splits = split_plan(b, h, sq, sk, n_sm=H100_SMS)
    assert per % KV_CHUNK == 0 or per == sk
    ranges = [range(s, min(s + per, sk)) for s in range(0, sk, per)]
    assert len(ranges) == n_splits
    assert [i for r in ranges for i in r] == list(range(sk))
    assert all(len(r) >= 1 for r in ranges)
    assert per >= min(KV_CHUNK, sk)
    tiles = b * h * (sq // BLOCK_Q)
    assert tiles * n_splits < max(tiles + 1, SPLITS_PER_SM * H100_SMS + tiles)


def test_full_width_takes_one_split():
    assert split_plan(*FULL_WIDTH, n_sm=H100_SMS) == (4096, 1)


@pytest.mark.parametrize("name", list(MAIN_PATH))
def test_plan_fills_the_card_at_the_main_path_launches(name):
    """Every main-path launch gets 132 blocks or more, unless its kv axis
    holds fewer of the kernel's 64-row chunks than that needs; then it
    takes one range a chunk (two at the shortest, Sk = 128)."""
    sq, sk, _ = MAIN_PATH[name]
    per, n_splits = split_plan(1, 1, sq, sk, n_sm=H100_SMS)
    blocks = (sq // BLOCK_Q) * n_splits
    assert blocks >= H100_SMS or per == KV_CHUNK
    assert n_splits >= 2


def test_plan_refuses_what_the_kernel_cannot_take():
    # every Sq, Sk >= 1 is taken (the last q tile and kv tile partial):
    # only an empty sequence is refused
    with pytest.raises(ValueError, match="Sq, Sk >= 1"):
        split_plan(1, 1, 0, 256, n_sm=H100_SMS)
    with pytest.raises(ValueError, match="Sq, Sk >= 1"):
        split_plan(1, 1, 128, 0, n_sm=H100_SMS)
    assert split_plan(1, 1, 192, 256, n_sm=H100_SMS)[1] >= 1


# --------------------------------------------------------------------------
# split-then-combine against the reference
# --------------------------------------------------------------------------
CASES = [
    # (b, sq, sk, h, g, d, causal, input scale)
    (1, 256, 512, 2, 1, 64, False, 1.0),
    (1, 256, 256, 2, 2, 128, True, 1.0),
    (1, 384, 384, 2, 1, 64, True, 1.0),     # splits above the diagonal
    (2, 128, 256, 2, 1, 128, False, 1.0),
    (1, 128, 128, 1, 1, 64, True, 30.0),    # extreme logits, causal
    (1, 128, 256, 1, 1, 128, False, 30.0),  # extreme logits, D = 128
    (1, 128, 256, 2, 1, 256, True, 1.0),    # D = 256: 64 x 32 tiles
    (1, 128, 256, 1, 1, 256, False, 10.0),  # D = 256, logits ~ 100
]


def _inputs(case):
    b, sq, sk, h, g, d, causal, scale = case
    rng = np.random.default_rng(sq * 7 + sk + h * 3 + g + d + int(causal))
    q = (scale * rng.standard_normal((b, sq, h, d))).astype(np.float32)
    k = (scale * rng.standard_normal((b, sk, g, d))).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES)
def test_split_combine_matches_reference(case):
    b, sq, sk, h, _, d, causal, _ = case
    q, k, v = _inputs(case)
    want_jax = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal=causal, interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = attention_ref(tq, tk, tv, causal=causal).numpy()
    plan_per, _ = split_plan(b, h, sq, sk, n_sm=H100_SMS, d=d)
    for per in sorted({plan_per, f32_tiles(d)[1], 128, sk}):
        got = kernel_emulation(tq, tk, tv, causal=causal, per=per).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, want_jax, **F32)


def test_a_range_above_the_diagonal_folds_to_nothing():
    """Causal, ranges of 64 rows: for the first q tile every range past
    row 127 walks no chunk (m = -1e30, l = 0, acc = 0); its weight
    2^(-1e30 - M) is exactly 0, so adding it changes no bit."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 256, 256, 1, 1, 64,
                                                     True, 1.0)))
    qt, kt, vt = q[0, :128, 0], k[0, :, 0], v[0, :, 0]
    m, l, acc = split_partials(qt, kt, vt, 0, 192, 64, 256, True)
    assert (m == NEG_INF).all() and (l == 0).all() and (acc == 0).all()
    m0, l0, a0 = split_partials(qt, kt, vt, 0, 0, 128, 256, True)
    big_m = torch.maximum(m0, m)
    assert torch.equal(big_m, m0)
    assert torch.equal(torch.exp2(m - big_m), torch.zeros_like(m))
    assert torch.equal(l0 * torch.exp2(m0 - big_m) + l * torch.exp2(m - big_m),
                       l0)


def test_split_combine_extreme_logits_no_nan():
    """One range's scores far below another's: its weight underflows to 0
    with no NaN, and the result is still the reference's."""
    rng = np.random.default_rng(7)
    d = 128
    q = np.full((1, 128, 1, d), 4.0, dtype=np.float32)
    k = rng.standard_normal((1, 256, 1, d)).astype(np.float32)
    k[:, :128] = np.abs(k[:, :128]) * 20.0     # first range's scores ~ +1e4
    k[:, 128:] = -np.abs(k[:, 128:]) * 20.0    # the second's ~ -1e4
    v = rng.standard_normal((1, 256, 1, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = attention_ref(tq, tk, tv, causal=False).numpy()
    want_jax = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal=False, interpret=True))
    got = kernel_emulation(tq, tk, tv, causal=False, per=128).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, want_jax, **F32)


def test_split_combine_is_the_same_from_run_to_run():
    """The combine folds the ranges in a fixed order with no atomics, so two
    runs give the same bits."""
    tq, tk, tv = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    one = kernel_emulation(tq, tk, tv, causal=False, per=64)
    two = kernel_emulation(tq, tk, tv, causal=False, per=64)
    assert torch.equal(one, two)
