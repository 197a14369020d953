"""Flash attention at every head width the reference's ``mha`` runs its
kernel for (D % 8 == 0), up to 512, on the CPU.

- The port's plain version against the reference Pallas kernel in
  interpret mode at D = 16 (the smoke configs' heads), 112 (Zamba2-7B's),
  192 (Nemotron-4-340B's), 256 (PaliGemma's), 320 and 512, at the f32
  tolerance of ``tests/test_torch_kernels.py``.
- The padded design of both tiled kernels (``csrc/flash_attention.cu``):
  a launch at D runs the instance built for ``DP = plan.padded_head_dim(D)``
  with the head padded in shared memory by zero columns.  The emulations of
  ``tests/_torch_flash_emulation.py`` at D in {8, 16, 40, 96, 112, 136, 192,
  200, 248}: f32 ``flash_fwd_kernel`` on zero-padded rows with
  ``f32_tiles(DP)`` and its ``split_plan`` cut (and a cut of one chunk a
  range), bf16 ``flash_fwd_sm90`` on TMA-style zero columns with
  ``sm90_kv_rows(DP)``; each held to the plain version at the card's
  tolerances (f32 atol 2e-5, rtol 1e-4; bf16 inputs rtol 1e-2, atol 1e-3 of
  the output's rms) and to the reference kernel in interpret mode (bf16 at
  ``tests/test_torch_kernels.py``'s bf16 tolerance).
- The f32 kernel's shared rows at each padded width: the places its
  copies write and those it zeroes make up each row, and the 32-column
  groups its S = Q K^T walks read the real chunks in order and zeros past
  D, whatever a row's swizzle.
- The tiles ``plan.py`` gives each padded width: both kernels' buffers fit
  a block's 227 KB of shared memory at every D, and the full-width launches
  split as the D = 128 ones do.
- Above D = 256, the wide kernels (``flash_fwd_wide``, f32, and
  ``flash_fwd_wide_sm90``, bf16): their emulations at D in {264, 320, 328,
  384, 456, 512} (O in column panels, one block a panel, S summed over
  64-column panels; f32 also cut into kv ranges and combined) held to the
  plain version and to the reference kernel in interpret mode as above;
  every width from 264 to ``plan.MAX_HEAD_DIM`` fitting a block's shared
  memory with no thread holding more accumulators than the DP 256
  instances; the cap itself the widest padded width the bf16 kernel's
  resident Q tile fits; and the wrapper naming the wide kernel at each.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_emulation import (kernel_emulation, sm90_emulation,
                                    wide_kernel_emulation,
                                    wide_sm90_emulation)
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        kernel_path)
from repro_torch.kernels.flash_attention.plan import (MAX_HEAD_DIM,
                                                      SMEM_PER_BLOCK,
                                                      TILED_HEAD_DIMS,
                                                      TILED_MAX_HEAD_DIM,
                                                      WIDE_PANEL, f32_tiles,
                                                      padded_head_dim,
                                                      sm90_kv_rows,
                                                      sm90_smem_bytes,
                                                      split_plan,
                                                      wide_f32_plan,
                                                      wide_sm90_plan)

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)          # tests/test_torch_kernels.py
CARD_RTOL, CARD_ATOL_RMS = 1e-2, 1e-3      # chip_smoke.py, bf16 kernels
H100_SMS = 132


def f32_smem_bytes(dp: int) -> int:
    """flash_fwd_kernel's shared memory at ``dp``: the Q tile, a ring of K
    and V chunks (3 stages at DP = 64, else 2) and each warp's rows of P,
    in floats."""
    bq, bk = f32_tiles(dp)
    stages = 3 if dp == 64 else 2
    return 4 * (bq * dp + 2 * stages * bk * dp + bq * bk)


def _inputs(case):
    b, sq, sk, h, g, d, causal, scale = case
    rng = np.random.default_rng(sq * 7 + sk + h * 3 + g + d + int(causal))
    q = (scale * rng.standard_normal((b, sq, h, d))).astype(np.float32)
    k = (scale * rng.standard_normal((b, sk, g, d))).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    return q, k, v


def _reference(q, k, v, causal):
    return np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=causal, interpret=True))


def _reference_bf16(q, k, v, causal):
    return np.asarray(jax_flash(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        causal=causal, interpret=True), dtype=np.float32)


# (b, sq, sk, h, g, d, causal, input scale)
REF_CASES = [
    (1, 128, 128, 2, 1, 16, True, 1.0),      # the smoke configs' width
    (1, 128, 256, 4, 2, 16, False, 1.0),
    (1, 128, 256, 4, 4, 112, True, 1.0),     # Zamba2-7B's width
    (1, 128, 128, 6, 2, 192, False, 1.0),    # Nemotron-4-340B's width
    (1, 128, 128, 2, 1, 256, True, 1.0),     # PaliGemma's width
    (1, 128, 256, 2, 2, 256, False, 1.0),
    (1, 128, 128, 2, 1, 320, True, 1.0),     # the wide kernels' widths
    (1, 128, 256, 2, 2, 320, False, 1.0),
    (1, 128, 128, 2, 1, 512, True, 1.0),
    (1, 128, 256, 2, 2, 512, False, 1.0),
]


@pytest.mark.parametrize("case", REF_CASES)
def test_plain_version_matches_the_reference_kernel(case):
    causal = case[6]
    q, k, v = _inputs(case)
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal).numpy()
    np.testing.assert_allclose(got, _reference(q, k, v, causal), **F32)


# Every padded width, its narrowest and widest D, widths whose real
# columns end inside a 32-column group (40, 112, 136, 200, 248) and the
# models' (16, 112, 192); Sq and Sk multiples of 128, as the card path takes.
PADDED_CASES = [
    (1, 128, 256, 2, 1, 8, True, 30.0),      # narrowest, extreme logits
    (1, 256, 256, 4, 2, 16, True, 1.0),      # the smoke configs' width
    (1, 128, 256, 2, 2, 40, False, 1.0),
    (2, 128, 128, 2, 1, 96, True, 1.0),
    (1, 256, 256, 2, 2, 112, True, 1.0),     # Zamba2-7B's width
    (1, 128, 256, 2, 1, 136, False, 1.0),    # DP 192, 8 columns in its last
    (1, 256, 256, 3, 1, 192, True, 1.0),     # Nemotron-4-340B's width
    (1, 128, 128, 2, 1, 200, True, 10.0),
    (1, 128, 256, 1, 1, 248, False, 10.0),   # widest padded, logits ~ 100
]


def _case_id(case):
    return f"d{case[5]}"


@pytest.mark.parametrize("case", PADDED_CASES, ids=_case_id)
def test_padded_f32_kernel_emulation_holds(case):
    b, sq, sk, h, _, d, causal, _ = case
    dp = padded_head_dim(d)
    q, k, v = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = attention_ref(tq, tk, tv, causal=causal).numpy()
    want_jax = _reference(q, k, v, causal)
    plan_per, _ = split_plan(b, h, sq, sk, n_sm=H100_SMS, d=dp)
    for per in sorted({plan_per, f32_tiles(dp)[1], sk}):
        got = kernel_emulation(tq, tk, tv, causal=causal, per=per).numpy()
        assert got.shape == q.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, want_jax, **F32)


@pytest.mark.parametrize("case", PADDED_CASES, ids=_case_id)
def test_padded_bf16_kernel_emulation_holds(case):
    causal = case[6]
    q, k, v = _inputs(case)
    bq, bk, bv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = attention_ref(bq.float(), bk.float(), bv.float(), causal=causal)
    got = sm90_emulation(bq, bk, bv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == bq.shape
    assert torch.isfinite(got.float()).all()
    atol = CARD_ATOL_RMS * want.pow(2).mean().sqrt().item()
    worst = ((got.float() - want).abs()
             / (atol + CARD_RTOL * want.abs())).max().item()
    assert worst <= 1.0
    np.testing.assert_allclose(got.float().numpy(),
                               _reference_bf16(q, k, v, causal), **BF16)


def _f32_row_tiles(dp: int) -> dict[str, tuple[int, int]]:
    """flash_fwd_kernel's shared tiles at ``dp``: name -> (rows, swizzle
    group G), G the rows that share a swizzle (0: none)."""
    bq, bk = f32_tiles(dp)
    rows_a_thread, cols_a_thread = bq // 16, bk // 16
    return {"Q": (bq, rows_a_thread), "K": (bk, cols_a_thread), "V": (bk, 0)}


@pytest.mark.parametrize("d", [c[5] for c in PADDED_CASES])
def test_f32_padded_rows_hold_d_then_zeros(d):
    """load_rows writes real chunk c of row r at place c ^ ((r / G) % 8);
    zero_pad zeroes place p where p ^ ((r / G) % 8) >= D / 4.  Together
    they fill each row once, and reading place u ^ f of each 32-column
    group S = Q K^T walks gives chunk u of the group: real up to D, zero
    after, in every row."""
    dp = padded_head_dim(d)
    chunks, d4 = dp // 4, d // 4
    for rows, g in _f32_row_tiles(dp).values():
        for r in range(rows):
            f = (r // g) % 8 if g else 0
            row = [None] * chunks
            for c in range(d4):                           # load_rows
                assert row[c ^ f] is None
                row[c ^ f] = c
            for p in range(chunks):                       # zero_pad
                if p ^ f >= d4:
                    assert row[p] is None
                    row[p] = "zero"
            assert None not in row
            walked = [row[8 * grp + (u ^ f)]
                      for grp, u in itertools.product(range(-(-d // 32)),
                                                      range(8))]
            assert walked == [c if c < d4 else "zero"
                              for c in range(len(walked))]


@pytest.mark.parametrize("d", range(8, MAX_HEAD_DIM + 1, 8))
def test_every_width_fits_a_block_at_its_padded_width(d):
    dp = padded_head_dim(d)
    assert dp % 64 == 0 and dp - 64 < d <= dp
    if d <= TILED_MAX_HEAD_DIM:
        assert dp in TILED_HEAD_DIMS
        assert f32_smem_bytes(dp) <= SMEM_PER_BLOCK
        assert sm90_smem_bytes(dp, sm90_kv_rows(dp)) <= SMEM_PER_BLOCK
    else:
        assert wide_f32_plan(dp).smem_bytes <= SMEM_PER_BLOCK
        assert wide_sm90_plan(dp).smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("d", [MAX_HEAD_DIM + 8, 1032, 20, 4, 0])
def test_padded_head_dim_refuses_what_no_kernel_takes(d):
    with pytest.raises(ValueError, match=f"D % 8 == 0 up to {MAX_HEAD_DIM}"):
        padded_head_dim(d)


def test_d256_tiles_fit_a_block():
    # flash_fwd_sm90: 128-row kv tiles up to DP = 128, 64 at DP 192 and 256
    assert [sm90_kv_rows(dp) for dp in TILED_HEAD_DIMS] == [128, 128, 64, 64]
    assert sm90_kv_rows(192) == 64
    for dp in (192, 256):
        assert sm90_smem_bytes(dp, 64) <= SMEM_PER_BLOCK
        assert sm90_smem_bytes(dp, 128) > SMEM_PER_BLOCK
    # flash_fwd_kernel: Q tile, two stages of K and V (three at DP = 64), P
    for dp in TILED_HEAD_DIMS:
        assert f32_smem_bytes(dp) <= SMEM_PER_BLOCK
    assert f32_tiles(192) == f32_tiles(256) == (64, 32)


def test_paligemma_full_width_fills_the_card_in_one_range():
    # 8 query heads, one KV head, 2048 tokens: 8 * 2048 / 64 = 256 blocks
    assert split_plan(1, 8, 2048, 2048, n_sm=H100_SMS, d=256) == (2048, 1)
    per, n = split_plan(1, 1, 128, 1024, n_sm=H100_SMS, d=256)
    assert per % 32 == 0 and n > 1


@pytest.mark.parametrize("b,h,s,d,want", [
    # PaliGemma-3B's shape at D 16 and 96: 128 blocks of 128 q rows on 132
    # SMs, cut in 3 ranges as at D = 128
    (1, 8, 2048, 16, (704, 3)),
    (1, 8, 2048, 96, (704, 3)),
    (1, 8, 2048, 128, (704, 3)),
    # Zamba2-7B (32 heads) and Nemotron-4-340B (96 heads) at 4096 tokens:
    # 1024 and 6144 blocks fill the card in one range
    (1, 32, 4096, 112, (4096, 1)),
    (1, 96, 4096, 192, (4096, 1)),
])
def test_split_plan_at_the_padded_width(b, h, s, d, want):
    assert split_plan(b, h, s, s, n_sm=H100_SMS,
                      d=padded_head_dim(d)) == want


# The wide kernels' widths: the narrowest (8 real columns in its last
# 64-column panel), two that end inside a 32-column group (328, 456),
# whole panels (320, 384) and the cap.  The inputs' scale stays where the
# f32 plain version is itself within F32 of a float64 evaluation: at D 328
# with scale 3 it lies 2.7e-5 from it, and at D 512 with scale 30 7.0e-4
# (the emulation 0.9e-5 and 3.8e-4), so no f32 evaluation order holds F32
# against another there.
WIDE_CASES = [
    (1, 128, 256, 2, 1, 264, True, 1.0),
    (1, 128, 256, 2, 2, 320, False, 1.0),
    (1, 256, 256, 4, 2, 328, True, 2.0),     # logits ~ 15
    (1, 128, 128, 2, 1, 384, False, 1.0),
    (1, 128, 256, 3, 1, 456, True, 1.0),
    (1, 256, 128, 2, 2, 512, True, 1.0),     # Sq != Sk, causal
    (1, 128, 256, 2, 1, 512, False, 1.0),
]


def _wide_id(case):
    return f"d{case[5]}-{'causal' if case[6] else 'full'}"


@pytest.mark.parametrize("case", WIDE_CASES, ids=_wide_id)
def test_wide_f32_kernel_emulation_holds(case):
    b, sq, sk, h, _, d, causal, _ = case
    dp = padded_head_dim(d)
    q, k, v = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = attention_ref(tq, tk, tv, causal=causal).numpy()
    want_jax = _reference(q, k, v, causal)
    plan_per, _ = split_plan(b, h, sq, sk, n_sm=H100_SMS, d=dp)
    for per in sorted({plan_per, wide_f32_plan(dp).kv_rows, sk}):
        got = wide_kernel_emulation(tq, tk, tv, causal=causal,
                                    per=per).numpy()
        assert got.shape == q.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, want_jax, **F32)


@pytest.mark.parametrize("case", WIDE_CASES, ids=_wide_id)
def test_wide_bf16_kernel_emulation_holds(case):
    causal = case[6]
    q, k, v = _inputs(case)
    bq, bk, bv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = attention_ref(bq.float(), bk.float(), bv.float(), causal=causal)
    got = wide_sm90_emulation(bq, bk, bv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == bq.shape
    assert torch.isfinite(got.float()).all()
    atol = CARD_ATOL_RMS * want.pow(2).mean().sqrt().item()
    worst = ((got.float() - want).abs()
             / (atol + CARD_RTOL * want.abs())).max().item()
    assert worst <= 1.0
    np.testing.assert_allclose(got.float().numpy(),
                               _reference_bf16(q, k, v, causal), **BF16)


@pytest.mark.parametrize("d", range(TILED_MAX_HEAD_DIM + 8, MAX_HEAD_DIM + 1,
                                    8))
def test_wide_plans_fit_every_width_to_the_cap(d):
    """Both wide kernels at every width they take: shared memory within a
    block's, no thread holding more accumulators than the DP = 256
    instances (f32 4 rows x 64 columns, bf16 a 64 x 256 wgmma accumulator
    of 128 a thread), the output panels covering DP, and S's panels the
    64-column ones."""
    dp = padded_head_dim(d)
    f, w = wide_f32_plan(dp), wide_sm90_plan(dp)
    for plan in (f, w):
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert plan.panel_cols % 64 == 0 and plan.panel_cols <= WIDE_PANEL
        assert plan.panels * plan.panel_cols >= dp
        assert (plan.panels - 1) * plan.panel_cols < d   # no empty panel
    assert 4 * f.panel_cols // 16 <= 4 * 256 // 16      # f32 accumulators
    assert w.panel_cols // 2 <= 256 // 2                 # bf16 wgmma N / 2
    assert (f.block_q, f.kv_rows) == f32_tiles(256)
    assert (w.block_q, w.kv_rows) == (128, sm90_kv_rows(256))


def test_the_cap_is_where_the_bf16_q_tile_stops_fitting():
    assert wide_sm90_plan(MAX_HEAD_DIM).smem_bytes <= SMEM_PER_BLOCK
    assert wide_sm90_plan(MAX_HEAD_DIM + 64).smem_bytes > SMEM_PER_BLOCK
    assert MAX_HEAD_DIM == 512
    with pytest.raises(ValueError, match="above 256"):
        wide_f32_plan(256)


@pytest.mark.parametrize("d", range(TILED_MAX_HEAD_DIM + 8, MAX_HEAD_DIM + 1,
                                    8))
def test_kernel_path_takes_every_wide_width(d):
    assert kernel_path(torch.float32, d, 128, 128) == "flash_fwd_wide"
    assert kernel_path(torch.bfloat16, d, 128, 128) == "flash_fwd_wide_sm90"


def test_the_launch_counter_names_the_wide_kernels():
    assert {"flash_fwd_kernel", "flash_fwd_sm90", "flash_fwd_wide",
            "flash_fwd_wide_sm90"} == set(flash_attention.launches_by_kernel)


@pytest.mark.parametrize("d", [MAX_HEAD_DIM + 8, 1032, 300, 4])
def test_widths_no_kernel_takes_name_the_roadmap(d):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            kernel_path(dtype, d, 128, 128)


@pytest.mark.parametrize("b,h,s,d,want", [
    # PaliGemma's shape at D 320 and 512: 8 heads x 32 q tiles x 2 output
    # panels = 512 blocks fill the card in one range
    (1, 8, 2048, 320, (2048, 1)),
    (1, 8, 2048, 512, (2048, 1)),
    # the small shape chip_smoke.py holds them on: 4 x 4 x 2 = 32 blocks
    (1, 4, 256, 264, (32, 8)),
    (1, 4, 256, 512, (32, 8)),
])
def test_split_plan_counts_the_wide_panels(b, h, s, d, want):
    assert split_plan(b, h, s, s, n_sm=H100_SMS,
                      d=padded_head_dim(d)) == want
