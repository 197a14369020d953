"""Flash attention at every head width the reference's ``mha`` runs its
kernel for (D % 8 == 0), up to 1024 in f32 and 512 in bf16, on the CPU.

- The port's plain version against the reference Pallas kernel in
  interpret mode at D = 16 (the smoke configs' heads), 112 (Zamba2-7B's),
  192 (Nemotron-4-340B's), 256 (PaliGemma's), 320, 512, 768 and 1024, at
  the f32 tolerance of ``tests/test_torch_kernels.py``.
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
  ``flash_fwd_wide_sm90``, bf16), which deal the head's panels to blocks
  along the grid's z: their emulations at D in {264, 320, 328, 384, 456,
  512}, and f32's also at 520, 768 and 1024 (f32 a thread-block cluster,
  each rank's partial S over its own columns summed in rank order, also
  cut into kv ranges and combined; bf16 each block S over the whole head;
  then P V per block) held to the plain version and to the reference
  kernel in interpret mode as above; ``plan.wide_panels`` dealing every
  padded width's panels; every width from 264 to each dtype's cap fitting
  a block's shared memory with no thread holding more accumulators than
  the DP 256 instances; the caps themselves (a cluster of four in f32, two
  blocks holding the whole Q tile in bf16); and the wrapper naming the
  wide kernel at each width and refusing bf16 above its cap.
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
from repro_torch.kernels.flash_attention.kernel import (flash_attention_cuda,
                                                        kernel_path)
from repro_torch.kernels.flash_attention.plan import (
    MAX_HEAD_DIM, SM90_MAX_HEAD_DIM, SMEM_PER_BLOCK, TILED_HEAD_DIMS,
    TILED_MAX_HEAD_DIM, WIDE_MAX_CLUSTER, WIDE_PANEL, WIDE_SM90_BLOCKS,
    f32_tiles, padded_head_dim, sm90_kv_rows, sm90_smem_bytes, split_plan,
    wide_f32_plan, wide_panels, wide_s_panels, wide_sm90_plan)

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
    (1, 128, 256, 2, 2, 768, False, 1.0),    # f32's clusters of 3 and 4
    (1, 128, 128, 2, 1, 1024, True, 1.0),
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
        if d <= SM90_MAX_HEAD_DIM:
            assert wide_sm90_plan(dp).smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("d", [MAX_HEAD_DIM + 8, 2048, 20, 4, 0])
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
# whole panels (320, 384) and bf16's cap; then f32's alone: a cluster of
# three (520: 8 real columns in the last of nine panels, 768) and of four
# (1024, Sq != Sk once).  The inputs' scale stays where the f32 plain
# version is itself within F32 of a float64 evaluation: at D 328 with scale
# 3 it lies 2.7e-5 from it, and at D 512 with scale 30 7.0e-4 (the
# emulation 0.9e-5 and 3.8e-4), so no f32 evaluation order holds F32
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
WIDE_F32_CASES = WIDE_CASES + [
    (1, 128, 256, 2, 1, 520, True, 1.0),
    (1, 128, 128, 2, 2, 768, False, 1.0),
    (1, 256, 128, 2, 1, 1024, True, 1.0),    # Sq != Sk, causal
    (1, 128, 256, 1, 1, 1024, False, 1.0),
]


def _wide_id(case):
    return f"d{case[5]}-{'causal' if case[6] else 'full'}"


@pytest.mark.parametrize("case", WIDE_F32_CASES, ids=_wide_id)
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


@pytest.mark.parametrize("dp", range(TILED_MAX_HEAD_DIM + 64,
                                     MAX_HEAD_DIM + 1, 64))
def test_wide_panels_deal_the_head_to_the_cluster(dp):
    """plan.wide_panels (and wide_run in csrc/flash_attention.cu): the
    DP / 64 panels in contiguous runs, one a rank, in order, ceil(DP / 256)
    ranks of at most four panels, two runs differing by one panel at most,
    the longer first."""
    runs = wide_panels(dp)
    assert len(runs) == -(-dp // WIDE_PANEL) <= WIDE_MAX_CLUSTER
    assert runs[0][0] == 0
    for (p0, n), (q0, _) in zip(runs, runs[1:]):
        assert q0 == p0 + n
    assert sum(n for _, n in runs) == dp // 64
    sizes = [n for _, n in runs]
    assert max(sizes) <= WIDE_PANEL // 64 and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    assert min(sizes) >= 2            # flash_fwd_wide's first unit is whole
    # f32's runs of Q and K: the same sizes the other way round, contiguous
    # from panel 0, so each block's S and O panels add up evenly
    s_runs = wide_s_panels(dp)
    assert [n for _, n in s_runs] == sizes[::-1]
    assert [p0 for p0, _ in s_runs] == [sum(sizes[::-1][:r])
                                        for r in range(len(sizes))]
    totals = [n + m for (_, n), (_, m) in zip(runs, s_runs)]
    assert max(totals) - min(totals) <= 1
    assert max(totals) <= 2 * (-(-(dp // 64) // len(runs)))


@pytest.mark.parametrize("d", range(TILED_MAX_HEAD_DIM + 8, MAX_HEAD_DIM + 1,
                                    8))
def test_wide_plans_fit_every_width_to_the_cap(d):
    """Both wide kernels at every width they take: shared memory within a
    block's, no thread holding more accumulators than the DP = 256
    instances (f32 4 rows x 64 columns, bf16 a 64 x 256 wgmma accumulator
    of 128 a thread), the cluster's blocks covering DP with no empty one,
    and a block's columns whole 64-column panels."""
    dp = padded_head_dim(d)
    plans = [wide_f32_plan(dp)]
    if d <= SM90_MAX_HEAD_DIM:
        plans.append(wide_sm90_plan(dp))
    for plan in plans:
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert plan.panel_cols % 64 == 0 and plan.panel_cols <= WIDE_PANEL
        assert plan.blocks * plan.panel_cols >= dp
        assert (plan.blocks - 1) * plan.panel_cols < d   # no empty block
        assert plan.panel_cols == 64 * max(n for _, n in wide_panels(dp))
    f = plans[0]
    assert f.cluster == f.blocks <= WIDE_MAX_CLUSTER    # f32: one cluster
    assert 4 * f.panel_cols // 16 <= 4 * 256 // 16      # f32 accumulators
    assert (f.block_q, f.kv_rows) == f32_tiles(256)
    if len(plans) > 1:
        w = plans[1]
        assert (w.blocks, w.cluster) == (WIDE_SM90_BLOCKS, 1)
        assert w.panel_cols // 2 <= 256 // 2             # bf16 wgmma N / 2
        assert (w.block_q, w.kv_rows) == (128, sm90_kv_rows(256))


def test_the_caps_are_the_widest_splits():
    """What sets each cap.  f32: a block holds at most WIDE_PANEL columns
    of Q, K, V and O, so a head is as wide as its widest cluster, four
    blocks.  bf16: two blocks of at most WIDE_PANEL columns of O, each
    holding the whole 128-row Q tile beside a V ring of its panels; two
    blocks stop fitting at DP 576, and three would buy that width alone (at
    640 the Q tile, the K ring and a three-panel V ring pass a block's
    shared memory)."""
    assert MAX_HEAD_DIM == WIDE_MAX_CLUSTER * WIDE_PANEL == 1024
    assert SM90_MAX_HEAD_DIM == WIDE_SM90_BLOCKS * WIDE_PANEL == 512
    assert WIDE_MAX_CLUSTER <= 8                         # portable clusters
    assert wide_f32_plan(MAX_HEAD_DIM).cluster == WIDE_MAX_CLUSTER
    assert wide_f32_plan(MAX_HEAD_DIM).smem_bytes <= SMEM_PER_BLOCK
    w = wide_sm90_plan(SM90_MAX_HEAD_DIM)
    assert w.smem_bytes <= SMEM_PER_BLOCK
    q_panel, v_panel = 128 * 64 * 2, 2 * 64 * 64 * 2
    assert w.smem_bytes + q_panel + v_panel > SMEM_PER_BLOCK   # 576, 5 + 4
    assert w.smem_bytes + 2 * q_panel - v_panel > SMEM_PER_BLOCK  # 640, x3
    with pytest.raises(ValueError, match="up to 1024"):
        wide_f32_plan(MAX_HEAD_DIM + 64)
    with pytest.raises(ValueError, match="up to 512"):
        wide_sm90_plan(SM90_MAX_HEAD_DIM + 64)
    with pytest.raises(ValueError, match="above 256"):
        wide_f32_plan(256)


@pytest.mark.parametrize("d", range(TILED_MAX_HEAD_DIM + 8, MAX_HEAD_DIM + 1,
                                    8))
def test_kernel_path_takes_every_wide_width(d):
    assert kernel_path(torch.float32, d, 128, 128) == "flash_fwd_wide"
    if d <= SM90_MAX_HEAD_DIM:
        assert (kernel_path(torch.bfloat16, d, 128, 128)
                == "flash_fwd_wide_sm90")
    else:
        with pytest.raises(ValueError, match="ROADMAP.md"):
            kernel_path(torch.bfloat16, d, 128, 128)


def test_the_launch_counter_names_the_wide_kernels():
    assert {"flash_fwd_kernel", "flash_fwd_sm90", "flash_fwd_wide",
            "flash_fwd_wide_sm90"} == set(
        flash_attention_cuda.launches_by_kernel)


@pytest.mark.parametrize("d", [MAX_HEAD_DIM + 8, 2048, 300, 4])
def test_widths_no_kernel_takes_name_the_roadmap(d):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            kernel_path(dtype, d, 128, 128)


@pytest.mark.parametrize("b,h,s,d,want", [
    # PaliGemma's shape at D 320 and 512: 8 heads x 32 q tiles x clusters
    # of 2 = 512 blocks fill the card in one range
    (1, 8, 2048, 320, (2048, 1)),
    (1, 8, 2048, 512, (2048, 1)),
    # the small shape chip_smoke.py holds them on: 4 x 4 x 2 = 32 blocks,
    # then clusters of 3 and 4: 48 and 64 blocks
    (1, 4, 256, 264, (32, 8)),
    (1, 4, 256, 512, (32, 8)),
    (1, 4, 256, 768, (64, 4)),
    (1, 4, 256, 1024, (64, 4)),
])
def test_split_plan_counts_the_wide_panels(b, h, s, d, want):
    assert split_plan(b, h, s, s, n_sm=H100_SMS,
                      d=padded_head_dim(d)) == want
