"""Flash attention at every head width the reference's ``mha`` runs its
kernel for (D % 8 == 0), up to 256, on the CPU.

- The port's plain version against the reference Pallas kernel in
  interpret mode at D = 16 (the smoke configs' heads) and 256
  (PaliGemma's), at the f32 tolerance of ``tests/test_torch_kernels.py``.
- The arithmetic of ``flash_fwd_simple`` (``csrc/flash_attention.cu``, the
  kernel of every width but 64, 128 and 256) emulated in float32: 32-row q
  tiles walking 32-row kv chunks, lane j scoring kv row j, a row's sum kept
  as the 32 lanes' shares and added by a xor butterfly at the end, masked
  scores -1e30, chunks above the diagonal skipped; held to the plain
  version at the card's tolerances (f32 atol 2e-5, rtol 1e-4; bf16 inputs
  rtol 1e-2, atol 1e-3 of the output's rms) and to the reference kernel.
- The tiles ``plan.py`` gives D = 256: both tiled kernels' buffers fit a
  block's 227 KB of shared memory, and PaliGemma's full-width launch fills
  the card without a kv split.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.plan import (SIMPLE_TILE,
                                                      SMEM_PER_BLOCK,
                                                      f32_tiles, sm90_kv_rows,
                                                      sm90_smem_bytes,
                                                      split_plan)

F32 = dict(atol=2e-5, rtol=1e-4)
CARD_RTOL, CARD_ATOL_RMS = 1e-2, 1e-3      # chip_smoke.py, bf16 kernels
NEG_INF = -1e30
H100_SMS = 132


def simple_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool) -> torch.Tensor:
    """flash_fwd_simple on q [B, Sq, H, D], k, v [B, Sk, G, D] (f32 or
    bf16, read into f32) -> the inputs' dtype."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    rep, t = h // g, SIMPLE_TILE
    scale_log2 = d ** -0.5 * math.log2(math.e)
    out = torch.empty_like(q)
    rows, lanes = torch.arange(t), torch.arange(t)
    for bi in range(b):
        for hi in range(h):
            kh = k[bi, :, hi // rep].float()
            vh = v[bi, :, hi // rep].float()
            for q0 in range(0, sq, t):
                qt = q[bi, q0:q0 + t, hi].float()
                m = torch.full((t, 1), NEG_INF)
                l_lane = torch.zeros(t, t)
                acc = torch.zeros(t, d)
                kv_end = min(sk, q0 + t) if causal else sk
                for k0 in range(0, kv_end, t):
                    x = (qt @ kh[k0:k0 + t].T) * scale_log2
                    if causal and k0 + t - 1 > q0:
                        keep = (q0 + rows)[:, None] >= (k0 + lanes)[None]
                        x = torch.where(keep, x, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, x.amax(dim=1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new)
                    l_lane = l_lane * alpha + p
                    acc = acc * alpha + p @ vh[k0:k0 + t]
                    m = m_new
                while l_lane.shape[1] > 1:             # xor 16, 8, 4, 2, 1
                    half = l_lane.shape[1] // 2
                    l_lane = l_lane[:, :half] + l_lane[:, half:]
                out[bi, q0:q0 + t, hi] = (
                    acc / torch.clamp(l_lane, min=1e-30)).to(q.dtype)
    return out


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


# (b, sq, sk, h, g, d, causal, input scale)
REF_CASES = [
    (1, 128, 128, 2, 1, 16, True, 1.0),      # the smoke configs' width
    (1, 128, 256, 4, 2, 16, False, 1.0),
    (1, 128, 128, 2, 1, 256, True, 1.0),     # PaliGemma's width
    (1, 128, 256, 2, 2, 256, False, 1.0),
]


@pytest.mark.parametrize("case", REF_CASES)
def test_plain_version_matches_the_reference_kernel(case):
    causal = case[6]
    q, k, v = _inputs(case)
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal).numpy()
    np.testing.assert_allclose(got, _reference(q, k, v, causal), **F32)


SIMPLE_CASES = [
    (1, 128, 128, 2, 1, 16, True, 1.0),
    (1, 64, 96, 2, 2, 40, False, 1.0),
    (2, 64, 64, 4, 2, 96, True, 1.0),
    (1, 96, 128, 2, 1, 200, True, 1.0),
    (1, 64, 64, 1, 1, 248, False, 30.0),     # extreme logits, widest
    (1, 32, 64, 2, 1, 8, True, 30.0),        # narrowest, extreme logits
]


@pytest.mark.parametrize("case", SIMPLE_CASES)
def test_simple_kernel_emulation_holds_f32(case):
    causal = case[6]
    q, k, v = _inputs(case)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = simple_emulation(tq, tk, tv, causal=causal)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), attention_ref(
        tq, tk, tv, causal=causal).numpy(), **F32)
    if case[1] % 128 == 0 and case[2] % 128 == 0:
        np.testing.assert_allclose(got.numpy(),
                                   _reference(q, k, v, causal), **F32)


@pytest.mark.parametrize("case", SIMPLE_CASES[:4])
def test_simple_kernel_emulation_holds_the_bf16_card_tolerance(case):
    causal = case[6]
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(case))
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    got = simple_emulation(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16
    atol = CARD_ATOL_RMS * want.pow(2).mean().sqrt().item()
    worst = ((got.float() - want).abs()
             / (atol + CARD_RTOL * want.abs())).max().item()
    assert worst <= 1.0


def test_d256_tiles_fit_a_block():
    # flash_fwd_sm90: 128-row kv tiles at D <= 128, 64 at D = 256
    assert [sm90_kv_rows(d) for d in (64, 128, 256)] == [128, 128, 64]
    assert sm90_smem_bytes(256, 64) <= SMEM_PER_BLOCK
    assert sm90_smem_bytes(256, 128) > SMEM_PER_BLOCK
    # flash_fwd_kernel: Q tile, two stages of K and V, P (floats)
    for d, stages in ((64, 3), (128, 2), (256, 2)):
        bq, bk = f32_tiles(d)
        assert 4 * (bq * d + 2 * stages * bk * d + bq * bk) <= SMEM_PER_BLOCK
    assert f32_tiles(256) == (64, 32)
    # flash_fwd_simple at its widest: Q, K padded to D + 1, V
    t = SIMPLE_TILE
    assert 4 * (t * 256 + t * 257 + t * 256) <= SMEM_PER_BLOCK


def test_paligemma_full_width_fills_the_card_in_one_range():
    # 8 query heads, one KV head, 2048 tokens: 8 * 2048 / 64 = 256 blocks
    assert split_plan(1, 8, 2048, 2048, n_sm=H100_SMS, d=256) == (2048, 1)
    per, n = split_plan(1, 1, 128, 1024, n_sm=H100_SMS, d=256)
    assert per % 32 == 0 and n > 1
