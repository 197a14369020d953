"""The arithmetic of ``flash_fwd_sm90`` (``csrc/flash_attention.cu``, the
bf16 tensor-core kernel) emulated in PyTorch on the CPU, and the wrapper's
choice of kernel.

The emulation walks 128 x 128 tiles as the kernel does: S = Q K^T in f32
from bf16 inputs; the online softmax in the log2 domain with
``scale * log2(e)`` folded into one multiply of the dot; scores masked to
-1e30 on the tile that crosses the diagonal and kv tiles above it skipped;
P split into two bf16 halves, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``,
both multiplied by bf16 V into an f32 accumulator; ``out = acc / max(l,
1e-30)`` rounded to bf16.  It is held (a) against the reference Pallas
kernel in interpret mode at ``tests/test_torch_kernels.py``'s bf16
tolerance (atol 2e-2, rtol 2e-2) and (b) against the port's plain version
computed in f32 on the same bf16 inputs at the tolerance ``chip_smoke.py``
holds the kernel to on the card: rtol 1e-2, atol 1e-3 of the output's rms.
With P rounded once to bf16 instead of split, (b) fails: one rounding of
p puts ~2^-9 of the output's rms on every element, several times the
limit (``test_one_bf16_rounding_of_p_misses_the_card_tolerance``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.kernel import (SM90_BLOCK,
                                                        kernel_path)

BLOCK = 128
NEG_INF = -1e30
BF16 = dict(atol=2e-2, rtol=2e-2)          # tests/test_torch_kernels.py
CARD_RTOL, CARD_ATOL_RMS = 1e-2, 1e-3      # chip_smoke.py, bf16 kernels


def sm90_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, split_p: bool = True) -> torch.Tensor:
    """flash_fwd_sm90's arithmetic on bf16 q [B, Sq, H, D] and k, v
    [B, Sk, G, D] -> bf16 [B, Sq, H, D]; ``split_p=False`` rounds P once
    to bf16 instead of splitting it."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    rep = h // g
    scale_log2 = d ** -0.5 * math.log2(math.e)
    out = torch.empty_like(q)
    rows = torch.arange(BLOCK)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, sq, BLOCK):
                qt = q[bi, q0:q0 + BLOCK, hi].float()
                m = torch.full((BLOCK, 1), NEG_INF)
                l = torch.zeros(BLOCK, 1)
                acc = torch.zeros(BLOCK, d)
                for k0 in range(0, sk, BLOCK):
                    if causal and k0 > q0 + BLOCK - 1:
                        break
                    kt = k[bi, k0:k0 + BLOCK, hi // rep].float()
                    vt = v[bi, k0:k0 + BLOCK, hi // rep].float()
                    s = (qt @ kt.T) * scale_log2
                    if causal and k0 + BLOCK - 1 > q0:
                        keep = (q0 + rows)[:, None] >= (k0 + rows)[None, :]
                        s = torch.where(keep, s, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new)
                    l = l * alpha + p.sum(dim=1, keepdim=True)
                    p_hi = p.to(torch.bfloat16).float()
                    pv = p_hi @ vt
                    if split_p:
                        pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
                    acc = acc * alpha + pv
                    m = m_new
                out[bi, q0:q0 + BLOCK, hi] = (
                    acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)
    return out


CASES = [
    # (b, sq, sk, h, g, d, causal, input scale)
    (1, 512, 512, 4, 2, 64, True, 1.0),      # GQA, S = 512
    (1, 512, 512, 4, 2, 128, False, 1.0),    # GQA, D = 128, non-causal
    (1, 512, 512, 4, 1, 128, True, 1.0),     # MQA, causal
    (1, 256, 512, 4, 1, 64, False, 1.0),     # MQA, Sq != Sk
    (2, 256, 384, 4, 2, 128, True, 1.0),     # Sq != Sk, causal, batch 2
    (1, 128, 128, 2, 2, 64, True, 30.0),     # extreme logits, causal
    (1, 128, 256, 2, 1, 128, False, 30.0),   # extreme logits, D = 128
]


def _inputs(case):
    b, sq, sk, h, g, d, causal, scale = case
    rng = np.random.default_rng(sq * 7 + sk + h * 3 + g + d + int(causal))
    q = (scale * rng.standard_normal((b, sq, h, d))).astype(np.float32)
    k = (scale * rng.standard_normal((b, sk, g, d))).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    return q, k, v


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_reference_kernel(case):
    causal = case[6]
    q, k, v = _inputs(case)
    want = jax_flash(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                     causal=causal, interpret=True)
    got = sm90_emulation(_bf16(q), _bf16(k), _bf16(v), causal=causal)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **BF16)


def _worst_over_card_limit(case, *, split_p: bool) -> float:
    """max |emulation - plain f32| / (atol + rtol |plain f32|): at most 1
    passes the card's check."""
    causal = case[6]
    q, k, v = (_bf16(x) for x in _inputs(case))
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    got = sm90_emulation(q, k, v, causal=causal, split_p=split_p).float()
    assert torch.isfinite(got).all()
    atol = CARD_ATOL_RMS * want.pow(2).mean().sqrt().item()
    return ((got - want).abs() / (atol + CARD_RTOL * want.abs())).max().item()


@pytest.mark.parametrize("case", CASES)
def test_emulation_holds_the_card_tolerance(case):
    assert _worst_over_card_limit(case, split_p=True) <= 1.0


@pytest.mark.parametrize("case", [
    *(c for c in CASES if c[7] == 1.0),
    (1, 4096, 4096, 2, 1, 128, True, 1.0),   # full sequence length
])
def test_one_bf16_rounding_of_p_misses_the_card_tolerance(case):
    # Why the kernel splits P: the cheaper design fails the same check.
    assert _worst_over_card_limit(case, split_p=False) > 1.0


@pytest.mark.parametrize("dtype,d,bq,bk,path", [
    (torch.bfloat16, 128, 128, 128, "flash_fwd_sm90"),
    (torch.bfloat16, 64, 128, 128, "flash_fwd_sm90"),
    (torch.float32, 128, 128, 128, "flash_fwd_kernel"),
    (torch.float32, 64, 64, 32, "flash_fwd_kernel"),
    # Neither kernel reads the spec's tile: the reference's other tiles are
    # taken (they were refused before the tile check went).
    (torch.bfloat16, 128, 64, 128, "flash_fwd_sm90"),
    (torch.bfloat16, 64, 128, 256, "flash_fwd_sm90"),
    (torch.float32, 128, 256, 128, "flash_fwd_kernel"),
    (torch.float32, 128, 128, 48, "flash_fwd_kernel"),
])
def test_kernel_path_names_the_kernel(dtype, d, bq, bk, path):
    assert kernel_path(dtype, d, bq, bk) == path


@pytest.mark.parametrize("dtype,d,bq,bk,match", [
    (torch.bfloat16, 96, 128, 128, "D in"),
    (torch.float32, 256, 128, 128, "D in"),
    (torch.float16, 128, 128, 128, "takes"),
])
def test_kernel_path_refuses_what_no_kernel_takes(dtype, d, bq, bk, match):
    with pytest.raises(ValueError, match=match):
        kernel_path(dtype, d, bq, bk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_q,block_k", [(128, 128), (256, 128),
                                             (128, 256)])
def test_kernel_path_takes_the_reference_tiles(dtype, block_q, block_k):
    # tests/test_kernels.py's tile invariance cases: the spec records the
    # reference's tile, and the wrapper takes whatever tile it records.
    from repro_torch.kernels.flash_attention.ops import launch_spec, mha

    spec = launch_spec(1, 512, 512, 4, 2, 64, dtype, block_q=block_q,
                       block_k=block_k)
    assert spec.operand("q").block_shape[1] == block_q
    assert spec.operand("k").block_shape[1] == block_k
    assert spec.grid == (4, 512 // block_q, 512 // block_k)
    path = "flash_fwd_kernel" if dtype == torch.float32 else "flash_fwd_sm90"
    assert kernel_path(dtype, 64, block_q, block_k) == path
    q, k, v = (torch.from_numpy(x) for x in _inputs(
        (1, 512, 512, 4, 2, 64, True, 1.0)))
    np.testing.assert_array_equal(
        mha(q, k, v, causal=True, block_q=block_q, block_k=block_k).numpy(),
        attention_ref(q, k, v, causal=True).numpy())


def test_sm90_block_is_the_default_spec_tile():
    # ops.mha's default blocks, which the card path's multiple-of-128 rule
    # makes the spec's bq and bk, are the tiles flash_fwd_sm90 takes.
    from repro_torch.kernels.flash_attention.ops import launch_spec

    spec = launch_spec(1, 256, 384, 4, 2, 128, torch.bfloat16)
    bq = spec.operand("q").block_shape[1]
    bk = spec.operand("k").block_shape[1]
    assert bq == bk == SM90_BLOCK
    assert kernel_path(torch.bfloat16, 128, bq, bk) == "flash_fwd_sm90"
