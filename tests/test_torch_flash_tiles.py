"""The arithmetic of ``flash_fwd_sm90`` (``csrc/flash_attention.cu``, the
bf16 tensor-core kernel) emulated in PyTorch on the CPU, and the wrapper's
choice of kernel.

The emulation (``tests/_torch_flash_emulation.py``) walks 128-row q tiles
and ``plan.sm90_kv_rows`` kv rows (128, or 64 at D = 256) as the kernel
does: S = Q K^T in f32 from bf16 inputs; the online softmax in the log2
domain with ``scale * log2(e)`` folded into one multiply of the dot;
scores masked to -1e30 on the tile that crosses the diagonal and kv tiles
above it skipped;
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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flash_emulation import sm90_emulation
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.kernel import (SM90_BLOCK,
                                                        kernel_path)

BF16 = dict(atol=2e-2, rtol=2e-2)          # tests/test_torch_kernels.py
CARD_RTOL, CARD_ATOL_RMS = 1e-2, 1e-3      # chip_smoke.py, bf16 kernels


CASES = [
    # (b, sq, sk, h, g, d, causal, input scale)
    (1, 512, 512, 4, 2, 64, True, 1.0),      # GQA, S = 512
    (1, 512, 512, 4, 2, 128, False, 1.0),    # GQA, D = 128, non-causal
    (1, 512, 512, 4, 1, 128, True, 1.0),     # MQA, causal
    (1, 256, 512, 4, 1, 64, False, 1.0),     # MQA, Sq != Sk
    (2, 256, 384, 4, 2, 128, True, 1.0),     # Sq != Sk, causal, batch 2
    (1, 128, 128, 2, 2, 64, True, 30.0),     # extreme logits, causal
    (1, 128, 256, 2, 1, 128, False, 30.0),   # extreme logits, D = 128
    (1, 256, 256, 4, 1, 256, True, 1.0),     # D = 256 (64-row kv tiles)
    (1, 128, 384, 2, 2, 256, False, 1.0),    # D = 256, Sq != Sk
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
    # D = 256 (PaliGemma's heads) on the tiled kernels, with smaller tiles
    (torch.bfloat16, 256, 128, 128, "flash_fwd_sm90"),
    (torch.float32, 256, 128, 128, "flash_fwd_kernel"),
    # other widths on the same kernels, padded to a 64-column panel
    (torch.bfloat16, 96, 128, 128, "flash_fwd_sm90"),
    (torch.float32, 16, 128, 128, "flash_fwd_kernel"),
    # above 256, the wide kernels
    (torch.bfloat16, 264, 128, 128, "flash_fwd_wide_sm90"),
    (torch.float32, 512, 128, 128, "flash_fwd_wide"),
])
def test_kernel_path_names_the_kernel(dtype, d, bq, bk, path):
    assert kernel_path(dtype, d, bq, bk) == path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(8, 257, 8))
def test_kernel_path_takes_every_width_a_multiple_of_8_up_to_256(dtype, d):
    # the reference's mha runs its kernel at any D % 8 == 0; the port's two
    # tiled kernels take each of them up to 256, padded in shared memory
    path = kernel_path(dtype, d, 128, 128)
    tiled = "flash_fwd_kernel" if dtype == torch.float32 else "flash_fwd_sm90"
    assert path == tiled


@pytest.mark.parametrize("dtype,d,bq,bk,match", [
    (torch.bfloat16, 520, 128, 128, "D % 8 == 0 up to 512"),
    (torch.float32, 1032, 128, 128, "D % 8 == 0 up to 1024"),
    (torch.float32, 20, 128, 128, "D % 8 == 0 up to 1024"),
    (torch.bfloat16, 4, 128, 128, "D % 8 == 0 up to 512"),
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
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         launch_spec)

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
        flash_attention(q, k, v, causal=True, block_q=block_q,
                        block_k=block_k).numpy(),
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
