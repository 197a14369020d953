"""The port's LM against ``repro.models.LM`` for the VLM family
(paligemma: patch embeddings prepended, MQA at head_dim 16, tanh GELU), at
the smoke config in float32: forward logits and aux, the loss, both
prefills and four decode steps (atol/rtol 1e-4).  Then dense and VLM in
bfloat16, the configs' own compute dtype."""

import numpy as np
import pytest
import torch

from _torch_lm import extra_embed, j, pair, t, to_np
from _torch_lm_cases import (  # noqa: F401  (collected here)
    test_forward_logits_and_aux, test_four_decode_steps_after_a_padded_prefill,
    test_loss_with_ignored_labels, test_prefill_logits_cache_and_next_pos)

# bf16 keeps 8 significant bits, so each rounding moves a value by up to
# 2^-9 of itself.  The port rounds after every operation, as the
# reference's program is written (its activations stepped as XLA expands
# them, see ``layers.silu``); XLA's default licence to keep fused
# elementwise chains in float32 ("excess precision") lets the compiled
# reference skip some of those roundings, so the two differ by about 0.01
# of the logits' rms, and at most by 0.047 of it on these seeds: the
# bound is 0.05 of the rms, on the largest entry.
BF16_BOUND = 0.05
# Compiled without that licence, the reference rounds where the port
# does: the port's logits then lie at most 0.21 as far from it as the
# reference's float32 logits do (most seeds agree exactly), where logits
# computed in float32, or with one activation rounded once, lie 0.75-1.0
# as far.
BF16_STRICT = {"xla_allow_excess_precision": False}
BF16_STRICT_RATIO = 0.5


@pytest.fixture(params=["paligemma-3b"])
def arch(request):
    return request.param


def _bf16_case(arch, seed):
    """(port's bf16 logits, the reference's bf16 jit, its args)."""
    ref, params, lm, jit = pair(arch, dtype="bfloat16")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, ref.cfg.vocab, size=(2, 24)).astype(np.int32)
    extra = extra_embed(ref.cfg, rng, 2)
    with torch.no_grad():
        got, _ = lm(t(tokens), extra_embed=t(extra))
    assert got.dtype == torch.bfloat16
    return to_np(got), jit["forward"], (params, j(tokens), j(extra))


def _rms(x):
    return np.sqrt(np.mean(x ** 2))


@pytest.mark.parametrize("bf16_arch", ["qwen2.5-14b", "paligemma-3b"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bf16_logits_within_a_stated_bound(bf16_arch, seed):
    got, forward, args = _bf16_case(bf16_arch, seed)
    want = to_np(forward(*args)[0])
    assert np.abs(got - want).max() <= BF16_BOUND * _rms(want)


@pytest.mark.parametrize("bf16_arch", ["qwen2.5-14b", "paligemma-3b"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bf16_logits_round_where_the_reference_rounds(bf16_arch, seed):
    got, forward, args = _bf16_case(bf16_arch, seed)
    strict = forward.lower(*args).compile(compiler_options=BF16_STRICT)
    want = to_np(strict(*args)[0])
    _, _, _, jit32 = pair(bf16_arch, dtype="float32")
    f32 = to_np(jit32["forward"](*args)[0])
    assert _rms(got - want) <= BF16_STRICT_RATIO * _rms(want - f32)
