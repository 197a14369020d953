"""The port's LM against ``repro.models.LM`` for the dense family's GQA
and SwiGLU configs (qwen2.5 with QKV bias, phi4-mini), at the smoke
configs in float32: forward logits and aux, the loss, both prefills and
four decode steps (atol/rtol 1e-4)."""

import pytest

from _torch_lm_cases import (  # noqa: F401  (collected here)
    test_forward_logits_and_aux, test_four_decode_steps_after_a_padded_prefill,
    test_loss_with_ignored_labels, test_prefill_logits_cache_and_next_pos)


@pytest.fixture(params=["qwen2.5-14b", "phi4-mini-3.8b"])
def arch(request):
    return request.param
