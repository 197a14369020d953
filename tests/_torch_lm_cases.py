"""Model-level cases of the port's LM against ``repro.models.LM``, in
float32 at the tolerance of ``tests/test_models.py`` (atol/rtol 1e-4),
with the reference's parameters carried across by the converter.

The ``test_torch_models_{dense,moe,vlm}.py`` files import these cases
and give them an ``arch`` fixture over their configs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_lm import assert_tree_close, extra_embed, j, pair, t, to_np

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(dtype="float32")
B, S, MAX_LEN = 2, 24, 40


def _tokens(cfg, seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, size=shape).astype(np.int32)


def test_forward_logits_and_aux(arch):
    ref, params, lm, jit = pair(arch, **F32)
    tokens = _tokens(ref.cfg, 1, (B, S))
    extra = extra_embed(ref.cfg, np.random.default_rng(2), B)
    want, aux_w = jit["forward"](params, j(tokens), j(extra))
    with torch.no_grad():
        got, aux_g = lm(t(tokens), extra_embed=t(extra))
    assert got.shape == (B, S, ref.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    np.testing.assert_allclose(to_np(aux_g), to_np(aux_w), **TOL)


def test_loss_with_ignored_labels(arch):
    ref, params, lm, jit = pair(arch, **F32)
    tokens = _tokens(ref.cfg, 3, (B, S))
    labels = _tokens(ref.cfg, 4, (B, S))
    labels[0, :5] = -1
    labels[1, -3:] = -1
    batch = {"tokens": tokens, "labels": labels}
    extra = extra_embed(ref.cfg, np.random.default_rng(5), B)
    if extra is not None:
        batch["extra_embed"] = extra
    want = jit["loss"](params, {k: j(v) for k, v in batch.items()})
    with torch.no_grad():
        got = lm.loss({k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def _prefill(arch, padded: bool):
    """Both prefills of a [B, 16] prompt (lengths 7 and 16 when padded),
    from fresh caches."""
    ref, params, lm, jit = pair(arch, **F32)
    tokens = _tokens(ref.cfg, 6, (B, 16))
    prompt_len = np.array([7, 16], np.int32) if padded else None
    extra = extra_embed(ref.cfg, np.random.default_rng(7), B)
    r_cache = ref.init_cache(B, MAX_LEN)
    want = jit["prefill"](params, j(tokens), r_cache, j(extra), j(prompt_len))
    with torch.no_grad():
        got = lm.prefill(t(tokens), lm.init_cache(B, MAX_LEN),
                         extra_embed=t(extra), prompt_len=t(prompt_len))
    return ref, params, lm, jit, got, want


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "prompt_len"])
def test_prefill_logits_cache_and_next_pos(arch, padded):
    _, _, _, _, (lg, cache, pos), (lg_w, cache_w, pos_w) = _prefill(arch, padded)
    assert lg.shape == tuple(lg_w.shape)
    np.testing.assert_allclose(to_np(lg), to_np(lg_w), **TOL)
    assert_tree_close(cache, cache_w, **TOL)
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_w))


def test_four_decode_steps_after_a_padded_prefill(arch):
    ref, params, lm, jit, (_, cache, pos), (_, cache_w, pos_w) = _prefill(
        arch, True)
    for step in range(4):
        tok = _tokens(ref.cfg, 10 + step, (B, 1))
        lg_w, cache_w = jit["decode"](params, j(tok), cache_w, pos_w)
        with torch.no_grad():
            lg, cache = lm.decode_step(t(tok), cache, pos)
        np.testing.assert_allclose(to_np(lg), to_np(lg_w), **TOL,
                                   err_msg=f"step {step}")
        pos, pos_w = pos + 1, pos_w + 1
    assert_tree_close(cache, cache_w, **TOL)
