"""The port's LM against ``repro.models.LM`` for the audio family
(whisper-large-v3's smoke config: a non-causal encoder over 32 seeded
frame embeddings, a decoder with self- and cross-attention) in float32:
the model cases of ``_torch_lm_cases`` (forward, loss, both prefills,
four decode steps, every cache at atol/rtol 1e-4), cross-attention
(``attention_fwd``'s ``kv_override``) at the layer tolerance, and the
``cross_kv`` cache, written once at prefill and only read by decode."""

import jax
import numpy as np
import pytest
import torch

from _torch_lm import (KEY, LAYER_TOL, both, close, extra_embed, layer_cfgs,
                       pair, seeded, t, to_np)
from _torch_lm_cases import (  # noqa: F401  (collected here)
    TOL, test_forward_logits_and_aux,
    test_four_decode_steps_after_a_padded_prefill,
    test_loss_with_ignored_labels, test_prefill_logits_cache_and_next_pos)
from repro.models import layers as RL
from repro_torch.models import layers as L


@pytest.fixture(params=["whisper-large-v3"])
def arch(request):
    return request.param


@pytest.mark.parametrize("attn_impl", ["naive", "chunked"])
def test_cross_attention_kv_override(attn_impl):
    """RoPE on the query only, the naive path whatever ``attn_impl``."""
    rcfg, cfg = layer_cfgs("whisper-large-v3", attn_impl=attn_impl,
                           attn_chunk=8)
    pj, pt = both(RL.attention_init(KEY, rcfg))
    rng = np.random.default_rng(9)
    hd = cfg.resolved_head_dim
    xj, xt = seeded(rng, 2, 5, cfg.d_model)
    kj, kt = seeded(rng, 2, 32, cfg.n_kv_heads, hd)
    vj, vt = seeded(rng, 2, 32, cfg.n_kv_heads, hd)
    pos = np.array([[3, 4, 5, 6, 7]] * 2, np.int32)
    want = jax.jit(lambda p, x, k, v: RL.attention_fwd(
        p, rcfg, x, pos, causal=False, kv_override=(k, v)))(pj, xj, kj, vj)
    got = L.attention_fwd(pt, cfg, xt, torch.from_numpy(pos), causal=False,
                          kv_override=(kt, vt))
    close(got, want, tol=LAYER_TOL)


def test_cross_kv_is_written_once_and_read_by_decode():
    ref, params, lm, jit = pair("whisper-large-v3", dtype="float32")
    cfg = lm.cfg
    rng = np.random.default_rng(10)
    frames = extra_embed(cfg, rng, 2)
    tokens = rng.integers(1, cfg.vocab, (2, 8)).astype(np.int32)
    r_cache = ref.init_cache(2, 24)
    _, cw, pw = jit["prefill"](params, tokens, r_cache, frames, None)
    with torch.no_grad():
        _, cache, pos = lm.prefill(t(tokens), lm.init_cache(2, 24),
                                   extra_embed=t(frames))
        assert cache["cross_kv"]["k"].shape == (
            cfg.n_layers, 2, cfg.enc_ctx, cfg.n_kv_heads,
            cfg.resolved_head_dim)
        for k in ("k", "v"):
            np.testing.assert_allclose(to_np(cache["cross_kv"][k]),
                                       to_np(cw["cross_kv"][k]), **TOL)
        before = {k: v.clone() for k, v in cache["cross_kv"].items()}
        for _ in range(2):
            tok = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 1)))
            _, cache = lm.decode_step(tok, cache, pos)
            pos = pos + 1
        for k, v in before.items():
            assert torch.equal(cache["cross_kv"][k], v)
    assert lm.cache_axes()["cross_kv"]["k"].index("batch") == 1


def test_the_encoder_needs_its_frames():
    _, _, lm, _ = pair("whisper-large-v3", dtype="float32")
    with torch.no_grad(), pytest.raises(ValueError, match="frame"):
        lm(torch.ones((1, 4), dtype=torch.int64))
