"""The port's attention (``repro_torch.models.layers``: the naive and
chunked cores, GQA forward and decode, MLA forward and absorbed decode)
against ``repro.models.layers`` in float32 at atol/rtol 1e-5, on the
reference's parameters (biases and the latent norm drawn too, so they
take part) and seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import KEY, both, close, layer_cfgs, seeded
from repro.models import layers as _RL
from repro_torch.models import layers as TL


class RL:
    """The reference's functions, jitted (one compile a shape and config
    rather than one per eager op)."""
    _sdpa_naive = jax.jit(_RL._sdpa_naive, static_argnames=("causal", "scale"))
    _sdpa_chunked = jax.jit(_RL._sdpa_chunked,
                            static_argnames=("causal", "scale", "chunk"))
    attention_fwd = jax.jit(_RL.attention_fwd, static_argnums=(1,),
                            static_argnames=("causal", "return_kv"))
    attention_decode = jax.jit(_RL.attention_decode, static_argnums=(1,))
    mla_fwd = jax.jit(_RL.mla_fwd, static_argnums=(1,),
                      static_argnames=("causal", "return_kv"))
    mla_decode = jax.jit(_RL.mla_decode, static_argnums=(1,))
    attention_init = _RL.attention_init
    mla_init = _RL.mla_init


# --------------------------------------------------------------------------
# Attention cores
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl,chunk", [("naive", None), ("chunked", 5),
                                        ("chunked", 13), ("chunked", 64)])
@pytest.mark.parametrize("dv", [16, 24])
def test_sdpa(impl, chunk, causal, dv):
    """GQA (4 query heads on 2 KV heads), 13 keys: chunk 5 leaves a
    remainder of 3 after the scan, 13 and 64 give one chunk; dv differs
    from d as in MLA."""
    rng = np.random.default_rng(2)
    qj, qt = seeded(rng, 2, 13, 4, 16)
    kj, kt = seeded(rng, 2, 13, 2, 16)
    vj, vt = seeded(rng, 2, 13, 2, dv)
    if impl == "naive":
        want = RL._sdpa_naive(qj, kj, vj, causal=causal, scale=0.25)
        got = TL._sdpa_naive(qt, kt, vt, causal=causal, scale=0.25)
    else:
        want = RL._sdpa_chunked(qj, kj, vj, causal=causal, scale=0.25,
                                chunk=chunk)
        got = TL._sdpa_chunked(qt, kt, vt, causal=causal, scale=0.25,
                               chunk=chunk)
    close(got, want)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attention_fwd_with_bias_and_kv(impl):
    rcfg, tcfg = layer_cfgs("qwen2.5-14b", attn_impl=impl, attn_chunk=5)
    rng = np.random.default_rng(3)
    pj, pt = both(RL.attention_init(KEY, rcfg), rng,
                   random=("bq", "bk", "bv"))
    xj, xt = seeded(rng, 2, 11, rcfg.d_model)
    pos = np.arange(11)[None, :]
    yw, (kw, vw) = RL.attention_fwd(pj, rcfg, xj, jnp.asarray(pos),
                                    return_kv=True)
    yg, (kg, vg) = TL.attention_fwd(pt, tcfg, xt, torch.from_numpy(pos),
                                    return_kv=True)
    close(yg, yw)
    close(kg, kw)
    close(vg, vw)


DECODE_POS = {
    "first": [0, 0, 0],
    "mid-cache": [3, 5, 1],
    "last-row": [7, 7, 7],
    "past-the-cache": [8, 8, 8],     # the write clamps to row 7
    "mixed": [0, 4, 8],
}


@pytest.mark.parametrize("case", list(DECODE_POS))
def test_attention_decode(case):
    rcfg, tcfg = layer_cfgs("qwen2.5-14b")
    rng = np.random.default_rng(4)
    pj, pt = both(RL.attention_init(KEY, rcfg), rng,
                   random=("bq", "bk", "bv"))
    b, max_len, kv, hd = 3, 8, rcfg.n_kv_heads, rcfg.resolved_head_dim
    xj, xt = seeded(rng, b, 1, rcfg.d_model)
    cj, ct = both({"k": rng.standard_normal((b, max_len, kv, hd)),
                    "v": rng.standard_normal((b, max_len, kv, hd))})
    pos = np.array(DECODE_POS[case], np.int32)
    yw, cw = RL.attention_decode(pj, rcfg, xj, cj, jnp.asarray(pos))
    yg, cg = TL.attention_decode(pt, tcfg, xt, ct, torch.from_numpy(pos))
    close(yg, yw)
    for name in ("k", "v"):
        close(cg[name], cw[name])
        assert cg[name] is ct[name]           # written in place


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_mla_fwd(impl):
    rcfg, tcfg = layer_cfgs("deepseek-v2-lite-16b", attn_impl=impl, attn_chunk=4)
    rng = np.random.default_rng(5)
    pj, pt = both(RL.mla_init(KEY, rcfg), rng, random=("kv_norm",))
    xj, xt = seeded(rng, 2, 10, rcfg.d_model)
    pos = np.arange(10)[None, :]
    yw, (cw, rw) = RL.mla_fwd(pj, rcfg, xj, jnp.asarray(pos), return_kv=True)
    yg, (cg, rg) = TL.mla_fwd(pt, tcfg, xt, torch.from_numpy(pos),
                              return_kv=True)
    close(yg, yw)
    close(cg, cw)
    close(rg, rw)


@pytest.mark.parametrize("case", list(DECODE_POS))
def test_mla_decode(case):
    rcfg, tcfg = layer_cfgs("deepseek-v2-lite-16b")
    rng = np.random.default_rng(6)
    pj, pt = both(RL.mla_init(KEY, rcfg), rng, random=("kv_norm",))
    b, max_len = 3, 8
    xj, xt = seeded(rng, b, 1, rcfg.d_model)
    cj, ct = both({
        "c_kv": rng.standard_normal((b, max_len, rcfg.kv_lora_rank)),
        "k_rope": rng.standard_normal((b, max_len, rcfg.rope_head_dim))})
    pos = np.array(DECODE_POS[case], np.int32)
    yw, cw = RL.mla_decode(pj, rcfg, xj, cj, jnp.asarray(pos))
    yg, cg = TL.mla_decode(pt, tcfg, xt, ct, torch.from_numpy(pos))
    close(yg, yw)
    for name in ("c_kv", "k_rope"):
        close(cg[name], cw[name])


