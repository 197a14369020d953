"""The reference's model-level invariants (``tests/test_models.py``), held
on the port's own LM and init: prefill plus step-by-step decode equals
the full forward, right-padding a prompt to a bucket changes nothing,
chunked attention equals naive, and the MoE balance loss rises when the
router collapses."""

import numpy as np
import pytest
import torch

from _torch_lm import SMOKE_1A
from repro_torch import configs
from repro_torch.models import LM
from repro_torch.models import moe as M


def _lm(arch: str, **changes) -> LM:
    cfg = configs.get_smoke(arch).replace(**changes)
    return LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def _extra(cfg, b: int):
    if cfg.family != "vlm":
        return None
    g = torch.Generator().manual_seed(1)
    return 0.1 * torch.randn(b, cfg.n_img_tokens, cfg.d_model, generator=g)


@pytest.mark.parametrize("arch", SMOKE_1A)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@torch.no_grad()
def test_prefill_decode_matches_forward(arch, impl):
    lm = _lm(arch, attn_impl=impl, attn_chunk=5, dtype="float32",
             moe_capacity_factor=64.0)   # dropless so decode == forward
    b, s, t0 = 2, 12, 8
    tokens = torch.randint(1, lm.cfg.vocab, (b, s),
                           generator=torch.Generator().manual_seed(7))
    extra = _extra(lm.cfg, b)
    full, _ = lm(tokens, extra_embed=extra)

    cache = lm.init_cache(b, 32, dtype="float32")
    lg, cache, pos = lm.prefill(tokens[:, :t0], cache, extra_embed=extra)
    errs = [float((lg[:, 0] - full[:, t0 - 1]).abs().max())]
    for t in range(t0, s):
        lg, cache = lm.decode_step(tokens[:, t:t + 1], cache, pos)
        pos = pos + 1
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, (arch, errs)


@pytest.mark.parametrize("arch", SMOKE_1A)
@torch.no_grad()
def test_prefill_right_padding_equivalent(arch):
    """A right-padded prompt with ``prompt_len`` gives the exact prompt's
    logits, next position and valid cache rows."""
    lm = _lm(arch, dtype="float32", moe_capacity_factor=64.0)
    tokens = torch.randint(1, lm.cfg.vocab, (1, 10),
                           generator=torch.Generator().manual_seed(3))
    extra = _extra(lm.cfg, 1)
    lg_exact, c_exact, pos_exact = lm.prefill(
        tokens, lm.init_cache(1, 32), extra_embed=extra)
    padded = torch.nn.functional.pad(tokens, (0, 6))
    lg_pad, c_pad, pos = lm.prefill(padded, lm.init_cache(1, 32),
                                    extra_embed=extra,
                                    prompt_len=torch.tensor([10]))
    assert int(pos[0]) == int(pos_exact[0]) == 10 + (
        lm.cfg.n_img_tokens if lm.cfg.family == "vlm" else 0)
    np.testing.assert_allclose(lg_pad, lg_exact, atol=1e-4, rtol=1e-4)
    n = int(pos[0])
    for name, buf in c_exact["attn"].items():
        np.testing.assert_allclose(c_pad["attn"][name][:, :, :n],
                                   buf[:, :, :n], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b"])
@torch.no_grad()
def test_chunked_attention_equals_naive(arch):
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    lm = LM(cfg.replace(attn_impl="naive"), device="cpu").init(
        torch.Generator().manual_seed(0))
    chunked = lm.with_config(cfg.replace(attn_impl="chunked", attn_chunk=16))
    tokens = torch.randint(0, cfg.vocab, (2, 48),
                           generator=torch.Generator().manual_seed(0))
    a, _ = lm(tokens)
    b, _ = chunked(tokens)
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@torch.no_grad()
def test_moe_balance_loss_signal():
    """Uniform router -> aux ~ coef; collapsed router -> aux >> coef."""
    lm = _lm("deepseek-moe-16b")
    cfg = lm.cfg
    mixer = lm.layers[0].mixer
    p = {k: mixer[k] for k in ("router", "w_gate", "w_up", "w_down", "shared")}
    g = torch.Generator().manual_seed(0)
    x = (0.1 * torch.randn(4, 16, cfg.d_model, generator=g)).abs().to(
        torch.bfloat16)
    _, aux_uniform = M.moe_fwd(p, cfg, x)
    bad_router = torch.full_like(p["router"], -0.1)
    bad_router[:, 0] = 0.5
    _, aux_collapsed = M.moe_fwd(dict(p, router=bad_router), cfg, x)
    assert float(aux_collapsed) > 2.0 * float(aux_uniform)
