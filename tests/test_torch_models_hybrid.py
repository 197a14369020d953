"""The port's LM against ``repro.models.LM`` for the hybrid family
(zamba2-7b's smoke config: one group of 5 SSM blocks, the shared
attention+MLP block, 1 trailing SSM block) in float32: the model cases
of ``_torch_lm_cases`` (forward, loss, both prefills, four decode steps,
every cache at atol/rtol 1e-4), the shared block's one set of weights
and its stacked KV cache, and its gradient summed over its applications
against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import pair, ref_params, to_np
from _torch_lm_cases import (  # noqa: F401  (collected here)
    TOL, test_forward_logits_and_aux,
    test_four_decode_steps_after_a_padded_prefill,
    test_loss_with_ignored_labels, test_prefill_logits_cache_and_next_pos)
from repro_torch import configs
from repro_torch.models.convert import from_reference, split_tree
from repro_torch.models.model import hybrid_layout, param_spec


@pytest.fixture(params=["zamba2-7b"])
def arch(request):
    return request.param


def test_layout_and_the_shared_blocks_cache():
    _, _, lm, _ = pair("zamba2-7b", dtype="float32")
    cfg = lm.cfg
    g, per, trailing = hybrid_layout(cfg)
    assert (g, per, trailing) == (1, 5, 1)
    assert hybrid_layout(configs.get("zamba2-7b")) == (13, 5, 3)
    assert len(lm.ssm_groups) == g and len(lm.ssm_groups[0]) == per
    assert len(lm.ssm_tail) == trailing
    cache = lm.init_cache(3, 20)
    hd = cfg.resolved_head_dim
    assert cache["shared_attn"]["k"].shape == (g, 3, 20, cfg.n_kv_heads, hd)
    assert cache["ssm_groups"]["state"].shape == (
        g, per, 3, cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    assert cache["ssm_groups"]["state"].dtype == torch.float32
    assert cache["ssm_tail"]["conv"].shape == (
        trailing, 3, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    axes = lm.cache_axes()
    for name in ("ssm_groups", "shared_attn", "ssm_tail"):
        for leaf, ax in axes[name].items():
            assert len(ax) == cache[name][leaf].ndim, (name, leaf)
    assert axes["ssm_groups"]["state"].index("batch") == 2


def test_full_config_applies_one_shared_block_thirteen_times():
    cfg = configs.get("zamba2-7b")
    spec = param_spec(cfg)
    assert len(spec["ssm_groups"]) == 13
    assert all(len(gp) == 5 for gp in spec["ssm_groups"])
    assert len(spec["ssm_tail"]) == 3
    assert isinstance(spec["shared_attn"], dict)   # one set, not a stack


def test_shared_block_gradient_sums_over_its_applications():
    """The port's gradient of every parameter against ``jax.grad`` of the
    reference's loss, in float32: the shared block's (applied after each
    group) included."""
    ref, params, _, jit = pair("zamba2-7b", dtype="float32")
    cfg = configs.get_smoke("zamba2-7b").replace(dtype="float32")
    lm = from_reference(ref_params("zamba2-7b"), cfg, device="cpu")
    lm.requires_grad_(True)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    want = jax.jit(jax.grad(ref.loss))(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss = lm.loss({"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(labels)})
    loss.backward()
    named = dict(lm.named_parameters())
    want = split_tree(jax.tree.map(np.asarray, want), named, cfg)
    for name, p in named.items():
        np.testing.assert_allclose(to_np(p.grad), want[name], rtol=1e-3,
                                   atol=1e-6, err_msg=name)
    assert float(lm.shared_attn.attn.wq.grad.abs().max()) > 0
