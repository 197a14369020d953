"""The port's gradients against ``jax.value_and_grad`` of the reference's
loss for the dense, MoE (MLA) and VLM families, on their smoke configs
in float32: the loss at rtol 1e-5 and every parameter's gradient at rtol
1e-3, atol 1e-6 (float32 sums in other orders, relative to gradients
down to 1e-7). A tied embedding (mamba2) takes its gradient from both
uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import GRAD_TOL, pair, port_lm, to_np, train_batch
from repro_torch.models.convert import split_tree


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-v2-lite-16b",
                                  "paligemma-3b"])
def test_gradients_equal_jax_value_and_grad(arch):
    ref, params, _, _ = pair(arch, dtype="float32")
    lm = port_lm(arch)
    batch = train_batch(lm.cfg, 11)
    loss_w, grad_w = jax.jit(jax.value_and_grad(ref.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lm.requires_grad_(True)
    loss = lm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
    named = dict(lm.named_parameters())
    want = split_tree(jax.tree.map(np.asarray, grad_w), named, lm.cfg)
    for name, p in named.items():
        np.testing.assert_allclose(to_np(p.grad), want[name], **GRAD_TOL,
                                   err_msg=name)
    if lm.cfg.tie_embeddings:      # mamba2: embedding and unembedding
        assert float(lm.embed.grad.abs().max()) > 0


