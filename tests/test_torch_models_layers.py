"""The port's norms, RoPE, MLPs and MoE (``repro_torch.models.layers``
and ``.moe``) against the reference's (``repro.models.layers`` and
``.moe``) in float32 at atol/rtol 1e-5, on the reference's parameters
(norm scales drawn too, so they take part) and seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import KEY, both, close, layer_cfgs, seeded
from repro.models import layers as _RL
from repro.models import moe as _RM
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM


class RL:
    """The reference's functions, jitted (one compile a shape and config
    rather than one per eager op)."""
    rms_norm = jax.jit(_RL.rms_norm, static_argnums=(2,))
    apply_rope = jax.jit(_RL.apply_rope, static_argnums=(2,))
    mlp_fwd = jax.jit(_RL.mlp_fwd, static_argnums=(1,))
    mlp_init = _RL.mlp_init


class RM:
    moe_fwd = jax.jit(_RM.moe_fwd, static_argnums=(1,))
    moe_init = _RM.moe_init
    CAPACITY_FACTOR = _RM.CAPACITY_FACTOR


# --------------------------------------------------------------------------
# RMSNorm, RoPE
# --------------------------------------------------------------------------
def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = seeded(rng, 2, 5, 64, scale=3.0)
    pj, pt = both({"scale": np.ones(64)}, rng, random=("scale",))
    close(TL.rms_norm(xt, pt, 1e-6), RL.rms_norm(xj, pj, 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("form", ["sequence", "decode"])
def test_apply_rope(theta, form):
    rng = np.random.default_rng(1)
    xj, xt = seeded(rng, 3, 7 if form == "sequence" else 1, 4, 16)
    if form == "sequence":
        pos = np.arange(7)[None, :]
    else:
        pos = np.array([0, 517, 4093])[:, None]
    close(TL.apply_rope(xt, torch.from_numpy(pos), theta),
          RL.apply_rope(xj, jnp.asarray(pos, jnp.int32), theta))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp(kind):
    rcfg, tcfg = layer_cfgs("qwen2.5-14b", mlp_kind=kind)
    rng = np.random.default_rng(7)
    pj, pt = both(RL.mlp_init(KEY, rcfg))
    xj, xt = seeded(rng, 2, 9, rcfg.d_model, scale=2.0)
    close(TL.mlp_fwd(pt, tcfg, xt), RL.mlp_fwd(pj, rcfg, xj))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
MOE_CASES = {
    "dropless": dict(moe_capacity_factor=64.0),
    "default-capacity": dict(),
    "tight-capacity": dict(moe_capacity_factor=0.5),
}


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_fwd(arch, case):
    rcfg, tcfg = layer_cfgs(arch, **MOE_CASES[case])
    rng = np.random.default_rng(8)
    pj, pt = both(RM.moe_init(KEY, rcfg))
    xj, xt = seeded(rng, 2, 16, rcfg.d_model)
    yw, aw = RM.moe_fwd(pj, rcfg, xj)
    yg, ag = TM.moe_fwd(pt, tcfg, xt)
    close(yg, yw)
    close(ag, aw)
    _, _, idx = TM.route(pt, tcfg, xt.reshape(-1, rcfg.d_model))
    counts = np.bincount(idx.numpy().ravel(), minlength=rcfg.n_routed_experts)
    cap = max(1, int((rcfg.moe_capacity_factor or RM.CAPACITY_FACTOR)
                     * 32 * rcfg.top_k / rcfg.n_routed_experts))
    assert (counts.max() > cap) == (case != "dropless")   # drops happen


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_routing_indices_equal_top_k(arch):
    rcfg, tcfg = layer_cfgs(arch)
    rng = np.random.default_rng(9)
    pj, pt = both(RM.moe_init(KEY, rcfg))
    xj, xt = seeded(rng, 64, rcfg.d_model)
    probs = jax.nn.softmax(xj @ pj["router"], axis=-1)
    gate_w, idx_w = jax.lax.top_k(probs, rcfg.top_k)
    _, gate, idx = TM.route(pt, tcfg, xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    close(gate, gate_w / gate_w.sum(-1, keepdims=True))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_moe_zero_router_breaks_ties_to_the_lower_index(arch):
    """A zero router gives every expert the same probability: top-k must
    pick experts 0..k-1 for every token, as ``lax.top_k`` does, and so
    overflow their capacity."""
    rcfg, tcfg = layer_cfgs(arch)
    rng = np.random.default_rng(10)
    tree = jax.tree.map(np.asarray, RM.moe_init(KEY, rcfg))
    tree["router"] = np.zeros_like(tree["router"])
    pj, pt = both(tree)
    xj, xt = seeded(rng, 2, 16, rcfg.d_model)
    _, _, idx = TM.route(pt, tcfg, xt.reshape(-1, rcfg.d_model))
    want = np.broadcast_to(np.arange(rcfg.top_k), idx.shape)
    np.testing.assert_array_equal(idx.numpy(), want)
    yw, aw = RM.moe_fwd(pj, rcfg, xj)
    yg, ag = TM.moe_fwd(pt, tcfg, xt)
    close(yg, yw)
    close(ag, aw)
