"""bf16 rounding with depth in the SSM and hybrid families: the port's
bf16 forward against its float32 forward, held to the reference's own
bf16 distance from float32, at a depth where that distance has grown.

With random parameters both packages' bf16 logits move away from float32
as layers are added (mamba2: about 0.013 of the rms at the smoke
config's 2 SSM layers, 0.09-0.10 at 24; zamba2: 0.031 at 7 blocks, 0.086
at 25), so a served bf16 logit at full depth cannot be held to a fixed
fraction of the rms.  These tests pin that the
growth is the model's and not the port's:

- the reference's distance at depth is over twice its distance at the
  smoke config's depth (it reads 6.8-7.1 times for mamba2, 2.7-2.8 for
  zamba2);
- the port's distance is within 10% of the reference's (compiled without
  XLA's excess-precision licence, so that it rounds where the port does);
- the port's bf16 logits lie at most half as far from that reference's as
  that reference lies from float32 (``test_torch_models_vlm.py``'s ratio).

Smoke widths, 64 tokens, parameters from ``KEY`` carried across by
``convert.from_reference``; distances are rms over all logits over the
float32 logits' rms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import KEY
from repro import configs as ref_configs
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.models.convert import from_reference

BF16_STRICT = {"xla_allow_excess_precision": False}
BF16_STRICT_RATIO = 0.5     # test_torch_models_vlm.py's
SAME_GROWTH = 0.1           # the port's distance within 10% of the reference's
GROWTH = 2.0                # depth against the smoke config's depth
# the depth held for each family: 24 SSM layers; 4 groups of 5 SSM
# blocks, each followed by the shared block, and 1 trailing block
DEPTH = {"mamba2-780m": 24, "zamba2-7b": 25}


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


@functools.lru_cache(maxsize=None)
def _models(arch: str, n_layers: int):
    """(reference params, jitted f32 forward, strict bf16 forward, port
    LMs in float32 and bf16) at ``n_layers``."""
    rcfg = ref_configs.get_smoke(arch).replace(n_layers=n_layers)
    ref32 = RefLM(rcfg.replace(dtype="float32"))
    ref16 = RefLM(rcfg.replace(dtype="bfloat16"))
    params = jax.jit(ref32.init)(KEY)
    f32 = jax.jit(lambda p, t: ref32.forward(p, t)[0])
    bf16 = jax.jit(lambda p, t: ref16.forward(p, t)[0])
    tokens = jnp.zeros((2, 64), jnp.int32)
    strict = bf16.lower(params, tokens).compile(compiler_options=BF16_STRICT)
    port32 = from_reference(
        jax.tree.map(np.asarray, params),
        configs.get_smoke(arch).replace(n_layers=n_layers, dtype="float32"),
        device="cpu")
    port16 = port32.with_config(port32.cfg.replace(dtype="bfloat16"))
    return params, f32, strict, port32, port16


def _distances(arch: str, n_layers: int, seed: int) -> dict:
    params, f32, strict, port32, port16 = _models(arch, n_layers)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, port32.cfg.vocab, size=(2, 64)).astype(np.int32)
    r32 = np.asarray(f32(params, tokens))
    r16 = np.asarray(strict(params, tokens).astype(jnp.float32))
    with torch.no_grad():
        t = torch.from_numpy(tokens)
        p32 = port32(t)[0].numpy()
        p16 = port16(t)[0].float().numpy()
    assert port16(t)[0].dtype == torch.bfloat16
    scale = _rms(r32)
    return {"ref": _rms(r16 - r32) / scale, "port": _rms(p16 - p32) / scale,
            "port_vs_ref": _rms(p16 - r16) / scale}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_bf16_distance_grows_with_depth_in_the_reference(arch, seed):
    shallow = _distances(arch, ref_configs.get_smoke(arch).n_layers, seed)
    deep = _distances(arch, DEPTH[arch], seed)
    assert deep["ref"] > GROWTH * shallow["ref"], (shallow, deep)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_port_bf16_distance_at_depth_is_the_references(arch, seed):
    d = _distances(arch, DEPTH[arch], seed)
    assert abs(d["port"] - d["ref"]) <= SAME_GROWTH * d["ref"], d


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", sorted(DEPTH))
def test_port_bf16_rounds_where_the_reference_rounds_at_depth(arch, seed):
    d = _distances(arch, DEPTH[arch], seed)
    assert d["port_vs_ref"] <= BF16_STRICT_RATIO * d["ref"], d
