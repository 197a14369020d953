"""Shared set-up of the LM-stack tests: the reference's smoke LMs, their
parameters carried into the port through ``convert.from_reference``, and
jitted reference entry points cached per configuration (each file runs
in one worker, so the cache lives for one file)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.models.convert import from_reference

# The seven smoke configs of the dense, MoE/MLA and VLM families.
SMOKE_1A = ("qwen2.5-14b", "phi4-mini-3.8b", "nemotron-4-340b",
            "granite-20b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
            "paligemma-3b")
# The three of the SSM, hybrid and audio families.
SMOKE_1B = ("mamba2-780m", "zamba2-7b", "whisper-large-v3")
KEY = jax.random.PRNGKey(0)


@functools.lru_cache(maxsize=None)
def ref_params(arch: str) -> dict:
    """The reference's smoke parameters for ``arch`` (``LM.init`` at
    ``KEY``) as numpy arrays."""
    ref = RefLM(ref_configs.get_smoke(arch))
    return jax.tree.map(np.asarray, jax.jit(ref.init)(KEY))


@functools.lru_cache(maxsize=None)
def pair(arch: str, **changes):
    """(reference LM, its params, port LM on the CPU with the same
    parameters, jitted reference entry points) for ``arch``'s smoke
    config with ``changes``."""
    rcfg = ref_configs.get_smoke(arch).replace(**changes)
    ref = RefLM(rcfg)
    params = jax.tree.map(jnp.asarray, ref_params(arch))
    lm = from_reference(ref_params(arch),
                        configs.get_smoke(arch).replace(**changes),
                        device="cpu")
    jit = {
        "forward": jax.jit(lambda p, t, e: ref.forward(p, t, extra_embed=e)),
        "loss": jax.jit(ref.loss),
        "prefill": jax.jit(lambda p, t, c, e, pl: ref.prefill(
            p, t, c, extra_embed=e, prompt_len=pl)),
        "decode": jax.jit(ref.decode_step),
    }
    return ref, params, lm, jit


def extra_embed(cfg, rng, b: int):
    """Seeded patch embeddings for the VLM, frame embeddings for the audio
    family's encoder, else None."""
    n = {"vlm": cfg.n_img_tokens, "audio": cfg.enc_ctx}.get(cfg.family)
    if n is None:
        return None
    return (0.1 * rng.standard_normal((b, n, cfg.d_model))).astype(np.float32)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t(x) -> torch.Tensor | None:
    return None if x is None else torch.from_numpy(np.asarray(x))


def j(x):
    return None if x is None else jnp.asarray(x)


def assert_tree_close(got: dict, want: dict, **tol) -> None:
    """Nested dicts of port tensors against the reference's arrays."""
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], dict):
            assert_tree_close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(to_np(got[k]), to_np(want[k]),
                                       err_msg=k, **tol)


# --------------------------------------------------------------------------
# Layer-level helpers: the same float32 values on both sides
# --------------------------------------------------------------------------
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)


def layer_cfgs(arch, **changes):
    kw = dict(dtype="float32", **changes)
    return (ref_configs.get_smoke(arch).replace(**kw),
            configs.get_smoke(arch).replace(**kw))


def both(tree, rng=None, random=()):
    """(jax pytree, torch dict) of the same float32 values; the leaves
    named in ``random`` are redrawn from ``rng`` (zero biases, unit norm
    scales would hide their use)."""
    out_j, out_t = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out_j[k], out_t[k] = both(v, rng, random)
            continue
        a = np.asarray(v, np.float32)
        if k in random:
            a = (1.0 + 0.5 * rng.standard_normal(a.shape)).astype(np.float32) \
                if k in ("scale", "kv_norm") else \
                (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        out_j[k], out_t[k] = jnp.asarray(a), torch.from_numpy(a.copy())
    return out_j, out_t


def seeded(rng, *shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(got, want, tol=LAYER_TOL, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, **kw)


# --------------------------------------------------------------------------
# Training helpers
# --------------------------------------------------------------------------
# the port's gradients against jax.value_and_grad's: float32 sums in other
# orders, relative to gradients down to 1e-7
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


def port_lm(arch: str):
    """A fresh float32 port LM (not the cached one of ``pair``: training
    changes it) holding the reference's smoke parameters."""
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    return from_reference(ref_params(arch), cfg, device="cpu")


def train_batch(cfg, seed: int, b: int = 2, s: int = 16) -> dict:
    """A seeded batch of numpy arrays: tokens, their next-token labels and
    the family's extra embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    e = extra_embed(cfg, rng, b)
    if e is not None:
        batch["extra_embed"] = e
    return batch
