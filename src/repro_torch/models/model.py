"""The language model: the ``dense``, ``moe`` and ``vlm`` families.

The port of ``repro.models.model.LM`` as an ``nn.Module``:

- ``dense`` — [attn + MLP] x L decoder (qwen2.5, phi4-mini, nemotron-4,
  granite; granite is MQA via n_kv_heads=1, nemotron uses squared-ReLU).
- ``moe``   — [attn|MLA + fine-grained MoE] x L (deepseek-moe,
  deepseek-v2-lite).
- ``vlm``   — PaliGemma: (stub) patch embeddings prepended to the token
  embeddings, Gemma-style decoder.

The ``ssm``, ``hybrid`` and ``audio`` families raise
``NotImplementedError``: they wait for ROADMAP.md's "LM stack, 1b".

Parameter names mirror the reference's pytree (``embed``, ``head``,
``ln_f.scale``, ``layers.{i}.attn.wq``, ``layers.{i}.mixer.router``, ...)
in its shapes and in float32; where the reference stacks the layers on a
leading axis for ``lax.scan``, the port keeps an ``nn.ModuleList`` and
loops over it (``convert.py`` splits and joins that axis).  The KV cache
keeps the reference's stacked layout ({"attn": {"k", "v"}: [L, B, S, KV,
hd]}, MLA {"c_kv", "k_rope"}) as a dict of tensors on the LM's device;
``prefill`` and ``decode_step`` write it in place and return it.

The reference's sharding hints and ``jax.checkpoint`` change nothing in
a forward pass and have no counterpart; ``cfg.remat`` has no effect.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.device import resolve_device

from . import layers as L
from . import moe as M
from .config import ModelConfig

__all__ = ["LM", "FAMILIES", "NOT_PORTED_FAMILIES"]

FAMILIES = ("dense", "moe", "vlm")
NOT_PORTED_FAMILIES = ("ssm", "hybrid", "audio")


def _flat(spec: dict, prefix: str = "") -> dict[str, L.Init]:
    out = {}
    for name, s in spec.items():
        if isinstance(s, dict):
            out.update(_flat(s, f"{prefix}{name}."))
        else:
            out[prefix + name] = s
    return out


def param_spec(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as nested dicts of :class:`Init`,
    layers as ``{"layers": [layer, ...]}``, in the reference's order."""
    if cfg.family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: it waits for "
            "ROADMAP.md's \"LM stack, 1b\"")
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    d, v = cfg.d_model, cfg.vocab
    spec: dict = {"embed": L.Init((v, d), "normal", d ** -0.5),
                  "ln_f": L.rms_norm_init(d)}
    if not cfg.tie_embeddings:
        spec["head"] = L.Init((d, v), "normal", d ** -0.5)

    def layer():
        return {
            "ln1": L.rms_norm_init(d),
            "attn": L.mla_init(cfg) if cfg.kv_lora_rank else L.attention_init(cfg),
            "ln2": L.rms_norm_init(d),
            "mixer": M.moe_init(cfg) if cfg.is_moe else L.mlp_init(cfg),
        }
    spec["layers"] = [layer() for _ in range(cfg.n_layers)]
    return spec


def flat_spec(cfg: ModelConfig) -> dict[str, L.Init]:
    """``param_spec`` flattened to the module's parameter names."""
    spec = param_spec(cfg)
    layers = spec.pop("layers")
    out = _flat(spec)
    for i, lp in enumerate(layers):
        out.update(_flat(lp, f"layers.{i}."))
    return out


class LM(L.ParamTree):
    """``LM(cfg, device="cuda")`` allocates the parameters (uninitialized)
    on the device, which must exist: ``device="cpu"`` is asked for by
    name.  ``init(generator)`` draws them."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        spec = param_spec(cfg)
        layers = spec.pop("layers")
        super().__init__(spec, dev)
        self.cfg = cfg
        self.layers = nn.ModuleList(L.ParamTree(lp, dev) for lp in layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return L.compute_dtype(self.cfg)

    # ------------------------------------------------------------------
    # init / configs sharing one parameter set
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "LM":
        """Draw every parameter in place, in the module's parameter order,
        from ``generator`` (on the parameters' device)."""
        spec = flat_spec(self.cfg)
        for name, p in self.named_parameters():
            spec[name].fill_(p, generator)
        return self

    def with_config(self, cfg: ModelConfig) -> "LM":
        """The same parameters (shared, not copied) under another config
        that gives them the same shapes: another compute dtype, attention
        or MoE capacity."""
        mine = {n: s.shape for n, s in flat_spec(self.cfg).items()}
        theirs = {n: s.shape for n, s in flat_spec(cfg).items()}
        if mine != theirs:
            raise ValueError(f"{cfg.name}'s parameters differ in shape "
                             f"from {self.cfg.name}'s")
        other = copy.copy(self)
        other.cfg = cfg
        return other

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _tf_layer_fwd(self, p, x, positions, aux, *, causal=True,
                      return_kv=False):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn = L.mla_fwd if cfg.kv_lora_rank else L.attention_fwd
        y = attn(p["attn"], cfg, h, positions, causal=causal,
                 return_kv=return_kv)
        kv = None
        if return_kv:
            y, kv = y
        x = x + y
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y, a = M.moe_fwd(p["mixer"], cfg, h)
            x = x + y
            aux = aux + a
        else:
            x = x + L.mlp_fwd(p["mixer"], cfg, h)
        return x, aux, kv

    def _decode_tf_layer(self, p, x, cache, pos):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn = L.mla_decode if cfg.kv_lora_rank else L.attention_decode
        y, new_cache = attn(p["attn"], cfg, h, cache, pos)
        x = x + y
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y, _ = M.moe_fwd(p["mixer"], cfg, h)
            x = x + y
        else:
            x = x + L.mlp_fwd(p["mixer"], cfg, h)
        return x, new_cache

    def _embed(self, tokens):
        # a gather, then the cast: the reference's cast, then the gather
        return self.embed[tokens].to(self.dtype)

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def _unembed(self, x):
        x = L.rms_norm(x, self.ln_f, self.cfg.norm_eps)
        return x @ self._head().to(x.dtype)

    def _prefix(self, x, extra_embed):
        if self.cfg.family == "vlm" and extra_embed is not None:
            x = torch.cat([extra_embed.to(x.dtype), x], dim=1)
        return x

    # ------------------------------------------------------------------
    # forward (teacher forcing)
    # ------------------------------------------------------------------
    def forward(self, tokens, *, extra_embed=None, return_hidden: bool = False):
        """(logits [B, S, V], aux) for a full sequence.

        ``extra_embed``: [B, T, d] VLM patch embeddings, prepended (their
        positions come first; their logits are cut off).
        ``return_hidden``: post-final-norm hidden states instead of logits.
        """
        x = self._prefix(self._embed(tokens), extra_embed)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in self.layers:
            x, aux, _ = self._tf_layer_fwd(lp, x, positions, aux)
        if self.cfg.family == "vlm" and extra_embed is not None:
            x = x[:, extra_embed.shape[1]:]
        if return_hidden:
            return L.rms_norm(x, self.ln_f, self.cfg.norm_eps), aux
        return self._unembed(x), aux

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over labels >= 0, plus aux.  The
        unembedding runs in chunks of 8192 tokens; as in the reference,
        tokens past the last whole chunk add nothing to the sum while the
        denominator counts every label >= 0."""
        labels = batch["labels"]
        x, aux = self.forward(batch["tokens"],
                              extra_embed=batch.get("extra_embed"),
                              return_hidden=True)
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        lf = labels.reshape(b * s)
        chunk = min(8192, b * s)
        n_chunks = max(1, (b * s) // chunk)
        w = self._head()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            xc, lc = xf[c * chunk:(c + 1) * chunk], lf[c * chunk:(c + 1) * chunk]
            logits = (xc @ w.to(xc.dtype)).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                torch.clamp(lc, min=0)[:, None].long())[:, 0]
            mask = (lc >= 0).to(torch.float32)
            total = total + torch.sum((lse - gold) * mask)
        denom = torch.clamp((lf >= 0).sum(), min=1).to(torch.float32)
        return total / denom + aux

    # ------------------------------------------------------------------
    # KV caches, prefill and single-token decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        cfg = self.cfg
        dt = getattr(torch, dtype) if isinstance(dtype, str) else (
            dtype or self.dtype)
        n = cfg.n_layers

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        if cfg.kv_lora_rank:
            return {"attn": {
                "c_kv": zeros(n, batch, max_len, cfg.kv_lora_rank),
                "k_rope": zeros(n, batch, max_len, cfg.rope_head_dim)}}
        shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"attn": {"k": zeros(*shape), "v": zeros(*shape)}}

    def cache_axes(self) -> dict:
        """Logical axes mirroring :meth:`init_cache`'s structure."""
        if self.cfg.kv_lora_rank:
            return {"attn": {"c_kv": (None, "batch", "cache_len", None),
                             "k_rope": (None, "batch", "cache_len", None)}}
        kv = (None, "batch", "cache_len", "kv_heads", None)
        return {"attn": {"k": kv, "v": kv}}

    def prefill(self, tokens, cache, *, extra_embed=None, prompt_len=None):
        """tokens: [B, S] -> (last_logits [B, 1, V], cache, next_pos [B]).

        Writes every position's K/V (padding included) at offset 0 of the
        cache.  ``prompt_len``: [B] valid prompt lengths when right-padded
        to a bucket; the causal mask keeps padded keys out of the valid
        queries, and the last valid position's logits are returned.
        ``next_pos`` counts the VLM prefix.
        """
        x = self._prefix(self._embed(tokens), extra_embed)
        s = x.shape[1]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        positions = torch.arange(s, device=x.device)[None, :]
        if prompt_len is None:
            next_pos = torch.full((x.shape[0],), s, dtype=torch.int32,
                                  device=x.device)
        else:
            offset = s - tokens.shape[1]          # vlm prefix tokens
            next_pos = prompt_len.to(torch.int32) + offset

        attn = cache["attn"]
        names = ("c_kv", "k_rope") if self.cfg.kv_lora_rank else ("k", "v")
        for i, lp in enumerate(self.layers):
            x, aux, kv = self._tf_layer_fwd(lp, x, positions, aux,
                                            return_kv=True)
            for name, new in zip(names, kv):
                attn[name][i, :, :s] = new.to(attn[name].dtype)

        if prompt_len is None:
            x_last = x[:, -1:, :]
        else:
            at = torch.clamp(next_pos.to(torch.int64) - 1, 0, s - 1)
            x_last = x[torch.arange(x.shape[0], device=x.device), at][:, None]
        return self._unembed(x_last), cache, next_pos

    def decode_step(self, tokens, cache, pos):
        """tokens: [B, 1]; pos: [B] write positions -> (logits [B, 1, V],
        cache)."""
        x = self._embed(tokens)
        attn = cache["attn"]
        for i, lp in enumerate(self.layers):
            x, _ = self._decode_tf_layer(
                lp, x, {name: buf[i] for name, buf in attn.items()}, pos)
        return self._unembed(x), cache
