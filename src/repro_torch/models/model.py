"""The language model: every family of the reference's ``LM``.

The port of ``repro.models.model.LM`` as an ``nn.Module``:

- ``dense``  — [attn + MLP] x L decoder (qwen2.5, phi4-mini, nemotron-4,
  granite; granite is MQA via n_kv_heads=1, nemotron uses squared-ReLU).
- ``moe``    — [attn|MLA + fine-grained MoE] x L (deepseek-moe,
  deepseek-v2-lite).
- ``ssm``    — [Mamba2/SSD] x L, attention-free (mamba2-780m).
- ``hybrid`` — Zamba2: groups of SSM blocks with ONE shared attention+MLP
  block applied after each group (one set of weights, applied g times;
  autograd sums its gradient over every application).
- ``audio``  — Whisper enc-dec: non-causal encoder over (stub) frame
  embeddings; decoder with self- and cross-attention.
- ``vlm``    — PaliGemma: (stub) patch embeddings prepended to the token
  embeddings, Gemma-style decoder.

Parameter names mirror the reference's pytree (``embed``, ``head``,
``ln_f.scale``, ``layers.{i}.attn.wq``, ``ssm_groups.{g}.{i}.ssm.w_in``,
``shared_attn.attn.wq``, ``enc_layers.{i}.mixer.w_up``, ...) in its shapes
and in float32; where the reference stacks layers on a leading axis for
``lax.scan`` (twice for ``ssm_groups``), the port keeps an
``nn.ModuleList`` (of ``ModuleList``) and loops over it (``convert.py``
splits and joins those axes).  The caches keep the reference's stacked
layout ({"attn": {"k", "v"}: [L, B, S, KV, hd]}, MLA {"c_kv", "k_rope"},
{"ssm": {"state": [L, B, H, N, P] f32, "conv": [L, B, K-1, C]}}, the
hybrid's ``ssm_groups`` [g, per, B, ...], ``shared_attn`` [g, B, S, KV,
hd] and ``ssm_tail``, the audio family's ``cross_kv``) as dicts of tensors
on the LM's device; ``prefill`` and ``decode_step`` write them in place
and return them.

Under autograd, ``cfg.remat`` rematerializes each layer body (each group
of the hybrid, each encoder layer) with ``torch.utils.checkpoint`` where
the reference wraps its scan bodies in ``jax.checkpoint``; the SSD chunk,
the attention chunk and the loss chunk are always rematerialized, as in
the reference.  Remat changes the memory a backward pass holds, not the
values.

``axes()`` gives every parameter's logical axes in the module's own tree
(per-layer lists, the reference's leading stack axes dropped), and the
reference's sharding hints stand at its sites as
``repro_torch.models.sharding.constrain`` calls: with parameters and
inputs placed as DTensors under ``sharding.activate(mesh, rules)`` (the
launch layer's cells) they redistribute the residual stream, the prefill
K/V and the embedding; on plain tensors they return their input.
"""

from __future__ import annotations

import copy

import torch

from repro_torch.device import resolve_device

from . import layers as L
from . import moe as M
from . import ssm as S
from .config import ModelConfig
from .shard_ops import (copy_into, logsumexp_last, row_chunks, take_last,
                        take_rows, write_block)
from .sharding import constrain

__all__ = ["LM", "FAMILIES", "axes_spec"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
_DECODERS = ("dense", "moe", "vlm")


def _flat(spec, prefix: str = "") -> dict[str, L.Init]:
    out = {}
    items = enumerate(spec) if isinstance(spec, list) else spec.items()
    for name, s in items:
        if isinstance(s, (dict, list)):
            out.update(_flat(s, f"{prefix}{name}."))
        else:
            out[prefix + str(name)] = s
    return out


def _residual(x, y):
    """``x + y`` with the block output ``y`` laid out as the residual
    stream first (sequence-sharded: the reduce-scatter after a block's
    output projection; no-op off a mesh)."""
    return x + constrain(y, "batch", "seq_residual", None)


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, ssm_per_group, trailing_ssm) of the hybrid family."""
    g = cfg.n_layers // cfg.attn_every
    per = cfg.attn_every - 1
    trailing = cfg.n_layers - g * cfg.attn_every
    return g, per, trailing


def param_spec(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as nested dicts of :class:`Init`,
    stacks of layers as lists (of lists for ``ssm_groups``), in the
    module's registration order."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    d, v = cfg.d_model, cfg.vocab
    spec: dict = {"embed": L.Init((v, d), "normal", d ** -0.5),
                  "ln_f": L.rms_norm_init(d)}
    if not cfg.tie_embeddings:
        spec["head"] = L.Init((d, v), "normal", d ** -0.5)

    def tf_layer(cross: bool = False):
        p = {
            "ln1": L.rms_norm_init(d),
            "attn": L.mla_init(cfg) if cfg.kv_lora_rank else L.attention_init(cfg),
            "ln2": L.rms_norm_init(d),
            "mixer": M.moe_init(cfg) if cfg.is_moe else L.mlp_init(cfg),
        }
        if cross:
            p["ln_x"] = L.rms_norm_init(d)
            p["xattn"] = L.attention_init(cfg)
        return p

    def ssm_layer():
        return {"ln": L.rms_norm_init(d), "ssm": S.ssm_init(cfg)}

    if cfg.family in _DECODERS:
        spec["layers"] = [tf_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        spec["layers"] = [ssm_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        g, per, trailing = hybrid_layout(cfg)
        spec["ssm_groups"] = [[ssm_layer() for _ in range(per)]
                              for _ in range(g)]
        spec["shared_attn"] = tf_layer()
        if trailing:
            spec["ssm_tail"] = [ssm_layer() for _ in range(trailing)]
    else:                                              # audio
        spec["enc_layers"] = [tf_layer() for _ in range(cfg.n_enc_layers)]
        spec["enc_ln_f"] = L.rms_norm_init(d)
        spec["layers"] = [tf_layer(cross=True) for _ in range(cfg.n_layers)]
    return spec


def axes_spec(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`param_spec`'s tree, leaf for leaf (the
    reference's ``LM.axes()`` without its leading ``"layers"`` stack
    axes)."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    spec: dict = {"embed": ("vocab", "fsdp"), "ln_f": L.rms_norm_axes()}
    if not cfg.tie_embeddings:
        spec["head"] = ("fsdp", "vocab")

    def tf_layer(cross: bool = False):
        p = {
            "ln1": L.rms_norm_axes(),
            "attn": L.mla_axes(cfg) if cfg.kv_lora_rank else L.attention_axes(cfg),
            "ln2": L.rms_norm_axes(),
            "mixer": M.moe_axes(cfg) if cfg.is_moe else L.mlp_axes(cfg),
        }
        if cross:
            p["ln_x"] = L.rms_norm_axes()
            p["xattn"] = L.attention_axes(cfg)
        return p

    def ssm_layer():
        return {"ln": L.rms_norm_axes(), "ssm": S.ssm_axes(cfg)}

    if cfg.family in _DECODERS:
        spec["layers"] = [tf_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm":
        spec["layers"] = [ssm_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        g, per, trailing = hybrid_layout(cfg)
        spec["ssm_groups"] = [[ssm_layer() for _ in range(per)]
                              for _ in range(g)]
        spec["shared_attn"] = tf_layer()
        if trailing:
            spec["ssm_tail"] = [ssm_layer() for _ in range(trailing)]
    else:                                              # audio
        spec["enc_layers"] = [tf_layer() for _ in range(cfg.n_enc_layers)]
        spec["enc_ln_f"] = L.rms_norm_axes()
        spec["layers"] = [tf_layer(cross=True) for _ in range(cfg.n_layers)]
    return spec


def flat_spec(cfg: ModelConfig) -> dict[str, L.Init]:
    """``param_spec`` flattened to the module's parameter names."""
    return _flat(param_spec(cfg))


class LM(L.ParamTree):
    """``LM(cfg, device="cuda")`` allocates the parameters (uninitialized)
    on the device, which must exist: ``device="cpu"`` is asked for by
    name.  ``init(generator)`` draws them."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        super().__init__(param_spec(cfg), dev)
        self.cfg = cfg

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
        with torch.no_grad():
            for name, p in self.named_parameters():
                spec[name].fill_(p, generator)
        return self

    def axes(self) -> dict:
        """Logical axes mirroring the parameter tree (:func:`axes_spec`)."""
        return axes_spec(self.cfg)

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
    def _maybe_remat(self, fn, *args):
        return L.remat(fn, *args) if self.cfg.remat else fn(*args)

    def _tf_layer_fwd(self, p, x, positions, aux, *, causal=True,
                      cross_kv=None, return_kv=False):
        cfg = self.cfg
        # Residual stream sequence-sharded between layers (Megatron-SP);
        # no-op when seq is indivisible (decode) or no mesh is active.
        # Gathered along the sequence at each block's entry, each block's
        # output scattered back (_residual).
        x = constrain(x, "batch", "seq_residual", None)
        h = constrain(L.rms_norm(x, p["ln1"], cfg.norm_eps),
                      "batch", "seq", None)
        attn = L.mla_fwd if cfg.kv_lora_rank else L.attention_fwd
        y = attn(p["attn"], cfg, h, positions, causal=causal,
                 return_kv=return_kv)
        kv = None
        if return_kv:
            y, kv = y
            # length-shard the prefill K/V like the (flash-decode-sharded)
            # cache it is written into
            if cfg.kv_lora_rank:
                kv = tuple(constrain(t, "batch", "cache_len", None)
                           for t in kv)
            else:
                kv = tuple(constrain(t, "batch", "cache_len", "kv_heads",
                                     None) for t in kv)
        x = _residual(x, y)
        if cross_kv is not None:
            h = constrain(L.rms_norm(x, p["ln_x"], cfg.norm_eps),
                          "batch", "seq", None)
            x = _residual(x, L.attention_fwd(p["xattn"], cfg, h, positions,
                                             causal=False,
                                             kv_override=cross_kv))
        h = constrain(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                      "batch", "seq", None)
        if cfg.is_moe:
            y, a = M.moe_fwd(p["mixer"], cfg, h)
            x = _residual(x, y)
            aux = aux + a
        else:
            x = _residual(x, L.mlp_fwd(p["mixer"], cfg, h))
        x = constrain(x, "batch", "seq_residual", None)
        return x, aux, kv

    def _decode_tf_layer(self, p, x, cache, pos, cross_kv=None):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        attn = L.mla_decode if cfg.kv_lora_rank else L.attention_decode
        y, new_cache = attn(p["attn"], cfg, h, cache, pos)
        x = x + y
        if cross_kv is not None:
            h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
            x = x + L.attention_fwd(p["xattn"], cfg, h, pos[:, None],
                                    causal=False, kv_override=cross_kv)
        h = constrain(L.rms_norm(x, p["ln2"], cfg.norm_eps),
                      "batch", "seq", None)
        if cfg.is_moe:
            y, _ = M.moe_fwd(p["mixer"], cfg, h)
            x = x + y
        else:
            x = x + L.mlp_fwd(p["mixer"], cfg, h)
        return x, new_cache

    def _ssm_layer_fwd(self, p, x, *, prompt_len=None, return_state=False):
        x = constrain(x, "batch", "seq_residual", None)
        # the scan runs along the whole sequence: gathered at block entry
        h = constrain(L.rms_norm(x, p["ln"], self.cfg.norm_eps),
                      "batch", "seq", None)
        if return_state:
            y, st = S.ssm_fwd(p["ssm"], self.cfg, h, return_state=True,
                              prompt_len=prompt_len)
            return _residual(x, y), st
        return _residual(x, S.ssm_fwd(p["ssm"], self.cfg, h))

    def _decode_ssm_layer(self, p, x, state, conv):
        """One SSM block's decode step; writes its state and conv rows
        back in place."""
        h = L.rms_norm(x, p["ln"], self.cfg.norm_eps)
        y, new = S.ssm_decode(p["ssm"], self.cfg, h,
                              {"state": state, "conv": conv})
        copy_into(state, new["state"])
        copy_into(conv, new["conv"])
        return x + y

    def _cross_kv(self, p, y_enc):
        """The decoder layer's cross-attention K/V over the encoder's
        output (no bias and no RoPE, as in the reference)."""
        dt = y_enc.dtype
        k = L._project(y_enc, p["xattn"]["wk"].to(dt), "kv_heads")
        v = L._project(y_enc, p["xattn"]["wv"].to(dt), "kv_heads")
        return k, v

    def _embed(self, tokens):
        # a gather, then the cast: the reference's cast, then the gather
        return constrain(take_rows(self.embed, tokens).to(self.dtype),
                         "batch", None, None)

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.head

    def _unembed(self, x):
        x = L.rms_norm(x, self.ln_f, self.cfg.norm_eps)
        return x @ self._head().to(x.dtype)

    def _prefix(self, x, extra_embed):
        if self.cfg.family == "vlm" and extra_embed is not None:
            x = torch.cat([extra_embed.to(x.dtype), x], dim=1)
        return x

    def _encoder(self, enc_embed):
        """Whisper encoder over (stub) frame embeddings, non-causal."""
        positions = torch.arange(enc_embed.shape[1],
                                 device=enc_embed.device)[None, :]
        aux = torch.zeros((), dtype=torch.float32, device=enc_embed.device)

        def body(lp, x):
            return self._tf_layer_fwd(lp, x, positions, aux, causal=False)[0]
        x = enc_embed
        for lp in self.enc_layers:
            x = self._maybe_remat(body, lp, x)
        # every decoder layer reads the whole encoder sequence
        return constrain(L.rms_norm(x, self.enc_ln_f, self.cfg.norm_eps),
                         "batch", "seq", None)

    def _frames(self, x, extra_embed):
        if extra_embed is None:
            raise ValueError("the audio family needs frame embeddings "
                             "(extra_embed)")
        return self._encoder(extra_embed.to(x.dtype))

    # ------------------------------------------------------------------
    # forward (teacher forcing)
    # ------------------------------------------------------------------
    def forward(self, tokens, *, extra_embed=None, return_hidden: bool = False):
        """(logits [B, S, V], aux) for a full sequence.

        ``extra_embed``: [B, T, d] VLM patch embeddings (prepended; their
        logits are cut off) or Whisper frame embeddings (the encoder's
        input).
        ``return_hidden``: post-final-norm hidden states instead of logits.
        """
        cfg = self.cfg
        x = self._prefix(self._embed(tokens), extra_embed)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        if cfg.family in _DECODERS:
            def body(lp, h, a):
                return self._tf_layer_fwd(lp, h, positions, a)[:2]
            for lp in self.layers:
                x, aux = self._maybe_remat(body, lp, x, aux)
        elif cfg.family == "ssm":
            for lp in self.layers:
                x = self._maybe_remat(self._ssm_layer_fwd, lp, x)
        elif cfg.family == "hybrid":
            def group(gp, h):
                for lp in gp:
                    h = self._ssm_layer_fwd(lp, h)
                return self._tf_layer_fwd(self.shared_attn, h, positions,
                                          aux)[0]
            for gp in self.ssm_groups:
                x = self._maybe_remat(group, gp, x)
            for lp in getattr(self, "ssm_tail", ()):
                x = self._maybe_remat(self._ssm_layer_fwd, lp, x)
        else:                                          # audio
            y_enc = self._frames(x, extra_embed)

            def body(lp, h, a):
                return self._tf_layer_fwd(lp, h, positions, a,
                                          cross_kv=self._cross_kv(lp, y_enc))[:2]
            for lp in self.layers:
                x, aux = self._maybe_remat(body, lp, x, aux)

        if cfg.family == "vlm" and extra_embed is not None:
            x = x[:, extra_embed.shape[1]:]
        if return_hidden:
            return L.rms_norm(x, self.ln_f, self.cfg.norm_eps), aux
        return self._unembed(x), aux

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy over labels >= 0, plus aux.  The
        unembedding runs in chunks of 8192 tokens, each rematerialized
        under autograd; as in the reference, tokens past the last whole
        chunk add nothing to the sum while the denominator counts every
        label >= 0."""
        labels = batch["labels"]
        x, aux = self.forward(batch["tokens"],
                              extra_embed=batch.get("extra_embed"),
                              return_hidden=True)
        b, s, d = x.shape
        xf = constrain(x, "batch", "seq", None).reshape(b * s, d)
        lf = labels.reshape(b * s)
        chunk = min(8192, b * s)
        n_chunks = max(1, (b * s) // chunk)
        # on a mesh the head is gathered over its FSDP axes once, before
        # the chunks (each chunk's logits stay sharded over the vocab)
        w = constrain(self._head(), None, "vocab")

        def chunk_loss(xc, lc, w):
            logits = (xc @ w.to(xc.dtype)).to(torch.float32)
            lse = logsumexp_last(logits)
            gold = take_last(logits, torch.clamp(lc, min=0).long())
            mask = (lc >= 0).to(torch.float32)
            return torch.sum((lse - gold) * mask)

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for xc, lc in row_chunks(xf, lf, chunk, n_chunks):
            total = total + L.remat(chunk_loss, xc, lc, w)
        denom = torch.clamp((lf >= 0).sum(), min=1).to(torch.float32)
        return total / denom + aux

    # ------------------------------------------------------------------
    # KV / state caches, prefill and single-token decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device=None) -> dict:
        """Zeroed caches on the LM's device (or ``device``: ``meta`` gives
        their shapes and dtypes alone)."""
        cfg = self.cfg
        dt = getattr(torch, dtype) if isinstance(dtype, str) else (
            dtype or self.dtype)
        hd = cfg.resolved_head_dim
        device = self.device if device is None else device

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=device)

        def attn_cache(n: int) -> dict:
            if cfg.kv_lora_rank:
                return {"c_kv": zeros(n, batch, max_len, cfg.kv_lora_rank),
                        "k_rope": zeros(n, batch, max_len, cfg.rope_head_dim)}
            shape = (n, batch, max_len, cfg.n_kv_heads, hd)
            return {"k": zeros(*shape), "v": zeros(*shape)}

        def ssm_cache(*stack: int) -> dict:
            di, n = cfg.d_inner, cfg.ssm_state
            return {
                "state": zeros(*stack, batch, cfg.n_ssm_heads, n,
                               cfg.ssm_head_dim, dtype=torch.float32),
                "conv": zeros(*stack, batch, cfg.ssm_conv - 1, di + 2 * n),
            }

        if cfg.family in _DECODERS:
            return {"attn": attn_cache(cfg.n_layers)}
        if cfg.family == "ssm":
            return {"ssm": ssm_cache(cfg.n_layers)}
        if cfg.family == "hybrid":
            g, per, trailing = hybrid_layout(cfg)
            c = {"ssm_groups": ssm_cache(g, per),
                 "shared_attn": attn_cache(g)}
            if trailing:
                c["ssm_tail"] = ssm_cache(trailing)
            return c
        shape = (cfg.n_layers, batch, cfg.enc_ctx, cfg.n_kv_heads, hd)
        return {"attn": attn_cache(cfg.n_layers),
                "cross_kv": {"k": zeros(*shape), "v": zeros(*shape)}}

    def cache_axes(self) -> dict:
        """Logical axes mirroring :meth:`init_cache`'s structure."""
        cfg = self.cfg
        if cfg.kv_lora_rank:
            attn = {"c_kv": (None, "batch", "cache_len", None),
                    "k_rope": (None, "batch", "cache_len", None)}
        else:
            kv = (None, "batch", "cache_len", "kv_heads", None)
            attn = {"k": kv, "v": kv}

        def ssm_axes(extra: int = 1) -> dict:
            pre = (None,) * extra
            return {"state": pre + ("batch", "ssm_heads", None, None),
                    "conv": pre + ("batch", None, "ssm_inner")}

        if cfg.family in _DECODERS:
            return {"attn": attn}
        if cfg.family == "ssm":
            return {"ssm": ssm_axes()}
        if cfg.family == "hybrid":
            c = {"ssm_groups": ssm_axes(extra=2), "shared_attn": attn}
            if hybrid_layout(cfg)[2]:
                c["ssm_tail"] = ssm_axes()
            return c
        xkv = (None, "batch", None, "kv_heads", None)
        return {"attn": attn, "cross_kv": {"k": xkv, "v": xkv}}

    @staticmethod
    def _write_kv(bufs: dict, at, kv: tuple, s: int) -> None:
        """The prefill's K/V of one attention layer into its cache rows
        [at][:, :s] (offset 0, as the reference's dynamic_update_slice)."""
        for name, new in zip(bufs, kv):
            new = new.to(bufs[name].dtype)
            write_block(bufs[name][at], new)

    @staticmethod
    def _write_state(bufs: dict, at, st: dict) -> None:
        for name in ("state", "conv"):
            new = st[name].to(bufs[name].dtype)
            copy_into(bufs[name][at], new)

    def prefill(self, tokens, cache, *, extra_embed=None, prompt_len=None):
        """tokens: [B, S] -> (last_logits [B, 1, V], cache, next_pos [B]).

        Writes every position's K/V (padding included) at offset 0 of the
        cache, each SSM layer's final state and conv tail, and the audio
        family's cross-attention K/V.  ``prompt_len``: [B] valid prompt
        lengths when right-padded to a bucket; the causal mask keeps
        padded keys out of the valid queries, SSM state updates are masked,
        and the last valid position's logits are returned.  ``next_pos``
        counts the VLM prefix.
        """
        cfg = self.cfg
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

        def ssm_stack(layers, bufs, at=()):
            nonlocal x
            for i, lp in enumerate(layers):
                x, st = self._ssm_layer_fwd(lp, x, prompt_len=prompt_len,
                                            return_state=True)
                self._write_state(bufs, at + (i,), st)

        if cfg.family in _DECODERS:
            for i, lp in enumerate(self.layers):
                x, aux, kv = self._tf_layer_fwd(lp, x, positions, aux,
                                                return_kv=True)
                self._write_kv(cache["attn"], i, kv, s)
        elif cfg.family == "ssm":
            ssm_stack(self.layers, cache["ssm"])
        elif cfg.family == "hybrid":
            for g, gp in enumerate(self.ssm_groups):
                ssm_stack(gp, cache["ssm_groups"], (g,))
                x, _, kv = self._tf_layer_fwd(self.shared_attn, x, positions,
                                              aux, return_kv=True)
                self._write_kv(cache["shared_attn"], g, kv, s)
            if "ssm_tail" in cache:
                ssm_stack(self.ssm_tail, cache["ssm_tail"])
        else:                                          # audio
            y_enc = self._frames(x, extra_embed)
            t = y_enc.shape[1]
            for i, lp in enumerate(self.layers):
                xkv = self._cross_kv(lp, y_enc)
                x, aux, kv = self._tf_layer_fwd(lp, x, positions, aux,
                                                cross_kv=xkv, return_kv=True)
                self._write_kv(cache["attn"], i, kv, s)
                self._write_kv(cache["cross_kv"], i, xkv, t)

        if prompt_len is None:
            x_last = x[:, -1:, :]
        else:
            at = torch.clamp(next_pos.to(torch.int64) - 1, 0, s - 1)
            x_last = x[torch.arange(x.shape[0], device=x.device), at][:, None]
        return self._unembed(x_last), cache, next_pos

    def decode_step(self, tokens, cache, pos):
        """tokens: [B, 1]; pos: [B] write positions -> (logits [B, 1, V],
        cache)."""
        cfg = self.cfg
        x = self._embed(tokens)

        def ssm_stack(layers, bufs, at=()):
            nonlocal x
            for i, lp in enumerate(layers):
                x = self._decode_ssm_layer(lp, x, bufs["state"][at + (i,)],
                                           bufs["conv"][at + (i,)])

        if cfg.family in _DECODERS:
            attn = cache["attn"]
            for i, lp in enumerate(self.layers):
                x, _ = self._decode_tf_layer(
                    lp, x, {name: buf[i] for name, buf in attn.items()}, pos)
        elif cfg.family == "ssm":
            ssm_stack(self.layers, cache["ssm"])
        elif cfg.family == "hybrid":
            shared = cache["shared_attn"]
            for g, gp in enumerate(self.ssm_groups):
                ssm_stack(gp, cache["ssm_groups"], (g,))
                x, _ = self._decode_tf_layer(
                    self.shared_attn, x,
                    {name: buf[g] for name, buf in shared.items()}, pos)
            if "ssm_tail" in cache:
                ssm_stack(self.ssm_tail, cache["ssm_tail"])
        else:                                          # audio
            attn, xkv = cache["attn"], cache["cross_kv"]
            for i, lp in enumerate(self.layers):
                x, _ = self._decode_tf_layer(
                    lp, x, {name: buf[i] for name, buf in attn.items()}, pos,
                    cross_kv=(xkv["k"][i], xkv["v"][i]))
        return self._unembed(x), cache
