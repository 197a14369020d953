"""Core transformer layers: norms, RoPE, GQA/MLA attention, MLPs.

The port of ``repro.models.layers``.  Functional, as the reference is:
each ``*_fwd`` takes its parameters as a mapping (a :class:`ParamTree` of
the :class:`~repro_torch.models.model.LM`, or a plain dict of tensors)
indexed by the reference's pytree keys, in the reference's shapes, so
every einsum string carries over one for one.  Parameters are float32;
each use casts to the config's compute dtype at the point where the
reference casts, and softmax and normalization run in float32.

Attention implementations (``cfg.attn_impl``):

- ``naive``:   materialized [S, S] scores — reference semantics.
- ``chunked``: online-softmax loop over KV chunks — the same math,
  O(S * chunk) live memory.

Both are ``torch.einsum`` and ``softmax``, as the reference's are
``jnp.einsum``: the LM reaches no kernel of ``repro_torch.kernels``.
Under autograd the chunked loop's body is rematerialized
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` is.

The decode functions write their cache in place (the reference returns
an updated copy) and return it; a write position past the cache is
clamped to its last row, as ``lax.dynamic_update_slice`` clamps, while
the mask keeps the unclamped ``pos``.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from . import shard_ops, sharding
from .config import ModelConfig

__all__ = [
    "Init", "ParamTree", "compute_dtype", "remat",
    "rms_norm", "rms_norm_init", "rms_norm_axes",
    "apply_rope",
    "attention_init", "attention_axes", "attention_fwd", "attention_decode",
    "mla_init", "mla_axes", "mla_fwd", "mla_decode",
    "mlp_init", "mlp_axes", "mlp_fwd",
]

Params = Mapping[str, "torch.Tensor | Params"]
NEG_INF = -1e30     # the reference's mask value, applied in float32


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    dt = getattr(torch, cfg.dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {cfg.dtype!r}")
    return dt


def remat(fn, *args):
    """``fn(*args)``, rematerialized in the backward pass when autograd
    records (``torch.utils.checkpoint``, non-reentrant): the port's
    ``jax.checkpoint``.  Without autograd it is a plain call.  Under a
    sharding context the recomputation runs under it too (autograd may
    run the backward pass on a thread of its own)."""
    if torch.is_grad_enabled():
        return checkpoint(sharding.carried(fn), *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------
# Parameters: the reference's init draws, and a module indexed like its
# pytree
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Init:
    """One float32 parameter: its shape and the reference's draw for it.

    ``trunc`` is ``scale * truncated_normal(-2, 2)`` (``layers.py:_init``),
    ``normal`` is ``scale * normal`` (the embedding and the head), ``ones``
    and ``zeros`` are constants (norm scales, biases), ``a_log`` the SSM's
    ``log(linspace(1, 16, h))``."""

    shape: tuple[int, ...]
    kind: str = "trunc"
    scale: float = 1.0

    def fill_(self, t: torch.Tensor, generator: torch.Generator) -> None:
        if self.kind == "trunc":
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            t.mul_(self.scale)
        elif self.kind == "normal":
            t.normal_(generator=generator).mul_(self.scale)
        elif self.kind == "ones":
            t.fill_(1.0)
        elif self.kind == "zeros":
            t.zero_()
        elif self.kind == "a_log":
            from .ssm import a_log_init
            t.copy_(torch.from_numpy(a_log_init(t.shape[0])))
        else:
            raise ValueError(f"unknown init {self.kind!r}")


class ParamTree(nn.Module):
    """A nested dict of :class:`Init` as a module whose parameters and
    children read by key (``p["wq"]``, ``p["shared"]["w_up"]``), so the
    layer functions index it as the reference indexes its pytree; a list
    of such dicts (a stack of layers) becomes an ``nn.ModuleList``.

    Parameters are allocated uninitialized; ``LM.init`` fills them.  They
    are made not requiring grad (serving never needs it);
    ``repro_torch.train`` turns it on."""

    def __init__(self, spec: Mapping, device: torch.device):
        super().__init__()
        for name, s in spec.items():
            if isinstance(s, (Mapping, list)):
                self.add_module(name, _module(s, device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=torch.float32, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _module(spec, device: torch.device) -> nn.Module:
    if isinstance(spec, list):
        return nn.ModuleList(_module(s, device) for s in spec)
    return ParamTree(spec, device)


def _trunc(shape: tuple[int, ...], scale: float) -> Init:
    return Init(tuple(shape), "trunc", scale)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rms_norm_init(d: int) -> dict:
    return {"scale": Init((d,), "ones")}


def rms_norm_axes() -> dict:
    return {"scale": ("embed",)}


def rms_norm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    # jnp.mean: a sum, then a division of the reduced rows
    var = torch.sum(xf * xf, dim=-1, keepdim=True) / xf.shape[-1]
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (rotate-half convention)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies in numpy float32, exactly as the reference builds
    them; kept per device, since each copy to a card waits for it."""
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(np.ascontiguousarray(freq)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (D even); positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freq = _rope_freq(half, theta, x.device)
    angles = positions.to(torch.float32)[..., None] * freq   # [..., S, half]
    angles = angles[..., None, :]                             # [..., S, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------
def attention_init(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = d ** -0.5
    p = {
        "wq": _trunc((d, h, hd), s),
        "wk": _trunc((d, kv, hd), s),
        "wv": _trunc((d, kv, hd), s),
        "wo": _trunc((h, hd, d), (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = Init((h, hd), "zeros")
        p["bk"] = Init((kv, hd), "zeros")
        p["bv"] = Init((kv, hd), "zeros")
    return p


def attention_axes(cfg: ModelConfig) -> dict:
    p = {
        "wq": ("fsdp", "heads", None),
        "wk": ("fsdp", "kv_heads", None),
        "wv": ("fsdp", "kv_heads", None),
        "wo": ("heads", None, "fsdp"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads", None)
        p["bk"] = ("kv_heads", None)
        p["bv"] = ("kv_heads", None)
    return p


def _heads_layout(x, w, axis: str):
    out = (x.shape[0], x.shape[1]) + tuple(w.shape[1:])
    return ((("batch", None, None), (None, axis, None), None),
            [(("batch", None, axis, None), out)])


@shard_ops.shard_local(_heads_layout)
def _project(x, w, axis: str):
    """x [B, S, d] through w [d, H, K] -> [B, S, H, K].  On a mesh each
    rank projects its own batch rows onto its own heads (``axis``, their
    logical name): DTensor's own strategy may split the fused H*K columns
    over a mesh axis that does not divide H."""
    return torch.einsum("bsd,dhk->bshk", x, w)


def _project_qkv(p: Params, cfg: ModelConfig, x, positions):
    dt = compute_dtype(cfg)
    q = _project(x, p["wq"].to(dt), "heads")
    k = _project(x, p["wk"].to(dt), "kv_heads")
    v = _project(x, p["wv"].to(dt), "kv_heads")
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _causal_mask(q_offset, sq: int, k_start: int, sk: int, device):
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = k_start + torch.arange(sk, device=device)
    return qpos[:, None] >= kpos[None, :]


@shard_ops.head_local
def _sdpa_naive(q, k, v, *, causal: bool, scale: float, q_offset=0):
    """q,k: [B,S,*,D]; v: [B,Sk,G,Dv] (Dv may differ, e.g. MLA).  On a
    mesh each rank runs it on its own shard (``shard_ops.head_local``)."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    dv = v.shape[-1]
    rep = h // g
    qh = q.reshape(b, sq, g, rep, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qh, k).to(torch.float32) * scale
    if causal:
        mask = _causal_mask(q_offset, sq, 0, k.shape[1], q.device)
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(b, sq, h, dv)


@shard_ops.head_local
def _sdpa_chunked(q, k, v, *, causal: bool, scale: float, chunk: int):
    """Online softmax over KV chunks: the same math, bounded memory.  The
    chunks are the reference scan's ``sk // chunk`` full ones, then its
    remainder.  On a mesh each rank runs the loop on its own shard, laid
    out as the reference's hints at its chunk loop lay it out (batch over
    the data axes, kv-head groups over the model axis when they divide:
    ``shard_ops.head_local``)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    g = k.shape[2]
    dv = v.shape[-1]
    rep = h // g
    chunk = min(chunk, sk)
    qh = q.reshape(b, sq, g, rep, d)
    f32 = torch.float32
    m = torch.full((b, g, rep, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, g, rep, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, g, rep, sq, dv), dtype=f32, device=q.device)

    def one_chunk(m, l, acc, kc, vc, start: int):
        s = torch.einsum("bsgrd,btgd->bgrst", qh, kc).to(f32) * scale
        if causal:
            s = s.masked_fill(
                ~_causal_mask(0, sq, start, kc.shape[1], q.device), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p_ = torch.exp(s - m_new[..., None])
        l = l * alpha + p_.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p_.to(q.dtype), vc).to(f32)
        return m_new, l, acc

    for start in range(0, sk, chunk):
        m, l, acc = remat(one_chunk, m, l, acc, k[:, start:start + chunk],
                          v[:, start:start + chunk], start)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4)     # b s g r dv
    return out.reshape(b, sq, h, dv)


def _sdpa(cfg: ModelConfig, q, k, v, *, causal: bool, scale: float):
    if cfg.attn_impl == "chunked":
        return _sdpa_chunked(q, k, v, causal=causal, scale=scale,
                             chunk=cfg.attn_chunk)
    return _sdpa_naive(q, k, v, causal=causal, scale=scale)


def attention_fwd(p: Params, cfg: ModelConfig, x, positions, *,
                  causal: bool = True, kv_override: tuple | None = None,
                  return_kv: bool = False):
    """Full-sequence attention (forward / prefill).

    ``kv_override``: (k, v) for cross-attention (encoder-decoder); RoPE is
    skipped on the overridden K/V (the query still takes it), and the
    naive path is taken whatever ``cfg.attn_impl`` says.
    ``return_kv``: also return the (roped) K/V for prefill cache writes.
    """
    dt = compute_dtype(cfg)
    scale = cfg.resolved_head_dim ** -0.5
    if kv_override is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
        out = _sdpa(cfg, q, k, v, causal=causal, scale=scale)
    else:
        q = _project(x, p["wq"].to(dt), "heads")
        if cfg.qkv_bias:
            q = q + p["bq"].to(dt)
        q = apply_rope(q, positions, cfg.rope_theta)
        k, v = kv_override
        out = _sdpa_naive(q, k, v, causal=causal, scale=scale)
    y = shard_ops.merge_heads(out, p["wo"].to(dt))
    if return_kv:
        return y, (k, v)
    return y


def _write_rows(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """buf[b, pos[b]] = new[b, 0] in place, with ``pos`` clamped to the
    last row as ``lax.dynamic_update_slice`` clamps its start."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    at = pos.to(torch.int64).clamp(0, buf.shape[1] - 1)
    shard_ops.write_rows(buf, rows, at, new[:, 0].to(buf.dtype))
    return buf


def _valid(pos: torch.Tensor, sk: int) -> torch.Tensor:
    """[B, sk]: key t is visible from a query at ``pos`` when t <= pos."""
    return torch.arange(sk, device=pos.device)[None, :] <= pos[:, None]


def attention_decode(p: Params, cfg: ModelConfig, x, cache: dict, pos):
    """Single-token decode with a preallocated KV cache.

    x: [B, 1, d]; cache: {"k","v": [B, L, KV, hd]} (written in place);
    pos: [B] current index.
    """
    dt = compute_dtype(cfg)
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    k_cache = _write_rows(cache["k"], k, pos)
    v_cache = _write_rows(cache["v"], v, pos)

    b, _, h, d = q.shape
    g = k_cache.shape[2]
    rep = h // g
    # on a mesh the cache's length is what shards over the model axis
    # (flash-decode); the query's heads stay whole (made so before the
    # view, which could not split heads sharded over the model axis)
    qh = sharding.constrain(q, "batch", None, None, None).reshape(
        b, g, rep, d)
    scores = torch.einsum("bgrd,btgd->bgrt", qh, k_cache).to(torch.float32)
    scores = scores * d ** -0.5
    valid = _valid(pos, k_cache.shape[1])
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bgrt,btgd->bgrd", w, v_cache).reshape(b, 1, h, d)
    y = shard_ops.merge_heads(out, p["wo"].to(dt))
    return y, {"k": k_cache, "v": v_cache}


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------
def mla_init(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    s = d ** -0.5
    return {
        "wq": _trunc((d, h, dn + dr), s),
        "wkv_a": _trunc((d, r + dr), s),
        "kv_norm": Init((r,), "ones"),
        "wkv_b": _trunc((r, h, dn + dv), r ** -0.5),
        "wo": _trunc((h, dv, d), (h * dv) ** -0.5),
    }


def mla_axes(cfg: ModelConfig) -> dict:
    return {
        "wq": ("fsdp", "heads", None),
        "wkv_a": ("fsdp", "kv_lora"),
        "kv_norm": ("kv_lora",),
        "wkv_b": ("kv_lora", "heads", None),
        "wo": ("heads", None, "fsdp"),
    }


def _mla_project(p: Params, cfg: ModelConfig, x, positions):
    dt = compute_dtype(cfg)
    dn = cfg.nope_head_dim
    r = cfg.kv_lora_rank
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(dt))
    c_kv, k_rope = kv_a[..., :r], kv_a[..., r:]
    c_kv = rms_norm(c_kv, {"scale": p["kv_norm"]}, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_attend(p: Params, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope,
                *, causal: bool, q_offset=0, valid_len=None):
    """Attention in latent space: wkv_b absorbed into the query (the
    paper's inference trick), so the cache stays [B, S, r + dr]."""
    dt = compute_dtype(cfg)
    dn = cfg.nope_head_dim
    wkv_b = p["wkv_b"].to(dt)              # [r, h, dn+dv]
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
    s1 = torch.einsum("bshr,btr->bhst", q_lat, c_kv)
    s2 = torch.einsum("bshk,btk->bhst", q_rope, k_rope)
    scale = (dn + cfg.rope_head_dim) ** -0.5
    scores = (s1 + s2).to(torch.float32) * scale
    sq, sk = scores.shape[2], scores.shape[3]
    if causal:
        scores = scores.masked_fill(
            ~_causal_mask(q_offset, sq, 0, sk, scores.device), NEG_INF)
    if valid_len is not None:
        ok = _valid(valid_len, sk)
        scores = scores.masked_fill(~ok[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhst,btr->bshr", w, c_kv)          # latent context
    out = torch.einsum("bshr,rhv->bshv", ctx, wv_b)        # [b,s,h,dv]
    return torch.einsum("bshv,hvd->bsd", out, p["wo"].to(dt))


def mla_fwd(p: Params, cfg: ModelConfig, x, positions, *, causal=True,
            return_kv: bool = False):
    """Full-sequence MLA: the latent KV expanded to per-head K/V through
    the naive or chunked attention (decode keeps the absorbed form)."""
    dt = compute_dtype(cfg)
    dn = cfg.nope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_project(p, cfg, x, positions)

    wkv_b = p["wkv_b"].to(dt)                             # [r, h, dn+dv]
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, wkv_b[..., :dn])
    v = torch.einsum("btr,rhv->bthv", c_kv, wkv_b[..., dn:])
    h = cfg.n_heads
    k_rope_h = k_rope[:, :, None, :].expand(
        *k_rope.shape[:2], h, cfg.rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)               # [b,s,h,dn+dr]
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = _sdpa(cfg, q, k, v, causal=causal,
                scale=(dn + cfg.rope_head_dim) ** -0.5)
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(dt))
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def mla_decode(p: Params, cfg: ModelConfig, x, cache: dict, pos):
    """cache: {"c_kv": [B, L, r], "k_rope": [B, L, dr]} (written in place)"""
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_project(
        p, cfg, x, pos[:, None])
    c_kv = _write_rows(cache["c_kv"], c_kv_new, pos)
    k_rope = _write_rows(cache["k_rope"], k_rope_new, pos)
    y = _mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                    causal=False, valid_len=pos)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


# --------------------------------------------------------------------------
# Dense MLPs
# --------------------------------------------------------------------------
def mlp_init(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    p = {
        "w_up": _trunc((d, f), d ** -0.5),
        "w_down": _trunc((f, d), f ** -0.5),
    }
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = _trunc((d, f), d ** -0.5)
    return p


def mlp_axes(cfg: ModelConfig) -> dict:
    p = {"w_up": ("fsdp", "ffn"), "w_down": ("ffn", "fsdp")}
    if cfg.mlp_kind == "swiglu":
        p["w_gate"] = ("fsdp", "ffn")
    return p


# The activations step by step, as XLA expands the reference's
# ``jax.nn.silu`` (``x * 1 / (1 + exp(-x))``) and ``jax.nn.gelu`` (whose
# default is the tanh approximation): in bfloat16 each step rounds to the
# input's dtype, and the reference's Python constants are that dtype's
# (``F.silu`` and ``F.gelu`` keep the whole function in float32 and round
# once, which moves a third of bfloat16 sigmoids by a step).
def silu(x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Silu.apply(x)
    return x * (1 / (1 + torch.exp(-x)))


class _Silu(torch.autograd.Function):
    """``x * s``, s = 1 / (1 + exp(-x)), with ``jax.nn.silu``'s gradient:
    from s and s (1 - s), where autograd would differentiate each step of
    the expansion."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + x * g * (s * (1 - s))


@functools.lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python number (a scalar
    operand needs no copy to a card)."""
    return torch.tensor(value, dtype=dtype).item()


def cube(x: torch.Tensor) -> torch.Tensor:
    """``x ** 3`` as XLA expands the reference's ``integer_pow``: two
    multiplies, each rounded to the input's dtype."""
    return x * x * x


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = _in_dtype(float(np.sqrt(2 / np.pi)), x.dtype)
    k = _in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * cube(x)))))


def mlp_fwd(p: Params, cfg: ModelConfig, x) -> torch.Tensor:
    dt = compute_dtype(cfg)
    up = x @ p["w_up"].to(dt)
    if cfg.mlp_kind == "swiglu":
        act = silu(x @ p["w_gate"].to(dt)) * up
    elif cfg.mlp_kind == "relu2":
        r = F.relu(up)
        act = r * r
    else:
        act = gelu_tanh(up)
    return act @ p["w_down"].to(dt)
