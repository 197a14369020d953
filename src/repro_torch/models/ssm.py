"""Mamba2 / SSD (state-space duality) blocks.

The port of ``repro.models.ssm``: the chunked SSD algorithm (Dao & Gu
2024) — within a chunk the quadratic attention-like form, across chunks
the linear recurrence — as plain ``torch.einsum`` in float32, looped over
chunks as the reference's ``lax.scan`` steps through them.  The port's
``ssm_chunked_scan`` kernel computes another function and is not used
here: the reference's LM reaches no Pallas kernel.  Single-token decode
keeps the O(1) recurrent state.

The intra-chunk segment sums ``cs_i - cs_j`` subtract two cumulative
sums that grow along the chunk, so late in a long chunk (256 steps) the
float32 forward loses bits the recurrent decode keeps.  Float64 inputs,
which the reference never sees, are computed in float64, a yardstick for
that float32 path.

Layout: heads ``h = d_inner / head_dim``, state size ``n``; B/C are shared
across heads (ngroups = 1, as in Mamba2).
"""

from __future__ import annotations

import numpy as np
import torch

from . import shard_ops
from .config import ModelConfig
from .layers import Init, Params, compute_dtype, remat, rms_norm, silu

__all__ = [
    "ssm_init", "ssm_axes", "ssm_fwd", "ssm_decode", "ssd_chunked", "ssd_ref",
    "softplus", "a_log_init",
]


def a_log_init(h: int) -> np.ndarray:
    """``log(linspace(1, 16, h))`` in float32, the linspace as
    ``jnp.linspace`` computes it (``start (1 - t) + stop t``, t = i / (h -
    1))."""
    f32 = np.float32
    if h == 1:
        lin = np.array([1.0], f32)
    else:
        t = np.arange(h - 1, dtype=f32) / f32(h - 1)
        lin = np.append(f32(1.0) * (f32(1.0) - t) + f32(16.0) * t, f32(16.0))
    return np.log(lin.astype(f32))


def ssm_init(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.n_ssm_heads
    conv_ch = di + 2 * n
    return {
        # fused in-projection: [z, x, B, C, dt]
        "w_in": Init((d, 2 * di + 2 * n + h), "trunc", d ** -0.5),
        "conv_w": Init((cfg.ssm_conv, conv_ch), "trunc", 0.5),
        "conv_b": Init((conv_ch,), "zeros"),
        "dt_bias": Init((h,), "zeros"),
        "a_log": Init((h,), "a_log"),
        "d_skip": Init((h,), "ones"),
        "norm": Init((di,), "ones"),
        "w_out": Init((di, d), "trunc", di ** -0.5),
    }


def ssm_axes(cfg: ModelConfig) -> dict:
    return {
        "w_in": ("fsdp", "ssm_inner"),
        "conv_w": ("conv", None),
        "conv_b": (None,),
        "dt_bias": ("ssm_heads",),
        "a_log": ("ssm_heads",),
        "d_skip": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "w_out": ("ssm_inner", "fsdp"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) at every x (``F.softplus`` returns x itself above its
    threshold of 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _split_in(cfg: ModelConfig, proj):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _conv_layout(xbc, w, b):
    """On a mesh each rank convolves its own batch rows."""
    rows = ("batch", None, None)
    return (rows, (None, None), (None,)), [(rows, tuple(xbc.shape))]


@shard_ops.shard_local(_conv_layout)
def _causal_conv(xbc, w, b):
    """xbc: [B, S, C]; w: [K, C] depthwise causal conv."""
    k = w.shape[0]
    s = xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + pad[:, i: i + s, :] * w[i]
    return out + b


def _acc(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_ref(x, dt, a, b, c, d_skip):
    """Naive O(S^2) SSD oracle (the tests hold the chunked path to it).

    x: [B,S,H,P]; dt: [B,S,H]; a: [H] (negative); b,c: [B,S,N]; d_skip: [H].
    y[i] = sum_{j<=i} c_i . b_j * exp(sum_{j<m<=i} dt_m a) * dt_j * x_j
    """
    f32 = _acc(x)
    dtf = dt.to(f32)
    da = dtf * a[None, None, :]                       # [B,S,H]
    cs = torch.cumsum(da, dim=1)
    seg = cs[:, :, None, :] - cs[:, None, :, :]       # [B,i,j,H]
    s = x.shape[1]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    # mask before exp: the upper triangle's segments are positive and
    # overflow
    seg = seg.masked_fill(~mask[None, :, :, None], -float("inf"))
    decay = torch.exp(seg)
    cb = torch.einsum("bin,bjn->bij", c.to(f32), b.to(f32))
    w = cb[:, :, :, None] * decay * dtf[:, None, :, :]
    y = torch.einsum("bijh,bjhp->bihp", w, x.to(f32))
    y = y + x.to(f32) * d_skip[None, None, :, None]
    return y.to(x.dtype)


def _chunk_body(r, xq, dtq, bq, cq, a, mask):
    """One chunk: the state ``r`` [B,H,N,P] in, (new state, y [B,Q,H,P])
    out; every tensor float32 (float64 for the yardstick).

    The reference's products in another layout and contraction order:
    the [B, Q, Q, H] intra-chunk tensors are kept as [B, H, Q, Q], so the
    diagonal block is one batched product with no copy, and the
    three-operand einsums contract their matrix product first (``y_off``
    scales ``C r`` by exp(cs); the state update scales x before
    contracting with B), never forming the [B, Q, N, H] outer products.
    The values differ only by rounding."""
    da = dtq * a[None, None, :]                      # [B,Q,H]
    cs = torch.cumsum(da, dim=1)                     # inclusive
    total = cs[:, -1, :]                             # [B,H]

    # intra-chunk (diagonal block), heads outside the chunk axes
    csh = cs.transpose(1, 2)                         # [B,H,Q]
    seg = csh[:, :, :, None] - csh[:, :, None, :]    # [B,H,i,j]
    seg = seg.masked_fill(~mask, -float("inf"))
    decay = torch.exp(seg)
    cb = torch.einsum("bin,bjn->bij", cq, bq)
    w = cb[:, None] * decay * dtq.transpose(1, 2)[:, :, None, :]
    y_diag = torch.matmul(w, xq.transpose(1, 2)).transpose(1, 2)

    # off-diagonal: the incoming state's contribution
    y_off = torch.einsum("bqn,bhnp->bqhp", cq, r) * torch.exp(cs)[..., None]

    # the chunk's terminal state
    decay_state = torch.exp(total[:, None, :] - cs)  # [B,Q,H]
    sc = torch.einsum("bqn,bqhp->bhnp", bq,
                      xq * (decay_state * dtq)[..., None])
    r_new = r * torch.exp(total)[:, :, None, None] + sc
    return r_new, y_diag + y_off


def _ssd_layout(x, dt, a, b, c, d_skip, chunk=None, *,
                return_final_state: bool = False):
    """On a mesh: batch over the data axes, heads over the model axis; B
    and C, shared by every head, whole on each rank."""
    heads = ("batch", None, "ssm_heads")
    outs = [(heads + (None,), tuple(x.shape))]
    if return_final_state:
        bsz, _, h, p = x.shape
        outs.append((("batch", "ssm_heads", None, None),
                     (bsz, h, b.shape[-1], p)))
    return (heads + (None,), heads, ("ssm_heads",), ("batch", None, None),
            ("batch", None, None), ("ssm_heads",), None), outs


@shard_ops.shard_local(_ssd_layout)
def ssd_chunked(x, dt, a, b, c, d_skip, chunk: int, *,
                return_final_state: bool = False):
    """Chunked SSD: [B,S,H,P] -> [B,S,H,P]; numerically matches ``ssd_ref``.

    S is padded up to a multiple of ``min(chunk, S)``.  Under autograd each
    chunk's body is rematerialized, as the reference's ``jax.checkpoint``
    does, so the backward pass never holds every chunk's [B, Q, Q, H]
    decay at once.  ``return_final_state``: also return the terminal
    recurrent state [B, H, N, P] (the prefill -> decode handoff).  On a
    mesh each rank runs the loop on its own shard (``_ssd_layout``)."""
    f32 = _acc(x)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    xp, dtp, bp, cp = x, dt, b, c
    if pad:
        xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dtp = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bp = torch.nn.functional.pad(b, (0, 0, 0, pad))
        cp = torch.nn.functional.pad(c, (0, 0, 0, pad))
    nc = xp.shape[1] // q

    xc = xp.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dtp.reshape(bsz, nc, q, h).to(f32)
    bc = bp.reshape(bsz, nc, q, n).to(f32)
    cc = cp.reshape(bsz, nc, q, n).to(f32)
    a = a.to(f32)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    r = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
    ys = []
    for i in range(nc):
        r, yq = remat(_chunk_body, r, xc[:, i], dtc[:, i], bc[:, i],
                      cc[:, i], a, mask)
        ys.append(yq)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * q, h, p)[:, :s]
    y = y + x.to(f32) * d_skip[None, None, :, None]
    if return_final_state:
        return y.to(x.dtype), r
    return y.to(x.dtype)


def ssm_fwd(p: Params, cfg: ModelConfig, x, *, return_state: bool = False,
            prompt_len=None):
    """Full-sequence Mamba2 block. x: [B, S, d] -> [B, S, d].

    ``return_state``: also return the decode cache {"state", "conv"} at
    the end of the sequence (prefill handoff).
    ``prompt_len``: [B] valid lengths; positions >= prompt_len are padding
    (dt forced to 0 so they leave the recurrent state untouched, and the
    conv tail is taken at the true end of the prompt).  As in the
    reference (``lax.dynamic_slice`` clamps its start to [0, S - k]), a
    prompt shorter than k = ``ssm_conv - 1`` takes rows 0..k-1 of the
    padded input, padding included, where the unpadded branch pads with
    zeros on the left.
    """
    dt_ = compute_dtype(cfg)
    f32 = _acc(x)
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    proj = shard_ops.pin(x @ p["w_in"].to(dt_))
    z, xbc_raw, dtr = _split_in(cfg, proj)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    xbc = silu(xbc)
    xs = xbc[..., :di]
    b = xbc[..., di: di + n]
    c = xbc[..., di + n:]
    dt = softplus(dtr.to(f32) + p["dt_bias"])
    bsz, s, _ = x.shape
    if prompt_len is not None:
        valid = torch.arange(s, device=x.device)[None, :] < prompt_len[:, None]
        dt = dt * valid[..., None].to(dt.dtype)
    a = -torch.exp(p["a_log"].to(f32))

    xh = xs.reshape(bsz, s, h, hd)
    out = ssd_chunked(xh, dt, a, b, c, p["d_skip"].to(f32), cfg.ssm_chunk,
                      return_final_state=return_state)
    y, final_state = out if return_state else (out, None)
    y = y.reshape(bsz, s, di)
    y = y * silu(z)
    y = rms_norm(y, {"scale": p["norm"]}, cfg.norm_eps)
    y = y @ p["w_out"].to(dt_)
    if return_state:
        k = cfg.ssm_conv - 1
        if prompt_len is None:
            conv_tail = xbc_raw[:, s - k:, :] if s >= k else \
                torch.nn.functional.pad(xbc_raw, (0, 0, k - s, 0))
        else:
            start = torch.clamp(prompt_len.to(torch.int64) - k, 0, s - k)
            rows = start[:, None] + torch.arange(k, device=x.device)[None, :]
            conv_tail = torch.gather(
                xbc_raw, 1, rows[..., None].expand(bsz, k, xbc_raw.shape[-1]))
        return y, {"state": final_state, "conv": conv_tail}
    return y


def ssm_decode(p: Params, cfg: ModelConfig, x, cache: dict) -> tuple:
    """Single-token decode.  x: [B, 1, d].

    cache: {"state": [B,H,N,P] f32, "conv": [B, K-1, C]}; returns the new
    ones (the caller writes them back).
    """
    dt_ = compute_dtype(cfg)
    f32 = torch.float32
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    proj = x @ p["w_in"].to(dt_)
    z, xbc, dtr = _split_in(cfg, proj)

    # conv over [cached K-1 inputs | current]
    conv_in = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # [B,K,C]
    w = p["conv_w"].to(dt_)
    out = torch.einsum("bkc,kc->bc", conv_in, w) + p["conv_b"].to(dt_)
    xbc_t = silu(out)[:, None, :]
    new_conv = conv_in[:, 1:, :]

    xs = xbc_t[..., :di]
    b = xbc_t[..., di: di + n]
    c = xbc_t[..., di + n:]
    dt = softplus(dtr[:, 0].to(f32) + p["dt_bias"])             # [B,H]
    a = -torch.exp(p["a_log"])

    bsz = x.shape[0]
    xh = xs.reshape(bsz, h, hd).to(f32)
    bf = b[:, 0].to(f32)
    cf = c[:, 0].to(f32)

    decay = torch.exp(dt * a[None, :])                         # [B,H]
    # the reference's three-operand einsum as jax contracts it: (B ⊗ dt)
    # first, then x (every product exact, so the values are its values)
    bdt = torch.einsum("bn,bh->bnh", bf, dt)
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bnh,bhp->bhnp", bdt, xh)
    y = torch.einsum("bn,bhnp->bhp", cf, state)
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(dt_)
    y = y * silu(z)
    y = rms_norm(y, {"scale": p["norm"]}, cfg.norm_eps)
    return y @ p["w_out"].to(dt_), {"state": state, "conv": new_conv}
