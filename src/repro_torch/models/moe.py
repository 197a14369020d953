"""Fine-grained Mixture-of-Experts (DeepSeek-MoE style).

The port of ``repro.models.moe``: top-k routing over
``n_routed_experts`` fine-grained experts plus ``n_shared_experts``
always-on shared experts, dispatched through a static [e, cap, d]
capacity buffer: token replicas are slotted by a stable sort on their
expert id, the expert FFNs run as one batched [e, cap, *] einsum, and the
outputs gather back with renormalized gates.  A replica past its expert's
capacity is dropped (its gate zeroed).  The capacity comes from the
call's own token count, so a decode step of B tokens can drop what a
forward pass over the same tokens keeps.

Ties in the router go to the lower expert index, as ``jax.lax.top_k``
breaks them, and each token's k expert outputs are summed in choice
order, as the reference's scatter-add sums them.

Returns the switch-style load-balance auxiliary loss beside the output.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import Params, _trunc, compute_dtype, silu
from .shard_ops import routed_experts, whole
from .sharding import constrain

__all__ = ["moe_init", "moe_axes", "moe_fwd", "route", "CAPACITY_FACTOR"]

CAPACITY_FACTOR = 1.25


def moe_init(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    e = cfg.n_routed_experts
    p = {
        "router": _trunc((d, e), d ** -0.5),
        "w_gate": _trunc((e, d, f), d ** -0.5),
        "w_up": _trunc((e, d, f), d ** -0.5),
        "w_down": _trunc((e, f, d), f ** -0.5),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": _trunc((d, fs), d ** -0.5),
            "w_up": _trunc((d, fs), d ** -0.5),
            "w_down": _trunc((fs, d), fs ** -0.5),
        }
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    p = {
        "router": ("fsdp", None),
        "w_gate": ("experts", "fsdp", "expert_ffn"),
        "w_up": ("experts", "fsdp", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "fsdp"),
    }
    if cfg.n_shared_experts:
        p["shared"] = {
            "w_gate": ("fsdp", "ffn"),
            "w_up": ("fsdp", "ffn"),
            "w_down": ("ffn", "fsdp"),
        }
    return p


def route(p: Params, cfg: ModelConfig, xt: torch.Tensor):
    """Router of ``xt`` [n, d]: (probs [n, e] f32, gate [n, k] f32
    renormalized, idx [n, k] int64), top-k ties to the lower index."""
    dt = compute_dtype(cfg)
    logits = (xt @ p["router"].to(dt)).to(torch.float32)          # [n, e]
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def moe_fwd(p: Params, cfg: ModelConfig, x) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss)."""
    dt = compute_dtype(cfg)
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_routed_experts, cfg.top_k
    nk = n * k
    # flattening (batch, seq) -> tokens mixes two sharded dims; pin the
    # token sharding explicitly
    xt = constrain(x.reshape(n, d), "tokens", None)
    probs, gate, idx = route(p, cfg, xt)

    # Load-balance aux loss (Switch/GShard): e * mean(frac_tokens * frac_prob).
    # The routing is small ([n, k] ids): on a mesh every rank holds all of
    # it, so the slots below are the global ones.
    flat_e = whole(idx).reshape(-1)                                # [nk]
    dev = flat_e.device
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))     # bincount would sync a card
    assign = counts.to(torch.float32) / nk
    aux = e * torch.sum(assign * probs.mean(dim=0)) * cfg.router_aux_coef

    # ---- permute: slot every (token, choice) into its expert's buffer ----
    cap_f = cfg.moe_capacity_factor or CAPACITY_FACTOR
    cap = max(1, int(cap_f * n * k / e))
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.cumsum(counts, dim=0) - counts                  # exclusive
    slot_sorted = torch.arange(nk, device=dev) - starts[sorted_e]
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    keep = slot < cap

    y = routed_experts(p, xt, gate, flat_e, slot, keep, cap, k, dt,
                       slot_in=_slot_in, ffn=_ffn, combine=_combine)

    if cfg.n_shared_experts:
        sp = p["shared"]
        act = silu(xt @ sp["w_gate"].to(dt)) * (xt @ sp["w_up"].to(dt))
        y = y + act @ sp["w_down"].to(dt)
    return y.reshape(b, s, d), aux


def _ffn(p: Params, dt, expert_in):
    """The expert FFNs: one batched product over the expert dimension."""
    gate_act = silu(
        torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"].to(dt)))
    up = torch.einsum("ecd,edf->ecf", expert_in, p["w_up"].to(dt))
    return torch.einsum("ecf,efd->ecd", gate_act * up, p["w_down"].to(dt))


def _slot_in(xt, flat_e, slot, keep, n_experts: int, cap: int, k: int, dt):
    """The [n_experts, cap, d] capacity buffer of the (token, choice)
    replicas in ``flat_e``/``slot``/``keep``; a replica past its expert's
    capacity (or not ``keep``) lands in row ``cap``, which is dropped."""
    safe_slot = torch.where(keep, slot, cap)                       # row `cap` = trash
    tok = torch.arange(flat_e.shape[0], device=xt.device) // k
    expert_in = torch.zeros((n_experts, cap + 1, xt.shape[1]), dtype=dt,
                            device=xt.device)
    expert_in.index_put_((flat_e, safe_slot), xt[tok].to(dt), accumulate=True)
    return expert_in[:, :cap]


def _combine(out, gate, flat_e, slot, keep, cap: int, n: int, k: int, dt):
    """Gather the replicas' outputs back and add each token's k choices,
    weighted by their gates, in choice order (the reference's scatter-add
    order)."""
    y_rep = out[flat_e, torch.clamp(slot, max=cap - 1)]            # [nk, d]
    w = (gate.reshape(-1) * keep.to(torch.float32)).to(dt)
    return scatter_rows((y_rep * w[:, None]).reshape(n, k, y_rep.shape[-1]))


def scatter_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, k, d] -> [n, d]: each token's k replicas added into a zero row
    in choice order, as the reference's scatter-add (``.at[tok].add``)
    adds them."""
    y = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        y = y + x[:, j]
    return y
