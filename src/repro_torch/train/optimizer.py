"""AdamW with low-precision moments, a cosine schedule and global-norm
clipping.

The port of ``repro.train.optimizer``.  Trees are flat dicts of tensors
keyed by the LM's parameter names (nested dicts are flattened with
dots); every function walks them in the order of the reference's pytree
leaves (``convert.tree_order``), so sums over leaves add in the
reference's order.

- Moments default to **bf16** (half the optimizer's memory and checkpoint
  bytes; master parameters stay float32); each update reads them into
  float32 and stores them back in ``state_dtype``.
- ``apply_updates`` works in place: the parameters and the moments are
  overwritten (the reference returns new trees), so a step holds no
  second copy of either.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from dataclasses import dataclass

import torch

from repro_torch.models.convert import tree_order

__all__ = ["AdamWConfig", "init_opt_state", "opt_state_axes",
           "zeros_like_param",
           "apply_updates", "cosine_schedule", "global_norm", "leaves"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "bfloat16"   # moment dtype (memory/checkpoint trick)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree: Mapping) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of a tree of tensors in the reference's leaf order;
    nested dicts are flattened with dots."""
    flat: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(f"{prefix}{k}.", v)
            else:
                flat[prefix + k] = v
    walk("", tree)
    return [(n, flat[n]) for n in tree_order(flat)]


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def zeros_like_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype``: on a DTensor parameter, a
    DTensor with its placements (each rank allocates its own shard), as
    ``train.step.train_state_axes`` lays the state out."""
    return torch.zeros_like(p, dtype=dtype, requires_grad=False,
                            memory_format=torch.contiguous_format)


def init_opt_state(params: Mapping, cfg: AdamWConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    items = leaves(params)

    def zeros():
        return {n: zeros_like_param(p, dt) for n, p in items}
    device = items[0][1].device if items else None
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_axes(param_axes) -> dict:
    """Moments shard exactly like their parameters."""
    return {"mu": param_axes, "nu": param_axes, "step": ()}


def global_norm(tree: Mapping) -> torch.Tensor:
    total = None
    for name, x in leaves(tree):    # a capture reads the leaf's ``name``
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Mapping, grads: Mapping, state: dict,
                  cfg: AdamWConfig) -> tuple[Mapping, dict, dict]:
    """One AdamW step, in place.  Returns (params, new_state, metrics):
    ``params`` and the moments are the tensors given, overwritten; the
    new state holds a new step count."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    sdt = getattr(torch, cfg.state_dtype)
    f32 = torch.float32
    g_of, mu_of, nu_of = dict(leaves(grads)), state["mu"], state["nu"]
    for name, p in leaves(params):
        g = g_of[name].to(f32) * scale
        mu_f = mu_of[name].to(f32) * b1 + (1 - b1) * g
        nu_f = nu_of[name].to(f32) * b2 + (1 - b2) * g * g
        mhat = mu_f / bc1
        vhat = nu_f / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(f32)
        p.copy_((p.to(f32) - lr * delta).to(p.dtype))
        mu_of[name].copy_(mu_f.to(sdt))
        nu_of[name].copy_(nu_f.to(sdt))
    new_state = {"mu": mu_of, "nu": nu_of, "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
