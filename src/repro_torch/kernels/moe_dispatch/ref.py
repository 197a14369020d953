"""Plain PyTorch version of MoE dispatch (counterpart of
``repro.kernels.moe_dispatch.ref``).

The reference oracle gathers ``w[expert_ids]`` into a [T, D, F] tensor,
which at a routed layer's width is hundreds of GB.  This version loops
over the experts that are present instead: ``y[rows] = x[rows] @ w[e]``
in float32, cast to x's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["moe_dispatch_sorted_ref", "moe_dispatch_ref"]


def moe_dispatch_sorted_ref(x: torch.Tensor, w: torch.Tensor,
                            tok: torch.Tensor,
                            eid: torch.Tensor) -> torch.Tensor:
    """x: [T, D]; w: [E, D, F]; tok, eid: [T] -> y: [T, F] with
    ``y[tok[i]] = x[tok[i]] @ w[eid[i]]`` (``tok`` a permutation of
    ``range(T)``).  A token or expert id out of range raises IndexError;
    a token order with a repeat raises ValueError, as the kernel traps."""
    t = x.shape[0]
    n_experts, _, f = w.shape
    tok, eid = tok.long(), eid.long()
    for what, ids, hi in (("token", tok, t), ("expert id", eid, n_experts)):
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= hi):
            raise IndexError(f"{what} outside [0, {hi})")
    if torch.bincount(tok, minlength=t).ne(1).any():
        raise ValueError("token order is not a permutation of [0, T)")
    y = torch.zeros(t, f, dtype=x.dtype, device=x.device)
    for e in torch.unique(eid).tolist():
        rows = tok[eid == e]
        y[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return y


def moe_dispatch_ref(x: torch.Tensor, w: torch.Tensor,
                     expert_ids: torch.Tensor) -> torch.Tensor:
    """x: [T, D]; w: [E, D, F]; expert_ids: [T] -> y: [T, F] with
    ``y[t] = x[t] @ w[expert_ids[t]]``."""
    tok = torch.arange(x.shape[0], device=x.device)
    return moe_dispatch_sorted_ref(x, w, tok, expert_ids)
