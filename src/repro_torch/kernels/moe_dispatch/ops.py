"""MoE dispatch entry points (counterpart of
``repro.kernels.moe_dispatch.ops``).

The launch spec is the reference's: grid ``(T,)``; the token order and the
expert ids, both int32, read once (``tok`` first, then ``eid``); step
``i`` moves row ``tok[i]`` of x in (``[1, D]``), expert ``eid[i]``'s
weight tile in (``[1, D, F]``, resident across a run of one expert) and
row ``tok[i]`` of y out (``[1, F]``).  The reference decides on D and F
multiples of 128 between kernel and oracle; here a CUDA tensor outside
that raises.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import moe_grouped_gemm
from .ref import moe_dispatch_sorted_ref

__all__ = ["moe_dispatch", "moe_dispatch_sorted", "launch_spec",
           "dispatch_flops"]


def dispatch_flops(*, n_tokens: int, d: int, f: int) -> float:
    """Arithmetic ops of one dispatch: a [1, d] x [d, f] GEMM per token."""
    return n_tokens * 2.0 * d * f


def launch_spec(t: int, d: int, f: int, n_experts: int, tok: torch.Tensor,
                eid: torch.Tensor, dtype: torch.dtype) -> LaunchSpec:
    """The launch geometry of dispatching ``t`` expert-sorted rows."""
    ids = dict(shape=(t,), block_shape=(t,), dtype=torch.int32,
               index_map=lambda i: (0,))
    return LaunchSpec(
        name="moe_dispatch",
        grid=(t,),
        operands=(
            LaunchOperand(name="tok", role="index", **ids),
            LaunchOperand(name="eid", role="index", **ids),
            LaunchOperand(name="x", role="in", shape=(t, d),
                          block_shape=(1, d), dtype=dtype,
                          index_map=lambda i, tok, eid: (int(tok[i]), 0),
                          steered=True),
            LaunchOperand(name="w", role="in", shape=(n_experts, d, f),
                          block_shape=(1, d, f), dtype=dtype,
                          index_map=lambda i, tok, eid: (int(eid[i]), 0, 0),
                          steered=True),
            LaunchOperand(name="y", role="out", shape=(t, f),
                          block_shape=(1, f), dtype=dtype,
                          index_map=lambda i, tok, eid: (int(tok[i]), 0),
                          steered=True),
        ),
        flops=dispatch_flops(n_tokens=t, d=d, f=f),
        index=(tok, eid),
    )


def moe_dispatch_sorted(x: torch.Tensor, w: torch.Tensor, tok: torch.Tensor,
                        eid: torch.Tensor) -> torch.Tensor:
    """x: [T, D]; w: [E, D, F]; tok, eid: [T] (expert-sorted) -> [T, F].

    ``tok`` is a permutation of ``range(T)`` such that ``eid`` (the expert
    of ``x[tok[i]]``) is non-decreasing; ``y[tok[i]] = x[tok[i]] @
    w[eid[i]]``.
    """
    t, d = x.shape
    n_experts, d_w, f = w.shape
    if d_w != d or tok.shape != (t,) or eid.shape != (t,):
        raise ValueError(f"moe dispatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, tok {tuple(tok.shape)}, eid "
                         f"{tuple(eid.shape)} do not fit together")
    tok, eid = tok.to(torch.int32), eid.to(torch.int32)
    spec = launch_spec(t, d, f, n_experts, tok, eid, x.dtype)
    emit(spec)
    if _build.on_card(x, w, tok, eid):
        if d % 128 or f % 128:
            raise ValueError(f"moe dispatch on CUDA needs D and F multiples "
                             f"of 128, got D={d}, F={f}")
        return moe_grouped_gemm(spec, x, w, tok, eid)
    return moe_dispatch_sorted_ref(x, w, tok, eid)


def moe_dispatch(x: torch.Tensor, w: torch.Tensor,
                 expert_ids: torch.Tensor) -> torch.Tensor:
    """Unsorted entry: sorts the tokens by expert (stable), then
    dispatches.  ``expert_ids``: [T] expert of each token (top-1)."""
    order = torch.argsort(expert_ids, stable=True)
    return moe_dispatch_sorted(x, w, order, expert_ids[order])
