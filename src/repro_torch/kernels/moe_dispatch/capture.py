"""Capture hook: an MoE dispatch launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.moe_dispatch.capture``).

Expert-parallel serving shards the token batch across cores, so a
thread's capture is its own ``n_tokens`` slice with thread-private top-1
expert assignments over the shared expert table.  The draws are the
reference hook's, in its order: the sorted expert ids (from
``expert_ids=`` when given, else from ``rng``), then the token order
``rng.permutation(n_tokens)``.  They are drawn before any memo lookup,
because the serving roster shares one rng across a window's captures.
The hook launches the dispatch on one seeded x/w per (geometry, device)
and walks the spec it launched.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from .ops import dispatch_flops, moe_dispatch_sorted

__all__ = ["capture", "dispatch_flops"]


def capture(*, n_tokens: int, d: int, f: int, n_experts: int,
            rng: np.random.Generator,
            expert_ids: np.ndarray | None = None,
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread geometry: dispatch ``n_tokens`` over ``n_experts``.

    ``expert_ids`` overrides the rng's assignment draw with an explicit
    per-token expert list (the serving scenarios feed traffic-shaped
    routing through here); the hook still sorts it and still draws the
    token order from ``rng``.
    """
    if d % 128 or f % 128:
        raise ValueError(f"d {d} / f {f} must be multiples of 128 (lanes)")
    if expert_ids is not None:
        eid = np.asarray(expert_ids, dtype=np.int64)
        if eid.ndim != 1 or eid.size != n_tokens:
            raise ValueError(f"expert_ids must be [{n_tokens}] (n_tokens), "
                             f"got shape {eid.shape}")
        if eid.size and (eid.min() < 0 or eid.max() >= n_experts):
            raise ValueError(f"expert_ids entries must be in [0, {n_experts})")
        eid = np.sort(eid)
    else:
        eid = np.sort(rng.integers(0, n_experts, size=n_tokens, dtype=np.int64))
    tok = rng.permutation(n_tokens).astype(np.int64)
    dev = resolve_device(device)
    return memoized(
        ("moe_dispatch", n_tokens, d, f, n_experts, tok.tobytes(),
         eid.tobytes(), str(dev)),
        lambda: _launch(n_tokens, d, f, n_experts, tok, eid, dev))


@functools.lru_cache(maxsize=2)
def _tables(n_tokens: int, d: int, f: int, n_experts: int,
            dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """One seeded activation batch and expert table per geometry."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n_tokens, d, generator=gen, device=dev)
    w = torch.randn(n_experts, d, f, generator=gen, device=dev) / d ** 0.5
    return x, w


def _launch(n_tokens: int, d: int, f: int, n_experts: int, tok: np.ndarray,
            eid: np.ndarray, dev: torch.device) -> GridCapture:
    x, w = _tables(n_tokens, d, f, n_experts, dev)
    tok_t = torch.from_numpy(tok.astype(np.int32)).to(dev)
    eid_t = torch.from_numpy(eid.astype(np.int32)).to(dev)
    return capture_launch(lambda: moe_dispatch_sorted(x, w, tok_t, eid_t),
                          dev)
