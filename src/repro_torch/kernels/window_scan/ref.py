"""Plain PyTorch version of the simulator's window count (counterpart of
the reference's jitted ``_jax_window_kernel``,
``repro/core/cachesim_vec.py:324-330``)."""

from __future__ import annotations

import torch

__all__ = ["window_counts_ref"]


def window_counts_ref(q: torch.Tensor, lo: torch.Tensor, thr: torch.Tensor,
                      span: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per row r: the count of j in [0, chunk) with j < span[r] and
    q[min(lo[r] + j, m - 1)] <= thr[r].  q: [m]; lo, thr, span: [rows];
    returns [rows] in q's dtype."""
    offs = torch.arange(int(chunk), dtype=torch.int64, device=q.device)
    idx = torch.clamp(lo.long()[:, None] + offs[None, :], max=q.shape[0] - 1)
    hit = (q[idx] <= thr[:, None]) & (offs[None, :] < span.long()[:, None])
    return hit.sum(dim=1).to(q.dtype)
