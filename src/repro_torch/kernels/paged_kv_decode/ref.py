"""Plain PyTorch version of paged-KV decode attention (counterpart of
``repro.kernels.paged_kv_decode.ref``)."""

from __future__ import annotations

import torch

__all__ = ["paged_decode_ref"]


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor,
                     page_table: torch.Tensor) -> torch.Tensor:
    """q: [H, D]; k_pages, v_pages: [P, page, D]; page_table: [n] -> [H, D].

    Gathers the active pages into one contiguous [n*page, D] KV view and
    runs dense softmax attention over it.
    """
    h, d = q.shape
    pt = page_table.long()
    k = k_pages[pt].reshape(-1, d)                  # [n*page, D]
    v = v_pages[pt].reshape(-1, d)
    s = (q @ k.T) * (d ** -0.5)                     # [H, n*page]
    p = torch.exp(s - s.max(dim=1, keepdim=True).values)
    p = p / p.sum(dim=1, keepdim=True)
    return (p @ v).to(q.dtype)
