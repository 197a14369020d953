"""Plain PyTorch version of the token gather (counterpart of
``repro.kernels.token_gather.ref``)."""

from __future__ import annotations

import torch

__all__ = ["gather_rows_ref"]


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: [N, D]; idx: [M] integer -> [M, D]."""
    return table[idx.long()]
