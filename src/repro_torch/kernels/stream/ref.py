"""Plain PyTorch versions of the STREAM kernels (counterpart of
``repro.kernels.stream.ref``).

The scalar ``q`` is cast to the array's dtype first, as the reference
kernel does, and each op rounds to the array's dtype op by op.
"""

from __future__ import annotations

import torch

__all__ = ["copy_ref", "scale_ref", "add_ref", "triad_ref"]


def _scalar(q, a: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(q, dtype=a.dtype, device=a.device)


def copy_ref(a: torch.Tensor) -> torch.Tensor:
    return a.clone()


def scale_ref(a: torch.Tensor, q) -> torch.Tensor:
    return _scalar(q, a) * a


def add_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def triad_ref(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return a + _scalar(q, a) * b
