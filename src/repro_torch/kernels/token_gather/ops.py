"""Token-gather entry points (counterpart of
``repro.kernels.token_gather.ops``).

The launch spec is the reference's: grid ``(m,)``; the int32 index vector
read once; step ``i`` moves table row block ``(idx[i], 0)`` of shape
``(1, D)`` in and output row ``i`` out.

:func:`gather_rows` is the reference's kernel-level entry and always
emits that spec.  :func:`gather` is the reference's dispatcher: it is
:func:`gather_rows` where the reference runs its kernel (D % 128 == 0),
and elsewhere emits no spec, as the reference's oracle launches no Pallas
kernel.  Either way a CUDA tensor runs the kernel, which takes every
D >= 1; the plain version serves CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import gather_rows_cuda
from .ref import gather_rows_ref

__all__ = ["gather_rows", "gather", "launch_spec"]


def launch_spec(n_rows: int, d: int, idx: torch.Tensor,
                dtype: torch.dtype) -> LaunchSpec:
    """The launch geometry of gathering ``idx`` rows of an [n_rows, d]
    table."""
    m = int(idx.shape[0])
    return LaunchSpec(
        name="token_gather",
        grid=(m,),
        operands=(
            LaunchOperand(name="idx", role="index", shape=(m,),
                          block_shape=(m,), dtype=torch.int32,
                          index_map=lambda i: (0,)),
            LaunchOperand(name="table", role="in", shape=(n_rows, d),
                          block_shape=(1, d), dtype=dtype,
                          index_map=lambda i, idx: (int(idx[i]), 0),
                          steered=True),
            LaunchOperand(name="out", role="out", shape=(m, d),
                          block_shape=(1, d), dtype=dtype,
                          index_map=lambda i: (i, 0)),
        ),
        flops=0.0,  # pure data movement
        index=(idx,),
    )


def _gather(spec: LaunchSpec, table: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    if _build.on_card(table, idx):
        return gather_rows_cuda(spec, table, idx)
    return gather_rows_ref(table, idx)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's kernel-level entry: table [N, D]; idx [M] -> [M, D],
    out[i] = table[idx[i]], emitting the launch spec."""
    idx = idx.to(torch.int32)
    spec = launch_spec(*table.shape, idx, table.dtype)
    emit(spec)
    return _gather(spec, table, idx)


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's ``gather``: :func:`gather_rows` where the reference
    runs its kernel (D % 128 == 0), else the same gather with no launch
    spec."""
    if table.shape[-1] % 128 == 0:
        return gather_rows(table, idx)
    idx = idx.to(torch.int32)
    return _gather(launch_spec(*table.shape, idx, table.dtype), table, idx)
