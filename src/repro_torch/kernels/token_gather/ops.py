"""Token-gather entry point (counterpart of
``repro.kernels.token_gather.ops``).

The launch spec is the reference's: grid ``(m,)``; the int32 index vector
read once; step ``i`` moves table row block ``(idx[i], 0)`` of shape
``(1, D)`` in and output row ``i`` out.  The CUDA kernel takes the whole
row, so D must be a multiple of 128 (the reference's lane rule) on the
card; the plain version on a CPU tensor takes any D.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import gather_rows
from .ref import gather_rows_ref

__all__ = ["gather", "launch_spec"]


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


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: [N, D]; idx: [M] -> [M, D], out[i] = table[idx[i]]."""
    n_rows, d = table.shape
    idx = idx.to(torch.int32)
    spec = launch_spec(n_rows, d, idx, table.dtype)
    emit(spec)
    if _build.on_card(table, idx):
        if d % 128:
            raise ValueError(f"gather on CUDA needs D % 128 == 0, got D={d}")
        return gather_rows(spec, table, idx)
    return gather_rows_ref(table, idx)
