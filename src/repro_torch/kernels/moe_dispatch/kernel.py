"""MoE dispatch as a CUDA kernel (``csrc/moe_dispatch.cu``).

Replaces ``moe_dispatch_sorted`` of ``repro/kernels/moe_dispatch/kernel.py``,
whose grid walks the expert-sorted token stream one token a step.
:func:`moe_grouped_gemm` launches a grouped GEMM over that stream: one
block per tile of 64 consecutive sorted rows and 64 output columns; the
block reads its own slice of both index vectors.  A pre-pass on the card
checks that the token order is a permutation.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["moe_grouped_gemm"]


@functools.cache
def _fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("moe_dispatch", "moe_dispatch_launch",
                       [i, v, v, v, v, v, v, i, i, i, i, v])


def moe_grouped_gemm(spec: LaunchSpec, x: torch.Tensor, w: torch.Tensor,
                     tok: torch.Tensor, eid: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x [T, D]; w [E, D, F]; tok, eid
    [T] int32 -> y [T, F].  A token outside [0, T), an expert id outside
    [0, E) or a ``tok`` that is not a permutation of [0, T) traps in the
    kernel, so the launch fails (raised at the next synchronize)."""
    if not _build.on_card(x, w, tok, eid):
        raise ValueError("moe_grouped_gemm takes CUDA tensors")
    code = _build.dtype_code(x, w)
    t, d = spec.operand("x").shape
    n_experts, _, f = spec.operand("w").shape
    if (x.shape != (t, d) or w.shape != (n_experts, d, f)
            or any(v.dtype != torch.int32 or v.shape != (t,)
                   for v in (tok, eid))
            or not all(v.is_contiguous() for v in (x, w, tok, eid))
            or d % 32 or f % 64):
        raise ValueError("moe_grouped_gemm: expected contiguous x [T, D], "
                         "w [E, D, F] with D % 32 == 0 and F % 64 == 0, and "
                         "[T] int32 tok/eid")
    seen = torch.zeros(t, dtype=torch.int32, device=x.device)
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    err = _fn()(code, x.data_ptr(), w.data_ptr(), tok.data_ptr(),
                eid.data_ptr(), seen.data_ptr(), y.data_ptr(), t, d, f,
                n_experts,
                _build.stream_ptr(x))
    _build.check("moe_dispatch", err)
    moe_grouped_gemm.launches += 1
    return y


moe_grouped_gemm.launches = 0
