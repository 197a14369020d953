"""STREAM copy/scale/add/triad as one CUDA kernel (``csrc/stream.cu``).

Replaces the Pallas launcher of ``repro/kernels/stream/kernel.py`` (one
``pallas_call`` for the four ops).  :func:`stream_cuda` launches from the
op's :class:`~repro_torch.capture.launch.LaunchSpec`: the kernel covers
the elements of the spec's output operand in tiles of 16-byte vectors, four
a thread, instead of one block per 512x128 tile, in float32, bfloat16 or
float16.  A strided or unaligned input is read through one dense copy
(``_build.dense``, counted on ``stream_cuda.copies``); ``out`` is written
in place, so it must be dense itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["stream_cuda", "OP_CODES"]

OP_CODES = {"copy": 0, "scale": 1, "add": 2, "triad": 3}


@functools.cache
def _fn():
    v = ctypes.c_void_p
    return _build.bind("stream", "stream_launch",
                       [ctypes.c_int, ctypes.c_int, v, v, v, ctypes.c_float,
                        ctypes.c_int64, v])


def stream_cuda(spec: LaunchSpec, op: str, a: torch.Tensor,
                b: torch.Tensor | None = None, q: float = 0.0, *,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the STREAM kernel for ``op`` on CUDA tensors; returns the
    output, shaped like ``a``: ``out`` when given, else a new tensor."""
    arrays = [a] if b is None else [a, b]
    given = [] if out is None else [out]
    if not _build.on_card(*arrays, *given):
        raise ValueError("stream_cuda takes CUDA tensors")
    code = _build.dtype_code(*arrays, *given)
    n = spec.operand("o").shape
    n_elems = n[0] * n[1]
    if any(t.numel() != n_elems for t in arrays + given):
        raise ValueError(f"stream {op}: expected {n_elems} elements, got "
                         f"{[tuple(t.shape) for t in arrays + given]}")
    if out is not None and not _build.is_dense(out):
        raise ValueError(f"stream {op}: out is written in place and must be "
                         f"contiguous and 16-byte aligned (a strided or "
                         f"unaligned out: ROADMAP.md, queue 2)")
    a, *rest = (_build.dense(t, stream_cuda) for t in arrays)
    b = rest[0] if rest else None
    if out is None:
        out = torch.empty_like(a)
    err = _fn()(OP_CODES[op], code, a.data_ptr(),
                0 if b is None else b.data_ptr(), out.data_ptr(), float(q),
                n_elems, _build.stream_ptr(a))
    _build.check("stream", err)
    stream_cuda.launches += 1
    return out


stream_cuda.launches = 0
stream_cuda.copies = 0
