"""The SSM scans as CUDA kernels (``csrc/ssm_ema_scan.cu``,
``csrc/ssm_chunked_scan.cu``).

Replace ``ssm_ema_scan`` and ``ssm_chunked_scan`` of
``repro/kernels/ssm_scan/kernel.py``, whose grids walk the time chunks in
order with the state in VMEM scratch.  Hopper blocks run in no order, so
here the chunk axis is a loop inside each block and the blocks split the
channels: :func:`ssm_ema_cuda` runs one thread per channel,
:func:`ssm_chunked_cuda` one block per tile of channels, its [N, tile]
state in registers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["ssm_ema_cuda", "ssm_chunked_cuda", "STATE_WIDTHS"]

# State widths N the chunked kernel takes (16 state rows per thread,
# N / 16 threads per channel, a power of two within one warp).
STATE_WIDTHS = (16, 32, 64, 128, 256)


@functools.cache
def _ema_fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ssm_ema_scan", "ssm_ema_launch",
                       [i, v, v, v, v, i, i, v])


@functools.cache
def _chunked_fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ssm_chunked_scan", "ssm_chunked_launch",
                       [i, v, v, v, v, v, i, i, i, v])


def _check(name: str, shapes: dict, tensors: dict) -> None:
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key] or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous "
                             f"{shapes[key]} tensor, got {tuple(t.shape)}")


def ssm_ema_cuda(spec: LaunchSpec, x: torch.Tensor, dt: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """Launch the EMA scan on CUDA tensors x, dt, g [T, D] -> y [T, D]."""
    if not _build.on_card(x, dt, g):
        raise ValueError("ssm_ema_cuda takes CUDA tensors")
    code = _build.dtype_code(x, dt, g)
    t, d = spec.operand("x").shape
    _check("ssm_ema_cuda", {"x": (t, d), "dt": (t, d), "g": (t, d)},
           {"x": x, "dt": dt, "g": g})
    y = torch.empty_like(x)
    err = _ema_fn()(code, x.data_ptr(), dt.data_ptr(), g.data_ptr(),
                    y.data_ptr(), t, d, _build.stream_ptr(x))
    _build.check("ssm_ema_scan", err)
    ssm_ema_cuda.launches += 1
    return y


def ssm_chunked_cuda(spec: LaunchSpec, x: torch.Tensor, dt: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the state-expanded scan on CUDA tensors x, dt [T, D] and
    b, c [T, N] -> y [T, D]."""
    if not _build.on_card(x, dt, b, c):
        raise ValueError("ssm_chunked_cuda takes CUDA tensors")
    code = _build.dtype_code(x, dt, b, c)
    t, d = spec.operand("x").shape
    n = spec.operand("b").shape[1]
    if n not in STATE_WIDTHS:
        raise ValueError(f"ssm chunked kernel takes N in {STATE_WIDTHS}, "
                         f"got N={n}")
    _check("ssm_chunked_cuda",
           {"x": (t, d), "dt": (t, d), "b": (t, n), "c": (t, n)},
           {"x": x, "dt": dt, "b": b, "c": c})
    y = torch.empty_like(x)
    err = _chunked_fn()(code, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                        c.data_ptr(), y.data_ptr(), t, d, n,
                        _build.stream_ptr(x))
    _build.check("ssm_chunked_scan", err)
    ssm_chunked_cuda.launches += 1
    return y


ssm_ema_cuda.launches = 0
ssm_chunked_cuda.launches = 0
