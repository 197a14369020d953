"""The SSM scans as CUDA kernels (``csrc/ssm_ema_scan.cu``,
``csrc/ssm_chunked_scan.cu``).

Replace ``ssm_ema_scan`` and ``ssm_chunked_scan`` of
``repro/kernels/ssm_scan/kernel.py``, whose grids walk the time chunks in
order with the state in VMEM scratch.  Hopper blocks run in no order, so
here the time axis is a loop inside each block and the blocks split the
channels: :func:`ssm_ema_cuda` runs one consumer thread per channel fed by
a ring of TMA (or, for rows that are not a multiple of 16 bytes, cp.async)
loads, its blocks and stages laid out by ``plan.ema_plan``;
:func:`ssm_chunked_cuda` one block per tile of channels and part of the
state, its [N, tile] state (padded to a power of two, in parts of at most
256 rows) in registers, laid out by ``plan.scan_plan``.  Both take every
D >= 1, and the chunked scan every N >= 1, in float32, bfloat16 or
float16 (the 2-byte types share their plans).  A strided or unaligned
input is read through one dense copy (``_build.dense``, counted on the
wrapper's ``copies``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build
from .plan import copy_piece, ema_plan, scan_plan, state_split

__all__ = ["ssm_ema_cuda", "ssm_chunked_cuda"]


@functools.cache
def _ema_fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ssm_ema_scan", "ssm_ema_launch",
                       [i, v, v, v, v, i, i, i, i, i, i, v])


@functools.cache
def _chunked_fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("ssm_chunked_scan", "ssm_chunked_launch",
                       [i, v, v, v, v, v, v, i, i, i, i, i, i, i, i, i, i, v])


def _dense(owner, shapes: dict, tensors: dict) -> list[torch.Tensor]:
    """The tensors, each dense (a copy counted on ``owner.copies`` where
    one is not); raises unless each has its shape."""
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{owner.__name__}: {key} must be a "
                             f"{shapes[key]} tensor, got {tuple(t.shape)}")
    return [_build.dense(t, owner) for t in tensors.values()]


def ssm_ema_cuda(spec: LaunchSpec, x: torch.Tensor, dt: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    """Launch the EMA scan on CUDA tensors x, dt, g [T, D] -> y [T, D],
    laid out by ``plan.ema_plan``."""
    if not _build.on_card(x, dt, g):
        raise ValueError("ssm_ema_cuda takes CUDA tensors")
    code = _build.dtype_code(x, dt, g)
    t, d = spec.operand("x").shape
    x, dt, g = _dense(ssm_ema_cuda, {"x": (t, d), "dt": (t, d), "g": (t, d)},
                      {"x": x, "dt": dt, "g": g})
    plan = ema_plan(t, d, x.element_size(), n_sm=_build.sm_count(x))
    y = torch.empty_like(x)
    err = _ema_fn()(code, x.data_ptr(), dt.data_ptr(), g.data_ptr(),
                    y.data_ptr(), t, d, plan.channels, plan.stage_steps,
                    plan.ring, plan.piece, _build.stream_ptr(x))
    _build.check("ssm_ema_scan", err)
    ssm_ema_cuda.launches += 1
    return y


def ssm_chunked_cuda(spec: LaunchSpec, x: torch.Tensor, dt: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the state-expanded scan on CUDA tensors x, dt [T, D] and
    b, c [T, N] -> y [T, D], laid out by ``plan.scan_plan``."""
    if not _build.on_card(x, dt, b, c):
        raise ValueError("ssm_chunked_cuda takes CUDA tensors")
    code = _build.dtype_code(x, dt, b, c)
    t, d = spec.operand("x").shape
    n = spec.operand("b").shape[1]
    x, dt, b, c = _dense(
        ssm_chunked_cuda,
        {"x": (t, d), "dt": (t, d), "b": (t, n), "c": (t, n)},
        {"x": x, "dt": dt, "b": b, "c": c})
    size = x.element_size()
    plan = scan_plan(t, d, n, size, n_sm=_build.sm_count(x))
    _, per, _ = state_split(n)
    y = torch.empty_like(x)
    part_y = (torch.empty(plan.parts * t * d, dtype=torch.float32,
                          device=x.device) if plan.parts > 1 else None)
    err = _chunked_fn()(code, x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                        c.data_ptr(), y.data_ptr(),
                        None if part_y is None else part_y.data_ptr(), t, d,
                        n, plan.rows, plan.channels, plan.stage_steps,
                        plan.state_rows, per, copy_piece(d, size),
                        copy_piece(n, size, per if plan.parts > 1 else 0),
                        _build.stream_ptr(x))
    _build.check("ssm_chunked_scan", err)
    ssm_chunked_cuda.launches += 1
    return y


ssm_ema_cuda.launches = 0
ssm_ema_cuda.copies = 0
ssm_chunked_cuda.launches = 0
ssm_chunked_cuda.copies = 0
