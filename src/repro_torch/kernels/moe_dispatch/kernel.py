"""MoE dispatch as a CUDA kernel (``csrc/moe_dispatch.cu``).

Replaces ``moe_dispatch_sorted`` of ``repro/kernels/moe_dispatch/kernel.py``,
whose grid walks the expert-sorted token stream one token a step.
:func:`moe_grouped_gemm` makes two launches: a one-block pre-pass that
checks the token order is a permutation and builds the list of M-tiles
(runs of one expert cut into at most ``plan.block_rows`` rows) in device
memory, then a persistent grouped GEMM over (M-tile, N-tile) items, on
the tensor cores for bf16 and f16 and the CUDA cores for f32, at every D,
F >= 1 and every token count (above 1 859 584 tokens the pre-pass's
permutation check keeps its bitmap in global memory).  A strided or
unaligned input is read through one dense copy (``_build.dense``, counted
on ``moe_grouped_gemm.copies``); ``out`` is written in place and must be
dense.  :func:`tile_list_on_card` runs the pre-pass alone, to check its
list against ``plan.tile_list``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build
from .plan import launch_shape, tile_capacity

__all__ = ["moe_grouped_gemm", "tile_list_on_card"]


@functools.cache
def _fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("moe_dispatch", "moe_dispatch_launch",
                       [i, v, v, v, v, v, v, i, i, i, i, i, i, v])


@functools.cache
def _list_fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind("moe_dispatch", "moe_tile_list_launch",
                       [v, v, v, i, i, i, v])


def _tiles_scratch(t: int, device: torch.device) -> torch.Tensor:
    """The pre-pass's output: int32 count, three zeros, then the records
    (row0, rows, expert, 0), then room for a bitmap of ``t`` bits, which
    the pre-pass keeps there where it would not fit a block's shared
    memory."""
    return torch.empty(4 + 4 * tile_capacity(t) + (t + 31) // 32,
                       dtype=torch.int32, device=device)


def _check_ids(t: int, tok: torch.Tensor, eid: torch.Tensor, owner=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tok and eid, each dense (a copy counted on ``owner.copies`` where
    one is not); raises unless both are [T] int32."""
    if any(v.dtype != torch.int32 or v.shape != (t,) for v in (tok, eid)):
        raise ValueError("moe dispatch: expected [T] int32 tok and eid")
    return _build.dense(tok, owner), _build.dense(eid, owner)


def moe_grouped_gemm(spec: LaunchSpec, x: torch.Tensor, w: torch.Tensor,
                     tok: torch.Tensor, eid: torch.Tensor, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x [T, D]; w [E, D, F]; tok, eid
    [T] int32 -> y [T, F] (into ``out`` when given, e.g. one filled with
    NaN, so that a row the kernel leaves unwritten shows).  A token outside
    [0, T), an expert id outside [0, E) or a ``tok`` that is not a
    permutation of [0, T) traps in the pre-pass, so the launch fails
    (raised at the next synchronize)."""
    if not _build.on_card(x, w, tok, eid):
        raise ValueError("moe_grouped_gemm takes CUDA tensors")
    code = _build.dtype_code(x, w)
    t, d = spec.operand("x").shape
    n_experts, _, f = spec.operand("w").shape
    if x.shape != (t, d) or w.shape != (n_experts, d, f):
        raise ValueError("moe_grouped_gemm: expected x [T, D] and w "
                         "[E, D, F]")
    if out is not None and (out.shape != (t, f) or out.dtype != x.dtype
                            or out.device != x.device
                            or not _build.is_dense(out)):
        raise ValueError("moe_grouped_gemm: out must be a contiguous, "
                         "16-byte aligned [T, F] tensor like x (it is "
                         "written in place)")
    tok, eid = _check_ids(t, tok, eid, moe_grouped_gemm)
    x, w = _build.dense(x, moe_grouped_gemm), _build.dense(w, moe_grouped_gemm)
    if out is None:
        out = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    tiles = _tiles_scratch(t, x.device)
    bm, grid = launch_shape(x.dtype, t, f, n_sm=_build.sm_count(x))
    err = _fn()(code, x.data_ptr(), w.data_ptr(), tok.data_ptr(),
                eid.data_ptr(), tiles.data_ptr(), out.data_ptr(), t, d, f,
                n_experts, bm, grid, _build.stream_ptr(x))
    _build.check("moe_dispatch", err)
    moe_grouped_gemm.launches += 1
    return out


moe_grouped_gemm.launches = 0
moe_grouped_gemm.copies = 0


def tile_list_on_card(tok: torch.Tensor, eid: torch.Tensor, n_experts: int,
                      bm: int) -> torch.Tensor:
    """Run the kernel's pre-pass alone on CUDA ``tok``, ``eid`` for tiles
    of at most ``bm`` rows and return its list as int64 [n_tiles, 3] of
    (row0, rows, expert), the form of ``plan.tile_list``.  A check hook: it
    does not count as a launch of the dispatch kernel."""
    if not _build.on_card(tok, eid):
        raise ValueError("tile_list_on_card takes CUDA tensors")
    t = tok.shape[0]
    tok, eid = _check_ids(t, tok, eid)
    if t == 0:
        return torch.zeros(0, 3, dtype=torch.long)
    tiles = _tiles_scratch(t, tok.device)
    err = _list_fn()(tok.data_ptr(), eid.data_ptr(), tiles.data_ptr(), t,
                     n_experts, bm, _build.stream_ptr(tok))
    _build.check("moe_dispatch", err)
    buf = tiles.cpu()
    count = int(buf[0])
    return buf[4:4 + 4 * count].view(count, 4)[:, :3].long()
