"""Flash attention forward as CUDA kernels (``csrc/flash_attention.cu``).

Replaces ``flash_attention`` of ``repro/kernels/flash_attention/kernel.py``.
:func:`flash_attention` launches one block per ``(b*h, 128-row q tile)``
(times the kv ranges of a split), each looping its kv rows itself; the
spec's tiles are the reference's and only set what the trace walk
replays.  The kernels read q, k and v in their [B, S, heads, D] layout, so
no transpose is materialized.  The dtype picks the kernel
(:func:`kernel_path`): bf16 runs ``flash_fwd_sm90`` on the tensor cores
(``wgmma``, TMA), float32 ``flash_fwd_kernel`` on the CUDA cores, its kv
axis cut into ranges by ``plan.split_plan`` (one range writes the output;
several write f32 partials into scratch that ``flash_combine`` folds).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build
from .plan import split_plan

__all__ = ["flash_attention", "kernel_path", "HEAD_DIMS", "SM90_BLOCK"]

HEAD_DIMS = (64, 128)   # head widths the kernels are instantiated for
SM90_BLOCK = 128        # bf16: the q and kv tile rows flash_fwd_sm90 walks

# Which kernel a launch takes, by dtype.
PATHS = {torch.float32: "flash_fwd_kernel", torch.bfloat16: "flash_fwd_sm90"}


def kernel_path(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> str:
    """The kernel that takes a launch of this dtype, head width and spec
    tiles; raises on a launch neither kernel takes.  Neither kernel reads
    the spec's tiles (the f32 kernel walks 128-row q tiles and 64-row kv
    chunks, flash_fwd_sm90 128-row tiles of both), so every tile
    ``ops.launch_spec`` gives is taken; the card path's Sq, Sk multiples of
    128 keep the kernels' own tiles whole."""
    if dtype not in PATHS:
        raise ValueError(f"flash_attention kernel takes {list(PATHS)}, "
                         f"got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got D={d}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"flash_attention takes positive tiles; got "
                         f"block_q={block_q}, block_k={block_k}")
    return PATHS[dtype]


@functools.cache
def _fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(
        "flash_attention", "flash_attention_launch",
        [i, v, v, v, v, v, i, i, i, i, i, i, i, i, i, ctypes.c_float, i, i,
         v])


def flash_attention(spec: LaunchSpec, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: q [B, Sq, H, D], k and v
    [B, Sk, G, D] -> [B, Sq, H, D]."""
    if not _build.on_card(q, k, v):
        raise ValueError("flash_attention takes CUDA tensors")
    code = _build.dtype_code(q, k, v)
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    bq = spec.operand("q").block_shape[1]
    bk = spec.operand("k").block_shape[1]
    path = kernel_path(q.dtype, d, bq, bk)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous, 16-byte "
                         "aligned inputs")
    per, n_splits = (split_plan(b, h, sq, sk, n_sm=_build.sm_count(q))
                     if path == "flash_fwd_kernel" else (sk, 1))
    out = torch.empty_like(q)
    part = (torch.empty(n_splits * b * sq * h * (d + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    err = _fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), None if part is None else part.data_ptr(),
                b, sq, sk, h, g, d, bq, bk, int(causal), d ** -0.5, per,
                n_splits, _build.stream_ptr(q))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[path] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys(PATHS.values(), 0)
