"""Flash attention forward as CUDA kernels (``csrc/flash_attention.cu``).

Replaces ``flash_attention`` of ``repro/kernels/flash_attention/kernel.py``.
:func:`flash_attention_cuda` launches one block per ``(b*h, 128-row q tile)``
(times the kv ranges of a split), each looping its kv rows itself; the
spec's tiles are the reference's and only set what the trace walk
replays.  The kernels read q, k and v in their [B, S, heads, D] layout, so
no transpose is materialized.  The dtype alone picks the kernel
(:func:`kernel_path`): bf16 runs ``flash_fwd_sm90`` on the tensor cores
(``wgmma``, TMA), float32 ``flash_fwd_kernel`` on the CUDA cores, its kv
axis cut into ranges by ``plan.split_plan`` (one range writes the output;
several write f32 partials into scratch that ``flash_combine`` folds).
Each takes every head width D % 8 == 0 up to 256 through the instance
built for ``plan.padded_head_dim(D)`` (64, 128, 192 or 256), which pads
the head in shared memory alone.  Above 256 the head width picks the wide
kernels instead, ``flash_fwd_wide`` (f32, split as above, up to
``plan.MAX_HEAD_DIM`` = 1024) and ``flash_fwd_wide_sm90`` (bf16, up to
``plan.SM90_MAX_HEAD_DIM`` = 512), which deal the head's columns of O to
blocks along the grid's z; in f32 those blocks form a thread-block
cluster that also splits S, summed from the blocks' parts
(``plan.wide_f32_plan``, ``plan.wide_sm90_plan``).  Every kernel takes
any Sq, Sk >= 1: its last q tile and last kv tile may be partial (rows
past the end load as zeros, their scores are masked, their outputs never
stored).  A wider or ragged head, and float16 (which the kernels are
not built for), raise and name ROADMAP.md.  A strided or unaligned input
(a transposed [B, H, S, D] view, a slice) is read through one dense copy
(``_build.dense``, counted on ``flash_attention_cuda.copies``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build
from .plan import (MAX_HEAD_DIM, SM90_MAX_HEAD_DIM, TILED_MAX_HEAD_DIM,
                   f32_tiles, padded_head_dim, split_plan, sm90_kv_rows,
                   wide_f32_plan, wide_sm90_plan)

__all__ = ["flash_attention_cuda", "kernel_path", "head_dim_ok", "max_head_dim",
           "SM90_BLOCK"]

SM90_BLOCK = 128        # bf16: the q tile rows flash_fwd_sm90 walks

# Which kernel a launch takes, by dtype: up to TILED_MAX_HEAD_DIM, and above.
PATHS = {torch.float32: "flash_fwd_kernel", torch.bfloat16: "flash_fwd_sm90"}
WIDE_PATHS = {torch.float32: "flash_fwd_wide",
              torch.bfloat16: "flash_fwd_wide_sm90"}


def max_head_dim(dtype: torch.dtype) -> int:
    """The widest head a kernel of this dtype takes: 512 in bf16, else
    1024."""
    return SM90_MAX_HEAD_DIM if dtype == torch.bfloat16 else MAX_HEAD_DIM


def head_dim_ok(d: int, dtype: torch.dtype) -> bool:
    """A head width a kernel of this dtype takes: D % 8 == 0, 8 <= D up to
    :func:`max_head_dim`."""
    return 8 <= d <= max_head_dim(dtype) and d % 8 == 0


def kernel_path(dtype: torch.dtype, d: int, block_q: int = 128,
                block_k: int = 128) -> str:
    """The kernel that takes a launch of this dtype, head width and spec
    tiles; raises on a launch no kernel takes.  No kernel reads the spec's
    tiles (each walks its own at the padded width: ``plan.f32_tiles``,
    128-row q tiles and ``plan.sm90_kv_rows`` kv rows for flash_fwd_sm90,
    ``plan.wide_f32_plan`` and ``plan.wide_sm90_plan`` above D = 256, the
    last of each partial where Sq or Sk ends inside it), so every tile
    ``ops.launch_spec`` gives is taken, and a launch with no reference
    geometry (``spec`` None in :func:`flash_attention_cuda`) too."""
    if dtype not in PATHS:
        raise ValueError(f"flash_attention kernel takes {list(PATHS)}, "
                         f"got {dtype} (other dtypes: ROADMAP.md, queue 2)")
    if not head_dim_ok(d, dtype):
        raise ValueError(f"flash_attention kernel takes D % 8 == 0 up to "
                         f"{max_head_dim(dtype)} in {dtype}, got D={d} "
                         f"(wider or ragged heads: ROADMAP.md, queue 2)")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"flash_attention takes positive tiles; got "
                         f"block_q={block_q}, block_k={block_k}")
    return (WIDE_PATHS if d > TILED_MAX_HEAD_DIM else PATHS)[dtype]


@functools.cache
def _fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(
        "flash_attention", "flash_attention_launch",
        [i, v, v, v, v, v, i, i, i, i, i, i, i, ctypes.c_float, i, i, i, v])


def flash_attention_cuda(spec: LaunchSpec | None, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: q [B, Sq, H, D], k and v
    [B, Sk, G, D] -> [B, Sq, H, D], at any Sq, Sk >= 1.  ``spec`` is the
    reference's launch geometry where one exists (``ops.launch_spec``),
    else None; the kernels walk their own tiles either way."""
    if not _build.on_card(q, k, v):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    code = _build.dtype_code(q, k, v)
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    if spec is None:
        path = kernel_path(q.dtype, d)
    else:
        path = kernel_path(q.dtype, d, spec.operand("q").block_shape[1],
                           spec.operand("k").block_shape[1])
    if sq < 1 or sk < 1 or b < 1:
        raise ValueError(f"flash_attention takes B, Sq, Sk >= 1; got "
                         f"B={b}, Sq={sq}, Sk={sk}")
    q, k, v = (_build.dense(t, flash_attention_cuda) for t in (q, k, v))
    dp = padded_head_dim(d)
    if q.dtype == torch.float32:
        per, n_splits = split_plan(b, h, sq, sk, n_sm=_build.sm_count(q),
                                   d=dp)
        tile_k = (wide_f32_plan(dp).kv_rows if path == "flash_fwd_wide"
                  else f32_tiles(dp)[1])
    else:
        per, n_splits = sk, 1
        tile_k = (wide_sm90_plan(dp).kv_rows if path == "flash_fwd_wide_sm90"
                  else sm90_kv_rows(dp))
    out = torch.empty_like(q)
    part = (torch.empty(n_splits * b * sq * h * (d + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    err = _fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), None if part is None else part.data_ptr(),
                b, sq, sk, h, g, d, int(causal), d ** -0.5, per,
                n_splits, tile_k, _build.stream_ptr(q))
    _build.check("flash_attention", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_kernel[path] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.copies = 0
flash_attention_cuda.launches_by_kernel = dict.fromkeys(
    [*PATHS.values(), *WIDE_PATHS.values()], 0)
