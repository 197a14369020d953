"""Paged-KV decode attention as a CUDA kernel (``csrc/paged_kv_decode.cu``).

Replaces ``paged_decode_attention`` of
``repro/kernels/paged_kv_decode/kernel.py``.  :func:`paged_decode_attention`
launches from the spec: the spec's sequential page grid ``(n_active,)`` is
cut into ranges of consecutive table entries (``plan.split_plan``), one
block walks each range in table order, and a second launch combines the
blocks' partials in split order; one range writes the output directly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build
from .plan import split_plan

__all__ = ["paged_decode_attention", "smem_bytes", "MAX_SMEM_BYTES",
           "MAX_HEADS"]

MAX_SMEM_BYTES = 232_448   # dynamic shared memory one Hopper block may use
MAX_HEADS = {128: 16, 256: 8}   # head width -> grouped heads the kernel takes


@functools.cache
def _launch_fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(
        "paged_kv_decode", "paged_decode_launch",
        [i, v, v, v, v, v, v, ctypes.c_int64, i, i, i, i, i, i, ctypes.c_float,
         v])


@functools.cache
def _smem_fn():
    i = ctypes.c_int
    return _build.bind("paged_kv_decode", "paged_decode_smem_bytes",
                       [i, i, i, i, i], ctypes.c_int64)


def smem_bytes(dtype: torch.dtype, h: int, d: int, page: int,
               per_split: int) -> int:
    """Shared memory the split kernel asks for at one (dtype, H, D, page,
    pages per split)."""
    return int(_smem_fn()(_build.DTYPE_CODES[dtype], h, d, page, per_split))


def paged_decode_attention(spec: LaunchSpec, q: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           page_table: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: q [H, D]; pools [P, page, D];
    page_table [n] int32 -> [H, D].  An entry outside [0, P) traps in the
    kernel, so the launch fails (raised at the next synchronize)."""
    if not _build.on_card(q, k_pages, v_pages, page_table):
        raise ValueError("paged_decode_attention takes CUDA tensors")
    code = _build.dtype_code(q, k_pages, v_pages)
    h, d = q.shape
    n_pages, page, _ = k_pages.shape
    n_active = spec.grid[0]
    if (page_table.dtype != torch.int32 or page_table.shape != (n_active,)
            or v_pages.shape != k_pages.shape
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16
            or not all(t.is_contiguous()
                       for t in (q, k_pages, v_pages, page_table))):
        raise ValueError("paged_decode_attention: expected contiguous "
                         "inputs, equal 16-byte aligned K/V pools and an [n] "
                         "int32 table")
    if h > MAX_HEADS.get(d, 0):
        raise ValueError(f"paged decode kernel takes D in {list(MAX_HEADS)} "
                         f"with up to {MAX_HEADS} heads; got H={h}, D={d}")
    per, n_splits = split_plan(n_active, page, d, h, q.element_size(),
                               n_sm=_build.sm_count(q))
    need = smem_bytes(q.dtype, h, d, page, per)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"(H={h}, D={d}, page={page}, {per} pages a split) "
                         f"needs {need} bytes of shared memory; a block has "
                         f"{MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    part = (torch.empty(n_splits * h * (d + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    err = _launch_fn()(
        code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), n_pages, h, d, page,
        n_active, per, n_splits, d ** -0.5, _build.stream_ptr(q))
    _build.check("paged_kv_decode", err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
