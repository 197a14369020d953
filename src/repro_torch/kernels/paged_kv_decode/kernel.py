"""Paged-KV decode attention as a CUDA kernel (``csrc/paged_kv_decode.cu``).

Replaces ``paged_decode_attention`` of
``repro/kernels/paged_kv_decode/kernel.py``.  :func:`paged_decode_cuda`
launches from the spec: the spec's sequential page grid ``(n_active,)`` is
cut into ranges of consecutive table entries (``plan.split_plan``), one
block walks each range in table order for each head group
(``plan.head_groups``), and a second launch combines the blocks' partials
in split order; one range writes the output directly.  Every H >= 1, every
D % 8 == 0 up to ``plan.MAX_HEAD_DIM`` and every page size is taken, in
float32 or bfloat16; float16, which the kernel is not built for, raises
and names ROADMAP.md.  A strided or unaligned input is read through one
dense copy (``_build.dense``, counted on ``paged_decode_cuda.copies``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build
from .plan import lanes_vec, split_plan

__all__ = ["paged_decode_cuda", "smem_bytes", "MAX_SMEM_BYTES",
           "DTYPES"]

DTYPES = (torch.float32, torch.bfloat16)   # the kernel's instances

MAX_SMEM_BYTES = 232_448   # dynamic shared memory one Hopper block may use


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
    pages per split): that of a block of one head group."""
    return int(_smem_fn()(_build.DTYPE_CODES[dtype], h, d, page, per_split))


def paged_decode_cuda(spec: LaunchSpec, q: torch.Tensor,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      page_table: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: q [H, D]; pools [P, page, D];
    page_table [n] int32 -> [H, D].  An entry outside [0, P) traps in the
    kernel, so the launch fails (raised at the next synchronize)."""
    if not _build.on_card(q, k_pages, v_pages, page_table):
        raise ValueError("paged_decode_cuda takes CUDA tensors")
    code = _build.dtype_code(q, k_pages, v_pages)
    if q.dtype not in DTYPES:
        raise ValueError(f"paged decode kernel takes {list(DTYPES)}, got "
                         f"{q.dtype} (other dtypes: ROADMAP.md, queue 2)")
    h, d = q.shape
    n_pages, page, _ = k_pages.shape
    n_active = spec.grid[0]
    if (page_table.dtype != torch.int32 or page_table.shape != (n_active,)
            or v_pages.shape != k_pages.shape):
        raise ValueError("paged_decode_cuda: expected equal K/V pools and "
                         "an [n] int32 table")
    q, k_pages, v_pages, page_table = (
        _build.dense(t, paged_decode_cuda)
        for t in (q, k_pages, v_pages, page_table))
    lanes_vec(d)   # raises on a head width no instance takes
    per, n_splits = split_plan(n_active, page, d, h, q.element_size(),
                               n_sm=_build.sm_count(q))
    need = smem_bytes(q.dtype, h, d, page, per)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"(H={h}, D={d}, page={page}, {per} pages a split) "
                         f"needs {need} bytes of shared memory; a block has "
                         f"{MAX_SMEM_BYTES} (a longer table: ROADMAP.md, "
                         f"queue 2)")
    out = torch.empty_like(q)
    part = (torch.empty(n_splits * h * (d + 2), dtype=torch.float32,
                        device=q.device) if n_splits > 1 else None)
    err = _launch_fn()(
        code, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), n_pages, h, d, page,
        n_active, per, n_splits, d ** -0.5, _build.stream_ptr(q))
    _build.check("paged_kv_decode", err)
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0
paged_decode_cuda.copies = 0
