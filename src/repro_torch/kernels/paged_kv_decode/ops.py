"""Paged-KV decode entry points (counterpart of
``repro.kernels.paged_kv_decode.ops``).

The launch spec is the reference's: grid ``(n_active,)``; the int32 page
table read once; q ``[H, D]`` resident (constant block index); step ``i``
moves page ``page_table[i]`` of the K and V pools in (``[1, page, D]``
blocks); the output written once.

:func:`paged_decode_attention` is the reference's kernel-level entry and
always emits that spec.  :func:`paged_decode` is the reference's
dispatcher: it is :func:`paged_decode_attention` where the reference runs
its kernel (D % 128 == 0), and elsewhere emits no spec, as the reference's
oracle launches no Pallas kernel.  Either way a CUDA tensor runs the
kernel at every H, page and D % 8 == 0 up to 512, and raises elsewhere,
naming ROADMAP.md; the plain version serves CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import paged_decode_cuda
from .plan import lanes_vec
from .ref import paged_decode_ref

__all__ = ["paged_decode_attention", "paged_decode", "launch_spec",
           "decode_flops"]

# Online-softmax vector ops per score element (exp, max, scale, two fused
# multiply-adds) on top of the two h x page x d products per page.
_SOFTMAX_OPS_PER_SCORE = 6.0


def decode_flops(*, h: int, page: int, d: int, n_active: int) -> float:
    """Arithmetic ops of one decode step over ``n_active`` pages."""
    return n_active * (4.0 * h * page * d + _SOFTMAX_OPS_PER_SCORE * h * page)


def launch_spec(h: int, d: int, n_pages: int, page: int,
                page_table: torch.Tensor, dtype: torch.dtype) -> LaunchSpec:
    """The launch geometry of one decode step over ``page_table``."""
    n_active = int(page_table.shape[0])
    kv = dict(shape=(n_pages, page, d), block_shape=(1, page, d), dtype=dtype,
              index_map=lambda i, pt: (int(pt[i]), 0, 0), steered=True)
    qo = dict(shape=(h, d), block_shape=(h, d), dtype=dtype,
              index_map=lambda i: (0, 0))
    return LaunchSpec(
        name="paged_kv_decode",
        grid=(n_active,),
        operands=(
            LaunchOperand(name="pt", role="index", shape=(n_active,),
                          block_shape=(n_active,), dtype=torch.int32,
                          index_map=lambda i: (0,)),
            LaunchOperand(name="q", role="in", **qo),
            LaunchOperand(name="k", role="in", **kv),
            LaunchOperand(name="v", role="in", **kv),
            LaunchOperand(name="o", role="out", **qo),
        ),
        flops=decode_flops(h=h, page=page, d=d, n_active=n_active),
        index=(page_table,),
    )


def _decode(spec: LaunchSpec, q: torch.Tensor, k_pages: torch.Tensor,
            v_pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The decode itself: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if _build.on_card(q, k_pages, v_pages, page_table):
        lanes_vec(q.shape[1])   # raises at a width the kernel does not take
        return paged_decode_cuda(spec, q, k_pages, v_pages, page_table)
    return paged_decode_ref(q, k_pages, v_pages, page_table)


def _spec(q: torch.Tensor, k_pages: torch.Tensor,
          page_table: torch.Tensor) -> LaunchSpec:
    h, d = q.shape
    n_pages, page, _ = k_pages.shape
    return launch_spec(h, d, n_pages, page, page_table, q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           page_table: torch.Tensor) -> torch.Tensor:
    """The reference's kernel-level entry: q [H, D]; pools [P, page, D];
    page_table [n] -> [H, D], emitting the launch spec."""
    page_table = page_table.to(torch.int32)
    spec = _spec(q, k_pages, page_table)
    emit(spec)
    return _decode(spec, q, k_pages, v_pages, page_table)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """The reference's ``paged_decode``: :func:`paged_decode_attention`
    where the reference runs its kernel (D % 128 == 0), else the same
    decode with no launch spec."""
    if q.shape[-1] % 128 == 0:
        return paged_decode_attention(q, k_pages, v_pages, page_table)
    page_table = page_table.to(torch.int32)
    return _decode(_spec(q, k_pages, page_table), q, k_pages, v_pages,
                   page_table)
