"""Paged-KV decode entry point (counterpart of
``repro.kernels.paged_kv_decode.ops``).

The launch spec is the reference's: grid ``(n_active,)``; the int32 page
table read once; q ``[H, D]`` resident (constant block index); step ``i``
moves page ``page_table[i]`` of the K and V pools in (``[1, page, D]``
blocks); the output written once.  The reference decides on D % 128 == 0
between kernel and oracle; here a CUDA tensor outside it raises.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import paged_decode_attention
from .ref import paged_decode_ref

__all__ = ["paged_decode", "launch_spec", "decode_flops"]

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


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor,
                 page_table: torch.Tensor) -> torch.Tensor:
    """q: [H, D]; pools [P, page, D]; page_table [n] -> [H, D]."""
    h, d = q.shape
    n_pages, page, _ = k_pages.shape
    page_table = page_table.to(torch.int32)
    spec = launch_spec(h, d, n_pages, page, page_table, q.dtype)
    emit(spec)
    if _build.on_card(q, k_pages, v_pages, page_table):
        if d % 128:
            raise ValueError(f"paged decode on CUDA needs D % 128 == 0, "
                             f"got D={d}")
        return paged_decode_attention(spec, q, k_pages, v_pages, page_table)
    return paged_decode_ref(q, k_pages, v_pages, page_table)
