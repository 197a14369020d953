"""Flash attention forward as a CUDA kernel (``csrc/flash_attention.cu``).

Replaces ``flash_attention`` of ``repro/kernels/flash_attention/kernel.py``.
:func:`flash_attention` launches from the spec: one block per
``(b*h, q tile)`` of the spec's grid ``(b*h, n_q, n_kv)``, looping the
spec's ``n_kv`` axis inside the block.  The kernel reads q, k and v in
their [B, S, heads, D] layout, so no transpose is materialized.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["flash_attention", "HEAD_DIMS", "MAX_BLOCK_Q", "KV_CHUNK"]

HEAD_DIMS = (64, 128)   # head widths the kernel is instantiated for
MAX_BLOCK_Q = 128       # q-tile rows one block holds
KV_CHUNK = 32           # kv rows staged per step; block_k must divide by it


@functools.cache
def _fn():
    v, i = ctypes.c_void_p, ctypes.c_int
    return _build.bind(
        "flash_attention", "flash_attention_launch",
        [i, v, v, v, v, i, i, i, i, i, i, i, i, i, ctypes.c_float, v])


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
    if (d not in HEAD_DIMS or bq > MAX_BLOCK_Q or bk % KV_CHUNK
            or not all(t.is_contiguous() for t in (q, k, v))):
        raise ValueError(
            f"flash_attention kernel takes contiguous inputs with D in "
            f"{HEAD_DIMS}, block_q <= {MAX_BLOCK_Q} and block_k a multiple "
            f"of {KV_CHUNK}; got D={d}, block_q={bq}, block_k={bk}")
    out = torch.empty_like(q)
    err = _fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, sq, sk, h, g, d, bq, bk, int(causal),
                d ** -0.5, _build.stream_ptr(q))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
