"""Flash attention forward as CUDA kernels (``csrc/flash_attention.cu``).

Replaces ``flash_attention`` of ``repro/kernels/flash_attention/kernel.py``.
:func:`flash_attention` launches from the spec: one block per
``(b*h, q tile)`` of the spec's grid ``(b*h, n_q, n_kv)``, looping the
spec's ``n_kv`` axis inside the block.  The kernels read q, k and v in
their [B, S, heads, D] layout, so no transpose is materialized.  The dtype
picks the kernel (:func:`kernel_path`): bf16 runs ``flash_fwd_sm90`` on
the tensor cores (``wgmma``, TMA), float32 ``flash_fwd_kernel`` on the
CUDA cores.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.capture.launch import LaunchSpec

from .. import _build

__all__ = ["flash_attention", "kernel_path", "HEAD_DIMS", "MAX_BLOCK_Q",
           "KV_CHUNK", "SM90_BLOCK"]

HEAD_DIMS = (64, 128)   # head widths the kernels are instantiated for
MAX_BLOCK_Q = 128       # f32: q-tile rows one block holds
KV_CHUNK = 32           # f32: kv rows staged per step; block_k divides by it
SM90_BLOCK = 128        # bf16: the q and kv tile rows flash_fwd_sm90 takes

# Which kernel a launch takes, by dtype.
PATHS = {torch.float32: "flash_fwd_kernel", torch.bfloat16: "flash_fwd_sm90"}


def kernel_path(dtype: torch.dtype, d: int, block_q: int, block_k: int) -> str:
    """The kernel that takes a launch of this dtype, head width and spec
    tiles; raises on a launch neither kernel takes."""
    if dtype not in PATHS:
        raise ValueError(f"flash_attention kernel takes {list(PATHS)}, "
                         f"got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got D={d}")
    if dtype == torch.bfloat16:
        if block_q != SM90_BLOCK or block_k != SM90_BLOCK:
            raise ValueError(
                f"flash_fwd_sm90 takes block_q = block_k = {SM90_BLOCK}; "
                f"got block_q={block_q}, block_k={block_k}")
    elif block_q > MAX_BLOCK_Q or block_k % KV_CHUNK:
        raise ValueError(
            f"flash_fwd_kernel takes block_q <= {MAX_BLOCK_Q} and block_k a "
            f"multiple of {KV_CHUNK}; got block_q={block_q}, "
            f"block_k={block_k}")
    return PATHS[dtype]


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
    path = kernel_path(q.dtype, d, bq, bk)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous, 16-byte "
                         "aligned inputs")
    out = torch.empty_like(q)
    err = _fn()(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b, sq, sk, h, g, d, bq, bk, int(causal),
                d ** -0.5, _build.stream_ptr(q))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[path] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys(PATHS.values(), 0)
