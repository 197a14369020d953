"""Flash-attention entry point (counterpart of
``repro.kernels.flash_attention.ops``).

The launch spec is the reference's: heads folded into the leading grid
axis, grid ``(b*h, n_q, n_kv)`` with the kv axis innermost, ``[1, bq, D]``
q/o tiles mapped on ``qi`` and ``[1, bk, D]`` k/v tiles mapped on ``ki``
(query head ``h`` reads kv head ``h // (H/G)``), ``bq = min(block_q, Sq)``
and ``bk = min(block_k, Sk)``.  The reference's ``mha`` guard (sequence
lengths multiples of 128, a head width the kernel takes) decides between
kernel and oracle on the TPU; here a CUDA tensor outside it raises, and
the plain version serves CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import HEAD_DIMS, flash_attention
from .ref import attention_ref

__all__ = ["mha", "launch_spec", "SOFTMAX_OPS_PER_SCORE"]

# Softmax/online-update vector ops per score element (exp, max, scale, two
# fused multiply-adds) on top of the two bq x bk x d products.
SOFTMAX_OPS_PER_SCORE = 6.0


def launch_spec(b: int, sq: int, sk: int, h: int, g: int, d: int,
                dtype: torch.dtype, *, block_q: int = 128,
                block_k: int = 128) -> LaunchSpec:
    """The launch geometry of one attention call.  ``flops`` counts every
    grid step (the schedule the walker replays) at the reference's hand
    formula."""
    if h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    rep = h // g
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq lens {(sq, sk)} not multiples of {(bq, bk)}")
    n_q, n_kv = sq // bq, sk // bk

    def q_map(bh, qi, ki):
        return (bh, qi, 0)

    def kv_map(bh, qi, ki):
        return ((bh // h) * g + (bh % h) // rep, ki, 0)

    qo = dict(shape=(b * h, sq, d), block_shape=(1, bq, d), dtype=dtype,
              index_map=q_map)
    kv = dict(shape=(b * g, sk, d), block_shape=(1, bk, d), dtype=dtype,
              index_map=kv_map)
    steps = b * h * n_q * n_kv
    return LaunchSpec(
        name="flash_attention",
        grid=(b * h, n_q, n_kv),
        operands=(
            LaunchOperand(name="q", role="in", **qo),
            LaunchOperand(name="k", role="in", **kv),
            LaunchOperand(name="v", role="in", **kv),
            LaunchOperand(name="o", role="out", **qo),
        ),
        flops=steps * (4.0 * bq * bk * d + SOFTMAX_OPS_PER_SCORE * bq * bk),
    )


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, block_q: int = 128,
        block_k: int = 128) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, G, D] (GQA) -> [B, Sq, H, D]."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    spec = launch_spec(b, sq, sk, h, g, d, q.dtype, block_q=block_q,
                       block_k=block_k)
    emit(spec)
    if _build.on_card(q, k, v):
        if sq % 128 or sk % 128 or d not in HEAD_DIMS:
            raise ValueError(
                f"flash attention on CUDA needs Sq and Sk multiples of 128 "
                f"and D in {HEAD_DIMS}; got Sq={sq}, Sk={sk}, D={d}")
        return flash_attention(spec, q, k, v, causal=causal)
    return attention_ref(q, k, v, causal=causal)
