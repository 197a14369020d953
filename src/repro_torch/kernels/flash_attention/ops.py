"""Flash-attention entry points (counterpart of
``repro.kernels.flash_attention.ops``).

The launch spec is the reference's: heads folded into the leading grid
axis, grid ``(b*h, n_q, n_kv)`` with the kv axis innermost, ``[1, bq, D]``
q/o tiles mapped on ``qi`` and ``[1, bk, D]`` k/v tiles mapped on ``ki``
(query head ``h`` reads kv head ``h // (H/G)``), ``bq = min(block_q, Sq)``
and ``bk = min(block_k, Sk)``.  Such a geometry exists where ``bq``
divides Sq and ``bk`` divides Sk (:func:`has_geometry`).

:func:`flash_attention` is the reference's kernel-level entry: it always
emits the spec of its tiles, and raises where they have no geometry, as
the reference's kernel asserts.  :func:`mha` is the reference's
dispatcher: it is :func:`flash_attention` where the reference runs its
kernel (Sq % 128 == 0, Sk % 128 == 0 and D % 8 == 0), and elsewhere emits
no spec, as the reference's oracle launches no Pallas kernel.  Either way
a CUDA tensor runs the kernels, which take every Sq, Sk >= 1, and raises
only at a head width they do not take (D % 8 != 0, D above 1024, 512 in
bf16), naming ROADMAP.md; the plain version serves CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from .kernel import flash_attention_cuda, head_dim_ok, max_head_dim
from .ref import attention_ref

__all__ = ["flash_attention", "mha", "launch_spec", "has_geometry",
           "uses_kernel", "SOFTMAX_OPS_PER_SCORE"]

# Softmax/online-update vector ops per score element (exp, max, scale, two
# fused multiply-adds) on top of the two bq x bk x d products.
SOFTMAX_OPS_PER_SCORE = 6.0


def has_geometry(sq: int, sk: int, *, block_q: int = 128,
                 block_k: int = 128) -> bool:
    """Whether the reference's Pallas ``flash_attention`` has a launch
    geometry at these lengths and tiles: ``min(block_q, Sq)`` divides Sq
    and ``min(block_k, Sk)`` divides Sk."""
    return (sq >= 1 and sk >= 1 and sq % min(block_q, sq) == 0
            and sk % min(block_k, sk) == 0)


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
    if not has_geometry(sq, sk, block_q=block_q, block_k=block_k):
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


def _attend(spec: LaunchSpec | None, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The attention itself: the kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if _build.on_card(q, k, v):
        d = q.shape[-1]
        if not head_dim_ok(d, q.dtype):
            raise ValueError(
                f"flash attention on CUDA needs D % 8 == 0 up to "
                f"{max_head_dim(q.dtype)} in {q.dtype} (other widths: "
                f"ROADMAP.md, queue 2); got D={d}")
        return flash_attention_cuda(spec, q, k, v, causal=causal)
    return attention_ref(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """The reference's kernel-level ``flash_attention``: q [B, Sq, H, D];
    k, v [B, Sk, G, D] (GQA) -> [B, Sq, H, D].  Emits the launch spec of
    its tiles; raises where ``min(block, S)`` does not divide S."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    spec = launch_spec(b, sq, sk, h, g, d, q.dtype, block_q=block_q,
                       block_k=block_k)
    emit(spec)
    return _attend(spec, q, k, v, causal)


def uses_kernel(sq: int, sk: int, d: int) -> bool:
    """Whether the reference's ``mha`` runs its Pallas kernel: Sq % 128 ==
    0, Sk % 128 == 0 and D % 8 == 0."""
    return sq % 128 == 0 and sk % 128 == 0 and d % 8 == 0


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True) -> torch.Tensor:
    """The reference's ``mha``: q [B, Sq, H, D]; k, v [B, Sk, G, D] (GQA)
    -> [B, Sq, H, D], at every Sq, Sk >= 1.  :func:`flash_attention`,
    spec and all, where the reference runs its kernel
    (:func:`uses_kernel`); elsewhere the same attention with no spec."""
    sq, d = q.shape[1], q.shape[-1]
    if uses_kernel(sq, k.shape[1], d):
        return flash_attention(q, k, v, causal=causal)
    return _attend(None, q, k, v, causal)
