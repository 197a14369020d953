"""Plain PyTorch version of flash attention (counterpart of
``repro.kernels.flash_attention.ref``).

Materialized-scores softmax attention with GQA and an optional causal
mask: scores in f32 (after the dtype's own product), masked with -1e30,
softmax weights cast back to the input dtype for the second product.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, D]; k, v: [B, Sk, G, D] with H = G * rep."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    qh = q.reshape(b, sq, g, rep, d)
    scale = d ** -0.5
    scores = torch.einsum("bsgrd,btgd->bgrst", qh, k).float() * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(qpos >= kpos, scores,
                             torch.full((), -1e30, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v)
    return out.reshape(b, sq, h, d)
