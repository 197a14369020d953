"""Capture hook: a flash-attention launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.flash_attention.capture``).

Two strong-scaling partitions, as multi-core attention is decomposed:

- ``partition="q"``  — query tiles are split across cores; K/V are read by
  every core (shared data -> ``l3_factor`` 1.0 upstream).
- ``partition="kv"`` — the KV sequence is split flash-decoding style; each
  core sweeps its private chunk for every query tile.

The hook launches one head over the per-thread sequence slice, non-causal
(the reference's capture schedule: its causal guard gates compute, not the
pipeline's copies), and walks the spec it launched.  ``flops`` is the
reference's hand formula over the per-thread grid.
"""

from __future__ import annotations

import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from .ops import mha

__all__ = ["capture"]


def capture(*, sq: int, sk: int, d: int, bq: int = 128, bk: int = 128,
            cores: int = 1, partition: str = "q",
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread geometry for one head of flash attention."""
    if sq % bq or sk % bk:
        raise ValueError(f"seq lens {(sq, sk)} not multiples of {(bq, bk)}")
    n_q, n_kv = sq // bq, sk // bk
    if partition == "q":
        n_q = max(1, n_q // max(1, cores))
    elif partition == "kv":
        n_kv = max(1, n_kv // max(1, cores))
    else:
        raise ValueError(f"partition must be 'q'|'kv', got {partition!r}")
    sq_t, sk_t = n_q * bq, n_kv * bk
    dev = resolve_device(device)
    return memoized(("flashattn", sq_t, sk_t, d, bq, bk, str(dev)),
                    lambda: _launch(sq_t, sk_t, d, bq, bk, dev))


def _launch(sq_t: int, sk_t: int, d: int, bq: int, bk: int,
            dev: torch.device) -> GridCapture:
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, sq_t, 1, d, generator=gen, device=dev)
    k = torch.randn(1, sk_t, 1, d, generator=gen, device=dev)
    v = torch.randn(1, sk_t, 1, d, generator=gen, device=dev)
    return capture_launch(
        lambda: mha(q, k, v, causal=False, block_q=bq, block_k=bk), dev)
