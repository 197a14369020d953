"""Capture hook: a paged-KV decode launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.paged_kv_decode.capture``).

Decode serving parallelizes across sequences, so a thread's capture is one
sequence's page walk: ``n_active`` pages drawn without replacement from
the shared pool by the workload rng, with numpy's own ``choice`` exactly as
the reference hook draws them, or an explicit ``page_table=``.  The hook
launches one decode step over one seeded pool per (geometry, device) and
walks the spec it launched.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from .ops import decode_flops, paged_decode_attention

__all__ = ["capture", "decode_flops"]


def capture(*, n_pages: int, page: int, d: int, h: int, n_active: int,
            rng: np.random.Generator | None = None,
            page_table: np.ndarray | None = None,
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread geometry: one sequence's decode step over the pool.

    ``page_table`` overrides the rng draw with an explicit page list (the
    serving scenarios feed traffic-shaped tables through here).  Unlike
    the rng draw it may repeat pages (a prefix cache maps many sequences
    onto shared prefix pages), but every entry must index into the pool.
    """
    if d % 128:
        raise ValueError(f"d {d} must be a multiple of 128 (lane dim)")
    if n_active > n_pages:
        raise ValueError(f"n_active {n_active} exceeds pool size {n_pages}")
    if page_table is not None:
        pt = np.asarray(page_table, dtype=np.int64)
        if pt.ndim != 1 or pt.size != n_active:
            raise ValueError(f"page_table must be [{n_active}] (n_active), "
                             f"got shape {pt.shape}")
        if pt.size and (pt.min() < 0 or pt.max() >= n_pages):
            raise ValueError(f"page_table entries must be in [0, {n_pages})")
    elif rng is None:
        raise ValueError("capture needs either rng or page_table")
    else:
        pt = rng.choice(n_pages, size=n_active, replace=False).astype(np.int64)
    dev = resolve_device(device)
    return memoized(
        ("paged_kv_decode", n_pages, page, d, h, pt.tobytes(), str(dev)),
        lambda: _launch(n_pages, page, d, h, pt, dev))


@functools.lru_cache(maxsize=1)
def _pools(n_pages: int, page: int, d: int,
           dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """One seeded K/V pool pair per geometry (the roster and the serving
    windows walk many page tables over the same pool)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return (torch.randn(n_pages, page, d, generator=gen, device=dev),
            torch.randn(n_pages, page, d, generator=gen, device=dev))


def _launch(n_pages: int, page: int, d: int, h: int, pt: np.ndarray,
            dev: torch.device) -> GridCapture:
    k_pages, v_pages = _pools(n_pages, page, d, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(h, d, generator=gen, device=dev)
    pt_t = torch.from_numpy(pt.astype(np.int32)).to(dev)
    return capture_launch(
        lambda: paged_decode_attention(q, k_pages, v_pages, pt_t), dev)
