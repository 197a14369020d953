"""Capture hook: a paged-KV decode launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.paged_kv_decode.capture``).

Decode serving parallelizes across sequences, so a thread's capture is one
sequence's page walk: ``n_active`` pages drawn without replacement from
the shared pool by the workload rng, with numpy's own ``choice`` exactly as
the reference hook draws them.  The hook launches one decode step over a
seeded pool (the active pages hold seeded values; the rest of the pool is
never read) and walks the spec it launched.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from .ops import decode_flops, paged_decode

__all__ = ["capture", "decode_flops"]


def capture(*, n_pages: int, page: int, d: int, h: int, n_active: int,
            rng: np.random.Generator,
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread geometry: one sequence's decode step over the pool."""
    if d % 128:
        raise ValueError(f"d {d} must be a multiple of 128 (lane dim)")
    if n_active > n_pages:
        raise ValueError(f"n_active {n_active} exceeds pool size {n_pages}")
    pt = rng.choice(n_pages, size=n_active, replace=False).astype(np.int64)
    dev = resolve_device(device)
    return memoized(
        ("paged_kv_decode", n_pages, page, d, h, pt.tobytes(), str(dev)),
        lambda: _launch(n_pages, page, d, h, pt, dev))


def _launch(n_pages: int, page: int, d: int, h: int, pt: np.ndarray,
            dev: torch.device) -> GridCapture:
    gen = torch.Generator(device=dev).manual_seed(0)
    pt_t = torch.from_numpy(pt.astype(np.int32)).to(dev)
    q = torch.randn(h, d, generator=gen, device=dev)
    k_pages = torch.zeros(n_pages, page, d, device=dev)
    v_pages = torch.zeros(n_pages, page, d, device=dev)
    k_pages[pt_t.long()] = torch.randn(len(pt), page, d, generator=gen,
                                       device=dev)
    v_pages[pt_t.long()] = torch.randn(len(pt), page, d, generator=gen,
                                       device=dev)
    return capture_launch(lambda: paged_decode(q, k_pages, v_pages, pt_t),
                          dev)
