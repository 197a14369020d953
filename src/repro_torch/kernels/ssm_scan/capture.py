"""Capture hook: an SSM scan launch's geometry as a ``GridCapture``
(counterpart of ``repro.kernels.ssm_scan.capture``).

Sequence-parallel SSM layers shard the time axis across cores, so a
thread's capture is the chunk walk over its ``seq_len / cores`` slice, at
least one chunk, as for STREAM.  The hook launches the scan on a seeded
[t_thread, D] input with dt in (0.95, 0.999), the reference's precision
regime, and walks the spec it launched: the state never appears in it.
"""

from __future__ import annotations

import torch

from repro_torch.capture.grid import GridCapture
from repro_torch.capture.launch import capture_launch, memoized
from repro_torch.device import resolve_device

from .ops import SSM_OPS, scan_flops, ssm_chunked_scan, ssm_ema_scan

__all__ = ["capture", "scan_flops", "SSM_OPS"]


def capture(op: str, *, seq_len: int, d: int, n: int = 128,
            chunk: int = 128, cores: int = 1,
            device: str | torch.device = "cuda") -> GridCapture:
    """Per-thread geometry for one SSM scan over ``seq_len / cores``."""
    if op not in SSM_OPS:
        raise ValueError(f"unknown ssm op {op!r}; expected {SSM_OPS}")
    if seq_len % chunk:
        raise ValueError(f"seq_len {seq_len} not a multiple of chunk {chunk}")
    if d % 128:
        raise ValueError(f"d {d} must be a multiple of 128 (lane dim)")
    t_thread = max(chunk, seq_len // max(1, cores) // chunk * chunk)
    dev = resolve_device(device)
    return memoized(("ssm_scan", op, t_thread, d, n, chunk, str(dev)),
                    lambda: _launch(op, t_thread, d, n, chunk, dev))


def _launch(op: str, t: int, d: int, n: int, chunk: int,
            dev: torch.device) -> GridCapture:
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(t, d, generator=gen, device=dev)
    dt = 0.95 + 0.049 * torch.rand(t, d, generator=gen, device=dev)
    if op == "ema":
        g = torch.randn(t, d, generator=gen, device=dev)
        return capture_launch(lambda: ssm_ema_scan(x, dt, g, chunk=chunk),
                              dev)
    b = torch.randn(t, n, generator=gen, device=dev) / n ** 0.5
    c = torch.randn(t, n, generator=gen, device=dev)
    return capture_launch(
        lambda: ssm_chunked_scan(x, dt, b, c, chunk=chunk), dev)
