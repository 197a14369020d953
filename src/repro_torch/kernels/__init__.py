"""Hand-written CUDA kernels of the port, one package per reference family.

Each package has ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the ctypes wrapper of ``csrc/<name>.cu``, with a plain-int ``launches``
counter it bumps on every launch), ``ops.py`` (the entry point: computes
the launch spec, records it, launches the kernel for CUDA tensors and the
plain version for CPU tensors, and raises otherwise) and ``capture.py``
(the per-thread capture hook of the suite):

- ``stream``          — STREAM copy/scale/add/triad (one kernel);
- ``token_gather``    — row gather steered by an index vector;
- ``flash_attention`` — GQA attention with an online softmax;
- ``paged_kv_decode`` — one decode step over a paged KV pool;
- ``moe_dispatch``    — expert-sorted gather, per-expert GEMM, scatter;
- ``ssm_scan``        — the gated EMA scan and the state-expanded scan
  (two kernels, two sources);
- ``window_scan``     — the cache simulator's window count, the scan of its
  ``cuda`` backend (``ref.py``, ``plan.py``, ``kernel.py`` and ``ops.py``,
  which also runs the scan's chunk loop on the card; it launches from the
  simulator, not from a captured entry, so it has no capture hook and no
  launch spec).
"""

from __future__ import annotations

from . import (flash_attention, moe_dispatch, paged_kv_decode, ssm_scan,
               stream, token_gather, window_scan)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "flash_attention", "moe_dispatch", "paged_kv_decode", "ssm_scan",
           "stream", "token_gather", "window_scan"]

# Kernel name (= csrc/<name>.cu) -> the wrapper that launches it.
KERNELS = {
    "stream": stream.kernel.stream_cuda,
    "token_gather": token_gather.kernel.gather_rows,
    "flash_attention": flash_attention.kernel.flash_attention,
    "paged_kv_decode": paged_kv_decode.kernel.paged_decode_attention,
    "moe_dispatch": moe_dispatch.kernel.moe_grouped_gemm,
    "ssm_ema_scan": ssm_scan.kernel.ssm_ema_cuda,
    "ssm_chunked_scan": ssm_scan.kernel.ssm_chunked_cuda,
    "window_scan": window_scan.kernel.window_count_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    split = flash_attention.kernel.flash_attention.launches_by_kernel
    for name in split:
        split[name] = 0
