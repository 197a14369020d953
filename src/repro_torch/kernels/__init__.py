"""Hand-written CUDA kernels of the port, one package per reference family.

Each package has ``ref.py`` (the plain PyTorch version), ``kernel.py``
(the ctypes wrapper of ``csrc/<name>.cu``, with a plain-int ``launches``
counter it bumps on every launch, and a ``copies`` counter it bumps on
every dense copy it makes of a strided or unaligned input,
``_build.dense``), ``ops.py`` (the entry points, as the
reference's: a kernel-level one that computes the launch spec and records
it, and a dispatcher that records it only where the reference launches
its Pallas kernel; both launch the kernel for CUDA tensors and the plain
version for CPU tensors, and raise otherwise) and ``capture.py`` (the
per-thread capture hook of the suite, which calls the kernel-level
entry):

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

__all__ = ["KERNELS", "launch_counts", "copy_counts", "reset_launch_counts",
           "flash_attention", "moe_dispatch", "paged_kv_decode", "ssm_scan",
           "stream", "token_gather", "window_scan"]

# Kernel name (= csrc/<name>.cu) -> the wrapper that launches it.
KERNELS = {
    "stream": stream.kernel.stream_cuda,
    "token_gather": token_gather.kernel.gather_rows_cuda,
    "flash_attention": flash_attention.kernel.flash_attention_cuda,
    "paged_kv_decode": paged_kv_decode.kernel.paged_decode_cuda,
    "moe_dispatch": moe_dispatch.kernel.moe_grouped_gemm,
    "ssm_ema_scan": ssm_scan.kernel.ssm_ema_cuda,
    "ssm_chunked_scan": ssm_scan.kernel.ssm_chunked_cuda,
    "window_scan": window_scan.kernel.window_count_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def copy_counts() -> dict[str, int]:
    """Dense copies of inputs per kernel since the last reset."""
    return {name: fn.copies for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's ``launches`` and ``copies`` to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
        fn.copies = 0
    split = flash_attention.kernel.flash_attention_cuda.launches_by_kernel
    for name in split:
        split[name] = 0
