"""STREAM entry points (counterpart of ``repro.kernels.stream.ops``).

Each op computes its :class:`~repro_torch.capture.launch.LaunchSpec` from
the array's size — the reference's 1-D grid of ``[block_rows, 128]``
tiles, the scalar q as a ``(1,)`` block fetched once — records it, and then
launches the CUDA kernel for a CUDA tensor or runs the plain version for a
CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.capture.launch import LaunchOperand, LaunchSpec, emit

from .. import _build
from . import ref
from .kernel import stream_cuda

__all__ = ["stream_copy", "stream_scale", "stream_add", "stream_triad",
           "launch_spec", "bytes_moved", "STREAM_OPS", "LANES",
           "DEFAULT_BLOCK_ROWS"]

LANES = 128
DEFAULT_BLOCK_ROWS = 512

# op -> (input operand names, arithmetic ops per output element)
STREAM_OPS: dict[str, tuple[tuple[str, ...], float]] = {
    "copy": (("a",), 0.0),
    "scale": (("q", "a"), 1.0),
    "add": (("a", "b"), 1.0),
    "triad": (("q", "a", "b"), 2.0),
}


def bytes_moved(op: str, n_elems: int, itemsize: int) -> int:
    """HBM bytes per invocation (reads + writes), STREAM convention."""
    passes = {"copy": 2, "scale": 2, "add": 3, "triad": 3}[op]
    return passes * n_elems * itemsize


def launch_spec(op: str, n_elems: int, dtype: torch.dtype,
                block_rows: int = DEFAULT_BLOCK_ROWS) -> LaunchSpec:
    """The launch geometry of one STREAM op over ``n_elems`` elements."""
    inputs, ops_per_elem = STREAM_OPS[op]
    rows = n_elems // LANES
    if rows * LANES != n_elems or rows % block_rows:
        raise ValueError(f"size {n_elems} is not a whole number of "
                         f"[{block_rows}, {LANES}] tiles")

    def tile(name: str, role: str) -> LaunchOperand:
        return LaunchOperand(name=name, role=role, shape=(rows, LANES),
                             block_shape=(block_rows, LANES), dtype=dtype,
                             index_map=lambda i: (i, 0))

    operands = [
        LaunchOperand(name="q", role="in", shape=(1,), block_shape=(1,),
                      dtype=dtype, index_map=lambda i: (0,))
        if name == "q" else tile(name, "in")
        for name in inputs
    ]
    operands.append(tile("o", "out"))
    return LaunchSpec(name=f"stream_{op}", grid=(rows // block_rows,),
                      operands=tuple(operands),
                      flops=ops_per_elem * n_elems)


def _run(op: str, a: torch.Tensor, b: torch.Tensor | None, q,
         block_rows: int) -> torch.Tensor:
    spec = launch_spec(op, a.numel(), a.dtype, block_rows)
    emit(spec)
    arrays = (a,) if b is None else (a, b)
    if _build.on_card(*arrays):
        # q is rounded to the array's dtype first, as the reference does.
        qv = float(torch.tensor(q, dtype=a.dtype)) if q is not None else 0.0
        return stream_cuda(spec, op, a, b, qv)
    if op == "copy":
        return ref.copy_ref(a)
    if op == "scale":
        return ref.scale_ref(a, q)
    if op == "add":
        return ref.add_ref(a, b)
    return ref.triad_ref(a, b, q)


def stream_copy(a: torch.Tensor, *,
                block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    return _run("copy", a, None, None, block_rows)


def stream_scale(a: torch.Tensor, q, *,
                 block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    return _run("scale", a, None, q, block_rows)


def stream_add(a: torch.Tensor, b: torch.Tensor, *,
               block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    return _run("add", a, b, None, block_rows)


def stream_triad(a: torch.Tensor, b: torch.Tensor, q, *,
                 block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    return _run("triad", a, b, q, block_rows)
