"""Launch geometry as the object that launches the kernel.

The reference reads a kernel's geometry out of its traced ``pallas_call``
(``repro.capture.jaxpr.from_jaxpr``).  PyTorch has no abstract trace of a
launch, so here every wrapper in ``repro_torch.kernels.*.ops`` computes one
:class:`LaunchSpec` from its arguments' shapes, launches its CUDA kernel
from that spec (or runs the plain version on a CPU tensor), and hands the
spec to any active :func:`record` block.  A capture hook therefore *runs*
the launcher and walks the spec that was launched: nothing is mirrored.

The spec keeps the reference's grid and per-program tile even where a CUDA
block loops over an axis inside itself (flash attention's kv axis, paged
decode's page axis), because the walker's revisit and write-back replay is
defined on that grid; :meth:`LaunchSpec.to_grid_capture` converts it.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import obs

from .grid import GridCapture, OperandSpec, elems_per_word

__all__ = ["LaunchOperand", "LaunchSpec", "record", "emit", "capture_launch",
           "memoized"]

# numpy stand-ins with the same item size (the walker reads only that).
_NP_DTYPES = {torch.float32: np.float32, torch.bfloat16: np.uint16,
              torch.int32: np.int32}


@dataclass(frozen=True)
class LaunchOperand:
    """One operand of a launch.

    ``role`` is ``"in"``, ``"out"`` or ``"index"`` — the last is an index
    vector every program reads (the reference scalar-prefetches it once
    before the grid runs; a CUDA block reads it from global memory).  A
    ``steered`` operand's ``index_map`` takes the program ids followed by
    every index vector of the launch (as numpy, in ``LaunchSpec.index``
    order), like a Pallas index map that reads the scalar-prefetch refs.
    """

    name: str
    role: str
    shape: tuple[int, ...]
    block_shape: tuple[int, ...]
    dtype: torch.dtype
    index_map: Callable[..., tuple[int, ...]]
    steered: bool = False


@dataclass(frozen=True)
class LaunchSpec:
    """Grid + per-operand blocks of one kernel launch, and its op count.

    ``index`` holds the launch's index tensors (gather rows; page table;
    MoE token order then expert ids), in the order of its ``"index"``
    operands; they are read back to the host only when the spec is walked.
    """

    name: str
    grid: tuple[int, ...]
    operands: tuple[LaunchOperand, ...]
    flops: float
    index: tuple[torch.Tensor, ...] = ()

    def operand(self, name: str) -> LaunchOperand:
        return next(op for op in self.operands if op.name == name)

    def to_grid_capture(self) -> GridCapture:
        idx = tuple(t.detach().cpu().numpy().astype(np.int64)
                    for t in self.index)
        ops = []
        for op in self.operands:
            npdt = _NP_DTYPES[op.dtype]
            if op.role == "index":
                rank = len(op.shape)
                ops.append(OperandSpec(
                    name=op.name, role="in", shape=op.shape,
                    block_shape=op.shape,
                    index_map=lambda *step, _r=rank: (0,) * _r,
                    elems_per_word=elems_per_word(npdt, op.shape[-1])))
                continue
            imap = op.index_map
            if op.steered:
                imap = (lambda *step, _m=op.index_map: _m(*step, *idx))
            ops.append(OperandSpec(
                name=op.name, role=op.role, shape=op.shape,
                block_shape=op.block_shape, index_map=imap,
                elems_per_word=elems_per_word(
                    npdt, op.block_shape[-1],
                    op.shape[-1] if len(op.shape) > 1 else 0)))
        return GridCapture(name=self.name, grid=self.grid,
                           operands=tuple(ops), flops=self.flops)


_RECORDERS: contextvars.ContextVar[tuple[list, ...]] = contextvars.ContextVar(
    "repro_torch_launch_recorders", default=())


@contextlib.contextmanager
def record() -> Iterator[list[LaunchSpec]]:
    """Collect the specs of every launch made inside the block."""
    sink: list[LaunchSpec] = []
    token = _RECORDERS.set(_RECORDERS.get() + (sink,))
    try:
        yield sink
    finally:
        _RECORDERS.reset(token)


def emit(spec: LaunchSpec) -> None:
    """Hand one launch's spec to every active :func:`record` block."""
    for sink in _RECORDERS.get():
        sink.append(spec)


def capture_launch(call: Callable[[], object],
                   device: torch.device) -> GridCapture:
    """Run one launcher call and convert the spec it launched.  On CUDA
    the device is synchronized first (span ``capture.sync``, the launch's
    device time plus its round trip), so a fault surfaces here."""
    with record() as launched:
        call()
    if device.type == "cuda":
        with obs.span("capture.sync"):
            torch.cuda.synchronize(device)
    if len(launched) != 1:
        raise RuntimeError(f"expected one launch, recorded {len(launched)}")
    return launched[0].to_grid_capture()


_MEMO: OrderedDict[tuple, GridCapture] = OrderedDict()
_MEMO_CAP = 256


def memoized(key: tuple, build: Callable[[], GridCapture]) -> GridCapture:
    """LRU-memoize one capture per geometry key, so a core sweep or a
    registry rebuild does not relaunch the kernel."""
    got = _MEMO.get(key)
    if got is not None:
        _MEMO.move_to_end(key)
        return got
    cap = _MEMO[key] = build()
    while len(_MEMO) > _MEMO_CAP:
        _MEMO.popitem(last=False)
    return cap
