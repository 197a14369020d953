"""Grid DMA walker: kernel launch geometry -> HBM word trace
(counterpart of ``repro.capture.grid``).

A tiled kernel's HBM traffic is determined by its launch geometry: the
grid, and one block (block shape + index map over program ids) per operand.
The reference's Pallas pipeline fetches an *input* block when its index map
output changes between consecutive grid steps (an unchanged block stays
resident: the "revisiting" optimization) and writes an *output* block on
the last consecutive grid step that maps to it.

:func:`walk` replays that schedule in NumPy and emits the HBM **word**
address stream (8-byte words; fp32 elements pack two per word), loads and
stores per operand tile, in issue order.  The port keeps the reference's
grid and per-program tile in every :class:`~repro_torch.capture.launch
.LaunchSpec`, even where a CUDA block loops over an axis inside itself, so
the stream walked here is byte-identical to the reference's.
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch import obs

__all__ = [
    "OperandSpec",
    "GridCapture",
    "CaptureResult",
    "walk",
    "elems_per_word",
    "WORDS_PER_FP32_PAIR",
]

# DAMOV traces address 8-byte words; fp32 elements pack two per word.
WORDS_PER_FP32_PAIR = 2

_LINE_WORDS = 8  # 64 B cache line, for base-address alignment only


def elems_per_word(dtype, *dims: int) -> int:
    """Elements per 8-byte trace word for one operand.

    Word collapse requires every row start to be word-aligned, so the
    packing factor is reduced (via gcd) to divide the operand's last-dim
    extents (a ``(1,)`` fp32 scalar packs 1 element per word, not 2).
    Zero extents are skipped.
    """
    epw = max(1, 8 // np.dtype(dtype).itemsize)
    for d in dims:
        epw = math.gcd(epw, int(d)) if d else epw
    return max(1, epw)


@dataclass(frozen=True)
class OperandSpec:
    """One operand block of a kernel launch, as data.

    ``index_map`` receives the grid indices and returns the block index
    tuple.
    """

    name: str
    role: str                       # "in" | "out"
    shape: tuple[int, ...]          # logical array shape, elements
    block_shape: tuple[int, ...]    # per-program block shape, elements
    index_map: Callable[..., tuple[int, ...]]
    elems_per_word: int = WORDS_PER_FP32_PAIR

    def __post_init__(self) -> None:
        if self.role not in ("in", "out"):
            raise ValueError(f"{self.name}: role must be 'in'|'out'")
        if len(self.shape) != len(self.block_shape):
            raise ValueError(
                f"{self.name}: rank mismatch {self.shape} vs {self.block_shape}"
            )
        if len(self.shape) > 1 and self.shape[-1] % self.elems_per_word:
            raise ValueError(
                f"{self.name}: array last dim {self.shape[-1]} not a "
                f"multiple of {self.elems_per_word} elems/word")

    @property
    def words(self) -> int:
        """Array footprint in 8-byte words."""
        return -(-math.prod(self.shape) // self.elems_per_word)

    @property
    def block_words(self) -> int:
        return -(-math.prod(self.block_shape) // self.elems_per_word)


@dataclass(frozen=True)
class GridCapture:
    """Per-thread launch geometry of one kernel invocation."""

    name: str
    grid: tuple[int, ...]
    operands: tuple[OperandSpec, ...]
    flops: float = 0.0              # arithmetic ops of the whole launch


@dataclass
class CaptureResult:
    """The captured HBM word-address stream + accounting."""

    name: str
    addresses: np.ndarray           # word addresses, issue order
    loads: int
    stores: int
    footprint_words: int            # sum of operand array footprints
    grid_steps: int
    flops: float

    @property
    def refs(self) -> int:
        # == addresses.size for a full walk; also right for a count-only
        # walk, whose address array is empty.
        return self.loads + self.stores

    @property
    def flops_per_ref(self) -> float:
        return self.flops / self.refs if self.refs else 0.0


def _tile_words_batch(op: OperandSpec, idxs: np.ndarray,
                      base_word: int) -> np.ndarray:
    """Word addresses of many blocks of one operand, row-major element
    order (DMA order): ``idxs`` is ``(k, rank)``, the result
    ``(k, block_words)``."""
    shape, blk = op.shape, op.block_shape
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    k = idxs.shape[0]
    starts = np.zeros((k, 1), dtype=np.int64)
    for a in range(len(blk) - 1):
        ax = np.arange(blk[a], dtype=np.int64) * strides[a]
        offs = idxs[:, a, None] * (blk[a] * strides[a]) + ax[None, :]
        starts = (starts[:, :, None] + offs[:, None, :]).reshape(k, -1)
    last_b = blk[-1]
    if last_b % op.elems_per_word:
        # With last_b word-aligned every block offset idx*last_b is too.
        raise ValueError(
            f"{op.name}: block rows must be word-aligned "
            f"(last dim {last_b}, {op.elems_per_word} elems/word)")
    row = np.arange(last_b, dtype=np.int64)
    elems = (starts[:, :, None]
             + (idxs[:, -1] * last_b)[:, None, None]
             + row[None, None, :]).reshape(k, -1)
    words = elems // op.elems_per_word
    # Collapse element groups sharing one word (fp32: stride-2 duplicates).
    if op.elems_per_word > 1:
        words = words[:, :: op.elems_per_word]
    return base_word + words


# index map -> (grid, table): a map walked again (a capture walked once
# per core count, a model's op walked for its count and then for its
# addresses) pays its per-step Python once.  Keyed weakly, so a map dies
# with its capture.
_OP_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _op_table(op: OperandSpec, grid: tuple[int, ...],
              steps: list[tuple[int, ...]]) -> np.ndarray:
    """Per-step block-index table, ``(n_steps, block_rank)`` int64,
    memoized per index map and grid."""
    cached = _OP_TABLES.get(op.index_map)
    if cached is not None and cached[0] == grid:
        return cached[1]
    rows = np.empty((len(steps), len(op.block_shape)), dtype=np.int64)
    for si, step in enumerate(steps):
        rows[si] = [int(x) for x in op.index_map(*step)]
    try:
        _OP_TABLES[op.index_map] = (tuple(grid), rows)
    except TypeError:
        pass                      # a map that takes no weak reference
    return rows


def walk(cap: GridCapture, *, count_only: bool = False,
         bases: dict[str, int] | None = None) -> CaptureResult:
    """Replay the pipeline schedule and emit the word-address stream.

    Arrays are laid out back-to-back in HBM, line-aligned, in operand
    order.  Per grid step (row-major order, last axis fastest): fetch
    every input block whose index differs from the last one recorded under
    its operand name (names are shared state: outputs of the same name
    count), then write back every output block whose residency ends at
    this step.  ``count_only`` returns the load/store/flop accounting
    with an empty address array.

    ``bases`` overrides the per-operand base word addresses (operand name
    -> absolute base).  :mod:`repro_torch.capture.model` places every op
    of a whole-model capture in one shared address space this way; its
    allocator applies the same line-aligned sizing rule as the default
    layout here, so a one-op model capture walks byte for byte like the
    standalone walk.
    """
    with obs.span("capture.walk", kernel=cap.name, count_only=count_only):
        res = _walk(cap, count_only=count_only, bases=bases)
    obs.count("capture.walk.calls")
    obs.count("capture.walk.refs", res.refs)
    return res


def _walk(cap: GridCapture, *, count_only: bool,
          bases: dict[str, int] | None) -> CaptureResult:
    if bases is None:
        base: dict[str, int] = {}
        cursor = 0
        for op in cap.operands:
            if op.name not in base:
                base[op.name] = cursor
                cursor += (-(-op.words // _LINE_WORDS) * _LINE_WORDS
                           + _LINE_WORDS)
    else:
        base = {op.name: bases[op.name] for op in cap.operands}
    footprint = sum({op.name: op.words for op in cap.operands}.values())

    n_steps = math.prod(cap.grid)
    if n_steps == 0:
        return CaptureResult(
            name=cap.name, addresses=np.empty(0, dtype=np.int64),
            loads=0, stores=0, footprint_words=footprint, grid_steps=0,
            flops=cap.flops)
    if count_only and n_steps == 1:
        # One-step launch (the whole-array ops of a model step): every
        # input fetches once, every output writes back once.
        loads = sum(op.block_words for op in cap.operands if op.role == "in")
        stores = sum(op.block_words for op in cap.operands
                     if op.role != "in")
        return CaptureResult(
            name=cap.name, addresses=np.empty(0, dtype=np.int64),
            loads=loads, stores=stores, footprint_words=footprint,
            grid_steps=1, flops=cap.flops)
    steps = list(np.ndindex(*cap.grid))
    tables = [_op_table(op, tuple(cap.grid), steps) for op in cap.operands]

    # Merged change masks per operand name (inputs consult the last index
    # written by ANY same-named operand, outputs included).
    by_name: dict[str, list[int]] = {}
    for oi, op in enumerate(cap.operands):
        by_name.setdefault(op.name, []).append(oi)
    emit = np.zeros((len(cap.operands), n_steps), dtype=bool)
    for ois in by_name.values():
        k = len(ois)
        merged = np.stack([tables[oi] for oi in ois], axis=1)  # (n, k, r)
        flat = merged.reshape(n_steps * k, -1)
        changed = np.empty(n_steps * k, dtype=bool)
        changed[0] = True
        np.any(flat[1:] != flat[:-1], axis=1, out=changed[1:])
        changed = changed.reshape(n_steps, k)
        for j, oi in enumerate(ois):
            if cap.operands[oi].role == "in":
                emit[oi] = changed[:, j]
    for oi, op in enumerate(cap.operands):
        if op.role != "in":
            t = tables[oi]
            emit[oi, -1] = True
            np.any(t[1:] != t[:-1], axis=1, out=emit[oi, :-1])

    loads = stores = 0
    if count_only:
        for oi, op in enumerate(cap.operands):
            words = int(emit[oi].sum()) * op.block_words
            if op.role == "in":
                loads += words
            else:
                stores += words
        addr = np.empty(0, dtype=np.int64)
    else:
        # nonzero on the transposed mask yields events in (step, operand)
        # order — the issue order.  Each operand's blocks tile in one
        # batched call, then land at their events' offsets.
        si_arr, oi_arr = np.nonzero(emit.T)
        bw = np.array([op.block_words for op in cap.operands],
                      dtype=np.int64)
        sizes = bw[oi_arr]
        ends = np.cumsum(sizes)
        addr = np.empty(int(ends[-1]) if ends.size else 0, dtype=np.int64)
        for oi, op in enumerate(cap.operands):
            sel = np.flatnonzero(oi_arr == oi)
            if not sel.size:
                continue
            tiles = _tile_words_batch(op, tables[oi][si_arr[sel]],
                                      base[op.name])
            pos = ((ends[sel] - sizes[sel])[:, None]
                   + np.arange(tiles.shape[1], dtype=np.int64)[None, :])
            addr[pos] = tiles
            if op.role == "in":
                loads += tiles.size
            else:
                stores += tiles.size

    return CaptureResult(
        name=cap.name,
        addresses=addr,
        loads=loads,
        stores=stores,
        footprint_words=footprint,
        grid_steps=n_steps,
        flops=cap.flops,
    )
