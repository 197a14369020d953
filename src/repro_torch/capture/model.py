"""Whole-model capture: one step's aten ops -> one concatenated trace
(counterpart of ``repro.capture.model``).

The reference walks the jaxpr of a whole jitted step.  The port runs the
step (on ``meta`` tensors for an abstract capture: shapes only, no
arithmetic) under a ``TorchDispatchMode`` that sees every aten op in
program order with its input and output tensors, forward and backward
alike (a rematerialized layer's recomputed forward included), and turns
every data-moving op into a captured op in one shared HBM address space,
concatenating the per-op walks in program order:

- the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``) lowers to a canonical (G, M, N, K) tiled
  :class:`~repro_torch.capture.grid.GridCapture` — grid ``(G, M/bm,
  N/bn, K/bk)``, k innermost — exactly as the reference lowers
  ``dot_general``;
- a convolution, and an arithmetic op (FLOPs > 0) that moves at least
  :data:`STREAM_MIN_ELEMS` elements, lowers to a one-step whole-array
  *stream* op: inputs read once, outputs written once;
- a small same-size op of the :data:`_TRANSPARENT` set aliases its
  output to its input's region (fused chains move no words but keep
  producer -> consumer locality);
- a kernel of :mod:`repro_torch.kernels` launched inside the step (its
  :class:`~repro_torch.capture.launch.LaunchSpec`, handed to the capture
  by ``launch.emit``) lowers through ``LaunchSpec.to_grid_capture`` as
  kind ``"pallas"``, the reference's ``pallas_call`` branch.  The spec
  carries shapes, not tensors, so the kernel's operands get regions of
  their own in operand order (a one-kernel step walks byte for byte like
  the kernel's standalone capture); the aten ops its plain version runs
  on a CPU tensor are the kernel's body and are not captured again;
- anything else moves no words: index math, views, small elementwise ops
  and in-place cache writes (``copy_`` or ``index_copy_`` into a slice),
  as the reference drops ``dynamic_update_slice`` traffic.

Regions.  Where the reference keys its region allocator by jaxpr
variable, the port keys it by the tensor's storage: a storage gets one
line-aligned region (the sizing rule :func:`~repro_torch.capture.grid.walk`
applies inside, which makes the one-op gate byte-identical) on first
touch, and a view reads its base's region at its storage offset — a
layer's slice of a stacked KV cache lands at ``base + offset``, as the
reference's unrolled ``scan`` slices its stacked operands.  The port's
layer loops are Python loops, so a step arrives unrolled, and each layer's
weights are parameters of their own.  Named tensors handed in as
``stacked`` (the LM's parameters, a train step's moments) are laid out as
the reference's stacked leaves: every ``layers.{i}.X`` reads one region
per reference leaf (``models.convert.reference_key``), sized for the
whole stack, at word offset ``i * words(X)`` (the words a layer's first
read takes), as the reference's scan reads slices of one stacked array.

FLOPs come from :func:`repro_torch.capture.flops.eqn_flops` over every
recorded op, the ones that emit no trace included.
"""

from __future__ import annotations

import gc
import math
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import obs
from repro_torch.models.convert import reference_key

from . import launch as _launch
from .flops import MATMUL, dot_geometry, eqn_flops, op_name
from .grid import (_LINE_WORDS, CaptureResult, GridCapture, OperandSpec,
                   elems_per_word, walk)

__all__ = ["ModelOp", "ModelCapture", "capture_model", "STREAM_MIN_ELEMS"]

# Arithmetic ops below this many moved elements (inputs + outputs) stay in
# registers / shared memory in the traffic model; at or above it they
# lower to a one-step whole-array stream op.  32768 fp32 elements = 128 KiB.
STREAM_MIN_ELEMS = 32768

# Runaway backstop: a smoke-config step is hundreds of ops, a full-width
# decode step a few thousand.
_MAX_OPS = 20_000

# Dense-dot grid-step ceiling; tiles grow past 128 before a dot
# degenerates to one whole-array pass (walk cost is per-step Python).
_MAX_DOT_STEPS = 8192

# Same-size elementwise aten ops whose output aliases an input region when
# they are too small to emit a stream op: the reference's set
# (``convert_element_type reshape transpose ... select_n copy``) by its
# aten names.
_TRANSPARENT = frozenset({
    "_to_copy", "clone", "copy", "contiguous", "_unsafe_view", "reshape",
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "exp",
    "log", "tanh", "sigmoid", "sqrt", "rsqrt", "pow", "where",
    "masked_fill", "relu", "square", "reciprocal",
})

# numpy stand-ins with the same item size (the walker reads only that).
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.bfloat16: np.uint16, torch.float16: np.float16,
              torch.int64: np.int64, torch.int32: np.int32,
              torch.int16: np.int16, torch.int8: np.int8,
              torch.uint8: np.uint8, torch.bool: np.bool_}


def _np_dtype(dt: torch.dtype):
    return _NP_DTYPES[dt]


@dataclass(frozen=True)
class ModelOp:
    """One captured op of a whole-model trace.

    ``bases`` maps the capture's operand names to absolute base word
    addresses in the model's shared address space; ``kind`` is
    ``"pallas"`` | ``"dense"`` | ``"stream"``.
    """

    name: str
    kind: str
    capture: GridCapture
    bases: dict[str, int]

    def walk(self, *, count_only: bool = False) -> CaptureResult:
        if count_only:
            # Count-only walks repeat (walk_window sizes every op, then the
            # whole-step accounting counts them again): cached on the
            # instance (frozen dataclass -> object.__setattr__).
            got = getattr(self, "_counts", None)
            if got is None:
                got = walk(self.capture, count_only=True, bases=self.bases)
                object.__setattr__(self, "_counts", got)
            return got
        return walk(self.capture, bases=self.bases)


@dataclass
class ModelCapture:
    """A whole step's ops in program order + whole-step accounting."""

    name: str
    ops: tuple[ModelOp, ...]
    flops: float                # counted over every recorded aten op
    footprint_words: int        # allocator high-water mark

    @property
    def op_kinds(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for op in self.ops:
            counts[op.kind] = counts.get(op.kind, 0) + 1
        return counts

    def walk(self, *, count_only: bool = False) -> CaptureResult:
        """Concatenate every op's walk in program order."""
        chunks: list[np.ndarray] = []
        loads = stores = steps = 0
        for op in self.ops:
            r = op.walk(count_only=count_only)
            loads += r.loads
            stores += r.stores
            steps += r.grid_steps
            if not count_only:
                chunks.append(r.addresses)
        if not count_only:
            # Counted so the streamed path (walk_stream -> simulate_chunked)
            # can be gated on never materializing a whole-step trace
            # (perf_gate --obs-require 'capture.model.concat==0').
            obs.count("capture.model.concat")
        addr = (np.concatenate(chunks) if chunks
                else np.empty(0, dtype=np.int64))
        return CaptureResult(
            name=self.name, addresses=addr, loads=loads, stores=stores,
            footprint_words=self.footprint_words, grid_steps=steps,
            flops=self.flops)

    def _window(self, target_refs: int, center: float):
        """(counts, total, start, end) of the centred window."""
        if target_refs <= 0:
            raise ValueError("target_refs must be positive")
        counts = [op.walk(count_only=True) for op in self.ops]
        total = sum(r.refs for r in counts)
        start = int((total - target_refs) * min(max(center, 0.0), 1.0))
        return counts, total, start, start + target_refs

    def _window_blocks(self, counts, start: int, end: int):
        pos = 0
        for op, r in zip(self.ops, counts):
            nxt = pos + r.refs
            if nxt > start and pos < end:
                yield op.walk().addresses[max(0, start - pos):end - pos]
            pos = nxt
            if pos >= end:
                break

    def walk_stream(self, target_refs: int | None = None, *,
                    center: float = 0.5):
        """Yield per-op address blocks in program order, never concatenated.

        The generator form of :meth:`walk` / :meth:`walk_window`: fed to
        :func:`repro_torch.core.cachesim_stream.simulate_chunked`, it
        simulates the whole step with the largest single op's walk as the
        peak trace memory.  With ``target_refs=None`` the blocks
        concatenate to ``walk().addresses``; with a target, to
        ``walk_window(target_refs, center=center).addresses``.  A step
        shorter than the target streams whole.
        """
        if target_refs is None:
            for op in self.ops:
                addr = op.walk().addresses
                if addr.size:
                    obs.count("capture.model.stream_blocks")
                    yield addr
            return
        counts, total, start, end = self._window(target_refs, center)
        if total <= target_refs:
            yield from self.walk_stream()
            return
        for blk in self._window_blocks(counts, start, end):
            if blk.size:
                obs.count("capture.model.stream_blocks")
                yield blk

    def walk_window(self, target_refs: int, *,
                    center: float = 0.5) -> CaptureResult:
        """A representative contiguous window of the whole-step trace.

        One contiguous ``target_refs`` window (``center`` picks where),
        walked op by op so the whole trace is never materialized.  A
        shorter trace comes back whole (callers cycle it).  Load/store
        counters are scaled pro rata; ``flops`` stays the whole-step count,
        so AI is taken against the whole-step refs.
        """
        counts, total, start, end = self._window(target_refs, center)
        if total <= target_refs:
            return self.walk()
        chunks = list(self._window_blocks(counts, start, end))
        obs.count("capture.model.concat")  # windowed traces materialize too
        addr = np.concatenate(chunks)
        loads = sum(r.loads for r in counts)
        w_loads = int(round(loads * target_refs / total))
        return CaptureResult(
            name=self.name, addresses=addr, loads=w_loads,
            stores=target_refs - w_loads,
            footprint_words=self.footprint_words,
            grid_steps=sum(r.grid_steps for r in counts),
            flops=self.flops)


# --------------------------------------------------------------------------
# Region allocator, keyed by storage (or by a fresh key for a kernel's
# operands).  A ref is (root key, word offset inside the root's region).
# --------------------------------------------------------------------------
class _Alloc:
    """Line-aligned regions.  A freed region is kept for its *site* — the
    program location whose op first touched it — and the next request of
    that size from the same site takes it back: the next layer's op at the
    same line reuses the last layer's buffer, as the reference's unrolled
    ``scan`` reuses a body variable's region on every iteration, while a
    step's one-off values keep regions of their own, as its top-level
    variables do."""

    def __init__(self) -> None:
        self.cursor = 0
        self.regions: dict[object, tuple[int, int, object]] = {}
        self._free: dict[tuple, list[int]] = {}

    @staticmethod
    def _stride(words: int) -> int:
        # the line-aligned rule of walk()'s own layout: the one-op
        # byte-identity depends on it
        return -(-words // _LINE_WORDS) * _LINE_WORDS + _LINE_WORDS

    def region(self, key, words: int, site=None) -> int:
        got = self.regions.get(key)
        if got is not None and got[1] >= words:
            return got[0]
        stride = self._stride(words)
        free = self._free.get((site, stride))
        if free:
            base = free.pop()
        else:
            base = self.cursor
            self.cursor += stride
        self.regions[key] = (base, words, site)
        return base

    def free(self, key) -> None:
        got = self.regions.pop(key, None)
        if got is not None:
            base, words, site = got
            self._free.setdefault((site, self._stride(words)), []).append(
                base)


def _tile(n: int, cap: int = 128) -> int:
    t = max(1, min(n, cap))
    while n % t:
        t -= 1
    return t


def _whole_spec(name: str, role: str, t: torch.Tensor) -> OperandSpec | None:
    """Whole-array one-step operand (conv / stream lowering)."""
    shape = tuple(int(d) for d in t.shape)
    if not shape or 0 in shape:
        return None  # scalars and empties move no words
    rank = len(shape)
    return OperandSpec(
        name=name, role=role, shape=shape, block_shape=shape,
        index_map=lambda *s, _r=rank: (0,) * _r,
        elems_per_word=elems_per_word(_np_dtype(t.dtype), shape[-1]))


def _lower_dot(name: str, g: int, m: int, n: int, k: int, lhs_dtype,
               rhs_dtype, out_dtype, flops: float) -> GridCapture | None:
    """Canonical tiled lowering of one (G, M, N, K) product (the
    reference's ``dot_general`` rule)."""
    if 0 in (g, m, n, k):
        return None
    bm, bn, bk = _tile(m), _tile(n), _tile(k)
    steps = g * (m // bm) * (n // bn) * (k // bk)
    if steps > _MAX_DOT_STEPS:  # stream the whole K per tile first
        bk = k
        steps = g * (m // bm) * (n // bn)
    if steps > _MAX_DOT_STEPS:
        bm, bn = _tile(m, 1024), _tile(n, 1024)
        steps = g * (m // bm) * (n // bn)
    if steps > _MAX_DOT_STEPS:  # degenerate: one whole-array pass
        bm, bn, bk = m, n, k

    def spec(name, role, shape, block, imap, dtype):
        return OperandSpec(
            name=name, role=role, shape=shape, block_shape=block,
            index_map=imap,
            elems_per_word=elems_per_word(_np_dtype(dtype), block[-1],
                                          shape[-1]))

    return GridCapture(
        name=name,
        grid=(g, m // bm, n // bn, k // bk),
        operands=(
            spec("lhs", "in", (g, m, k), (1, bm, bk),
                 lambda gg, i, j, kk: (gg, i, kk), lhs_dtype),
            spec("rhs", "in", (g, k, n), (1, bk, bn),
                 lambda gg, i, j, kk: (gg, kk, j), rhs_dtype),
            spec("out", "out", (g, m, n), (1, bm, bn),
                 lambda gg, i, j, kk: (gg, i, j), out_dtype),
        ),
        flops=flops)


def _einsum_dims(equation: str, a: torch.Tensor, b: torch.Tensor
                 ) -> tuple[int, int, int, int]:
    """(G, M, N, K) of ``einsum(equation, a, b)`` as ``dot_general(a, b)``:
    batch labels, ``a``'s and ``b``'s own kept labels, contracted ones."""
    ins, _, result = equation.partition("->")
    la, lb = ins.split(",")
    size = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    both = set(la) & set(lb)

    def prod(labels) -> int:
        return math.prod(int(size[x]) for x in labels)

    batch = [x for x in result if x in both]
    return (prod(batch),
            prod(x for x in la if x in result and x not in both),
            prod(x for x in lb if x in result and x not in both),
            prod(x for x in both if x not in result))


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def jax_swaps(equation: str) -> bool:
    """Does ``jnp.einsum(equation, a, b)`` contract as ``dot_general(b,
    a)``?  jax pops the two operands right to left (``lhs = b``, ``rhs =
    a``) and keeps ``dot_general(a, b)`` only when its output needs no
    transpose (``jax/_src/numpy/einsum.py``); torch's einsum always
    multiplies ``a`` by ``b``.  A swapped contraction's M and N trade
    places, and so do its operands'."""
    ins, _, result = equation.partition("->")
    a, b = ins.split(",")
    both = set(a) & set(b)
    batch = [x for x in result if x in both]
    gone = set(batch) | {x for x in a + b if x not in result}
    rem_a = "".join(x for x in a if x not in gone)
    rem_b = "".join(x for x in b if x not in gone)
    return "".join(batch) + rem_a + rem_b != result


def _einsum_call() -> tuple[str, tuple] | None:
    """``(equation, operands)`` of the two-operand ``torch.einsum`` call on
    the stack, if any (read from its frame, which also finds the einsums a
    rematerialized layer runs again in the backward pass)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code is _EINSUM_CODE:
            eq, ops = f.f_locals.get("equation"), f.f_locals.get("operands")
            if isinstance(eq, str) and ops is not None and len(ops) == 2 \
                    and "->" in eq and "." not in eq:
                return eq.replace(" ", ""), tuple(ops)
            return None
        f = f.f_back
    return None


_EINSUM_CODE = torch.functional.einsum.__code__


def _composites() -> dict:
    """Port functions that spell one jax primitive chain in elementary
    torch ops (so that their values are the reference's bit for bit),
    captured as the reference's primitives: code -> chain (see
    :data:`_CHAINS`) over the function's argument ``x`` and result
    ``out``."""
    from repro_torch.models import layers as L

    return {L.silu.__code__: "silu"}


# jax primitive chains that one port function or one aten op stands for:
# (primitive, inputs, output, shape) with shape "x" (the input's), "red"
# (the input's without ``dim``) or "keep" (``dim`` kept at 1).  A
# ``broadcast_in_dim`` moves nothing and its output takes a region of its
# own when read (the reference's walker aliases no broadcast).
_CHAINS = {
    "silu": (("logistic", ("x",), "t", "x"),          # jax.nn.silu
             ("mul", ("x", "t"), "out", "x")),
    "_softmax": (("reduce_max", ("x",), "m", "red"),  # jax.nn.softmax
                 ("max", ("m",), "m1", "red"),
                 ("broadcast_in_dim", ("m1",), "mk", "keep"),
                 ("sub", ("x", "mk"), "t", "x"),
                 ("exp", ("t",), "u", "x"),
                 ("reduce_sum", ("u",), "s", "red"),
                 ("broadcast_in_dim", ("s",), "sk", "keep"),
                 ("div", ("u", "sk"), "out", "x")),
    "logsumexp": (("reduce_max", ("x",), "m", "red"),  # jax.nn.logsumexp
                  ("max", ("m",), "m1", "red"),
                  ("broadcast_in_dim", ("m1",), "mk", "keep"),
                  ("sub", ("x", "mk"), "t", "x"),
                  ("exp", ("t",), "u", "x"),
                  ("reduce_sum", ("u",), "s", "red"),
                  ("sign", ("s",), "s1", "red"),
                  ("abs", ("s",), "s2", "red"),
                  ("log", ("s2",), "s3", "red"),
                  ("add", ("s3", "m1"), "out", "red")),
}
_REDUCTIONS = ("reduce_max", "reduce_sum")
# aten ops captured as a chain, and where each takes its axis
_ATEN_CHAIN_DIM = {"_softmax": lambda args: args[1],
                   "logsumexp": lambda args: args[1][0],
                   "silu": lambda args: -1}


_HERE = Path(__file__).resolve().parent
_PACKAGE = str(_HERE.parent)
_OPTIMIZER = str(_HERE.parent / "train" / "optimizer.py")
_HERE = str(_HERE)


def _site():
    """The program location of the op being captured: the lines of the
    port's own frames on the stack (the capture's excepted), and the
    autograd node running it in a backward pass.  The optimizer's update
    runs leaf by leaf in a Python loop where the reference maps it over
    its parameter tree at trace time, each leaf's values variables of
    their own: an op under it is a site of its own."""
    node = torch._C._current_autograd_node()
    out: list = [node.name() if node is not None else None]
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PACKAGE) and not fn.startswith(_HERE):
            if fn == _OPTIMIZER:
                return object()
            out.append((fn, f.f_lineno))
        f = f.f_back
    return tuple(out)


def _use_count(key: int) -> int:
    return torch._C._storage_Use_Count(key)


class _Walker(TorchDispatchMode):
    """Records, lowers and binds every aten op as it is dispatched."""

    def __init__(self, stream_min_elems: int) -> None:
        super().__init__()
        self.alloc = _Alloc()
        self.ops: list[ModelOp] = []
        self.flops = 0.0
        self.stream_min_elems = stream_min_elems
        # storage key -> (root key, word offset); a root's region lives
        # while any storage that reads it does
        self._alias: dict[int, tuple[object, int]] = {}
        self._live: dict[object, int] = {}
        self._held: dict[int, object] = {}     # key -> its storage
        self._owner: dict[int, int] = {}       # own root -> storage key
        self._root_words: dict[int, int] = {}  # root -> its storage's words
        self._span: dict[int, int] = {}        # alias of a view -> words
        self._roots = 0
        # a stacked layer's root -> (its leaf's key, flat layer, layers)
        self._slot: dict[int, tuple[object, int, int]] = {}
        self._slot_words: dict[object, int] = {}   # leaf -> a layer's words
        self._stacks: list[dict] = []
        self._kernel_frame = None        # a launching wrapper's frame
        self._composite_codes = _composites()
        self._composite: list | None = None   # [frame, x, out]
        self._seq = 0
        self._swapped_operands: set = set()

    # -- regions -------------------------------------------------------------
    def _track(self, st, key: int, root, off: int) -> None:
        self._alias[key] = (root, off)
        self._live[root] = self._live.get(root, 0) + 1
        self._held[key] = st

    def _sweep(self) -> None:
        """Free the storages only the walker still holds: a storage's key
        may then be reused by a new one, and its root's region is freed
        with the root's last reader.  Run before each op, so frees land at
        the same point of the program on every device."""
        dead = [k for k in self._held if _use_count(k) <= 1]
        for key in dead:
            del self._held[key]
            self._span.pop(key, None)
            root, _ = self._alias.pop(key)
            if self._owner.get(root) == key:
                del self._owner[root]      # the key may now be reused
            self._live[root] -= 1
            if not self._live[root]:
                del self._live[root]
                del self._root_words[root]
                self.alloc.free(root)

    def close(self) -> None:
        self._held.clear()

    def stack(self, named: dict) -> None:
        """Lay the stacked tensors of ``named`` ({LM parameter name:
        tensor}) out as the reference's stacked leaves: every layer of one
        leaf reads a slot of one region, the leaf's, at its flat layer
        index times the slot's words.  The slot is as wide as the first
        read of any layer (a bf16 copy of an f32 weight aliases it and
        reads half its words), so the stack holds what the reference's
        scan slices of it."""
        leaves: dict[str, list] = {}
        for name, t in named.items():
            leaf, idx = reference_key(name)
            if idx:
                leaves.setdefault(leaf, []).append((idx, t))
        group = len(self._stacks)
        self._stacks.append(named)       # held: the storages stay alive
        for leaf, members in leaves.items():
            dims = tuple(max(idx[a] for idx, _ in members) + 1
                         for a in range(len(members[0][0])))
            for idx, t in members:
                root, _ = self._ref(t)
                self._slot[root] = ((group, leaf),
                                    int(np.ravel_multi_index(idx, dims)),
                                    math.prod(dims))

    def _ref(self, t: torch.Tensor) -> tuple[object, int]:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._alias:
            # a root of its own: a number, not the storage's address, which
            # a later storage may reuse while this root's region lives on
            self._roots += 1
            self._owner[self._roots] = key
            self._root_words[self._roots] = -(-st.nbytes() // 8)
            self._track(st, key, self._roots, 0)
        root, off = self._alias[key]
        return root, off + (t.storage_offset() * t.element_size()) // 8

    def _base(self, t: torch.Tensor, words: int) -> int:
        """The base word of ``t``'s operand: its root's region at ``t``'s
        offset.  A storage's own region is sized for the whole storage (a
        layer's slice of a stacked cache sizes the stack, as the
        reference's scan slices size their stacked parent); an alias is
        sized by the words read through it, as the reference sizes a
        variable's region at first touch, unless it copies a view of a
        larger storage (a slice made contiguous for a product), which
        sizes that storage."""
        root, off = self._ref(t)
        key = t.untyped_storage()._cdata
        size = self._root_words[root] if self._owner.get(root) == key \
            else self._span.get(key, 0)
        need = max(size, off + words)
        slot = self._slot.get(root)
        if slot is None:
            return self.alloc.region(root, need, _site()) + off
        leaf, i, n = slot           # a layer of a stacked leaf
        stride = self._slot_words.setdefault(leaf, need)
        return self.alloc.region(leaf, n * max(stride, need)) + i * stride \
            + off

    # -- op emission ---------------------------------------------------------
    def _emit(self, kind: str, cap: GridCapture, bases: dict) -> None:
        if len(self.ops) >= _MAX_OPS:
            raise ValueError(
                f"whole-model capture exceeded {_MAX_OPS} ops; raise "
                f"stream_min_elems or cut the traced config")
        self._seq += 1
        self.ops.append(ModelOp(name=f"{self._seq:04d}.{cap.name}",
                                kind=kind, capture=cap, bases=bases))

    def _emit_bound(self, kind: str, cap: GridCapture, tensors) -> None:
        """Bind the capture's operands to regions in operand order (the
        order walk() itself lays out, so a lone op reproduces the
        standalone layout)."""
        bases = {spec.name: self._base(t, spec.words)
                 for spec, t in zip(cap.operands, tensors)}
        self._emit(kind, cap, bases)

    def launched(self, spec: _launch.LaunchSpec) -> None:
        """A kernel wrapper emitted ``spec``: capture it as a ``pallas``
        op and treat the aten ops its frame runs next as its body."""
        cap = spec.to_grid_capture()
        bases: dict[str, int] = {}
        for op in cap.operands:
            if op.name not in bases:
                bases[op.name] = self.alloc.region(object(), op.words)
        self.flops += cap.flops
        self._emit("pallas", cap, bases)
        self._kernel_frame = sys._getframe(3)   # append <- emit <- wrapper

    def _in_kernel(self) -> bool:
        if self._kernel_frame is None:
            return False
        f = sys._getframe(1)
        while f is not None:
            if f is self._kernel_frame:
                return True
            f = f.f_back
        self._kernel_frame = None
        return False

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_kernel():
            return out
        frame = self._composite_frame()
        if frame is not None:
            if self._composite is None or self._composite[0] is not frame:
                self.finish_composite()
                self._composite = [frame, frame.f_locals["x"], None]
            self._composite[2] = _tensors(out)[0]
            return out
        self.finish_composite()
        name = op_name(func)
        if name in _ATEN_CHAIN_DIM and args[0].dim() > 0:
            self.chain(name, args[0], _tensors(out)[0],
                       _ATEN_CHAIN_DIM[name](args))
            return out
        self.op(func, args, kwargs, out)
        return out

    def _composite_frame(self):
        f = sys._getframe(2)
        while f is not None:
            if f.f_code in self._composite_codes:
                return f
            f = f.f_back
        return None

    def finish_composite(self) -> None:
        """Lower the composite call that just ended as its primitives."""
        if self._composite is None:
            return
        frame, x, out = self._composite
        self._composite = None
        self.chain(self._composite_codes[frame.f_code], x, out)

    def chain(self, which: str, x: torch.Tensor, out: torch.Tensor,
              dim: int = -1) -> None:
        """Capture ``out = which(x)`` as the reference's primitive chain,
        its intermediates on ``meta`` (regions of their own, freed after
        the chain as the reference's scan-body variables are reused)."""
        d = dim % x.dim()
        shapes = {"x": tuple(x.shape),
                  "red": tuple(x.shape[:d]) + tuple(x.shape[d + 1:]),
                  "keep": tuple(x.shape[:d]) + (1,) + tuple(x.shape[d + 1:])}
        env = {"x": x, "out": out}
        for prim, ins, o, shape in _CHAINS[which]:
            if o not in env:
                env[o] = torch.empty(shapes[shape], dtype=x.dtype,
                                     device="meta")
            ins_t, outs = [env[i] for i in ins], [env[o]]
            if prim == "broadcast_in_dim":
                continue
            flops = float((ins_t[0] if prim in _REDUCTIONS
                           else outs[0]).numel())
            self.flops += flops
            if self._wants_stream(flops, ins_t, outs):
                self._stream(prim, ins_t, outs, flops)
            else:
                self._alias_to(outs[0], ins_t)

    def op(self, func, args, kwargs, out) -> None:
        self._sweep()
        name = op_name(func)
        outs = _tensors(out)
        flops = eqn_flops(func, args, kwargs, out)
        self.flops += flops
        if name in MATMUL and name != "convolution":
            a = args[1:] if name in ("addmm", "baddbmm") else args
            self._dense(name, dot_geometry(func, args), a[0], a[1], outs[0],
                        flops, self._swap(a[0], a[1]))
            return
        if name == "mul" and self._outer_product(outs, flops):
            return
        ins = _tensors((args, kwargs))
        if name == "convolution" or self._wants_stream(flops, ins, outs):
            self._stream(name, ins, outs, flops)
            return
        self._maybe_alias(func, name, ins, outs)

    def _dense(self, name, gmnk, a, b, out, flops, swap) -> None:
        g, m, n, k = gmnk
        if swap:
            m, n, a, b = n, m, b, a
        if out.numel() == 0:
            return
        cap = _lower_dot(name, g, m, n, k, a.dtype, b.dtype, out.dtype,
                         flops)
        if cap is not None:
            self._emit_bound("dense", cap, [a, b, out])

    def _outer_product(self, outs, flops) -> bool:
        """A two-operand einsum that contracts nothing runs as a broadcast
        ``mul`` in torch and as a K = 1 ``dot_general`` in jax: lowered as
        the latter, over the einsum's own operands."""
        call = _einsum_call()
        if call is None or flops <= 0.0:
            return False
        eq, (a, b) = call
        g, m, n, k = _einsum_dims(eq, a, b)
        if k != 1 or g * m * n != outs[0].numel():
            return False
        self.flops += 2.0 * g * m * n - flops     # dot_general's count
        self._dense("dot_general", (g, m, n, 1), a, b, outs[0],
                    2.0 * g * m * n, jax_swaps(eq))
        return True

    def _tag(self, t: torch.Tensor) -> tuple:
        """An operand by its root, offset and extents (a transposed view
        of it in the backward pass has the same)."""
        return self._ref(t) + (tuple(sorted(t.shape)),)

    def _swap(self, a: torch.Tensor, b: torch.Tensor) -> bool:
        """Lower this matmul as jax's ``dot_general(b, a)``?  Inside a
        two-operand einsum, by jax's rule; in the backward pass, when it
        reads an operand of a swapped forward product (jax's transposes of
        a swapped ``dot_general`` are swapped too: both gradients' M and N
        trade places against autograd's)."""
        call = _einsum_call()
        if call is not None:
            swap = jax_swaps(call[0])
            if swap:
                self._swapped_operands.update((self._tag(a), self._tag(b)))
            return swap
        if torch._C._current_autograd_node() is not None:
            return (self._tag(a) in self._swapped_operands
                    or self._tag(b) in self._swapped_operands)
        return False

    def _stream(self, name, ins, outs, flops) -> None:
        operands: list[OperandSpec] = []
        tensors: list[torch.Tensor] = []
        seen: list[int] = []
        for i, t in enumerate(ins):
            if id(t) in seen:
                continue
            seen.append(id(t))
            spec = _whole_spec(f"in{i}", "in", t)
            if spec is not None:
                operands.append(spec)
                tensors.append(t)
        n_in = len(operands)
        for i, t in enumerate(outs):
            spec = _whole_spec(f"out{i}", "out", t)
            if spec is not None:
                operands.append(spec)
                tensors.append(t)
        if not operands or len(operands) == n_in:
            return
        self._emit_bound("stream", GridCapture(
            name=name, grid=(), operands=tuple(operands), flops=flops),
            tensors)

    def _wants_stream(self, flops, ins, outs) -> bool:
        if not outs or flops <= 0.0:
            return False
        moved = sum(t.numel() for t in ins) + sum(t.numel() for t in outs)
        return moved >= self.stream_min_elems

    def _maybe_alias(self, func, name, ins, outs) -> None:
        """Transparent elementwise: a fresh output aliases a same-size
        input's region (an in-place op keeps its own)."""
        if name not in _TRANSPARENT or not outs or func._schema.is_mutable:
            return
        self._alias_to(outs[0], ins)

    def _alias_to(self, o: torch.Tensor, ins) -> None:
        n = o.numel()
        for t in ins:
            if t.numel() == n and t.dim() > 0:
                st = o.untyped_storage()
                if st._cdata not in self._alias:
                    root, off = self._ref(t)
                    self._track(st, st._cdata, root, off - (
                        o.storage_offset() * o.element_size()) // 8)
                    if t.numel() * t.element_size() \
                            < t.untyped_storage().nbytes():
                        self._span[st._cdata] = self._root_words.get(root,
                                                                     0)
                return


class _Sink(list):
    """A launch-record sink that hands each spec to the walker as it is
    emitted, so the kernel lands in program order."""

    def __init__(self, walker: _Walker) -> None:
        super().__init__()
        self.walker = walker

    def append(self, spec) -> None:
        super().append(spec)
        self.walker.launched(spec)


def capture_model(fn, args, *, name: str = "model",
                  stream_min_elems: int = STREAM_MIN_ELEMS,
                  stacked=()) -> ModelCapture:
    """Run ``fn(*args)`` under the recorder and capture its whole-step
    schedule.

    ``args`` are tensors (``meta`` ones for an abstract capture: no
    memory, no arithmetic) or anything ``fn`` takes.  ``stacked`` holds
    dicts of tensors keyed by the LM's parameter names (its parameters,
    an optimizer's moments), each laid out as the reference's stacked
    leaves.  Returns the ops in program order plus the counted FLOPs of
    every aten op; ``ModelCapture.walk`` yields the concatenated
    word-address stream.
    """
    walker = _Walker(stream_min_elems)
    for named in stacked:
        walker.stack(named)
    # Regions are freed as storages die; with the cyclic collector off,
    # only reference counts free them, at the same point in every run.
    gc_was = gc.isenabled()
    gc.disable()
    try:
        with obs.span("capture.model.trace", model=name):
            with _launch.record(into=_Sink(walker)), walker:
                fn(*args)
            walker.finish_composite()
    finally:
        walker.close()
        if gc_was:
            gc.enable()
    obs.count("capture.model.captures")
    obs.count("capture.model.ops", len(walker.ops))
    return ModelCapture(name=name, ops=tuple(walker.ops), flops=walker.flops,
                        footprint_words=walker.alloc.cursor)
