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

Regions.  The reference keys its region allocator by jaxpr variable: a
scan walks one body with the same variables every iteration, so they
take the same regions, alive or not, and nothing is freed.  The port's
loops are Python loops, so a step arrives unrolled; it stands for a
variable by *what made it*: the op's site (the lines of the step's
frames, torch's and the capture's excepted) and its place among that
site's ops within the same calls (``_Walker._op_key``).  Iteration
i + 1 calls the layer (or the SSD chunk) afresh and so takes iteration
i's keys; a loop inside one call, or the step's top level, makes new
ones.  A backward op has no frame: it takes its forward op's site
through the autograd node's sequence number, so layer i's backward
reuses layer i + 1's regions, as the reference's transposed scan does.
A storage's first read sizes its region (line-aligned, the rule
:func:`~repro_torch.capture.grid.walk` applies inside, which makes the
one-op gate byte-identical); a view reads its base's region at its
offset.  Regions are laid out once the step has run, in the order ops
touch them, so what the step does later can place a value: a write into
a stacked cache's slot puts the value at that slot of the stack's
output, as the reference's scan writes its ys; a value the backward
pass reads after its call returned is a residual, a region per
iteration, as the reference stacks a scan's residuals.  Named tensors
handed in as ``stacked`` (the LM's parameters, a train step's moments)
are laid out as the reference's stacked leaves: every ``layers.{i}.X``
reads one region per reference leaf (``models.convert.reference_key``),
sized for the whole stack, at word offset ``i * words(X)`` (the words a
layer's first read takes), as the reference's scan reads slices of one
stacked array; the gradients the optimizer reads are laid out the same
way.

FLOPs come from :func:`repro_torch.capture.flops.eqn_flops` over every
recorded op, the ones that emit no trace included.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import obs
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import shard_ops as SO
from repro_torch.models import ssm as S
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
# Region allocator.  A storage's root reads the region of its variable key
# (what stands for the reference's jaxpr variable, see ``_Walker._op_key``)
# or, with none, a region of its own.  A ref is (root, word offset inside
# the root's region).
# --------------------------------------------------------------------------
class _Alloc:
    """Line-aligned regions keyed as the reference keys them by jaxpr
    variable: a key's region is taken again whenever it is big enough,
    whether or not the value last held there is still alive, and nothing is
    ever freed."""

    def __init__(self) -> None:
        self.cursor = 0
        self.regions: dict[object, tuple[int, int]] = {}

    def region(self, key, words: int) -> int:
        got = self.regions.get(key)
        if got is not None and got[1] >= words:
            return got[0]
        # the line-aligned rule of walk()'s own layout: the one-op
        # byte-identity depends on it
        base = self.cursor
        self.cursor += -(-words // _LINE_WORDS) * _LINE_WORDS + _LINE_WORDS
        self.regions[key] = (base, words)
        return base


def _tile(n: int, cap: int = 128) -> int:
    t = max(1, min(n, cap))
    while n % t:
        t -= 1
    return t


def _whole_spec(name: str, role: str, t: torch.Tensor,
                dtype=None) -> OperandSpec | None:
    """Whole-array one-step operand (conv / stream lowering), read as
    ``dtype`` if given."""
    shape = tuple(int(d) for d in t.shape)
    if not shape or 0 in shape:
        return None  # scalars and empties move no words
    rank = len(shape)
    return OperandSpec(
        name=name, role=role, shape=shape, block_shape=shape,
        index_map=lambda *s, _r=rank: (0,) * _r,
        elems_per_word=elems_per_word(_np_dtype(dtype or t.dtype),
                                      shape[-1]))


# backward nodes of the reductions jax differentiates through a location
# indicator (``_reduce_chooser_jvp_rule``)
_CHOOSERS = ("AmaxBackward", "AminBackward", "MaxBackward", "MinBackward")

# reductions whose ``keepdim`` output jax's ``reduce_*`` never keeps
_KEEPDIM = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod",
                      "nansum", "norm", "linalg_vector_norm", "var", "std",
                      "any", "all"})


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


# Port functions that spell a jitted jax function (``jax.nn.silu`` and its
# transpose, ``jax.nn.softplus``).  jax traces a jitted function once for
# each signature and every call reuses that jaxpr, variables and all, so
# its values take one region for every call with the same shapes.
_JITTED = frozenset({L.silu.__code__, L._Silu.backward.__code__,
                     S.softplus.__code__})


# aten ops that the reference reaches through a jitted ``jnp`` function
# (``_where``, ``cumsum``, ``_pad``, ``tril``, ``relu``, ``_take``,
# ``take_along_axis``): keyed by their signature alone, for the same reason.
_JITTED_OPS = frozenset({"where", "masked_fill", "cumsum", "constant_pad_nd",
                         "tril", "relu", "index", "gather"})


def _signature(values) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in values
                 if isinstance(t, torch.Tensor))


# Port functions that spell one jax primitive chain in elementary torch
# ops (so that their values are the reference's bit for bit), captured as
# the reference's primitives: code -> chain (see :data:`_CHAINS`) over the
# function's argument ``x`` and result ``out``.
_COMPOSITES = {L.silu.__code__: "silu", L.cube.__code__: "cube",
               MOE.scatter_rows.__code__: "scatter_add",
               SO.logsumexp_rows.__code__: "logsumexp"}


# jax primitive chains that one port function or one aten op stands for:
# (primitive, inputs, output, shape) with shape "x" (the input's), "red"
# (the input's without ``dim``) or "keep" (``dim`` kept at 1).  A
# ``broadcast_in_dim`` moves nothing and its output takes a region of its
# own when read (the reference's walker aliases no broadcast).
_CHAINS = {
    "silu": (("logistic", ("x",), "t", "x"),          # jax.nn.silu
             ("mul", ("x", "t"), "out", "x")),
    "cube": (("integer_pow", ("x",), "out", "x"),),   # x ** 3
    "scatter_add": (),          # moves no words and counts no flops
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
_ELEM_COST = {"integer_pow": 2}     # a chain's x ** 3: |y| - 1 multiplies
# aten ops captured as a chain, and where each takes its axis
_ATEN_CHAIN_DIM = {"_softmax": lambda args: args[1],
                   "logsumexp": lambda args: args[1][0],
                   "silu": lambda args: -1}


_HERE = Path(__file__).resolve().parent
_TORCH = str(Path(torch.__file__).resolve().parent)
_OPTIMIZER = str(_HERE.parent / "train" / "optimizer.py")
_HERE = str(_HERE)


_ENGINE = torch.autograd.graph._engine_run_backward.__code__
# the functions a nested scan's loop calls for each step (an attention
# chunk, an SSD chunk)
_SCAN_BODIES = frozenset({L.remat.__code__, S._chunk_body.__code__})


def _stack(top):
    """The step's own frames on the stack of the op being captured, below
    ``top`` (the capture's caller), outermost first: torch's and the
    capture's excepted.  Under the optimizer's update, its frame alone
    (see ``_Walker._op_key``).  In the backward pass only the frames above
    the autograd engine count (a recomputation's): the engine may run on a
    thread of its own, where the caller of ``backward`` is not on the
    stack."""
    frames = []
    f = sys._getframe(1)
    while f is not None and f is not top and f.f_code is not _ENGINE:
        fn = f.f_code.co_filename
        if not fn.startswith(_HERE) and not fn.startswith(_TORCH):
            if fn == _OPTIMIZER:
                return f
            frames.append(f)
        f = f.f_back
    frames.reverse()
    return tuple(frames)


class _Walker(TorchDispatchMode):
    """Records, lowers and binds every aten op as it is dispatched."""

    def __init__(self, stream_min_elems: int) -> None:
        super().__init__()
        self.alloc = _Alloc()
        self.ops: list[ModelOp] = []
        self.flops = 0.0
        self.stream_min_elems = stream_min_elems
        # storage key -> (root, word offset); every storage seen is held to
        # the end of the capture, so no later storage takes its address
        self._alias: dict[int, tuple[object, int]] = {}
        self._held: dict[int, object] = {}     # key -> its storage
        self._owner: dict[int, int] = {}       # own root -> storage key
        self._root_words: dict[int, int] = {}  # root -> its storage's words
        self._span: dict[int, int] = {}        # alias of a view -> words
        self._roots = 0
        # variable keys: a new storage's, until it becomes a root; a root's
        self._named: dict[int, object] = {}
        self._var: dict[int, object] = {}
        self._occ: dict[tuple, int] = {}       # (site, calls) -> ops so far
        self._calls: dict[int, tuple] = {}     # id -> (frame, its number)
        self._forward: dict[int, tuple] = {}   # autograd node -> (site, calls)
        # a split's view (and the views of it) -> (view, root, the split)
        self._splits: dict[int, tuple] = {}
        # a loop's slice (and its views) -> (view, root, offset, i, n, slice)
        self._scans: dict[int, tuple] = {}
        self._stacked_names: dict[str, int] = {}   # layer tensor -> layers
        # the current op's (iterations, innermost call); a root's, when made
        self._now: tuple = ((), None)
        self._now_calls: tuple = ()
        self._born: dict[int, tuple] = {}
        self._kids: dict[tuple, dict] = {}   # (call, line) -> {call: index}
        self._residual: set = set()
        self._params = None        # (group, named), until the optimizer
        self._layers = 1           # the current op's stack of layers
        self._ys: dict[int, tuple] = {}        # root -> (stacked root, offset)
        self._bound: list[tuple] = []          # (kind, capture, operands)
        # a stacked layer's root -> (its leaf's key, flat layer, layers)
        self._slot: dict[int, tuple[object, int, int]] = {}
        self._slot_words: dict[object, int] = {}   # leaf -> a layer's words
        self._stacks: list[dict] = []
        self._kernel_frame = None        # a launching wrapper's frame
        self.top = None                  # the frame that runs the step
        self._composite: list | None = None   # [frame, x, out, op key]
        self._seq = 0
        self._swapped_operands: set = set()

    # -- variable keys -------------------------------------------------------
    def _call_numbers(self, frames: tuple) -> tuple:
        """A number for each frame's call, given when the frame is first
        seen (every frame seen is held, so no new frame takes a seen one's
        address; a generator's frame keeps its number across its
        resumptions)."""
        out = []
        for f in frames:
            got = self._calls.get(id(f))
            if got is None:
                got = self._calls[id(f)] = (f, len(self._calls))
            out.append(got[1])
        return tuple(out)

    def _op_key(self, func, args, kwargs):
        """What stands for the reference's jaxpr variables of this op: its
        *site* and its occurrence among the ops at that site within the same
        calls of every frame on the stack.  The port's layer loops (and a
        scan's chunk loop) call a function each iteration, so iteration
        i + 1's ops take iteration i's keys, as the reference's unrolled
        ``scan`` walks one body with the same variables; a loop inside one
        call (unrolled at trace time in the reference too) and the step's
        one-off values take new ones.

        - A forward op's site is the lines of the step's frames.  Its
          node, if it makes one, is remembered by sequence number.
        - An autograd node's own op in the backward pass has no frame: its
          site is the node's name and its forward op's site, counted within
          the forward op's calls, so layer i's backward ops take layer
          i + 1's keys, as the reference's transposed scan reuses its body's.
        - An op recomputed for a rematerialized layer has the frames of the
          layer's function, marked as the backward pass's.
        - An op of the optimizer's update has a key of its own.
        - An op inside a port function that spells a jitted jax function
          (:data:`_JITTED`) counts from that function's call, its site
          that function's lines and its arguments' signature; an op that
          the reference reaches through a jitted ``jnp`` function
          (:data:`_JITTED_OPS`) is keyed by its name and signature."""
        frames = _stack(self.top)
        self._layers = 1
        if not isinstance(frames, tuple):
            self._now, self._now_calls = ((), None), ()
            return self._optimizer_key(frames)
        calls = self._now_calls = self._call_numbers(frames)
        self._now = (self._iterations(frames, calls),
                     calls[-1] if calls else None)
        name = op_name(func)
        if name in _JITTED_OPS:
            return "jit", name, _signature(_tensors((args, kwargs)))
        for d, f in enumerate(frames):
            if f.f_code in _JITTED:
                code = f.f_code
                sig = _signature(f.f_locals[v] for v in
                                 code.co_varnames[:code.co_argcount])
                site = ("jit", sig) + tuple((g.f_code, g.f_lineno)
                                             for g in frames[d:])
                return self._count(site, self._call_numbers(frames[d:]))
        node = torch._C._current_autograd_node()
        if node is not None and not frames:
            fwd = self._forward.get(node._sequence_nr())
            site = ("bwd", node.name(), fwd and fwd[0])
            calls = fwd[1] if fwd else ()
        else:
            site = tuple((f.f_code, f.f_lineno) for f in frames)
            if node is not None:
                site = ("recompute",) + site
            elif torch.is_grad_enabled():
                # a node this op made has the last sequence number taken
                self._forward.setdefault(
                    torch._C._autograd._get_sequence_nr() - 1, (site, calls))
        return self._count(site, calls)

    def _iterations(self, frames: tuple, calls: tuple) -> tuple:
        """Which iteration each frame's call is of the loop around it: its
        place among the calls its caller made from the same line."""
        out = []
        for k in range(1, len(frames)):
            kids = self._kids.setdefault(
                (calls[k - 1], frames[k - 1].f_lineno), {})
            out.append(kids.setdefault(calls[k], len(kids)))
        return tuple(out)

    def _residuals(self, tensors, calls) -> None:
        """Tensors read in the backward pass by an op outside the call that
        made them (a backward node, or the recomputation of a later step)
        are a scan's residuals: the reference stacks them over the scan's
        iterations, so each iteration's takes a region of its own."""
        for t in tensors:
            root, _ = self._ref(t)
            born = self._born.get(root)
            if born is not None and born[1] is not None \
                    and born[1] not in calls:
                self._residual.add(root)

    def _count(self, site, calls) -> tuple:
        n = self._occ.get((site, calls), 0)
        self._occ[(site, calls)] = n + 1
        return site, n

    def _optimizer_key(self, frame) -> object:
        """The optimizer updates one layer's tensor at a time in a Python
        loop where the reference maps its update over its stacked leaves:
        an op's values are variables of their own (a key of its own), it
        is a stream op when the whole stack's would be (``_layers``), and
        the gradients it reads are laid out as the reference's stacked
        gradient leaves."""
        self._layers = self._stacked_names.get(frame.f_locals.get("name"), 1)
        if self._params is not None:
            group, named = self._params
            self._params = None
            for t in named.values():
                root, _ = self._ref(t)
                slot = self._slot.get(root)
                if t.grad is not None and slot is not None:
                    (_, leaf), i, n = slot
                    groot, _ = self._ref(t.grad)
                    self._slot.setdefault(groot, (("grad", leaf), i, n))
        return object()

    def _name(self, tensors, key, taken=()) -> None:
        """Give each tensor's storage, if it is new (not one of ``taken``,
        the op's inputs'), the variable key ``(key, i)``."""
        for i, t in enumerate(tensors):
            st = t.untyped_storage()
            k = st._cdata
            if k not in self._alias and k not in self._named \
                    and k not in taken:
                self._named[k] = (key, i, self._now)
                self._held[k] = st

    def _split(self, func, args, kwargs, out, key) -> None:
        """A slice along the last axis (a fused projection split into its
        parts), any slice of a layer's parameter (a row of a conv kernel)
        and any slice of a value made in a call still running (a padded
        input's windows) is a ``slice`` of its own in the reference, whose
        output is a variable of its own; in torch it is a view of its
        source's storage.  Such a view, and every view of it, reads a
        region of its own, laid out as the split made contiguous.  (A
        loop's slice of a stacked buffer, or of a value handed to the loop,
        stays at its offset, as the reference's scan slices its stacked
        operands.)"""
        src = args[0]
        name = op_name(func)
        if name in ("slice", "select"):
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            last = dim % src.dim() == src.dim() - 1 \
                and out.shape[-1] < src.shape[-1]
            root = self._ref(src)[0]
            made = self._born.get(root, (None, None))[1]
            if (name == "slice" and last) or (
                    out.numel() < src.numel()
                    and (root in self._slot or made in self._now_calls)):
                self._roots += 1
                self._var[self._roots] = (key, "split")
                self._born[self._roots] = self._now
                self._root_words[self._roots] = -(
                    -out.numel() * out.element_size() // 8)
                self._splits[id(out)] = (out, self._roots, out)
                return
        if out is src or out.untyped_storage()._cdata \
                != src.untyped_storage()._cdata:
            return
        for views in (self._splits, self._scans):
            got = views.get(id(src))
            if got is not None:
                views[id(out)] = (out,) + got[1:]

    def _unbound(self, src: torch.Tensor, outs) -> None:
        """``unbind`` is a loop's xs (the SSD's chunks): as the reference's
        scan slices its stacked operand, slice i reads the stack's region
        at i times the words its reader takes, the region sized for all of
        them."""
        root, off = self._ref(src)
        for i, t in enumerate(outs):
            self._scans[id(t)] = (t, root, off, i, len(outs), t)

    @staticmethod
    def _split_offset(t: torch.Tensor, split: torch.Tensor) -> int:
        """Words from the start of ``split``, made contiguous, to ``t``."""
        rest = t.storage_offset() - split.storage_offset()
        at = 0
        for size, stride, inner in sorted(
                zip(split.shape, split.stride(),
                    torch.empty(split.shape, device="meta").stride()),
                key=lambda d: -d[1]):
            if stride and size > 1:
                at += (rest // stride) * inner
                rest %= stride
        return at * t.element_size() // 8

    # -- regions -------------------------------------------------------------
    def _track(self, st, key: int, root, off: int) -> None:
        self._alias[key] = (root, off)
        self._held[key] = st

    def close(self) -> None:
        self._held.clear()
        self._calls.clear()

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
        if self._params is None and not self._stacked_names:
            self._params = (group, named)   # the first: the parameters
        for leaf, members in leaves.items():
            dims = tuple(max(idx[a] for idx, _ in members) + 1
                         for a in range(len(members[0][0])))
            for idx, t in members:
                root, _ = self._ref(t)
                self._slot[root] = ((group, leaf),
                                    int(np.ravel_multi_index(idx, dims)),
                                    math.prod(dims))
        for name, t in named.items():
            leaf, idx = reference_key(name)
            if idx:
                self._stacked_names.setdefault(
                    name, self._slot[self._ref(t)[0]][2])

    def _ref(self, t: torch.Tensor) -> tuple[object, int]:
        split = self._splits.get(id(t))
        if split is not None:
            return split[1], self._split_offset(t, split[2])
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._alias:
            # a root of its own, reading its variable's region if it has one
            self._roots += 1
            if key in self._named:
                var, i, born = self._named.pop(key)
                self._var[self._roots] = (var, i)
                self._born[self._roots] = born
            self._owner[self._roots] = key
            self._root_words[self._roots] = -(-st.nbytes() // 8)
            self._track(st, key, self._roots, 0)
        root, off = self._alias[key]
        return root, off + (t.storage_offset() * t.element_size()) // 8

    def _key(self, root) -> object:
        """The region key of a root: its variable's, once per iteration if
        it is a residual, or the root itself."""
        key = self._var.get(root, root)
        if root in self._residual:
            key = (key, self._born[root][0])
        return key

    def _bind(self, t: torch.Tensor, words: int) -> tuple:
        """``(root, offset, words needed)`` of ``t``'s operand (a loop's
        slice: ``("scan", ...)``): its root's region at ``t``'s offset,
        taken at the end of the capture (:meth:`_base`).  A storage's own
        region is sized for the whole storage (a layer's slice of a stacked
        cache sizes the stack, as the reference's scan slices size their
        stacked parent); an alias for the whole of it, or for the storage
        whose view it copies (a slice made contiguous for a product)."""
        scan = self._scans.get(id(t))
        if scan is not None:
            _, root, off, i, n, piece = scan
            return "scan", root, off + self._split_offset(t, piece), i, n, \
                words
        root, off = self._ref(t)
        st = t.untyped_storage()
        key = st._cdata
        if id(t) in self._splits or self._owner.get(root) == key:
            size = self._root_words[root]
        else:           # an alias: the whole of it, or the view it copies
            size = max(self._span.get(key, 0),
                       self._alias[key][1] + -(-st.nbytes() // 8))
        return root, off, max(size, off + words)

    def _base(self, bind: tuple) -> int:
        """The base word of a bound operand, once the capture has seen
        every op (a value written into a stacked buffer later on is known
        by then)."""
        if bind[0] == "scan":
            _, root, off, i, n, words = bind
            return self.alloc.region(self._key(root), n * words) \
                + off + i * words
        root, off, need = bind
        if root is None:                 # a kernel's operand
            return self.alloc.region(object(), need)
        ys = self._ys.get(root)
        if ys is not None:
            dst, at = ys
            return self.alloc.region(("ys", dst), self._root_words[dst]) \
                + at + off
        slot = self._slot.get(root)
        if slot is None:
            return self.alloc.region(self._key(root), need) + off
        leaf, i, n = slot           # a layer of a stacked leaf
        stride = self._slot_words.setdefault(leaf, need)
        return self.alloc.region(leaf, n * max(stride, need)) + i * stride \
            + off

    def _copied(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst.copy_(src)``: a value written whole into a slot of another
        buffer (a layer's state or K/V into a stacked cache) is the
        reference's layer scan writing a variable of its stacked output,
        whose region that slot of the output's is.  A value made inside a
        nested scan (a remat'd chunk loop) keeps the region of that scan's
        carry, as the reference's does."""
        st = src.untyped_storage()
        if src.storage_offset() \
                or src.numel() * src.element_size() != st.nbytes():
            return
        root, off = self._ref(src)
        var = self._var.get(root)
        if off or not isinstance(var, tuple) \
                or not isinstance(var[0], tuple) \
                or any(isinstance(x, tuple) and x[0] in _SCAN_BODIES
                       for x in var[0][0]):
            return
        droot, doff = self._ref(dst)
        if droot != root and droot not in self._slot:
            self._ys[root] = (droot, doff)

    def finish(self) -> None:
        """Lay out every op's operands in program order."""
        self.finish_composite()
        for kind, cap, binds in self._bound:
            self._seq += 1
            self.ops.append(ModelOp(
                name=f"{self._seq:04d}.{cap.name}", kind=kind, capture=cap,
                bases={name: self._base(b) for name, b in binds.items()}))
        self._bound.clear()

    # -- op emission ---------------------------------------------------------
    def _emit(self, kind: str, cap: GridCapture, binds: dict) -> None:
        if len(self._bound) >= _MAX_OPS:
            raise ValueError(
                f"whole-model capture exceeded {_MAX_OPS} ops; raise "
                f"stream_min_elems or cut the traced config")
        self._bound.append((kind, cap, binds))

    def _emit_bound(self, kind: str, cap: GridCapture, tensors) -> None:
        """Bind the capture's operands to regions in operand order (the
        order walk() itself lays out, so a lone op reproduces the
        standalone layout)."""
        binds = {spec.name: self._bind(t, spec.words)
                 for spec, t in zip(cap.operands, tensors)}
        self._emit(kind, cap, binds)

    def launched(self, spec: _launch.LaunchSpec) -> None:
        """A kernel wrapper emitted ``spec``: capture it as a ``pallas``
        op and treat the aten ops its frame runs next as its body."""
        cap = spec.to_grid_capture()
        binds: dict[str, tuple] = {}
        for op in cap.operands:
            if op.name not in binds:
                binds[op.name] = (None, 0, op.words)
        self.flops += cap.flops
        self._emit("pallas", cap, binds)
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
        key = self._op_key(func, args, kwargs)
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        self._name(outs, key, {t.untyped_storage()._cdata for t in ins})
        if torch._C._current_autograd_node() is not None:
            self._residuals(ins, self._now_calls)
        if outs and args and isinstance(args[0], torch.Tensor):
            if op_name(func) == "unbind":
                self._unbound(args[0], outs)
            else:
                self._split(func, args, kwargs, outs[0], key)
        frame = self._composite_frame()
        if frame is not None:
            if self._composite is None or self._composite[0] is not frame:
                self.finish_composite()
                self._composite = [frame, frame.f_locals["x"], None, key]
            self._composite[2] = outs[0]
            return out
        self.finish_composite()
        name = op_name(func)
        if name in _ATEN_CHAIN_DIM and args[0].dim() > 0:
            self.chain(name, args[0], outs[0], key,
                       _ATEN_CHAIN_DIM[name](args))
            return out
        self.op(func, args, kwargs, out)
        return out

    def _composite_frame(self):
        f = sys._getframe(2)
        while f is not None:
            if f.f_code in _COMPOSITES:
                return f
            f = f.f_back
        return None

    def finish_composite(self) -> None:
        """Lower the composite call that just ended as its primitives."""
        if self._composite is None:
            return
        frame, x, out, key = self._composite
        self._composite = None
        self.chain(_COMPOSITES[frame.f_code], x, out, key)

    def chain(self, which: str, x: torch.Tensor, out: torch.Tensor, key,
              dim: int = -1) -> None:
        """Capture ``out = which(x)`` as the reference's primitive chain,
        its intermediates on ``meta``, each keyed by the op key ``key`` of
        the op that ran the chain and its name, as the chain's variables
        would be the reference's."""
        d = dim % x.dim()
        shapes = {"x": tuple(x.shape),
                  "red": tuple(x.shape[:d]) + tuple(x.shape[d + 1:]),
                  "keep": tuple(x.shape[:d]) + (1,) + tuple(x.shape[d + 1:])}
        env = {"x": x, "out": out}
        for prim, ins, o, shape in _CHAINS[which]:
            if o not in env:
                env[o] = torch.empty(shapes[shape], dtype=x.dtype,
                                     device="meta")
                self._name([env[o]], (key, o))
            ins_t, outs = [env[i] for i in ins], [env[o]]
            if prim == "broadcast_in_dim":
                continue
            flops = float((ins_t[0] if prim in _REDUCTIONS
                           else outs[0]).numel() * _ELEM_COST.get(prim, 1))
            self.flops += flops
            if self._wants_stream(flops, ins_t, outs):
                self._stream(prim, ins_t, outs, flops)
            else:
                self._alias_to(outs[0], ins_t)

    def op(self, func, args, kwargs, out) -> None:
        name = op_name(func)
        outs = _tensors(out)
        flops = eqn_flops(func, args, kwargs, out)
        self.flops += flops
        if name in MATMUL and name != "convolution":
            a = args[1:] if name in ("addmm", "baddbmm") else args
            call = _einsum_call()
            if call is not None:
                self._einsum_dense(name, call, a, outs[0], flops)
                return
            self._dense(name, dot_geometry(func, args), a[0], a[1], outs[0],
                        flops, self._backward_swap(a[0], a[1]))
            return
        if name == "copy_":
            self._copied(args[0], args[1])
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

    def _einsum_dense(self, name, call, args, out, flops) -> None:
        """A product inside a two-operand ``torch.einsum``: lowered as jax's
        ``dot_general`` of the einsum's own operands, its geometry and
        operand order read from the equation by jax's rule (torch may hand
        ``bmm`` the operands the other way round).  A swapped product's
        operands are remembered, for its backward pass."""
        eq, (a, b) = call
        swap = jax_swaps(eq)
        if swap:
            self._swapped_operands.update((self._tag(args[0]),
                                           self._tag(args[1])))
        self._dense(name, _einsum_dims(eq, a, b), a, b, out, flops, swap)

    def _backward_swap(self, a: torch.Tensor, b: torch.Tensor) -> bool:
        """Lower this backward matmul as ``dot_general(b, a)``?  When it
        reads an operand of a swapped forward product: jax's transposes of
        a swapped ``dot_general`` are swapped too (both gradients' M and N
        trade places against autograd's)."""
        if torch._C._current_autograd_node() is not None:
            return (self._tag(a) in self._swapped_operands
                    or self._tag(b) in self._swapped_operands)
        return False

    def _stream(self, name, ins, outs, flops) -> None:
        """One whole-array op, as the reference's primitive reads it: an
        input of another dtype than the result is read converted (jnp
        converts it first, and the conversion aliases its input), and a
        reduction's kept axes are dropped."""
        operands: list[OperandSpec] = []
        tensors: list[torch.Tensor] = []
        seen: list[int] = []
        result = outs[0].dtype if outs and outs[0].is_floating_point() \
            else None
        node = torch._C._current_autograd_node()
        if node is not None and node.name().startswith(_CHOOSERS) and outs:
            # jax transposes a max by broadcasting the cotangent to the
            # operand's shape first (broadcast_in_dim): read at full size
            ins = [t.expand(outs[0].shape) if t.dim() == outs[0].dim()
                   else t for t in ins]
        if name in _KEEPDIM and ins and outs \
                and outs[0].dim() == ins[0].dim() > 0:
            kept = [d for d in range(outs[0].dim())
                    if outs[0].shape[d] == 1 != ins[0].shape[d]]
            outs = [outs[0].squeeze(kept)] + list(outs[1:])
        for i, t in enumerate(ins):
            if id(t) in seen:
                continue
            seen.append(id(t))
            spec = _whole_spec(f"in{i}", "in", t, result)
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
        return moved * self._layers >= self.stream_min_elems

    def _maybe_alias(self, func, name, ins, outs) -> None:
        """Transparent elementwise: a fresh output aliases a same-size
        input's region (an in-place op keeps its own).  A select aliases
        its predicate or nothing: ``jnp.where`` broadcasts the predicate
        to the output's shape, and ``select_n`` aliases that."""
        if name not in _TRANSPARENT or not outs or func._schema.is_mutable:
            return
        if name in ("where", "masked_fill"):
            ins = ins[:1] if name == "where" else ins[1:2]
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
                    src = t.untyped_storage()
                    if t.numel() * t.element_size() < src.nbytes() \
                            or src._cdata in self._span:
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
    walker.top = sys._getframe()
    for named in stacked:
        walker.stack(named)
    try:
        with obs.span("capture.model.trace", model=name):
            with _launch.record(into=_Sink(walker)), walker:
                fn(*args)
            walker.finish()
    finally:
        walker.close()
    obs.count("capture.model.captures")
    obs.count("capture.model.ops", len(walker.ops))
    return ModelCapture(name=name, ops=tuple(walker.ops), flops=walker.flops,
                        footprint_words=walker.alloc.cursor)
