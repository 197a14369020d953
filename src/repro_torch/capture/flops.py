"""Arithmetic-op counting over the aten ops of a step (counterpart of
``repro.capture.flops``).

The reference walks a jaxpr and charges each floating-point equation its
arithmetic cost.  The port records the aten ops that a step dispatches
(forward and backward alike, under a ``TorchDispatchMode``) and charges
each one by the same rules.  DAMOV counts arithmetic operations, not
instructions:

- an op whose first output is not floating-point costs **zero** (index
  arithmetic, comparisons, bool masks);
- data-movement ops (views, copies, casts, gathers, scatters, fills,
  concatenation, sorting) cost zero whatever their dtype;
- the matmul family costs ``2 * G * M * N * K`` (multiply + accumulate),
  a convolution its im2col equivalent;
- reductions (and cumulative ops) cost one op per *input* element;
- every other floating-point op costs one op per output element, times
  the count in :data:`_COST_PER_ELEM` where one aten op stands for
  several jax primitives.

Where an aten op stands for jax primitives, it is charged as they are:

=========================================  ==================================
aten op                                    jax primitives it stands for
=========================================  ==================================
``mm`` ``bmm`` ``addmm`` ``baddbmm``       ``dot_general`` (2·G·M·N·K; the
``mv`` ``dot``                             bias of ``addmm`` is not charged)
``convolution``                            ``conv_general_dilated``
``_to_copy`` ``clone`` ``copy_``           ``convert_element_type``/``copy``
``view`` ``expand`` ``permute`` ...        ``reshape`` ``broadcast_in_dim``
                                           ``transpose`` (zero)
``where`` ``masked_fill``                  ``select_n`` (zero)
``index`` ``index_select`` ``gather``      ``gather`` ``dynamic_slice``
``embedding`` ``slice`` ``select``         (zero)
``index_put`` ``scatter`` ``index_add``    ``scatter``/``scatter-add``
``index_copy`` ``slice_scatter``           ``dynamic_update_slice`` (zero)
``sum`` ``amax`` ``amin`` ``prod``         ``reduce_sum`` ``reduce_max`` ...
``cumsum`` ``cumprod``                     (input elements)
``mean``                                   ``reduce_sum`` + ``div``
``_softmax``                               ``reduce_max`` ``max`` ``sub``
                                           ``exp`` ``reduce_sum`` ``div``
                                           (5 / elem + 1 / row)
``_log_softmax``                           ``reduce_max`` ``max`` ``sub``
                                           ``exp`` ``reduce_sum`` ``log``
                                           ``sub`` (5 / elem + 2 / row)
``logsumexp``                              ``reduce_max`` ``max`` ``sub``
                                           ``exp`` ``reduce_sum`` ``sign``
                                           ``abs`` ``log`` ``add``
                                           (4 / elem + 5 / row)
``_softmax_backward_data``                 ``mul`` ``reduce_sum`` ``sub``
                                           ``mul`` (4 / elem)
``clamp``                                  ``max`` then ``min`` (2 / elem)
``pow`` (integer exponent ``y``)           ``integer_pow`` (``|y| - 1``)
``add`` ``mul`` ``exp`` ``rsqrt`` ...      the elementwise primitive (1)
=========================================  ==================================

Decompositions differ between the two graphs (an RMSNorm or a softmax
backward is a different set of primitives in each), so elementwise counts
agree with the reference's within a few percent, and the dense counts,
which carry a step's weight, agree exactly.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["count_flops", "eqn_flops", "op_name", "dot_geometry", "MATMUL"]

# Pure data movement / layout / bookkeeping: zero arithmetic whatever the
# dtype.  (Comparisons, integer index math and masks are already zeroed by
# the float-output gate.)
_ZERO = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "permute", "transpose", "t", "squeeze", "unsqueeze", "alias", "detach",
    "lift_fresh", "as_strided", "unfold", "view_as_real", "view_as_complex",
    "_to_copy", "clone", "copy", "copy_", "_copy_from", "contiguous",
    "slice", "select", "narrow", "split", "split_with_sizes", "unbind",
    "chunk", "cat", "stack", "flip", "roll", "repeat", "constant_pad_nd",
    "index", "index_select", "gather", "embedding", "take",
    "index_put", "index_put_", "_index_put_impl", "scatter", "scatter_",
    "scatter_add", "index_add", "index_copy", "index_copy_", "slice_scatter",
    "select_scatter", "diagonal_scatter", "masked_scatter",
    "where", "masked_fill", "fill", "fill_", "zero", "zero_", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full", "arange", "linspace", "scalar_tensor",
    "_local_scalar_dense", "sort", "argsort", "topk", "argmax", "argmin",
    "tril", "triu", "one_hot", "bernoulli", "normal", "uniform", "random_",
    "set_", "resize_",
})

# Reductions: one op per *input* element.
_REDUCE = frozenset({
    "sum", "amax", "amin", "max", "min", "prod", "cumsum", "cumprod",
    "cummax", "cummin", "nansum", "norm", "linalg_vector_norm",
})

# One aten op standing for several jax primitives (see the table above):
# ops per element, and per row of the reduced axis.
_COST_PER_ELEM = {
    "clamp": 2, "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 4,
}
_ROW_REDUCE = {"_softmax": (5, 1), "_log_softmax": (5, 2),
               "logsumexp": (4, 5)}

MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "dot",
                    "convolution"})


def op_name(func) -> str:
    """The aten op's name without namespace or overload: ``"mm"``,
    ``"add_"``."""
    return func.overloadpacket.__name__


def _base_name(func) -> str:
    name = op_name(func)
    if name.endswith("_") and not name.startswith("_") and name not in _ZERO:
        return name[:-1]          # in-place arithmetic counts as its op
    return name


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point or t.dtype.is_complex


def dot_geometry(func, args) -> tuple[int, int, int, int] | None:
    """(G, M, N, K) of one matmul-family op, or None for a convolution."""
    name = op_name(func)
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name == "mm" or name == "addmm":
        (m, k), n = a.shape, b.shape[1]
        return 1, m, n, k
    if name in ("bmm", "baddbmm"):
        g, m, k = a.shape
        return g, m, b.shape[2], k
    if name == "mv":
        m, k = a.shape
        return 1, m, 1, k
    if name == "dot":
        return 1, 1, 1, a.shape[0]
    return None


def _conv_flops(args, out: torch.Tensor) -> float:
    # im2col equivalence: 2 * out_elems * (in_ch / groups) * kernel_spatial
    w = args[1]
    return 2.0 * out.numel() * w.shape[1] * math.prod(w.shape[2:])


def eqn_flops(func, args, kwargs, out) -> float:
    """Arithmetic-op cost of one recorded aten op."""
    name = _base_name(func)
    if name in _ZERO:
        return 0.0
    outs = _tensors(out)
    if not outs or not _is_float(outs[0]):
        return 0.0
    if name in MATMUL:
        if name == "convolution":
            return _conv_flops(args, outs[0])
        g, m, n, k = dot_geometry(func, args)
        return 2.0 * g * m * n * k
    ins = _tensors(args)
    if name in _REDUCE:
        return float(ins[0].numel())
    if name == "mean":
        return float(ins[0].numel() + outs[0].numel())
    if name in _ROW_REDUCE:
        x = ins[0]
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        width = math.prod(x.shape[d] for d in dims) if x.dim() else 1
        per_elem, per_row = _ROW_REDUCE[name]
        return float(per_elem * x.numel() + per_row * x.numel() // width)
    if name == "pow" and len(args) > 1 and not isinstance(
            args[1], torch.Tensor) and float(args[1]).is_integer():
        return max(1, abs(int(args[1])) - 1) * float(outs[0].numel())
    return _COST_PER_ELEM.get(name, 1) * float(outs[0].numel())


class _Counter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.flops += eqn_flops(func, args, kwargs, out)
        return out


def count_flops(fn, args=()) -> float:
    """Total arithmetic-op count of ``fn(*args)``: every aten op it
    dispatches, a backward pass it runs included.  ``args`` may be
    ``meta`` tensors (shapes only, no arithmetic)."""
    with _Counter() as c:
        fn(*args)
    return c.flops
