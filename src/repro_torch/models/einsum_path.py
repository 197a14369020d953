"""The pairwise order in which ``jnp.einsum`` contracts three operands.

jax hands a many-operand einsum to ``opt_einsum.contract_path(...,
optimize="auto", use_blas=True)`` and contracts the pairs it returns, one
``dot_general`` each (``jax/_src/numpy/einsum.py``).  The port imports
neither, so this module keeps that choice for three operands, where
``auto`` is opt_einsum's ``optimal`` search with no memory limit:

- the first pair is one of (0, 1), (0, 2), (1, 2), tried in that order;
  the one whose two contractions cost the fewest flops wins, a tie
  keeping the earlier pair;
- a contraction over the labels I costs ``prod(size[I])``, twice that
  when it sums a label away;
- the first pair's result is labelled in opt_einsum's tensordot order:
  its labels as they first appear in the higher-numbered operand's
  labels, then the lower's.

:func:`einsum3` runs the two pairs as two-operand ``torch.einsum`` calls,
the operand jax takes as ``rhs`` first (the lower-numbered one, then the
remaining input before the intermediate), so a product reads its
operands in jax's order and one that contracts nothing stays one product
(the capture lowers both as jax's ``dot_general``).  The values are the
reference's products of the same factors in the same order.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["contract_path", "einsum3"]


def _cost(labels, sums: bool, size: dict[str, int]) -> int:
    return math.prod(size[x] for x in labels) * (2 if sums else 1)


@functools.lru_cache(maxsize=256)
def contract_path(equation: str, *shapes) -> tuple[tuple, tuple]:
    """The two contractions of a three-operand ``equation`` at ``shapes``,
    as ``opt_einsum.contract_path(..., einsum_call=True)`` lists them:
    ``(positions, summed labels, "lhs,rhs->out")`` each, positions popped
    from the operand list (the first result is appended to it)."""
    ins, out = equation.replace(" ", "").split("->")
    terms = ins.split(",")
    if len(terms) != 3 or len(shapes) != 3:
        raise ValueError(f"three operands expected: {equation!r}")
    size: dict[str, int] = {}
    for term, shape in zip(terms, shapes):
        for x, d in zip(term, shape):
            if size.get(x, 1) == 1:     # a broadcast 1 takes the other size
                size[x] = int(d)
    sets = [frozenset(t) for t in terms]
    keep_out = frozenset(out)
    best = None
    for i, j in ((0, 1), (0, 2), (1, 2)):
        (k,) = {0, 1, 2} - {i, j}
        both = sets[i] | sets[j]
        kept = both & (keep_out | sets[k])
        flops = (_cost(both, bool(sets[i] & sets[j] - kept), size)
                 + _cost(kept | sets[k], bool(kept & sets[k] - keep_out),
                         size))
        if best is None or flops < best[0]:
            best = (flops, i, j, k, both, kept)
    _, i, j, k, both, kept = best
    first = "".join(sorted(kept, key=(terms[j] + terms[i]).find))
    last = frozenset(first) | sets[k]
    return (((j, i), both - kept, f"{terms[j]},{terms[i]}->{first}"),
            ((1, 0), last - keep_out, f"{first},{terms[k]}->{out}"))


def einsum3(equation: str, *operands: torch.Tensor,
            path: tuple | None = None) -> torch.Tensor:
    """``jnp.einsum(equation, *operands)`` for three operands, contracted
    pair by pair as jax contracts them at these shapes (or as ``path``,
    :func:`contract_path` of other shapes, says: a shard's operands take
    the whole arrays' order)."""
    (pos, _, eq1), (_, _, eq2) = path or contract_path(
        equation, *(tuple(t.shape) for t in operands))
    j, i = pos
    (k,) = {0, 1, 2} - {i, j}
    pair, first = eq1.split("->")
    lhs, rhs = pair.split(",")
    t = torch.einsum(f"{rhs},{lhs}->{first}", operands[i], operands[j])
    pair, out = eq2.split("->")
    lhs, rhs = pair.split(",")
    return torch.einsum(f"{rhs},{lhs}->{out}", operands[k], t)
