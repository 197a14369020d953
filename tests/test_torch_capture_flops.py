"""``repro_torch.capture.flops`` against ``repro.capture.flops``.

The counterparts of the reference's counter rules
(``tests/test_capture_model.py``: a dot plus an elementwise op, integer
ops at zero, reductions by input elements, a loop multiplied by its trip
count), each held equal to the reference's count of the same function;
and the aten ops that stand for several jax primitives (softmax,
log-softmax, clamp, an integer power) held to the reference's count of
the jax function they stand for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.capture import flops as JF
from repro_torch.capture import flops as F
from repro_torch.capture.model import jax_swaps


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _jax(fn, *shapes, dtype=jnp.float32):
    return JF.count_flops(jax.make_jaxpr(fn)(
        *(jax.ShapeDtypeStruct(s, dtype) for s in shapes)))


def test_dot_and_elementwise():
    got = F.count_flops(lambda x, y: torch.tanh(x @ y),
                        (_meta(64, 32), _meta(32, 16)))
    want = _jax(lambda x, y: jnp.tanh(x @ y), (64, 32), (32, 16))
    assert got == want == 2 * 64 * 16 * 32 + 64 * 16


def test_batched_dot_and_einsum():
    got = F.count_flops(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                        (_meta(4, 8, 16), _meta(4, 16, 32)))
    want = _jax(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                (4, 8, 16), (4, 16, 32))
    assert got == want == 2 * 4 * 8 * 32 * 16


def test_integer_ops_cost_zero():
    got = F.count_flops(lambda x: x + x * 2, (_meta(128, dtype=torch.int32),))
    want = _jax(lambda x: x + x * 2, (128,), dtype=jnp.int32)
    assert got == want == 0.0


def test_reduction_counts_input_elems():
    got = F.count_flops(lambda x: torch.sum(x), (_meta(64, 32),))
    want = _jax(lambda x: jnp.sum(x), (64, 32))
    assert got == want == 64 * 32


def test_loop_multiplies_by_trip_count():
    """The reference's ``scan`` body counted ``length`` times is the
    port's Python loop, run that many times."""
    def port(xs):
        c = torch.zeros(128, device=xs.device)
        for x in xs:
            c = c + x
        return c

    def ref(xs):
        return jax.lax.scan(lambda c, x: (c + x, None),
                            jnp.zeros((128,)), xs)[0]

    assert F.count_flops(port, (_meta(8, 128),)) == _jax(ref, (8, 128)) \
        == 8 * 128


def test_backward_pass_is_counted():
    """A backward pass's products are counted like the reference's
    transposed ones: the forward and the two gradient products."""
    w = torch.empty(32, 16, device="meta", requires_grad=True)

    def port(x):
        (x @ w).sum().backward()

    want = _jax(lambda x, w: jax.grad(lambda w: jnp.sum(x @ w))(w),
                (64, 32), (32, 16))
    got = F.count_flops(port, (_meta(64, 32),))
    assert got >= 2 * (2 * 64 * 32 * 16)
    assert abs(got - want) <= 64 * 16 + 32 * 16


@pytest.mark.parametrize("case", ["softmax", "log_softmax", "logsumexp",
                                  "clamp", "square", "cube"])
def test_composite_ops_match_their_jax_primitives(case):
    port = {"softmax": lambda x: torch.softmax(x, -1),
            "logsumexp": lambda x: torch.logsumexp(x, -1),
            "log_softmax": lambda x: torch.log_softmax(x, -1),
            "clamp": lambda x: torch.clamp(x, -1.0, 1.0),
            "square": lambda x: x ** 2,
            "cube": lambda x: x ** 3}[case]
    ref = {"softmax": lambda x: jax.nn.softmax(x, -1),
           "logsumexp": lambda x: jax.nn.logsumexp(x, -1),
           "log_softmax": lambda x: jax.nn.log_softmax(x, -1),
           "clamp": lambda x: jnp.clip(x, -1.0, 1.0),
           "square": lambda x: x ** 2,
           "cube": lambda x: x ** 3}[case]
    assert F.count_flops(port, (_meta(16, 64),)) == _jax(ref, (16, 64))


def test_data_movement_costs_zero():
    def port(x, i):
        y = x.to(torch.bfloat16).reshape(64, 16).t().contiguous()
        return torch.cat([y, y]), x[i], torch.where(x > 0, x, 0.0)

    got = F.count_flops(port, (_meta(16, 64),
                               torch.zeros(3, dtype=torch.long,
                                           device="meta")))
    assert got == 0.0


@pytest.mark.parametrize("eq", [
    "bsd,dhk->bshk", "bsgrd,btgd->bgrst", "bgrst,btgd->bsgrd",
    "bshk,hkd->bsd", "bin,bjn->bij", "bijh,bjhp->bihp", "bn,bh->bnh",
    "bnh,bhp->bhnp", "bqn,bhnp->bqhp", "btr,rhk->bthk", "bhst,btr->bshr",
])
def test_jax_swaps_matches_jax_einsum(eq):
    """:func:`jax_swaps` predicts which operand jax's einsum puts first
    in its ``dot_general``."""
    ins, _, _ = eq.partition("->")
    la, lb = ins.split(",")
    size = {c: 2 + i for i, c in enumerate(sorted(set(la + lb)))}
    a = jax.ShapeDtypeStruct(tuple(size[c] for c in la), jnp.float32)
    b = jax.ShapeDtypeStruct(tuple(size[c] for c in lb), jnp.float32)
    jx = jax.make_jaxpr(lambda x, y: jnp.einsum(eq, x, y))(a, b)

    def dots(j):
        for e in j.eqns:
            if e.primitive.name == "dot_general":
                yield e
            for v in e.params.values():
                if hasattr(v, "jaxpr"):
                    yield from dots(v.jaxpr)
                elif hasattr(v, "eqns"):
                    yield from dots(v)

    (dot,) = list(dots(jx.jaxpr))
    lhs_shape = tuple(dot.invars[0].aval.shape)
    swapped = lhs_shape != a.shape or (a.shape == b.shape and
                                       dot.invars[0] is not jx.jaxpr.invars[0])
    assert jax_swaps(eq) == swapped
    np.testing.assert_equal(lhs_shape in (a.shape, b.shape), True)
