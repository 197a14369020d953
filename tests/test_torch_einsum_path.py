"""``repro_torch.models.einsum_path`` against the choice jax makes.

``jnp.einsum`` hands a many-operand einsum to ``opt_einsum.contract_path(
..., optimize="auto", use_blas=True)``; the port keeps its own copy of that
choice for three operands.  Held here:

- the same pairs, summed labels and intermediate labels as opt_einsum for
  the SSD's two einsums and the decode's, at every shape the zoo's SSM
  configs give them (smoke and full width, each batch and chunk length of
  the sweep) and at drawn small shapes;
- ``einsum3`` equal to ``jnp.einsum`` on seeded inputs.
"""

import numpy as np
import opt_einsum
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch import configs
from repro_torch.models.einsum_path import contract_path, einsum3

SSD = ("bqn,bqh,bhnp->bqhp", "bqh,bqn,bqhp->bhnp")   # y_off, the state's
DECODE = "bh,bn,bhp->bhnp"
SSM_ARCHS = ("mamba2-780m", "zamba2-7b")


def _shapes(eq: str, size: dict) -> list[tuple]:
    return [tuple(size[x] for x in t) for t in eq.split("->")[0].split(",")]


def _jax_path(eq: str, shapes) -> tuple:
    _, contractions = opt_einsum.contract_path(
        eq, *shapes, shapes=True, einsum_call=True, use_blas=True,
        optimize="auto")
    return tuple((pos, frozenset(removed), s)
                 for pos, removed, s, *_ in contractions)


def _zoo_sizes(arch: str, full: bool) -> list[dict]:
    """Every (B, Q, H, N, P) the zoo's sweep hands the SSD of ``arch``:
    batches 1-64, sequences 128 and 512 (Q = min(chunk, S))."""
    cfg = configs.get(arch) if full else configs.get_smoke(arch)
    return [dict(b=b, q=min(cfg.ssm_chunk, s), h=cfg.n_ssm_heads,
                 n=cfg.ssm_state, p=cfg.ssm_head_dim)
            for b in (1, 4, 8, 16, 32, 64) for s in (128, 512)]


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("eq", SSD + (DECODE,))
def test_path_is_jax_choice_at_zoo_shapes(eq, arch, full):
    for size in _zoo_sizes(arch, full):
        shapes = _shapes(eq, size)
        assert contract_path(eq, *shapes) == _jax_path(eq, shapes), size


@settings(max_examples=300, deadline=None)
@given(eq=st.sampled_from(SSD + (DECODE,)),
       dims=st.lists(st.integers(1, 64), min_size=5, max_size=5))
def test_path_is_jax_choice_at_drawn_shapes(eq, dims):
    size = dict(zip("bqhnp", dims))
    shapes = _shapes(eq, size)
    assert contract_path(eq, *shapes) == _jax_path(eq, shapes)


def test_paths_at_smoke_and_full_width_differ_as_jax_does():
    """At a smoke width jax forms the outer product first; at mamba2-780m's
    width it contracts C with the state first and scales after."""
    smoke = _zoo_sizes("mamba2-780m", False)[0]
    full = _zoo_sizes("mamba2-780m", True)[0]
    (_, _, eq1), _ = contract_path(SSD[0], *_shapes(SSD[0], smoke))
    assert eq1 == "bqh,bqn->bqhn"
    (_, _, eq1), (_, _, eq2) = contract_path(SSD[0], *_shapes(SSD[0], full))
    assert (eq1, eq2) == ("bhnp,bqn->bhpq", "bhpq,bqh->bqhp")


@pytest.mark.parametrize("eq", SSD + (DECODE,))
@pytest.mark.parametrize("size", [dict(b=2, q=8, h=3, n=5, p=4),
                                  dict(b=1, q=32, h=48, n=128, p=64)],
                         ids=["small", "wide"])
def test_einsum3_is_jnp_einsum(eq, size):
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in _shapes(eq, size)]
    got = einsum3(eq, *(torch.from_numpy(a) for a in arrays)).numpy()
    want = np.asarray(jnp.einsum(eq, *arrays))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
