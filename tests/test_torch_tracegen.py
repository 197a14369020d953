"""The port's synthetic families (``repro_torch.core.tracegen``) against
the reference's (``repro.core.tracegen``).

Every entry of the 21-point synthetic grid and of ``make_suite`` (with
jittered variants) must give byte-identical word addresses and equal
``l3_factor``, ``mlp`` and ``dram_rows_irregular`` at cores 1, 4 and 256:
the generators are copied and draw from numpy's ``default_rng`` streams,
so no tolerance applies.  The grid is also generated at full width
(``DEFAULT_REFS``)."""

import numpy as np
import pytest

from repro.core import tracegen as jax_tracegen
from repro.suite.registry import _synthetic_grid as jax_grid
from repro_torch.core import tracegen
from repro_torch.suite.registry import _synthetic_grid

REFS = 2_000
CORES = (1, 4, 256)

GRID = {w.name: w for w, _ in _synthetic_grid(REFS)}
JAX_GRID = {w.name: w for w, _ in jax_grid(REFS)}
SUITE = {w.name: w for w in tracegen.make_suite(refs=REFS, variants=2)}
JAX_SUITE = {w.name: w for w in jax_tracegen.make_suite(refs=REFS,
                                                        variants=2)}


def assert_same_trace(port_w, jax_w, cores, seed=0):
    got, want = port_w.trace(cores, seed=seed), jax_w.trace(cores, seed=seed)
    assert got.addresses.dtype == want.addresses.dtype == np.int64
    assert got.addresses.tobytes() == want.addresses.tobytes()
    assert (got.l3_factor, got.mlp, got.dram_rows_irregular) == (
        want.l3_factor, want.mlp, want.dram_rows_irregular)


def assert_same_record(port_w, jax_w):
    assert (port_w.name, port_w.family, port_w.expected_class,
            port_w.ai_ops_per_access, port_w.instr_per_access,
            port_w.core_invariant) == (
        jax_w.name, jax_w.family, jax_w.expected_class,
        jax_w.ai_ops_per_access, jax_w.instr_per_access,
        jax_w.core_invariant)


def test_constants_equal_the_reference():
    assert tracegen.DEFAULT_REFS == jax_tracegen.DEFAULT_REFS
    assert tracegen.FAMILIES == jax_tracegen.FAMILIES
    assert tracegen._HOT_WORDS == jax_tracegen._HOT_WORDS
    assert list(GRID) == list(JAX_GRID) and len(GRID) == 21
    assert list(SUITE) == list(JAX_SUITE) and len(SUITE) == 28


@pytest.mark.parametrize("name", list(JAX_GRID))
def test_grid_entry_equals_reference(name):
    assert_same_record(GRID[name], JAX_GRID[name])
    for cores in CORES:
        assert_same_trace(GRID[name], JAX_GRID[name], cores)


@pytest.mark.parametrize("name", list(JAX_SUITE))
def test_make_suite_entry_equals_reference(name):
    assert_same_record(SUITE[name], JAX_SUITE[name])
    for cores in CORES:
        assert_same_trace(SUITE[name], JAX_SUITE[name], cores)


@pytest.mark.parametrize("seed", [1, 7])
def test_make_suite_seed_and_trace_seed(seed):
    port = tracegen.make_suite(refs=REFS, seed=seed)
    ref = jax_tracegen.make_suite(refs=REFS, seed=seed)
    for p, r in zip(port, ref, strict=True):
        assert_same_record(p, r)
        assert_same_trace(p, r, 4, seed=seed)


def test_mix_hot_cold_equals_reference():
    rng = np.random.default_rng(3)
    hot = rng.integers(0, 100, size=997)
    cold = rng.integers(1000, 2000, size=143)
    for every in (2, 7, 8):
        got = tracegen._mix_hot_cold(hot, cold, every)
        assert got.tobytes() == jax_tracegen._mix_hot_cold(
            hot, cold, every).tobytes()


FULL = {w.name: w for w, _ in _synthetic_grid(tracegen.DEFAULT_REFS)}
JAX_FULL = {w.name: w for w, _ in jax_grid(jax_tracegen.DEFAULT_REFS)}


@pytest.mark.parametrize("name", list(JAX_FULL))
def test_grid_entry_at_full_width(name):
    """Generation only, at ``DEFAULT_REFS`` (blocked entries draw twice
    that, contended ones their own sweep length, the repeated runs of
    l1cap and gemm a whole number of runs)."""
    for cores in (1, 256):
        assert_same_trace(FULL[name], JAX_FULL[name], cores)
    if FULL[name].family in ("stream", "irregular", "chase"):
        assert FULL[name].trace(1).addresses.size == tracegen.DEFAULT_REFS
