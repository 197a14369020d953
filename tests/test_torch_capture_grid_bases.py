"""``repro_torch.capture.grid.walk(bases=)`` against the reference's.

A whole-model capture places every op in one address space by handing
the walker each operand's base; the port's walker must place them byte
for byte as ``repro.capture.grid.walk(bases=)`` does, full walks and
count-only walks alike, on the 24 captured entries' mirror geometry (one
core) and on one-step launches (the count-only shortcut).
"""

import numpy as np
import pytest

from repro.capture.grid import GridCapture as JaxGridCapture
from repro.capture.grid import OperandSpec as JaxOperandSpec
from repro.capture.grid import walk as jax_walk
from repro.capture.kernels import CAPTURED_KERNELS as JAX_KERNELS
from repro_torch.capture.grid import GridCapture, OperandSpec, walk
from repro_torch.capture.kernels import CAPTURED_KERNELS
from repro_torch.core.tracegen import stable_name_seed

NAMES = [k.name for k in CAPTURED_KERNELS]
JAX_BY_NAME = {k.name: k for k in JAX_KERNELS}


def _bases(cap, seed: int) -> dict[str, int]:
    """Scattered, line-aligned bases for every operand name."""
    rng = np.random.default_rng(seed)
    names = sorted({op.name for op in cap.operands})
    return {n: int(rng.integers(0, 1 << 30)) * 8 for n in names}


def _same(got, want) -> None:
    assert got.addresses.tobytes() == want.addresses.tobytes()
    assert (got.loads, got.stores, got.flops, got.grid_steps,
            got.footprint_words, got.refs) == (
        want.loads, want.stores, want.flops, want.grid_steps,
        want.footprint_words, want.refs)


@pytest.mark.parametrize("name", NAMES)
def test_walk_with_bases_byte_identical(name):
    port = next(k for k in CAPTURED_KERNELS if k.name == name)
    seed = stable_name_seed(name)
    cap = port.builder(1, np.random.default_rng(seed), "cpu")
    ref = JAX_BY_NAME[name].builder(1, np.random.default_rng(seed),
                                    path="mirror")
    bases = _bases(cap, seed)
    _same(walk(cap, bases=bases), jax_walk(ref, bases=bases))
    _same(walk(cap, bases=bases, count_only=True),
          jax_walk(ref, bases=bases, count_only=True))
    # the default layout is a special case of the explicit one
    _same(walk(cap), jax_walk(ref))


def _one_step(ns):
    shapes = ((64, 96), (96,), (64, 96))
    ops = [ns[1](name=n, role=r, shape=s, block_shape=s,
                 index_map=lambda *i, _k=len(s): (0,) * _k)
           for n, r, s in zip(("a", "b", "o"), ("in", "in", "out"), shapes)]
    return ns[0](name="one", grid=(), operands=tuple(ops), flops=123.0)


def test_one_step_count_only_shortcut():
    cap = _one_step((GridCapture, OperandSpec))
    ref = _one_step((JaxGridCapture, JaxOperandSpec))
    bases = {"a": 80, "b": 4096, "o": 1 << 20}
    counted = walk(cap, bases=bases, count_only=True)
    _same(counted, jax_walk(ref, bases=bases, count_only=True))
    full = walk(cap, bases=bases)
    _same(full, jax_walk(ref, bases=bases))
    assert counted.addresses.size == 0
    assert (counted.loads, counted.stores) == (full.loads, full.stores) == (
        (64 * 96 + 96) // 2, 64 * 96 // 2)


def test_index_map_table_memo_is_per_grid():
    """The per-map table memo never hands one grid's table to another."""
    imap = lambda i, j: (i, j)          # noqa: E731
    op = OperandSpec(name="x", role="in", shape=(32, 32),
                     block_shape=(8, 8), index_map=imap)
    small = walk(GridCapture("s", (2, 2), (op,)))
    big = walk(GridCapture("b", (4, 4), (op,)))
    again = walk(GridCapture("s", (2, 2), (op,)))
    assert small.loads == again.loads == 4 * 32
    assert big.loads == 16 * 32
    assert small.addresses.tobytes() == again.addresses.tobytes()
