"""The port's captured traces against the reference's mirror geometry.

For each of the 24 captured entries and every core count of the sweep, the
word trace walked from the spec the port's launcher launched (on the CPU,
through the plain versions) must be byte-identical to the reference's
``walk(spec.builder(cores, rng, path="mirror"))``, with equal loads,
stores and flops; the AI column must be equal too.
"""

import numpy as np
import pytest
import torch

from repro.capture.grid import walk as jax_walk
from repro.capture.kernels import CAPTURED_KERNELS as JAX_KERNELS
from repro.capture.kernels import captured_workloads as jax_workloads
from repro.core.sweep import CORE_SWEEP as JAX_CORE_SWEEP
from repro.core.tracegen import stable_name_seed as jax_name_seed
from repro_torch.capture.grid import walk
from repro_torch.capture.kernels import CAPTURED_KERNELS, captured_workloads
from repro_torch.capture.launch import record
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.core.tracegen import stable_name_seed
from repro_torch.kernels.flash_attention import mha
from repro_torch.kernels.flash_attention.ops import launch_spec

NAMES = [k.name for k in CAPTURED_KERNELS]
JAX_BY_NAME = {k.name: k for k in JAX_KERNELS}


def test_slice_is_the_first_four_families():
    """The roster is the reference's six families, all 24 entries, in the
    reference's order and with its metadata."""
    assert len(NAMES) == 24
    assert NAMES == [k.name for k in JAX_KERNELS]
    assert {k.kernel for k in CAPTURED_KERNELS} == {
        "stream", "gather", "flashattn", "pagedkv", "moe", "ssm"}
    assert CORE_SWEEP == JAX_CORE_SWEEP
    for k in CAPTURED_KERNELS:
        j = JAX_BY_NAME[k.name]
        assert (k.kernel, k.domain, k.expected_class, k.target_refs,
                k.l3_shared, k.mlp, k.dram_rows_irregular, k.instr_overhead,
                k.geometry, k.core_invariant) == (
            j.kernel, j.domain, j.expected_class, j.target_refs,
            j.l3_shared, j.mlp, j.dram_rows_irregular, j.instr_overhead,
            j.geometry, j.core_invariant)
        assert stable_name_seed(k.name) == jax_name_seed(k.name)


@pytest.mark.parametrize("cores", CORE_SWEEP)
@pytest.mark.parametrize("name", NAMES)
def test_trace_byte_identical_to_reference_mirror(name, cores):
    port = next(k for k in CAPTURED_KERNELS if k.name == name)
    seed = stable_name_seed(name)
    got = walk(port.builder(cores, np.random.default_rng(seed), "cpu"))
    want = jax_walk(JAX_BY_NAME[name].builder(
        cores, np.random.default_rng(seed), path="mirror"))
    assert got.addresses.dtype == want.addresses.dtype == np.int64
    assert got.addresses.tobytes() == want.addresses.tobytes()
    assert (got.loads, got.stores, got.flops, got.grid_steps,
            got.footprint_words) == (want.loads, want.stores, want.flops,
                                     want.grid_steps, want.footprint_words)


def test_ai_column_equals_reference():
    port = captured_workloads(device="cpu")
    ref = {w.name: w for w in jax_workloads()}
    for w in port:
        r = ref[w.name]
        assert (w.family, w.expected_class, w.ai_ops_per_access,
                w.instr_per_access, w.core_invariant) == (
            r.family, r.expected_class, r.ai_ops_per_access,
            r.instr_per_access, r.core_invariant)


def test_count_only_walk_matches_full_walk():
    cap = CAPTURED_KERNELS[-1].builder(1, np.random.default_rng(0), "cpu")
    full, counted = walk(cap), walk(cap, count_only=True)
    assert counted.addresses.size == 0
    assert (counted.loads, counted.stores) == (full.loads, full.stores)
    assert full.refs == full.addresses.size


def test_capture_is_memoized_per_geometry():
    """A core sweep over a core-invariant entry launches once."""
    gather = next(k for k in CAPTURED_KERNELS if k.kernel == "gather")
    with record() as launched:
        a = gather.builder(1, np.random.default_rng(5), "cpu")
        b = gather.builder(64, np.random.default_rng(5), "cpu")
    assert a is b
    assert len(launched) <= 1


def test_gqa_spec_maps_query_heads_onto_their_kv_head():
    """Folded (b*h) program ids read kv head (b*g) + h // (H/G)."""
    spec = launch_spec(2, 128, 256, 4, 2, 64, torch.float32)
    kv = spec.operand("k").index_map
    assert spec.grid == (8, 1, 2)
    assert [kv(bh, 0, 1)[0] for bh in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
    q = torch.zeros(2, 128, 4, 64)
    kvt = torch.zeros(2, 256, 2, 64)
    with record() as launched:
        mha(q, kvt, kvt, causal=False)
    cap = launched[0].to_grid_capture()
    res = walk(cap)
    # each q tile once, each kv tile once per (q tile, kv step), o once
    tile = 128 * 64 // 2
    assert res.loads == 8 * tile + 2 * 8 * 2 * tile
    assert res.stores == 8 * tile
