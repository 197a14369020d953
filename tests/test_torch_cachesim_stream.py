"""The port's chunk-streamed simulator (``simulate_chunked``) against the
reference's and against the port's in-memory path, the cases of
``tests/test_cachesim_seg_stream.py`` (``TestChunkedStreaming`` and the
truncated megaref prefix; its 10M-ref case runs on the card's host in
``chip_smoke.py``): every family x hierarchy, chunk-size invariance,
spilling to disk, generator input, the empty trace.  ``scan="cuda"`` raises
without a card, and its loop equals the NumPy scan through the window
count's plain version."""

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.core import cachesim as jax_cachesim
from repro.core.cachesim_stream import simulate_chunked as jax_chunked
from repro_torch import obs
from repro_torch.core import cachesim, cachesim_vec, tracegen
from repro_torch.core.cachesim_stream import (_Blocks, _stripes_for,
                                              simulate_chunked)

REFS = 4_000

CONFIGS = {
    "host": lambda c: c.host_config(4),
    "host+pf": lambda c: c.host_config(4, prefetcher=True),
    "host+nuca": lambda c: c.host_config(4, nuca_mb_per_core=2.0),
    "ndp": lambda c: c.ndp_config(4),
}


def _one_per_family():
    byfam = {}
    for w in tracegen.make_suite(refs=REFS):
        byfam.setdefault(w.family, w)
    assert set(byfam) == set(tracegen.FAMILIES)
    return byfam


WORKLOADS = _one_per_family()


def _counters(sim):
    return (sim.level_hits, sim.level_misses, sim.lines_touched,
            sim.prefetch_issued, sim.prefetch_useful, sim.accesses,
            sim.instructions)


def _megaref_trace(n: int, seed: int = 0) -> np.ndarray:
    """The reference tests' megaref shape: strided sweeps over a bounded
    footprint with a hot reuse set (``tests/test_cachesim_seg_stream.py``,
    ``_megaref_trace``)."""
    rng = np.random.default_rng(seed)
    footprint = 1 << 19
    sweep = (np.arange(n, dtype=np.int64) * 3) % footprint
    hot = rng.integers(0, 4_096, n, dtype=np.int64)
    pick = rng.random(n) < 0.3
    return np.where(pick, hot, sweep) * 8


@pytest.mark.parametrize("config_name", sorted(CONFIGS))
@pytest.mark.parametrize("family", sorted(tracegen.FAMILIES))
def test_chunked_matches_reference_and_in_memory(family, config_name):
    w = WORKLOADS[family]
    addr = w.trace(4).addresses
    cfg = CONFIGS[config_name](cachesim)
    kwargs = dict(ai_ops_per_access=w.ai_ops_per_access,
                  instr_per_access=w.instr_per_access,
                  l3_factor=0.5 if cfg.shared_llc else 1.0)
    want = cachesim.simulate(addr.copy(), cfg, backend="vectorized", **kwargs)
    got = simulate_chunked(addr.copy(), cfg, chunk=997, **kwargs)
    ref = jax_chunked(addr.copy(), CONFIGS[config_name](jax_cachesim),
                      chunk=997, **kwargs)
    assert _counters(got) == _counters(want) == _counters(ref)
    assert got.lfmr == want.lfmr and got.mpki == ref.mpki


@pytest.mark.parametrize("chunk", [1, 63, 4_096, 10**9])
def test_chunk_size_invariance(chunk):
    addr = WORKLOADS["irregular"].trace(4).addresses
    cfg = cachesim.host_config(4)
    want = cachesim.simulate(addr.copy(), cfg, backend="vectorized")
    got = simulate_chunked(addr.copy(), cfg, chunk=chunk)
    assert _counters(got) == _counters(want)


def test_spill_to_disk_preserves_counters():
    addr = WORKLOADS["contended"].trace(4).addresses
    cfg = cachesim.host_config(4, prefetcher=True)
    want = cachesim.simulate(addr.copy(), cfg, backend="vectorized")
    obs.reset_counters()
    got = simulate_chunked(addr.copy(), cfg, chunk=512, spill_bytes=1)
    assert _counters(got) == _counters(want)
    assert obs.counters()["stream.spill.bytes"] > 0


def test_generator_input_never_materializes():
    addr = WORKLOADS["stream"].trace(4).addresses
    cfg = cachesim.ndp_config(4)
    want = cachesim.simulate(addr.copy(), cfg, backend="vectorized")

    def blocks():
        for lo in range(0, addr.size, 777):
            yield addr[lo:lo + 777].copy()

    obs.reset_counters()
    got = simulate_chunked(blocks(), cfg, chunk=777)
    assert _counters(got) == _counters(want)
    assert obs.counters()["stream.gen.blocks"] == -(-addr.size // 777)


def test_empty_trace():
    got = simulate_chunked(np.empty(0, dtype=np.int64),
                           cachesim.host_config(1))
    assert got.accesses == 0 and got.level_misses == (0, 0, 0)


def test_truncated_megaref_prefix():
    addr = _megaref_trace(200_000)
    cfg = cachesim.host_config(4)
    want = cachesim.simulate(addr.copy(), cfg, backend="vectorized")
    got = simulate_chunked(addr.copy(), cfg, chunk=1 << 14)
    ref = jax_chunked(addr.copy(), jax_cachesim.host_config(4),
                      chunk=1 << 14)
    assert _counters(got) == _counters(want) == _counters(ref)


def test_counters_equal_the_reference():
    addr = WORKLOADS["contended"].trace(4).addresses
    obs.reset_counters()
    jax_obs.reset_counters()
    simulate_chunked(addr.copy(), cachesim.host_config(4, prefetcher=True),
                     chunk=512, spill_bytes=4096)
    jax_chunked(addr.copy(), jax_cachesim.host_config(4, prefetcher=True),
                chunk=512, spill_bytes=4096)
    mine, theirs = obs.counters(), jax_obs.counters()
    assert mine == theirs
    assert mine["stream.level"] == 2 and mine["pf.replay"] == 1
    assert mine["stream.stripe"] > 1


def test_blocks_store_spills_and_replays_in_order():
    store = _Blocks(budget=64, tag="t")
    parts = [np.arange(i, i + 10, dtype=np.int64) for i in range(0, 50, 10)]
    for p in parts:
        store.append(p)
    assert store.total == 50 and len(store) == 5
    assert all(np.array_equal(a, b) for a, b in zip(store, parts))
    store.close()
    assert list(store) == []


def test_stripes_keep_a_hot_set_alone():
    stripes = _stripes_for(np.array([3, 3, 100, 2, 2, 2]), chunk=8)
    assert stripes.tolist() == [0, 0, 1, 2, 2, 2]


def test_cuda_scan_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    addr = WORKLOADS["stream"].trace(4).addresses
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_chunked(addr, cachesim.host_config(4), scan="cuda")


def test_cuda_scan_loop_equals_numpy_scan(monkeypatch):
    monkeypatch.setattr(cachesim_vec, "_scan_device",
                        lambda: torch.device("cpu"))
    addr = WORKLOADS["irregular"].trace(4).addresses
    cfg = cachesim.host_config(4)
    obs.reset_counters()
    want = simulate_chunked(addr.copy(), cfg, chunk=1_024)
    got = simulate_chunked(addr.copy(), cfg, chunk=1_024, scan="cuda")
    assert _counters(got) == _counters(want)
    assert obs.counters()["scan.cuda"] > 0
