"""The port's segmented simulator against the reference's.

``repro_torch.core.cachesim_vec.simulate_many`` equals the reference's
``simulate_many`` and per-trace ``simulate_batch`` on the matrix of
``tests/test_cachesim_seg_stream.py`` (one trace per family, four
hierarchies, ragged LLC factors).  With counters reset and memo pools
emptied in both packages, the same ``simulate_batch`` / ``simulate_many``
calls give the same counter dicts (``scan.jax`` against ``scan.cuda``
aside), the hand counts of ``tests/test_obs.py`` included.  The ``cuda``
scan runs here through the window count's plain version (its ``q`` put on
the CPU), equal to the NumPy scan, counters and all.  Last, the engine:
``SimEngine.simulate_cells`` equals per-cell ``simulate``."""

import numpy as np
import pytest

from repro import obs as jax_obs
from repro.core import cachesim as jax_cachesim
from repro.core import cachesim_vec as jax_vec
from repro.core import tracegen as jax_tracegen
from repro.study.engine import SimEngine as JaxEngine
from repro_torch import obs
from repro_torch.core import cachesim, cachesim_vec, tracegen
from repro_torch.core.tracegen import TraceSpec, Workload
from repro_torch.kernels import window_scan
from repro_torch.study.engine import SimEngine
from repro_torch.suite import ResultStore

REFS = 4_000

CONFIGS = {
    "host": lambda c: c.host_config(4),
    "host+pf": lambda c: c.host_config(4, prefetcher=True),
    "host+nuca": lambda c: c.host_config(4, nuca_mb_per_core=2.0),
    "ndp": lambda c: c.ndp_config(4),
}
FAMILIES = sorted(tracegen.FAMILIES)


def _one_per_family(module):
    byfam = {}
    for w in module.make_suite(refs=REFS):
        byfam.setdefault(w.family, w)
    return byfam


PORT_W = _one_per_family(tracegen)
JAX_W = _one_per_family(jax_tracegen)


def _counters(sim):
    return (sim.level_hits, sim.level_misses, sim.lines_touched,
            sim.prefetch_issued, sim.prefetch_useful, sim.accesses,
            sim.instructions)


def _configs(module, names=None):
    return [CONFIGS[k](module) for k in (names or sorted(CONFIGS))]


def _opts(w):
    return {"ai_ops_per_access": w.ai_ops_per_access,
            "instr_per_access": w.instr_per_access,
            "l3_factor": (1.0, 0.25, 1.0, 1.0 / 16)}


def _requests(module, workloads, families=FAMILIES):
    """One request per family, all four hierarchies each; fresh array
    copies, so every trace misses the memo pool."""
    return [(workloads[f].trace(4).addresses.copy(), _configs(module),
             _opts(workloads[f])) for f in families]


@pytest.fixture
def clean():
    """Both packages' counters zeroed and memo pools emptied, so their
    ``memo.*`` gauges start alike."""
    for vec, o in ((cachesim_vec, obs), (jax_vec, jax_obs)):
        with vec._MEMOS_LOCK:
            vec._MEMOS.clear()
            vec._MEMO_BYTES_LAST = 0
        o.reset_counters()
    yield
    for o in (obs, jax_obs):
        o.reset_counters()


def _both_counters():
    mine, theirs = obs.counters(), jax_obs.counters()
    mine.pop("scan.cuda", None)
    theirs.pop("scan.jax", None)
    return mine, theirs


def test_port_traces_equal_the_reference_traces():
    for f in FAMILIES:
        assert np.array_equal(PORT_W[f].trace(4).addresses,
                              JAX_W[f].trace(4).addresses)


# --------------------------------------------------------------------------
# simulate_many: the segmented matrix
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_many_equals_reference_many_and_per_trace_batch(family):
    got = cachesim_vec.simulate_many(_requests(cachesim, PORT_W))
    want = jax_vec.simulate_many(_requests(jax_cachesim, JAX_W))
    k = FAMILIES.index(family)
    assert [_counters(s) for s in got[k]] == [_counters(s) for s in want[k]]
    addr, configs, opts = _requests(cachesim, PORT_W, [family])[0]
    batch = cachesim_vec.simulate_batch(addr, configs, **opts)
    assert [_counters(s) for s in got[k]] == [_counters(s) for s in batch]
    assert [s.lfmr for s in got[k]] == [s.lfmr for s in batch]
    assert [s.mpki for s in got[k]] == [s.mpki for s in want[k]]
    assert [s.name for s in got[k]] == [s.name for s in want[k]]


def test_many_counters_equal_the_reference(clean):
    cachesim_vec.simulate_many(_requests(cachesim, PORT_W))
    jax_vec.simulate_many(_requests(jax_cachesim, JAX_W))
    mine, theirs = _both_counters()
    assert mine == theirs
    assert 0 < mine["profile.scan"] <= mine["profile.geom"]
    assert mine["profile.scan"] < len(FAMILIES) * 3   # not one per trace
    assert mine["profile.segments"] >= 2


def test_batch_counters_equal_the_reference_cold_and_warm(clean):
    addr = PORT_W["contended"].trace(4).addresses.copy()
    jaddr = addr.copy()
    for _ in range(2):                     # cold, then every node recalled
        cachesim_vec.simulate_batch(addr, _configs(cachesim), l3_factor=0.5)
        jax_vec.simulate_batch(jaddr, _configs(jax_cachesim), l3_factor=0.5)
        mine, theirs = _both_counters()
        assert mine == theirs
    assert mine["memo.hit"] == 1 and mine["node.reuse"] > 0
    addr[0] += 8                           # mutated in place: recompute
    jaddr[0] += 8
    cachesim_vec.simulate_batch(addr, _configs(cachesim, ["ndp"]))
    jax_vec.simulate_batch(jaddr, _configs(jax_cachesim, ["ndp"]))
    mine, theirs = _both_counters()
    assert mine == theirs and mine["memo.invalidate"] == 1


def test_memo_hand_counts(clean):
    """``tests/test_obs.py``'s hand counts on the port."""
    w = tracegen.make_suite(refs=2_000)[0]
    addr = w.trace(4).addresses.copy()
    cfg = cachesim.host_config(4)          # L1 -> L2 -> L3
    cachesim_vec.simulate_batch(addr, [cfg])
    c = obs.counters()
    assert c["memo.miss"] == 1 and "memo.hit" not in c
    assert c["profile.geom"] == 3 == c["profile.scan"]
    assert c["node.compute"] == 3 and "node.reuse" not in c

    obs.reset_counters()
    cachesim_vec.simulate_batch(addr, [cfg])
    c = obs.counters()
    assert c["memo.hit"] == 1 and "memo.miss" not in c
    assert c["node.reuse"] == 3 and "node.compute" not in c
    assert "profile.scan" not in c


def test_segmented_scan_bounded_by_geometries(clean):
    """Two LLC variants behind the host-L2 and pf-L2 miss streams share
    one segmented scan, so ``profile.scan < profile.geom``."""
    w = tracegen.make_suite(refs=2_000)[1]
    addr = w.trace(4).addresses.copy()
    cfgs = [cachesim.host_config(4), cachesim.ndp_config(4),
            cachesim.host_config(4, prefetcher=True)]
    cachesim_vec.simulate_batch(addr, cfgs)
    c = obs.counters()
    assert 0 < c["profile.scan"] < c["profile.geom"]
    assert c.get("profile.segments", 0) >= 2
    assert c["pf.replay"] == 1


def test_empty_and_single_requests():
    assert cachesim_vec.simulate_many([]) == []
    assert cachesim.simulate_many([]) == []
    addr = PORT_W["stream"].trace(4).addresses.copy()
    cfg = cachesim.host_config(4)
    [sims] = cachesim_vec.simulate_many([(addr, [cfg], {})])
    want = cachesim.simulate(addr.copy(), cfg, backend="vectorized")
    assert _counters(sims[0]) == _counters(want)


@pytest.mark.parametrize("backend", ["reference", "vectorized"])
def test_cachesim_simulate_many_backends_agree(backend):
    reqs = _requests(cachesim, PORT_W, ["stream", "irregular"])
    got = cachesim.simulate_many(reqs, backend=backend)
    ref = jax_cachesim.simulate_many(
        _requests(jax_cachesim, JAX_W, ["stream", "irregular"]),
        backend="reference")
    assert [[_counters(s) for s in r] for r in got] == \
        [[_counters(s) for s in r] for r in ref]


def test_reference_loop_spot_check():
    addr = PORT_W["stream"].trace(4).addresses.copy()
    cfg = cachesim.host_config(4, prefetcher=True)
    [sims] = cachesim_vec.simulate_many([(addr, [cfg], {})])
    ref = cachesim.simulate(addr.copy(), cfg, backend="reference")
    assert _counters(sims[0]) == _counters(ref)


# --------------------------------------------------------------------------
# The cuda scan's loop, through the window count's plain version
# --------------------------------------------------------------------------
@pytest.fixture
def scan_on_cpu(monkeypatch):
    """Put the cuda scan's q on the CPU, so its window counts run the
    plain version (the tests' path; a card's tensors launch the kernel)."""
    import torch

    monkeypatch.setattr(cachesim_vec, "_scan_device",
                        lambda: torch.device("cpu"))


def _loop_steps(q, win_lo, threshold, win_hi, skip_below, cap):
    """The chunk loop written out once more, one masked gather a step:
    each step's (live rows, chunk), the counts, and how many rows stopped
    at cap before their window ended."""
    lo, sd = win_lo.astype(np.int64), np.zeros(win_lo.size, dtype=np.int64)
    live = np.flatnonzero(win_hi - lo >= skip_below)
    chunk, steps, capped = max(int(skip_below), 1), [], 0
    while live.size:
        steps.append((live.size, chunk))
        rem = win_hi[live] - lo[live]
        n = np.minimum(rem, chunk)
        offs = np.arange(int(n.max()))
        idx = np.minimum(lo[live][:, None] + offs, q.size - 1)
        sd[live] += ((q[idx] <= threshold[live][:, None])
                     & (offs < n[:, None])).sum(axis=1)
        capped += int(((rem > chunk) & (sd[live] >= cap)).sum())
        lo[live] += chunk
        live = live[(rem > chunk) & (sd[live] < cap)]
        chunk *= 4
    return steps, sd, capped


def _spied_scans(monkeypatch):
    """Wrap the cuda scan's loop: each call's inputs (q as NumPy), its
    counts and the (rows, chunk) of every window count it made."""
    seen = []
    real = window_scan.ops.scan

    def spy(q, win_lo, threshold, win_hi, skip_below, cap):
        args = (q.numpy().copy(), win_lo.copy(), threshold.copy(),
                win_hi.copy(), skip_below, cap)
        with window_scan.record() as calls:
            sd = real(q, win_lo, threshold, win_hi, skip_below, cap)
        seen.append((args, sd, [(r.shape[1], c) for _, r, c in calls]))
        return sd

    monkeypatch.setattr(window_scan.ops, "scan", spy)
    return seen


def test_cuda_scan_loop_equals_numpy_scan(clean, scan_on_cpu, monkeypatch):
    before = window_scan.window_count_cuda.launches
    reqs = _requests(cachesim, PORT_W)
    plain = cachesim_vec.simulate_many([(a.copy(), c, o) for a, c, o in reqs])
    numpy_counters = obs.counters()
    obs.reset_counters()
    seen = _spied_scans(monkeypatch)
    with window_scan.record() as calls:
        scanned = cachesim_vec.simulate_many(reqs, scan="cuda")
    for ps, cs in zip(plain, scanned):
        assert [_counters(s) for s in ps] == [_counters(s) for s in cs]
    c = obs.counters()
    assert c.pop("scan.cuda") == len(seen) > 0 and calls
    assert {k: v for k, v in c.items() if not k.startswith("memo.")} == \
        {k: v for k, v in numpy_counters.items() if not k.startswith("memo.")}
    # one window count a chunk step, over that step's live rows
    assert [(r.shape[1], k) for _, r, k in calls] == \
        [step for _, _, steps in seen for step in steps]
    for args, sd, steps in seen:
        want_steps, want_sd, _ = _loop_steps(*args)
        assert steps == want_steps and np.array_equal(sd, want_sd)
    assert all(rows.shape[1] > 0 and chunk >= 1 for _, rows, chunk in calls)
    assert window_scan.window_count_cuda.launches == before  # no card


def test_cuda_scan_counters_equal_the_reference_jax_scan(clean, scan_on_cpu):
    pytest.importorskip("jax")
    reqs = _requests(cachesim, PORT_W, ["contended", "irregular"])
    cachesim_vec.simulate_many(reqs, scan="cuda")
    jax_vec.simulate_many(
        _requests(jax_cachesim, JAX_W, ["contended", "irregular"]),
        scan="jax")
    assert obs.counters()["scan.cuda"] == jax_obs.counters()["scan.jax"] > 0
    mine, theirs = _both_counters()
    assert mine == theirs


def _stream(n: int, sets: int, lines_per_set: int, seed: int) -> np.ndarray:
    """Seeded line stream: a hot set of lines and a wide tail, so windows
    run from a few slots to thousands."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, sets * 3, n)
    wide = rng.integers(0, sets * lines_per_set, n)
    return np.where(rng.random(n) < 0.6, hot, wide).astype(np.int64)


# (sets, ways, segments): a one-byte and a two-byte set sort key, a
# segmented profile, and ways 1-2 whose cap stops long windows early.
LOOP_CASES = [(64, [2, 8], 1), (1_024, [4, 16], 1), (64, [2, 8], 3),
              (16, [1, 2], 1)]


@pytest.mark.parametrize("sets,ways,segments", LOOP_CASES)
def test_cuda_loop_on_the_cpu_equals_the_numpy_and_jax_scans(
        scan_on_cpu, monkeypatch, sets, ways, segments):
    """The cuda scan's loop, its q on the CPU: every ``_contested_sd`` of
    a ``_replay_ways`` gives the NumPy scan's counts and the reference's
    ``scan="jax"`` counts, one window count a step."""
    pytest.importorskip("jax")
    lines = _stream(6_000, sets, 24, seed=sets + segments)
    offsets = np.linspace(0, lines.size, segments, endpoint=False).astype(
        np.int64) if segments > 1 else None
    contested = []
    real = cachesim_vec._contested_sd

    def spy(*args, **kw):
        sd = real(*args, **kw)
        contested.append((args, kw, sd))
        return sd

    monkeypatch.setattr(cachesim_vec, "_contested_sd", spy)
    seen = _spied_scans(monkeypatch)
    prof = cachesim_vec.StreamProfile(lines, seg_offsets=offsets)
    masks = cachesim_vec._replay_ways(prof, sets, ways, scan="cuda")
    assert contested and len(seen) == len(contested)
    for args, kw, sd in contested:
        assert kw["scan"] == "cuda"
        numpy_kw = dict(kw, scan=None)
        assert np.array_equal(sd, real(*args, **numpy_kw))
        assert np.array_equal(sd, jax_vec._contested_sd(
            *args, **dict(kw, scan="jax")))
    capped = 0
    for args, sd, steps in seen:
        want_steps, want_sd, n_capped = _loop_steps(*args)
        assert steps == want_steps and np.array_equal(sd, want_sd)
        assert [k for _, k in steps] == [max(args[4], 1) * 4 ** i
                                         for i in range(len(steps))]
        capped += n_capped
    if ways == [1, 2]:
        assert capped > 0          # rows stopped at cap, windows unfinished
    jax_prof = jax_vec.StreamProfile(lines, seg_offsets=offsets)
    want = jax_vec._replay_ways(jax_prof, sets, ways, scan="jax")
    assert all(np.array_equal(masks[w], want[w]) for w in ways)


# --------------------------------------------------------------------------
# Engine contract
# --------------------------------------------------------------------------
def _invariant_workload(name: str = "seg-inv") -> Workload:
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        del cores, rng
        addr = (np.arange(3_000, dtype=np.int64) * 24) % 8_192
        return TraceSpec(addr * 8, l3_factor=1.0, mlp=2.0,
                         dram_rows_irregular=False)

    return Workload(name=name, family="stream", expected_class="1a",
                    ai_ops_per_access=0.25, instr_per_access=2.0,
                    gen=gen, core_invariant=True)


def test_cells_equal_per_cell_simulate_and_the_reference(clean):
    items = [(PORT_W[f], c, cachesim.host_config(c))
             for f in FAMILIES[:4] for c in (1, 4)]
    batch = SimEngine().simulate_cells(items)
    single = SimEngine()
    want = [single.simulate(w, c, h) for w, c, h in items]
    assert [_counters(s) for s in batch] == [_counters(s) for s in want]
    jitems = [(JAX_W[f], c, jax_cachesim.host_config(c))
              for f in FAMILIES[:4] for c in (1, 4)]
    ref = JaxEngine().simulate_cells(jitems)
    assert [_counters(s) for s in batch] == [_counters(s) for s in ref]


def test_cells_take_one_simulate_many_call(clean):
    eng = SimEngine()
    items = [(PORT_W[f], 4, cfg) for f in FAMILIES
             for cfg in _configs(cachesim)]
    eng.simulate_cells(items)
    c = obs.counters()
    assert c["engine.sim.run"] == len(items)
    assert c["engine.trace.run"] == len(FAMILIES)
    assert 0 < c["profile.scan"] < c["profile.geom"]
    eng.simulate_cells(items)
    assert obs.counters()["engine.sim.hit"] == len(items)


def test_core_invariant_trace_generated_once():
    eng = SimEngine()
    w = _invariant_workload()
    eng.simulate_cells([(w, c, cachesim.host_config(c))
                        for c in (1, 2, 4, 8)])
    assert eng.stats.trace_runs == 1


def test_profile_store_shares_cells_across_engines(tmp_path, clean):
    store = ResultStore(tmp_path)
    w = _invariant_workload("seg-store")
    items = [(w, 4, cachesim.host_config(4)), (w, 4, cachesim.ndp_config(4))]

    first = SimEngine(profile_store=store).simulate_cells(items)
    c = obs.counters()
    assert c["store.profile.miss"] == 2 and "store.profile.hit" not in c

    obs.reset_counters()
    second = SimEngine(profile_store=store).simulate_cells(items)
    c = obs.counters()
    assert c["store.profile.hit"] == 2 and "store.profile.miss" not in c
    assert c.get("engine.sim.run") is None
    assert [_counters(s) for s in second] == [_counters(s) for s in first]


def test_threaded_batch_spans_and_counters(clean):
    eng = SimEngine()
    w = PORT_W["irregular"]
    cells = [(c, cachesim.host_config(c)) for c in (1, 2, 4)]
    got = eng.simulate_batch(w, cells, max_workers=3)
    want = SimEngine().simulate_batch(w, cells)
    assert [_counters(s) for s in got] == [_counters(s) for s in want]
    assert obs.counters()["engine.sim.run"] == 6
