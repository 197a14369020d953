"""The port's Study layer (``repro_torch.study``), energy and scalability
models against the reference's.

On ``make_suite(refs=2_000)`` with cores (1, 4, 16): the four tables and
``thresholds()`` / ``validate()`` equal the reference's exactly (the numpy
pipeline is copied; no tolerance).  The engine's hit/miss accounting
matches the reference's on one query sequence; ``energy_for`` and
``analyze`` equal the reference's field by field for one workload of each
family.  Also the engine's name-collision check, ``sweep_parallel``, the
cell store and the backend selection."""

import dataclasses

import pytest

from repro.core import cachesim as jax_cachesim
from repro.core import energy as jax_energy
from repro.core import scalability as jax_scalability
from repro.core import tracegen as jax_tracegen
from repro.study import Study as JaxStudy
from repro.study import SimEngine as JaxEngine
from repro_torch.core import cachesim, energy, scalability, tracegen
from repro_torch.study import SimEngine, Study, StudyResult
from repro_torch.suite.store import ResultStore

REFS = 2_000
CORES = (1, 4, 16)


@pytest.fixture(scope="module")
def studies():
    return (Study(refs=REFS, cores=CORES), JaxStudy(refs=REFS, cores=CORES))


# table -> rows per workload (scalability: one per system; energy: host
# and NDP at each core count)
TABLES = {"metrics_table": 1, "classification_table": 1,
          "scalability_table": 3, "energy_table": 2 * len(CORES)}


@pytest.mark.parametrize("table", list(TABLES))
def test_table_equals_reference(table, studies):
    port, ref = studies
    got, want = getattr(port, table)(), getattr(ref, table)()
    assert got.to_dict() == want.to_dict()
    assert len(got) == 14 * TABLES[table]


@pytest.mark.parametrize("nuca", [False, True])
def test_nuca_tables_equal_reference(nuca, studies):
    port, ref = studies
    assert port.scalability_table(nuca=nuca, core_model="inorder").to_dict() \
        == ref.scalability_table(nuca=nuca, core_model="inorder").to_dict()
    assert port.energy_table(nuca=nuca).to_dict() == \
        ref.energy_table(nuca=nuca).to_dict()


def test_thresholds_and_validation_equal_reference(studies):
    port, ref = studies
    got, want = port.thresholds(), ref.thresholds()
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert port.validate() == ref.validate()
    assert port.validate(got) == ref.validate(want)
    assert [port.classify(w) for w in port] == [ref.classify(w) for w in ref]


def _family_heads(suite):
    seen = {}
    for w in suite:
        seen.setdefault(w.family, w)
    return seen


PORT_HEADS = _family_heads(tracegen.make_suite(refs=REFS))
JAX_HEADS = _family_heads(jax_tracegen.make_suite(refs=REFS))


def _sim_fields(sim):
    return (sim.name, sim.accesses, sim.instructions, sim.ai,
            sim.level_misses, sim.level_hits, sim.lines_touched,
            sim.prefetch_issued, sim.prefetch_useful, sim.dram_lines,
            sim.dram_bytes)


@pytest.mark.parametrize("family", list(tracegen.FAMILIES))
def test_energy_and_scalability_equal_reference(family):
    pw, jw = PORT_HEADS[family], JAX_HEADS[family]
    pe, je = SimEngine(), JaxEngine()
    for core_model, nuca in (("ooo", False), ("inorder", True)):
        got = scalability.analyze(pw, core_model=core_model, cores=CORES,
                                  nuca=nuca, engine=pe)
        want = jax_scalability.analyze(jw, core_model=core_model,
                                       cores=CORES, nuca=nuca, engine=je)
        assert (got.workload, got.expected_class, got.core_model) == (
            want.workload, want.expected_class, want.core_model)
        assert list(got.points) == list(want.points)
        for cfg in got.points:
            assert got.perf_normalized(cfg) == want.perf_normalized(cfg)
            for p, q in zip(got.points[cfg], want.points[cfg], strict=True):
                assert (p.config, p.cores, p.thread_cycles, p.perf,
                        p.dram_gbs, p.amat_cycles) == (
                    q.config, q.cores, q.thread_cycles, q.perf, q.dram_gbs,
                    q.amat_cycles)
                assert _sim_fields(p.sim) == _sim_fields(q.sim)
                assert dataclasses.astuple(p.energy) == \
                    dataclasses.astuple(q.energy)
                assert p.energy.total_j == q.energy.total_j
                for ndp, hops in ((False, 0.0), (True, 0.0), (False, 3.0)):
                    assert dataclasses.astuple(energy.energy_for(
                        p.sim, ndp=ndp, nuca_hops=hops)) == \
                        dataclasses.astuple(jax_energy.energy_for(
                            q.sim, ndp=ndp, nuca_hops=hops))
        assert got.speedup_ndp_vs_host() == want.speedup_ndp_vs_host()


def test_energy_constants_equal_reference():
    names = ("L1_HIT", "L1_MISS", "L2_HIT", "L2_MISS", "L3_HIT", "L3_MISS",
             "DRAM_INTERNAL_PJ_BIT", "DRAM_LOGIC_PJ_BIT", "LINK_PJ_BIT",
             "NOC_ROUTER_PJ", "NOC_LINK_PJ")
    assert [getattr(energy, n) for n in names] == \
        [getattr(jax_energy, n) for n in names]
    assert energy.EnergyBreakdown(1, 2, 3, 4, 5, 6).scaled(2.0).total_j == \
        jax_energy.EnergyBreakdown(1, 2, 3, 4, 5, 6).scaled(2.0).total_j


def _query_sequence(engine, suite, host_config):
    """One sequence of engine queries; the stats after each step."""
    a, b, c = suite[0], suite[6], suite[8]
    h1, h4 = host_config(1), host_config(4)
    out = []
    engine.trace(a, 1)
    out.append(engine.stats.as_dict())
    engine.simulate(a, 4, h4)
    out.append(engine.stats.as_dict())
    engine.simulate_batch(a, [(1, h1), (4, h4), (4, h4), (16, h4)])
    out.append(engine.stats.as_dict())
    engine.sweep(b, CORES, host_config)
    out.append(engine.stats.as_dict())
    engine.simulate_cells([(a, 1, h1), (b, 4, h1), (c, 4, h4), (c, 4, h4),
                           (c, 16, h1)])
    out.append(engine.stats.as_dict())
    engine.sweep_parallel(c, (1, 4, 16, 64), host_config, max_workers=2)
    out.append(engine.stats.as_dict())
    out.append(engine.cells)
    return out


def test_engine_accounting_equals_reference():
    port = _query_sequence(SimEngine(), tracegen.make_suite(refs=REFS),
                           cachesim.host_config)
    ref = _query_sequence(JaxEngine(), jax_tracegen.make_suite(refs=REFS),
                          jax_cachesim.host_config)
    assert port == ref


def test_name_collision_rejected():
    suite = tracegen.make_suite(refs=REFS)
    engine = SimEngine()
    engine.register(suite[0])
    engine.register(tracegen.make_suite(refs=REFS)[0])  # same content
    clash = dataclasses.replace(suite[1], name=suite[0].name)
    with pytest.raises(ValueError, match="already registered"):
        engine.register(clash)
    longer = tracegen.make_suite(refs=2 * REFS)[0]
    with pytest.raises(ValueError, match="already registered"):
        engine.simulate(longer, 1, cachesim.host_config(1))
    engine.clear()
    assert engine.cells == 0 and engine.stats.sim_runs == 0
    engine.register(longer)


def test_sweep_parallel_equals_sweep():
    w = tracegen.make_suite(refs=REFS)[7]
    seq, par = SimEngine(), SimEngine()
    want = seq.sweep(w, CORES, cachesim.host_config)
    got = par.sweep_parallel(w, CORES, cachesim.host_config, max_workers=3)
    assert [_sim_fields(s) for s in got] == [_sim_fields(s) for s in want]
    assert par.stats.sim_runs == seq.stats.sim_runs == len(CORES)
    again = par.sweep_parallel(w, CORES, cachesim.host_config)
    assert again == got and par.stats.sim_hits == len(CORES)


def test_cell_store_recalls_without_simulating(tmp_path):
    suite = tracegen.make_suite(refs=REFS)[:4]
    cells = [(w, c, cachesim.host_config(c)) for w in suite for c in CORES]
    first = SimEngine(profile_store=ResultStore(tmp_path))
    want = first.simulate_cells(cells)
    second = SimEngine(profile_store=ResultStore(tmp_path))
    got = second.simulate_cells(cells)
    assert second.stats.sim_runs == 0 and second.stats.trace_runs == 0
    assert [_sim_fields(s) for s in got] == [_sim_fields(s) for s in want]


def test_backend_selection(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
    assert cachesim.default_backend() == "vectorized"
    monkeypatch.setenv("REPRO_SIM_BACKEND", "reference")
    assert cachesim.default_backend() == "reference"
    monkeypatch.setenv("REPRO_SIM_BACKEND", "jax")
    with pytest.raises(ValueError, match="backend 'cuda'"):
        cachesim.default_backend()
    w = tracegen.make_suite(refs=REFS)[0]
    with pytest.raises(ValueError, match="backend 'cuda'"):
        SimEngine().simulate(w, 1, cachesim.host_config(1))
    monkeypatch.setenv("REPRO_SIM_BACKEND", "bogus")
    with pytest.raises(ValueError, match="invalid"):
        cachesim.default_backend()
    with pytest.raises(ValueError, match="unknown backend"):
        SimEngine(backend="jax")
    assert cachesim.BACKENDS == ("reference", "vectorized", "cuda")


def test_study_result_round_trips(studies):
    port, _ = studies
    table = port.metrics_table()
    assert StudyResult.from_json(table.to_json()).to_dict() == \
        table.to_dict()
    again = StudyResult.from_records(table.name, table.records(),
                                     table.columns)
    assert again.rows == table.rows
    assert table.to_csv().splitlines()[0] == ",".join(table.columns)
    assert table.column("name") == port.names()
    with pytest.raises(ValueError, match="row width"):
        table.append(("too", "short"))
