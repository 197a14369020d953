"""The port's paper-figure sections (``repro_torch.benchmarks.paper_figures``)
against the reference's (``benchmarks/paper_figures.py``).

Every figure and case section, over one shared Study a side at 4 000
refs (the full core sweep), equals the reference's table exactly: names,
columns and every rounded value (the NumPy pipeline is copied, so no
tolerance).  fig18 builds its held-out suite at the same refs.  Table 3
runs the 45-entry roster on the CPU at 2 000 refs, the reference on its
mirror capture path.  Also the reference's Study-layer figure tests
(``tests/test_study.py``): the figures reproduce the free functions'
rows, and each cell is simulated at most once across the figure set."""

import pytest

from benchmarks import paper_figures as ref_figures
from repro.study import Study as RefStudy
from repro.suite import SuiteRunner as RefRunner
from repro.suite import default_registry as ref_default_registry
from repro_torch.benchmarks import paper_figures
from repro_torch.core import cachesim, classify, scalability, tracegen
from repro_torch.study import Study
from repro_torch.suite import SuiteRunner, default_registry

REFS = 4_000
TABLE3_REFS = 2_000


@pytest.fixture(scope="module")
def studies():
    """One shared Study a side, as the driver shares one across sections."""
    return Study(refs=REFS), RefStudy(refs=REFS)


# section -> (function name, keyword arguments)
SECTIONS = {
    "fig1": ("fig1_roofline_mpki", {}),
    "fig3": ("fig3_locality_clustering", {}),
    "fig4": ("fig4_lfmr_mpki", {}),
    "fig5": ("fig5_scalability", {}),
    "fig5_nuca": ("fig5_scalability", {"nuca": True}),
    "fig7": ("fig7_energy", {}),
    "fig7_nuca": ("fig7_energy", {"nuca": True}),
    "fig18": ("fig18_summary_and_validation", {}),
    "case1": ("case1_noc", {}),
    "case2": ("case2_accelerators", {}),
    "case3": ("case3_core_models", {}),
    "case4": ("case4_offload", {}),
}


@pytest.mark.parametrize("section", list(SECTIONS))
def test_section_equals_reference(section, studies):
    port, ref = studies
    fn, kwargs = SECTIONS[section]
    got = getattr(paper_figures, fn)(port, **kwargs)
    want = getattr(ref_figures, fn)(ref, **kwargs)
    assert got.to_dict() == want.to_dict()
    assert len(got) > 0


def test_fig18_holds_out_on_the_studys_backend(monkeypatch):
    """fig18's held-out Study simulates on the shared study's backend (so
    ``--backend cuda`` reaches the held-out sweep too)."""
    made = []

    class Stop(Exception):
        pass

    def spy(self, *args, **kw):
        made.append((len(kw["suite"]), kw.get("backend")))
        raise Stop

    study = Study(refs=2_000, backend="reference")
    monkeypatch.setattr(Study, "__init__", spy)
    with pytest.raises(Stop):
        paper_figures.fig18_summary_and_validation(study)
    assert made == [(5 * len(study) - len(study), "reference")]


def test_table3_equals_reference_mirror(monkeypatch):
    port = paper_figures.table3_suite_roster(
        SuiteRunner(default_registry(refs=TABLE3_REFS, device="cpu"),
                    cores=(1, 4), store=None))
    monkeypatch.setenv("REPRO_CAPTURE_PATH", "mirror")
    ref = ref_figures.table3_suite_roster(
        RefRunner(ref_default_registry(refs=TABLE3_REFS), cores=(1, 4),
                  store=None))
    assert port.name == "table3"
    assert port.to_dict() == ref.to_dict()
    assert len(port) == 45


def test_table3_builds_its_runner_on_the_device_asked_for(monkeypatch):
    """Without a runner, table3 builds one over the default registry on
    ``device`` (the card by default)."""
    seen = []

    def fake_registry(*, refs=None, device="cuda"):
        seen.append((refs, device))
        raise RuntimeError("stop")

    import repro_torch.suite as suite
    monkeypatch.setattr(suite, "default_registry", fake_registry)
    for kwargs in ({}, {"device": "cpu", "refs": 10}):
        with pytest.raises(RuntimeError, match="stop"):
            paper_figures.table3_suite_roster(**kwargs)
    assert seen == [(None, "cuda"), (10, "cpu")]


# --------------------------------------------------------------------------
# The reference's Study-layer figure tests, on the port
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def suite():
    return tracegen.make_suite(refs=6_000)


def test_figure_queries_reproduce_free_function_rows(suite):
    """The Study-backed figures emit exactly the rows the free functions
    produce."""
    study = Study(suite=suite)
    fig4 = paper_figures.fig4_lfmr_mpki(study)
    for w, row in zip(suite, fig4.to_rows()):
        m = classify.measure(w)  # fresh, engine-free
        assert row == (w.name, w.expected_class, round(m.mpki, 2)) + \
            tuple(round(x, 3) for x in m.lfmr_by_cores)

    fig5 = paper_figures.fig5_scalability(study)
    rows = fig5.to_rows()
    for i, w in enumerate(suite[:2]):
        r = scalability.analyze(w)
        for j, cfg in enumerate(("host", "host+pf", "ndp")):
            expect = (w.name, w.expected_class, cfg) + tuple(
                round(p, 2) for p in r.perf_normalized(cfg))
            assert rows[3 * i + j] == expect


def test_each_cell_simulated_at_most_once(suite, monkeypatch):
    """Across the whole figure set each (workload, cores, config) cell
    passes through the simulator at most once, whether it is submitted
    singly or inside a batch."""
    calls = []
    real = cachesim.simulate
    real_batch = cachesim.simulate_batch
    real_many = cachesim.simulate_many

    def counting(addresses, config, **kw):
        calls.append(config)
        return real(addresses, config, **kw)

    def counting_batch(addresses, configs, **kw):
        configs = list(configs)
        calls.extend(configs)
        return real_batch(addresses, configs, **kw)

    def counting_many(requests, **kw):
        requests = list(requests)
        for _, configs, _ in requests:
            calls.extend(configs)
        return real_many(requests, **kw)

    monkeypatch.setattr(cachesim, "simulate", counting)
    monkeypatch.setattr(cachesim, "simulate_batch", counting_batch)
    monkeypatch.setattr(cachesim, "simulate_many", counting_many)
    study = Study(suite=suite[:4])
    paper_figures.fig1_roofline_mpki(study)
    paper_figures.fig3_locality_clustering(study)
    paper_figures.fig4_lfmr_mpki(study)
    paper_figures.fig5_scalability(study)
    paper_figures.fig7_energy(study)
    paper_figures.case1_noc(study)
    assert len(calls) == study.engine.stats.sim_runs
    assert len(calls) == study.engine.cells
    assert study.engine.stats.sim_hits > 0


def test_default_study_and_bare_workload_lists():
    study = paper_figures.default_study(2_000, backend="reference")
    assert study.refs == 2_000 and study.engine.backend == "reference"
    ws = tracegen.make_suite(refs=2_000)[:2]
    fig3 = paper_figures.fig3_locality_clustering(ws)
    assert fig3.column("name") == [w.name for w in ws]
