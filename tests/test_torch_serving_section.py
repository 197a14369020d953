"""The port's ``serving`` roster section against the reference's: the 16
serving scenarios through the suite runner (phase timelines and the best
measured mitigation) at cores (1, 4, 16) on the CPU, equal row by row
(``REPRO_CAPTURE_PATH=mirror`` on the reference side), each timeline equal
to ``measure_windows``'."""

import pytest

from repro.suite import SuiteRunner as JaxRunner
from repro.suite import registry_for as jax_registry_for
from repro_torch.serving import SCENARIOS, measure_windows
from repro_torch.suite import SECTION_COLUMNS, SuiteRunner, registry_for
from repro_torch.suite.__main__ import main
from repro_torch.suite.runner import ROSTER_COLUMNS

CORES = (1, 4, 16)


def _rows(runner):
    return {r[0]: r for r in runner.roster().rows}


@pytest.fixture(scope="module")
def serving():
    sections = ("serving",)
    runner = SuiteRunner(registry_for(sections=sections, device="cpu"),
                         cores=CORES, store=None, sections=sections)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CAPTURE_PATH", "mirror")
        ref = JaxRunner(jax_registry_for(sections=sections), cores=CORES,
                        store=None, sections=sections)
        return runner, _rows(runner), _rows(ref)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serving_row_equals_reference(name, serving):
    runner, got, want = serving
    assert len(got) == 16
    assert runner.columns == ROSTER_COLUMNS + SECTION_COLUMNS["serving"]
    assert got[name] == want[name]
    rec = dict(zip(runner.columns, got[name]))
    assert rec["match"] == 1
    assert rec["phase_timeline"] == measure_windows(
        name, cores=CORES, engine=runner.study.engine,
        device="cpu").timeline()


def test_serving_histogram_and_check(serving):
    runner, _, _ = serving
    assert runner.histogram().columns == ("class", "serving", "total")
    assert sum(runner.histogram().column("total")) == 16
    assert runner.divergent(source="serving") == []


def test_cli_serving_check(capsys):
    assert main(["--sections", "serving", "--fast", "--check", "--device",
                 "cpu", "--cores", "1,4", "--no-store"]) == 0
    roster, hist = capsys.readouterr().out.strip().split("\n\n")
    assert len(roster.splitlines()) == 2 + 16
    assert hist.splitlines()[1] == "class,serving,total"
