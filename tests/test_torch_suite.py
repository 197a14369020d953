"""The slice as a whole: the port's 45 roster rows (``SuiteRunner`` over
``default_registry`` on the CPU, ``FAST_REFS``, the full core sweep)
against the reference's ``SuiteRunner(default_registry(refs=20_000))`` on
its mirror capture path.  Every row must be equal, class verdicts and
metrics alike: the numpy pipeline is copied, the synthetic traces are drawn
from the same ``default_rng`` streams and the captured ones are
byte-identical.  The CLI then reads the same rows back from the store."""

import json

import pytest

from repro.suite import SuiteRunner as JaxRunner
from repro.suite import default_registry as jax_default_registry
from repro_torch.capture.kernels import CAPTURED_KERNELS
from repro_torch.suite import ResultStore, SuiteRunner, default_registry
from repro_torch.suite.__main__ import FAST_REFS, main
from repro_torch.suite.registry import _synthetic_grid
from repro_torch.suite.runner import ROSTER_COLUMNS

NAMES = ([w.name for w, _ in _synthetic_grid(FAST_REFS)]
         + [k.name for k in CAPTURED_KERNELS])
HISTOGRAM = {"1a": (6, 16, 22), "1b": (3, 7, 10), "1c": (3, 1, 4),
             "2a": (3, 0, 3), "2b": (3, 0, 3), "2c": (3, 0, 3)}


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("store")


@pytest.fixture(scope="module")
def port_runner(store_dir):
    runner = SuiteRunner(default_registry(refs=FAST_REFS, device="cpu"),
                         store=ResultStore(store_dir))
    runner.roster()
    return runner


@pytest.fixture(scope="module")
def port_rows(port_runner):
    return {r[0]: r for r in port_runner.roster().rows}


@pytest.fixture(scope="module")
def reference_runner():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CAPTURE_PATH", "mirror")
        runner = JaxRunner(jax_default_registry(refs=FAST_REFS), store=None)
        runner.roster()
        return runner


@pytest.mark.parametrize("name", NAMES)
def test_roster_row_equals_reference(name, port_rows, reference_runner):
    want = {r[0]: r for r in reference_runner.roster().rows}[name]
    got = port_rows[name]
    assert len(got) == len(ROSTER_COLUMNS)
    assert got[4] == want[4]            # class verdict, exactly
    assert got == want                  # and every metric


def test_all_classes_as_expected(port_runner, reference_runner):
    roster = port_runner.roster()
    assert len(roster) == 45 and roster.columns == ROSTER_COLUMNS
    assert all(r[5] == 1 for r in roster.rows)
    assert port_runner.divergent() == []
    assert port_runner.divergent(source="synthetic") == []
    hist = port_runner.histogram()
    assert hist.to_dict() == reference_runner.histogram().to_dict()
    assert {r[0]: r[1:] for r in hist.rows} == HISTOGRAM
    assert port_runner.study.stats.as_dict() == \
        reference_runner.study.stats.as_dict()


def test_cli_check_and_histogram(tmp_path, port_runner, store_dir, capsys):
    out = tmp_path / "roster.json"
    assert main(["--fast", "--check", "--device", "cpu", "--cores",
                 "1,4,16,64,256", "--json", "--store", str(store_dir),
                 "--stats", "--out", str(out)]) == 0
    roster, hist = json.loads(out.read_text())
    assert roster["name"] == "suite_roster"
    assert roster["columns"] == list(ROSTER_COLUMNS)
    assert [tuple(r) for r in roster["rows"]] == port_runner.roster().rows
    assert hist["columns"] == ["class", "synthetic", "captured", "total"]
    assert {row[0]: tuple(row[1:]) for row in hist["rows"]} == HISTOGRAM
    err = capsys.readouterr().err
    assert "# store: {'computed': 0, 'recalled': 45}" in err
    assert "'sim_runs': 0" in err


def test_cli_csv_sections(capsys, store_dir):
    assert main(["--device", "cpu", "--fast", "--store", str(store_dir)]) == 0
    text = capsys.readouterr().out
    assert text.startswith("## suite_roster\n" + ",".join(ROSTER_COLUMNS))
    assert "## class_histogram\nclass,synthetic,captured,total" in text
    roster, hist = text.strip().split("\n\n")
    assert len(roster.splitlines()) == 2 + 45
    assert len(hist.splitlines()) == 2 + 6
