"""The port's ``scalability`` and ``energy`` roster sections against the
reference's: the 45-entry roster (synthetic traces of 2 000 refs) at cores
(1, 4, 16) on the CPU.  Rows must be equal exactly
(``REPRO_CAPTURE_PATH=mirror`` on the reference side).  The serving
section is held in ``tests/test_torch_serving_section.py``."""

import json

import pytest

from repro.suite import SuiteRunner as JaxRunner
from repro.suite import registry_for as jax_registry_for
from repro_torch.capture.kernels import CAPTURED_KERNELS
from repro_torch.suite import (ROSTER_COLUMNS, SECTION_COLUMNS, ResultStore,
                               SuiteRegistry, SuiteRunner, registry_for)
from repro_torch.suite.__main__ import main
from repro_torch.suite.registry import _synthetic_grid

REFS = 2_000
CORES = (1, 4, 16)
SECTIONS = ("scalability", "energy")
NAMES = ([w.name for w, _ in _synthetic_grid(REFS)]
         + [k.name for k in CAPTURED_KERNELS])


def _rows(runner):
    return {r[0]: r for r in runner.roster().rows}


def _reference(sections):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CAPTURE_PATH", "mirror")
        runner = JaxRunner(jax_registry_for(refs=REFS, sections=sections),
                           cores=CORES, store=None, sections=sections)
        return _rows(runner)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sections")


@pytest.fixture(scope="module")
def sectioned(store_dir):
    runner = SuiteRunner(registry_for(refs=REFS, device="cpu"),
                         cores=CORES, store=ResultStore(store_dir),
                         sections=SECTIONS)
    return runner, _rows(runner), _reference(SECTIONS)


@pytest.mark.parametrize("name", NAMES)
def test_sectioned_row_equals_reference(name, sectioned):
    runner, got, want = sectioned
    assert runner.columns == ROSTER_COLUMNS + SECTION_COLUMNS[
        "scalability"] + SECTION_COLUMNS["energy"]
    assert len(got[name]) == len(runner.columns) == 17
    assert got[name] == want[name]


def test_unknown_section_rejected(capsys):
    with pytest.raises(ValueError, match="unknown roster section"):
        SuiteRunner(SuiteRegistry(), sections=("models",))
    with pytest.raises(SystemExit):
        main(["--sections", "models", "--device", "cpu", "--no-store"])
    assert "unknown section" in capsys.readouterr().err


def test_cli_sections_recall_in_canonical_order(tmp_path, sectioned,
                                                store_dir, capsys):
    """``--sections energy,scalability`` keys and lays out the columns in
    canonical order, so it recalls the fixture's rows."""
    runner, got, _ = sectioned
    out = tmp_path / "roster.json"
    assert main(["--refs", str(REFS), "--device", "cpu", "--cores", "1,4,16",
                 "--sections", "energy,table3,scalability", "--json",
                 "--store", str(store_dir), "--stats", "--out",
                 str(out)]) == 0
    roster, _ = json.loads(out.read_text())
    assert roster["columns"] == list(runner.columns)
    assert [tuple(r) for r in roster["rows"]] == list(got.values())
    assert "'recalled': 45" in capsys.readouterr().err
