"""The slice as a whole: the port's 24 roster rows (``SuiteRunner`` on the
CPU) against the reference's ``classify.measure`` / ``classify`` rows for
the same workloads, on the reference's mirror capture path.  Classes must
be equal, and so must every metric: the numpy pipeline is copied and the
traces are byte-identical."""

import json

import pytest

from repro.capture.kernels import CAPTURED_KERNELS as JAX_KERNELS
from repro.capture.kernels import captured_workloads as jax_workloads
from repro.core import classify as jax_classify
from repro.study.engine import SimEngine as JaxEngine
from repro_torch.capture.kernels import CAPTURED_KERNELS
from repro_torch.suite.__main__ import main
from repro_torch.suite.runner import ROSTER_COLUMNS, SuiteRunner

NAMES = [k.name for k in CAPTURED_KERNELS]


@pytest.fixture(scope="module")
def port_rows():
    return {r[0]: r for r in SuiteRunner(device="cpu").roster().rows}


@pytest.fixture(scope="module")
def reference_rows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CAPTURE_PATH", "mirror")
        specs = {k.name: k for k in JAX_KERNELS if k.name in NAMES}
        engine = JaxEngine()
        rows = {}
        for w in jax_workloads(tuple(specs.values())):
            m = jax_classify.measure(w, engine=engine)
            assigned = jax_classify.classify(m)
            rows[w.name] = (
                w.name, specs[w.name].domain, "captured", w.expected_class,
                assigned, int(assigned == w.expected_class),
                round(m.spatial, 3), round(m.temporal, 3), round(m.ai, 3),
                round(m.mpki, 2), round(m.lfmr_mean, 3),
                round(m.lfmr_slope, 3))
        return rows


@pytest.mark.parametrize("name", NAMES)
def test_roster_row_equals_reference(name, port_rows, reference_rows):
    got, want = port_rows[name], reference_rows[name]
    assert len(got) == len(ROSTER_COLUMNS)
    assert got[4] == want[4]            # class verdict, exactly
    assert got == want                  # and every metric


def test_all_classes_as_expected(port_rows):
    assert len(port_rows) == 24
    assert all(r[5] == 1 for r in port_rows.values())


def test_cli_check_and_histogram(tmp_path):
    out = tmp_path / "roster.json"
    assert main(["--fast", "--check", "--device", "cpu", "--cores",
                 "1,4,16,64,256", "--format", "json", "--out",
                 str(out)]) == 0
    roster, hist = json.loads(out.read_text())
    assert roster["name"] == "suite_roster"
    assert roster["columns"] == list(ROSTER_COLUMNS)
    assert len(roster["rows"]) == 24
    counts = {row[0]: row[1] for row in hist["rows"]}
    assert counts == {"1a": 16, "1b": 7, "1c": 1, "2a": 0, "2b": 0, "2c": 0}


def test_cli_csv_sections(capsys):
    assert main(["--device", "cpu", "--cores", "1,4"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("## suite_roster\n" + ",".join(ROSTER_COLUMNS))
    assert "## class_histogram\nclass,captured,total" in text
