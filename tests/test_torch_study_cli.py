"""The port's study CLI (``python -m repro_torch.study``) and substrates
against the reference's (``python -m repro.study``).

The reference's CLI tests (``tests/test_study.py``, ``TestCLI``) run on the
port; then both ``main`` functions, given the same arguments, write the
same bytes: every trace-substrate section at ``--refs 2000 --cores 1,4``
in CSV and JSON, the ``--stats`` line, and the suite substrate on the CPU
(the reference on its mirror capture path, as the port is held against
it; each side's result store in its own temporary directory).  No
tolerance: the NumPy pipeline is a copy.  ``--substrate hlo`` fails
naming the ROADMAP item, and the trace-only flags are refused where the
reference refuses them, with the same message."""

import json

import pytest

from repro.study.__main__ import main as ref_main
from repro_torch import obs
from repro_torch.obs.report import aggregate
from repro_torch.study import (Study, StudyResult, Substrate, SuiteSubstrate,
                               TraceSubstrate, get_substrate)
from repro_torch.study.__main__ import SECTIONS, main
from repro_torch.suite import ResultStore, SuiteRunner, default_registry

SMALL = ["--refs", "2000", "--cores", "1,4"]


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    """Both packages' default result stores under ``tmp_path``, so no test
    recalls a row another run wrote."""
    monkeypatch.setenv("REPRO_TORCH_SUITE_STORE", str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_SUITE_STORE", str(tmp_path / "ref"))


# --------------------------------------------------------------------------
# The reference's CLI tests, on the port
# --------------------------------------------------------------------------
class TestCLI:
    def test_trace_csv(self, capsys):
        rc = main(["--refs", "2000", "--cores", "1,4",
                   "--sections", "classify", "--format", "csv"])
        assert rc == 0
        out = capsys.readouterr().out
        assert out.startswith("## classification")
        assert "STRCpy" in out

    def test_trace_json_sections(self, capsys, tmp_path):
        out_file = tmp_path / "study.json"
        rc = main(["--refs", "2000", "--cores", "1,4",
                   "--workloads", "STRCpy,CHAHsti",
                   "--sections", "metrics,classify",
                   "--format", "json", "--out", str(out_file)])
        assert rc == 0
        tables = json.loads(out_file.read_text())
        assert [t["name"] for t in tables] == ["metrics", "classification"]
        metrics = StudyResult.from_json(json.dumps(tables[0]))
        assert metrics.column("name") == ["STRCpy", "CHAHsti"]
        assert "lfmr@4" in metrics.columns and "lfmr@16" not in metrics.columns

    def test_unknown_substrate_rejected(self):
        with pytest.raises(ValueError, match="unknown substrate"):
            get_substrate("zsim")


# --------------------------------------------------------------------------
# Equality with the reference's CLI
# --------------------------------------------------------------------------
def _both(argv, capsys):
    """stdout and stderr of the port's main and of the reference's."""
    assert main(list(argv)) == 0
    port = capsys.readouterr()
    assert ref_main(list(argv)) == 0
    ref = capsys.readouterr()
    return (port.out, port.err), (ref.out, ref.err)


@pytest.mark.parametrize("fmt", ["csv", "json"])
@pytest.mark.parametrize("section", SECTIONS)
def test_trace_section_equals_reference(section, fmt, capsys):
    port, ref = _both(SMALL + ["--sections", section, "--format", fmt],
                      capsys)
    assert port == ref
    assert port[0].strip()


def test_workloads_variants_and_stats_equal_reference(capsys):
    argv = SMALL + ["--sections", "characterize,scalability",
                    "--variants", "2", "--suite-seed", "3", "--seed", "1",
                    "--stats"]
    port, ref = _both(argv, capsys)
    assert port == ref
    assert port[1].startswith("# engine: ")
    port, ref = _both(SMALL + ["--workloads", "STRCpy,PLYalu",
                               "--sections", "energy"], capsys)
    assert port == ref


def test_suite_substrate_equals_reference_mirror(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_CAPTURE_PATH", "mirror")
    argv = ["--substrate", "suite", "--refs", "2000", "--cores", "1,4",
            "--stats"]
    assert main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr()
    assert ref_main(argv) == 0
    ref = capsys.readouterr()
    assert (port.out, port.err) == (ref.out, ref.err)
    assert port.out.startswith("## suite_characterization\nname,class,")
    assert len(port.out.strip().splitlines()) == 2 + 45


def test_suite_substrate_writes_the_ports_store(tmp_path, capsys):
    """A self-built suite run persists to ``$REPRO_TORCH_SUITE_STORE``
    only (45 records), and a rerun recalls every row."""
    argv = ["--substrate", "suite", "--refs", "2000", "--cores", "1",
            "--device", "cpu", "--format", "json"]
    assert main(argv) == 0
    first = capsys.readouterr().out
    assert len(ResultStore(tmp_path / "port")) == 45
    assert not (tmp_path / "ref").exists()
    assert main(argv + ["--stats"]) == 0
    again = capsys.readouterr()
    assert again.out == first
    assert "'sim_runs': 0" in again.err


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------
def test_hlo_substrate_names_its_roadmap_item(capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--substrate", "hlo"])
    assert "ROADMAP.md's \"the cost substrate\"" in str(exc.value.code)
    assert capsys.readouterr().out == ""
    with pytest.raises(NotImplementedError, match="the cost substrate"):
        get_substrate("hlo")


@pytest.mark.parametrize("substrate", ["suite", "hlo"])
@pytest.mark.parametrize("flag", [
    ["--sections", "metrics"], ["--workloads", "STRCpy"],
    ["--variants", "2"], ["--suite-seed", "1"],
    ["--sections", "scalability", "--variants", "3"],
])
def test_trace_only_flags_refused_as_the_reference_does(substrate, flag,
                                                        capsys):
    argv = ["--substrate", substrate] + flag
    device = ["--device", "cpu"] if substrate == "suite" else []
    with pytest.raises(SystemExit) as port:
        main(argv + device)
    with pytest.raises(SystemExit) as ref:
        ref_main(argv)
    assert str(port.value.code) == str(ref.value.code)
    assert "applies to the trace substrate" in str(port.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv", [
    ["--device", "cpu"], ["--device", "cuda"],
    ["--substrate", "trace", "--device", "cpu"],
    ["--substrate", "hlo", "--device", "cpu"],
])
def test_device_refused_off_the_suite_substrate(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(SMALL + argv)
    assert "--device applies to the suite substrate" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_unknown_workload_refused_as_the_reference_does():
    argv = SMALL + ["--workloads", "NOPE"]
    with pytest.raises(SystemExit) as port:
        main(argv)
    with pytest.raises(SystemExit) as ref:
        ref_main(argv)
    assert str(port.value.code) == str(ref.value.code)


@pytest.mark.parametrize("argv", [["--backend", "jax"],
                                  ["--substrate", "zsim"],
                                  ["--cores", ","]])
def test_bad_flags_rejected_by_the_parser(argv):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2


# --------------------------------------------------------------------------
# Substrates and tracing
# --------------------------------------------------------------------------
def test_substrates_follow_the_protocol():
    study = Study(refs=2000, cores=(1, 4))
    trace = get_substrate("trace", study=study)
    assert isinstance(trace, TraceSubstrate) and isinstance(trace, Substrate)
    assert trace.items() == study.names()
    runner = SuiteRunner(default_registry(refs=2000, device="cpu"),
                         cores=(1,), store=None)
    suite = SuiteSubstrate(runner=runner)
    assert isinstance(suite, Substrate)
    assert suite.items() == [e.name for e in runner.registry]
    table = suite.characterize()
    assert table.columns[:2] == ("name", "class")
    assert [r[1] for r in table.rows] == [r[4] for r in runner.roster().rows]


def test_trace_flag_records_the_study_run_span(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    assert main(SMALL + ["--sections", "classify", "--trace", str(path)]) == 0
    traced = capsys.readouterr().out
    assert not obs.enabled()
    rep = aggregate([path])
    assert rep.spans["study.run"].count == 1
    assert rep.span_total("sim.many") > 0
    assert main(SMALL + ["--sections", "classify"]) == 0
    assert capsys.readouterr().out == traced
