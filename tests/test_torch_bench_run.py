"""The port's benchmark driver (``python -m repro_torch.benchmarks.run``).

One ``--fast --device cpu`` run: it prints the reference driver's
sections in the reference's order (read from ``benchmarks/run.py``'s own
section table), minus ``models``, ``models_sweep`` and ``roofline``, which
wait for later slices; its perf record goes to the file it is given (by
default one under ``build/``) and never to ``BENCH.json``.  Naming a
waiting section fails with its ROADMAP item; the ``kernels_*`` sections on
the CPU time the plain versions and carry no H100 column.  The figure and
case rows themselves are held against the reference's in
``tests/test_torch_paper_figures.py``."""

import ast
import contextlib
import hashlib
import io
import json
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import kernel_bench, run

ROOT = Path(__file__).resolve().parents[1]
WAITING = ("models", "models_sweep", "roofline")


def _reference_sections() -> list[str]:
    """Keys of the ``sections = {...}`` table in the reference driver."""
    tree = ast.parse((ROOT / "benchmarks" / "run.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "sections"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no sections table in benchmarks/run.py")


def _sha(path: Path) -> str | None:
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    """stdout and perf record of one ``--fast --device cpu`` run, from an
    empty working directory, with the default record path moved into a
    temporary ``build/`` and the result store into a temporary root."""
    tmp = tmp_path_factory.mktemp("bench")
    bench_before = _sha(ROOT / "BENCH.json")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("REPRO_TORCH_SUITE_STORE", str(tmp / "store"))
        mp.setattr(run, "DEFAULT_BENCH_JSON", tmp / "build" / "bench.json")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert run.main(["--fast", "--device", "cpu"]) == 0
    return {"out": out.getvalue(), "tmp": tmp,
            "record": json.loads((tmp / "build" / "bench.json").read_text()),
            "bench_before": bench_before}


def _sections(out: str) -> dict[str, list[str]]:
    secs, cur = {}, None
    for line in out.splitlines():
        if line.startswith("## "):
            cur = line[3:]
            secs[cur] = []
        elif line and not line.startswith("# ") and cur is not None:
            secs[cur].append(line)
    return secs


def test_sections_in_the_reference_order(fast_run):
    ref = [s for s in _reference_sections() if s not in WAITING]
    ref.remove("fig18")            # --fast drops it, as the reference does
    assert list(_sections(fast_run["out"])) == ref
    timings = [line for line in fast_run["out"].splitlines()
               if line.startswith("# ") and " rows in " in line]
    assert [t[2:].split(":")[0] for t in timings] == ref
    assert "# engine: " in fast_run["out"]


def test_rows_of_the_roster_and_serving_sections(fast_run):
    secs = _sections(fast_run["out"])
    assert len(secs["table3"]) == 1 + 45
    hist = [r.split(",") for r in secs["suite"][1:]]
    assert [r[0] for r in hist] == ["1a", "1b", "1c", "2a", "2b", "2c"]
    assert [sum(int(r[i]) for r in hist) for i in (1, 2, 3)] == [21, 24, 45]
    assert secs["serving_warm"][1:] == secs["serving"][1:]
    assert len(secs["serving"]) == 1 + 16
    assert [r.split(",")[0] for r in secs["megaref"][1:]] == \
        ["megaref.host", "megaref.ndp"]
    assert all(r.split(",")[1] == "2000000" for r in secs["megaref"][1:])


def test_perf_record_goes_to_build_and_never_to_bench_json(fast_run):
    assert _sha(ROOT / "BENCH.json") == fast_run["bench_before"]
    assert not (fast_run["tmp"] / "BENCH.json").exists()
    (key, bucket), = fast_run["record"]["runs"].items()
    assert key == "fast-refs20000-vectorized-cpu"
    assert bucket["meta"]["device"] == "cpu"
    assert "card" not in bucket["meta"]
    assert set(bucket["sections"]) == set(_sections(fast_run["out"]))
    assert bucket["engine"]["sim_runs"] > 0
    default = Path(run.build_parser().get_default("bench_json"))
    assert default == ROOT / "build" / "repro_torch_bench.json"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_kernel_sections_on_the_cpu_carry_no_h100_column(fast_run):
    secs = _sections(fast_run["out"])
    for name, unit in (("kernels_stream", "bytes"),
                       ("kernels_attention", "flops")):
        header = secs[name][0].split(",")
        assert header == ["kernel", "plain_cpu_ms", unit]
        assert not any("h100" in c or "roof" in c for c in header)
    assert [r.split(",")[0] for r in secs["kernels_stream"][1:]] == \
        [f"stream_{op}" for op in ("copy", "scale", "add", "triad")]
    assert len(secs["kernels_attention"]) == 1 + len(
        kernel_bench.ATTENTION_SHAPES)


@pytest.mark.parametrize("name,hbm", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H200", 4.8e12),
])
def test_card_peaks_chosen_by_the_cards_name(name, hbm):
    assert kernel_bench.card_peaks(name)["bytes"] == hbm


def test_kernel_inputs_are_the_tables_shapes():
    a, b = kernel_bench.stream_inputs("cpu")
    assert a.shape == b.shape == (kernel_bench.STREAM_N,)
    assert a.dtype == torch.float32 and not torch.equal(a, b)
    got = list(kernel_bench.attention_inputs("cpu"))
    assert [shape for shape, *_ in got] == list(kernel_bench.ATTENTION_SHAPES)
    for (bsz, s, h, g, d), q, k, v in got:
        assert q.shape == (bsz, s, h, d) and q.dtype == torch.bfloat16
        assert k.shape == v.shape == (bsz, s, g, d)


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA L4", ""])
def test_card_peaks_raise_for_a_card_without_published_peaks(name):
    with pytest.raises(RuntimeError, match="no published peaks"):
        kernel_bench.card_peaks(name)


@pytest.mark.parametrize("section,item", [
    ("models", "the whole-model zoo"), ("models_sweep", "the whole-model zoo"),
    ("roofline", "the cost substrate"),
])
def test_waiting_sections_fail_naming_their_item(section, item, capsys):
    with pytest.raises(SystemExit) as exc:
        run.main(["--only", section, "--device", "cpu", "--bench-json", ""])
    assert item in str(exc.value.code) and "ROADMAP.md" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_unknown_section_fails(capsys):
    with pytest.raises(SystemExit, match="unknown section"):
        run.main(["--only", "fig2", "--device", "cpu", "--bench-json", ""])
    assert capsys.readouterr().out == ""


def test_only_runs_its_sections_and_merges_the_record(tmp_path, capsys):
    path = tmp_path / "rec.json"
    path.write_text(json.dumps({"baseline": {"kept": True}}))
    argv = ["--fast", "--device", "cpu", "--bench-json", str(path)]
    assert run.main(argv + ["--only", "fig3,case2"]) == 0
    assert list(_sections(capsys.readouterr().out)) == ["fig3", "case2"]
    assert run.main(argv + ["--only", "fig4"]) == 0
    capsys.readouterr()
    rec = json.loads(path.read_text())
    assert rec["baseline"] == {"kept": True}
    bucket = rec["runs"]["fast-refs20000-vectorized-cpu"]
    assert set(bucket["sections"]) == {"fig3", "case2", "fig4"}
    assert "total_seconds" not in bucket and "engine" not in bucket
