"""``repro_torch.benchmarks.perf_gate`` against the reference's jax-free
``benchmarks.perf_gate``: on the same records and the same traces, the
same verdicts (exit codes, failing sections, report lines); and the
committed baseline is a card run of the port's driver."""

import contextlib
import io
import json

import pytest

from benchmarks import perf_gate as jax_gate
from repro_torch import obs
from repro_torch.benchmarks import perf_gate
from repro_torch.benchmarks.run import DEFAULT_BENCH_JSON

CFG = "fast-refs20000-vectorized-cuda"


def _run(module, args) -> tuple[int, str, str]:
    """``module.main(args)`` with its report and verdict captured (the
    reference binds its report stream at import: pointed here too)."""
    out, err = io.StringIO(), io.StringIO()
    saved = [(fn, dict(fn.__kwdefaults__)) for fn in (module.gate,
                                                      module.obs_gate)]
    for fn, _ in saved:
        fn.__kwdefaults__["out"] = out
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = module.main(args)
    finally:
        for fn, kw in saved:
            fn.__kwdefaults__.update(kw)
    return rc, out.getvalue(), err.getvalue()


def _record(path, sections: dict[str, float], cal: float = 0.0) -> str:
    meta = {"calibration_seconds": cal} if cal else {}
    path.write_text(json.dumps({"runs": {CFG: {"meta": meta, "sections": {
        n: {"seconds": s, "rows": 1} for n, s in sections.items()}}}}))
    return str(path)


CASES = {
    "within": ({"a": 2.0, "b": 4.0}, {"a": 3.9, "b": 4.0}, 0, 0),
    "regressed": ({"a": 2.0, "b": 1.0}, {"a": 4.1, "b": 1.0}, 0, 0),
    "floor": ({"a": 0.0, "b": 0.1}, {"a": 1.0, "b": 2.0}, 0, 0),
    "one-sided": ({"a": 1.0, "gone": 3.0}, {"a": 1.0, "new": 9.0}, 0, 0),
    "slower-host": ({"a": 2.0}, {"a": 7.0}, 0.1, 0.2),
    "capped": ({"a": 2.0}, {"a": 30.0}, 0.1, 10.0),
    "faster-host": ({"a": 2.0}, {"a": 3.9}, 0.2, 0.1),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("skip", ["", "b"])
def test_wall_clock_verdict_equals_reference(case, skip, tmp_path):
    base, cur, base_cal, cur_cal = CASES[case]
    args = ["--baseline", _record(tmp_path / "b.json", base, base_cal),
            "--current", _record(tmp_path / "c.json", cur, cur_cal),
            "--config", CFG, "--skip", skip]
    rc, out, err = _run(perf_gate, args)
    want_rc, want_out, want_err = _run(jax_gate, args)
    assert rc == want_rc
    assert out == want_out and "section" in out
    assert err.splitlines()[-1] == want_err.splitlines()[-1]


def test_speed_factor_and_gate_functions_equal_reference():
    for b, c in ((0.0, 1.0), (1.0, 0.0), (0.1, 0.2), (0.1, 9.0),
                 (2.0, 0.1)):
        assert perf_gate.speed_factor(b, c) == jax_gate.speed_factor(b, c)
    kw = dict(max_ratio=2.0, min_seconds=0.75)
    for base, cur, *_ in CASES.values():
        assert perf_gate.gate(base, cur, out=io.StringIO(), **kw) == \
            jax_gate.gate(base, cur, out=io.StringIO(), **kw)


def _trace(path):
    """A port trace: spans and counters as a models_sweep run writes."""
    obs.reset_counters()
    obs.enable(path)
    try:
        with obs.span("suite.run"):
            with obs.span("suite.registry"):
                pass
            obs.count("capture.model.stream_blocks", 62)
            obs.count("profile.scan", 3)
            obs.count("profile.geom", 3)
    finally:
        obs.disable()


@pytest.mark.parametrize("require", [
    ["capture.model.concat==0", "capture.model.stream_blocks>0"],
    ["profile.scan==profile.geom", "profile.scan<=2"],
    ["span:suite.run>=0", "capture.model.stream_blocks!=62"],
])
def test_counter_verdict_equals_reference(require, tmp_path):
    trace = tmp_path / "t.jsonl"
    _trace(trace)
    args = ["--obs-trace", str(trace)]
    for r in require:
        args += ["--obs-require", r]
    args += ["--obs-min-coverage", "suite.run=0.5"]
    rc, out, _ = _run(perf_gate, args)
    want_rc, want_out, _ = _run(jax_gate, args)
    assert rc == want_rc
    strip = lambda text: [line.split("[")[0] for line in  # noqa: E731
                          text.splitlines()]
    assert strip(out) == strip(want_out) and len(strip(out)) == 3


def test_defaults_read_the_committed_card_baseline():
    ap = perf_gate.build_parser()
    args = ap.parse_args([])
    assert args.baseline.endswith("src/repro_torch/benchmarks/"
                                  "baseline_h100.json")
    assert args.config == CFG and args.max_ratio == 2.0
    assert set(args.skip.split(",")) == {"kernels_stream",
                                         "kernels_attention"}
    record = json.load(open(args.baseline))
    bucket = record["runs"][CFG]
    assert bucket["meta"]["device"] == "cuda"
    assert bucket["meta"]["card"].startswith("NVIDIA H100")
    assert bucket["meta"]["power_limit"].endswith("W")
    assert {"models", "models_sweep", "table3", "serving"} <= set(
        bucket["sections"])
    assert "roofline" not in bucket["sections"]
    assert DEFAULT_BENCH_JSON.name == "repro_torch_bench.json"
    assert DEFAULT_BENCH_JSON.parent.name == "build"
