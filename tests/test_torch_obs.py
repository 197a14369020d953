"""``repro_torch.obs`` against the behaviours ``tests/test_obs.py`` pins on
``repro.obs``: span schema, nesting, exceptions, ``traced``, enable and
disable, delta flushes, ``warn_once``, the disabled span's zero
allocations, a child process inheriting the sink through
``REPRO_TORCH_TRACE``, the report and Chrome export and both subcommands;
then the suite and serving CLIs' ``--trace`` end to end (rows unchanged),
and each package's report reading the other's trace file."""

import gc
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import obs as jax_obs
from repro.obs.report import aggregate as jax_aggregate
from repro_torch import obs
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.report import (
    aggregate,
    aggregate_events,
    format_report,
    load_events,
    to_chrome,
)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _isolated_obs(monkeypatch):
    """Each test starts with both packages' tracing off, counters zeroed
    and both variables unset."""
    for mod in (obs, jax_obs):
        monkeypatch.delenv(mod.ENV_VAR, raising=False)
        mod.disable()
        mod.reset_counters()
    yield
    for mod in (obs, jax_obs):
        mod.disable()
        mod.reset_counters()


def _events(path) -> list[dict]:
    return [json.loads(line) for line in
            Path(path).read_text().splitlines() if line.strip()]


def _span_ev(name, ts, dur, pid=1, tid=1):
    return {"ev": "span", "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def test_env_var_is_the_ports_own():
    assert obs.ENV_VAR == "REPRO_TORCH_TRACE" != jax_obs.ENV_VAR


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------
def test_disabled_span_is_shared_singleton():
    assert not obs.enabled()
    assert obs.span("a") is obs.span("b", depth=3, note="x")


def test_span_event_schema(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    with obs.span("work.unit", depth=2, kind="test"):
        pass
    obs.disable()
    (ev,) = _events(trace)
    assert ev["ev"] == "span" and ev["name"] == "work.unit"
    assert ev["pid"] == os.getpid() and isinstance(ev["tid"], int)
    assert isinstance(ev["ts"], int) and ev["ts"] > 10**15
    assert ev["dur"] >= 0.0
    assert ev["tags"] == {"depth": 2, "kind": "test"}


def test_nesting_order_and_containment(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    obs.disable()
    inner, outer = _events(trace)
    assert (inner["name"], outer["name"]) == ("inner", "outer")
    assert inner["dur"] <= outer["dur"] and inner["ts"] >= outer["ts"]


def test_exception_recorded_and_propagated(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("no")
    obs.disable()
    (ev,) = _events(trace)
    assert ev["error"] == "ValueError"


def test_nonscalar_tags_coerced_to_str(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    with obs.span("t", shape=(4, 2), ok=True, none=None):
        pass
    obs.disable()
    (ev,) = _events(trace)
    assert ev["tags"] == {"shape": "(4, 2)", "ok": True, "none": None}


def test_traced_decorator_toggles_per_call(tmp_path):
    @obs.traced("deco.fn", kind="t")
    def f(x):
        return x + 1

    assert f(1) == 2
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    assert f(2) == 3
    obs.disable()
    (ev,) = _events(trace)
    assert ev["name"] == "deco.fn" and ev["tags"] == {"kind": "t"}
    assert f(3) == 4


def test_traced_defaults_to_qualname(tmp_path):
    @obs.traced()
    def g():
        return 7

    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    assert g() == 7
    obs.disable()
    (ev,) = _events(trace)
    assert ev["name"].endswith("g")


# --------------------------------------------------------------------------
# Enable / disable
# --------------------------------------------------------------------------
def test_enable_exports_env_disable_clears(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    assert obs.enabled() and obs.trace_path() == str(trace)
    assert os.environ["REPRO_TORCH_TRACE"] == str(trace)
    assert "REPRO_TRACE" not in os.environ   # the reference's stays off
    assert not jax_obs.enabled()
    obs.disable()
    assert not obs.enabled() and obs.trace_path() is None
    assert "REPRO_TORCH_TRACE" not in os.environ


def test_enable_same_path_is_idempotent(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    with obs.span("a"):
        pass
    obs.enable(trace)
    with obs.span("b"):
        pass
    obs.disable()
    assert [e["name"] for e in _events(trace)] == ["a", "b"]


def test_enable_new_path_switches_sink(tmp_path):
    t1, t2 = tmp_path / "t1.jsonl", tmp_path / "t2.jsonl"
    obs.enable(t1)
    with obs.span("first"):
        pass
    obs.enable(t2)
    with obs.span("second"):
        pass
    obs.disable()
    assert [e["name"] for e in _events(t1) if e["ev"] == "span"] == ["first"]
    assert [e["name"] for e in _events(t2) if e["ev"] == "span"] == ["second"]


def test_unopenable_env_path_never_breaks_import(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv(obs.ENV_VAR, str(tmp_path))  # a directory
    obs._init_from_env()
    assert not obs.enabled()
    assert "cannot open trace file" in capsys.readouterr().err


# --------------------------------------------------------------------------
# Counters
# --------------------------------------------------------------------------
def test_count_accumulates_and_resets():
    obs.count("x")
    obs.count("x", 2)
    obs.count("y", 0.5)
    assert obs.counters() == {"x": 3, "y": 0.5}
    obs.reset_counters()
    assert obs.counters() == {}


def test_flush_writes_deltas_not_cumulative(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    obs.count("a", 2)
    obs.flush()
    obs.count("a", 3)
    obs.flush()
    obs.flush()  # nothing new: no third event
    obs.disable()
    evs = [e for e in _events(trace) if e["ev"] == "counters"]
    assert [e["counters"]["a"] for e in evs] == [2, 3]
    assert aggregate([trace]).counter("a") == 5


def test_disable_flushes_pending_counters(tmp_path):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    obs.count("pending", 4)
    obs.disable()
    assert aggregate([trace]).counter("pending") == 4


def test_flush_is_noop_when_disabled():
    obs.count("z", 9)
    obs.flush()
    assert obs.counters()["z"] == 9


def test_warn_once_per_key(capsys):
    obs.warn_once("k1-test-torch-obs", "first message")
    obs.warn_once("k1-test-torch-obs", "repeat suppressed")
    obs.warn_once("k2-test-torch-obs", "second key")
    err = capsys.readouterr().err
    assert err.count("first message") == 1
    assert "repeat suppressed" not in err and "second key" in err
    assert "# repro_torch.obs: first message" in err


def test_counters_are_the_ports_own():
    obs.count("only.port", 2)
    assert "only.port" not in jax_obs.counters()


# --------------------------------------------------------------------------
# Zero cost when off
# --------------------------------------------------------------------------
def test_disabled_span_site_leaks_zero_allocations():
    assert not obs.enabled()

    def site():
        with obs.span("hot.loop", depth=1):
            pass

    for _ in range(100):
        site()
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(10_000):
        site()
    assert sys.getallocatedblocks() - before <= 16


# --------------------------------------------------------------------------
# Cross-process merge
# --------------------------------------------------------------------------
def test_child_inherits_sink_via_env(tmp_path):
    trace = tmp_path / "merged.jsonl"
    obs.enable(trace)
    child = ("from repro_torch import obs\n"
             "with obs.span('child.work'):\n"
             "    pass\n"
             "obs.count('child.counter', 7)\n"
             "obs.flush()\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    with obs.span("parent.work"):
        subprocess.run([sys.executable, "-c", child], env=env, check=True,
                       timeout=120)
    obs.disable()
    rep = aggregate([trace])
    assert len(rep.pids) >= 2
    assert rep.spans["child.work"].count == 1
    assert rep.spans["parent.work"].count == 1
    assert rep.counter("child.counter") == 7


# --------------------------------------------------------------------------
# Report aggregation + Chrome export
# --------------------------------------------------------------------------
def test_aggregate_stats_and_wall():
    rep = aggregate_events([
        _span_ev("a", 1_000_000, 2_000_000),
        _span_ev("a", 2_000_000, 4_000_000),
        _span_ev("b", 3_000_000, 1_000_000, pid=2),
        {"ev": "counters", "pid": 1, "ts": 0, "counters": {"x": 2}},
        {"ev": "counters", "pid": 2, "ts": 0, "counters": {"x": 3.5}},
    ])
    a = rep.spans["a"]
    assert a.count == 2 and a.total_s == 6.0
    assert (a.min_s, a.max_s, a.mean_s) == (2.0, 4.0, 3.0)
    assert rep.span_total("b") == 1.0 and rep.span_total("nope") == 0.0
    assert rep.wall_s == pytest.approx(5.0)
    assert rep.counter("x") == 5.5
    assert rep.pids == {1, 2} and rep.events == 5


def test_corrupt_lines_skipped_and_counted(tmp_path):
    trace = tmp_path / "t.jsonl"
    trace.write_text(
        json.dumps(_span_ev("ok", 0, 1000)) + "\n"
        + '{"ev": "span", "name": "trunca' + "\n[1, 2, 3]\n"
        + '{"no_ev_key": 1}\n')
    events, skipped = load_events([trace])
    assert len(events) == 1 and skipped == 3
    rep = aggregate([trace])
    assert rep.skipped_lines == 3 and rep.spans["ok"].count == 1
    assert "3 corrupt line(s) skipped" in format_report(rep)


def test_multiple_files_merge(tmp_path):
    t1, t2 = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    t1.write_text(json.dumps(_span_ev("s", 0, 1000, pid=1)) + "\n")
    t2.write_text(json.dumps(_span_ev("s", 500, 1000, pid=2)) + "\n")
    rep = aggregate([t1, t2])
    assert rep.spans["s"].count == 2 and rep.pids == {1, 2}


def test_format_report_table():
    rep = aggregate_events([
        _span_ev("alpha", 0, 2_000_000),
        {"ev": "counters", "pid": 1, "ts": 0,
         "counters": {"hits": 42, "busy_s": 1.25}},
    ])
    text = format_report(rep)
    assert "alpha" in text and "hits" in text
    assert "42" in text and "1.25" in text and "wall 2.000s" in text


def test_to_dict_round_trips_through_json():
    rep = aggregate_events([_span_ev("a", 0, 1_500_000),
                            {"ev": "counters", "pid": 1, "ts": 0,
                             "counters": {"k": 3}}])
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["spans"]["a"]["count"] == 1
    assert d["spans"]["a"]["total_seconds"] == 1.5
    assert d["counters"]["k"] == 3 and d["wall_seconds"] == 1.5


def test_chrome_span_events_become_complete_events():
    out = to_chrome([_span_ev("a", 10, 20, pid=3, tid=4)])
    assert out["displayTimeUnit"] == "ms"
    (ev,) = out["traceEvents"]
    assert ev == {"name": "a", "ph": "X", "ts": 10.0, "dur": 20.0,
                  "pid": 3, "tid": 4, "args": {}}


def test_chrome_counter_deltas_become_cumulative_samples():
    out = to_chrome([
        {"ev": "counters", "pid": 1, "ts": 10, "counters": {"c": 2}},
        {"ev": "counters", "pid": 1, "ts": 20, "counters": {"c": 3}},
    ])
    samples = [e for e in out["traceEvents"] if e["ph"] == "C"]
    assert [s["args"]["value"] for s in samples] == [2, 5]


def test_chrome_malformed_events_are_dropped():
    out = to_chrome([{"ev": "span", "name": "x"}, _span_ev("ok", 0, 1)])
    assert [e["name"] for e in out["traceEvents"]] == ["ok"]


def test_report_and_chrome_subcommands(tmp_path, capsys):
    trace = tmp_path / "t.jsonl"
    obs.enable(trace)
    with obs.span("stage.one"):
        pass
    obs.count("n", 3)
    obs.disable()

    assert obs_main(["report", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "stage.one" in out and "n" in out

    assert obs_main(["report", "--json", str(trace)]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["spans"]["stage.one"]["count"] == 1 and d["counters"]["n"] == 3

    chrome_out = tmp_path / "t.trace.json"
    assert obs_main(["chrome", str(trace), "-o", str(chrome_out)]) == 0
    assert any(e["ph"] == "X"
               for e in json.loads(chrome_out.read_text())["traceEvents"])


def test_module_entry_point_runs(tmp_path):
    trace = tmp_path / "t.jsonl"
    trace.write_text(json.dumps(_span_ev("cli.span", 0, 1000)) + "\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report",
                          "--json", str(trace)], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out)["spans"]["cli.span"]["count"] == 1


# --------------------------------------------------------------------------
# One schema: each package reads the other's file
# --------------------------------------------------------------------------
def _write_trace(mod, path):
    mod.enable(path)
    with mod.span("shared.outer", kind="x"):
        with mod.span("shared.inner"):
            pass
    mod.count("shared.counter", 5)
    mod.disable()


def test_reference_report_reads_a_port_trace(tmp_path):
    trace = tmp_path / "port.jsonl"
    _write_trace(obs, trace)
    theirs, ours = jax_aggregate([trace]), aggregate([trace])
    assert theirs.to_dict() == ours.to_dict()
    assert theirs.spans["shared.outer"].count == 1
    assert theirs.counter("shared.counter") == 5


def test_port_report_reads_a_reference_trace(tmp_path):
    trace = tmp_path / "ref.jsonl"
    _write_trace(jax_obs, trace)
    theirs, ours = jax_aggregate([trace]), aggregate([trace])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.spans["shared.inner"].count == 1
    assert ours.counter("shared.counter") == 5


# --------------------------------------------------------------------------
# --trace on the port's CLIs
# --------------------------------------------------------------------------
def test_suite_cli_trace_end_to_end(tmp_path, capsys):
    from repro_torch.suite.__main__ import main

    trace, traced, plain = (tmp_path / "suite.jsonl", tmp_path / "t.csv",
                            tmp_path / "p.csv")
    base = ["--device", "cpu", "--fast", "--no-store"]
    assert main([*base, "--trace", str(trace), "--out", str(traced)]) == 0
    assert not obs.enabled() and obs.ENV_VAR not in os.environ
    assert main([*base, "--out", str(plain)]) == 0
    capsys.readouterr()
    assert traced.read_text() == plain.read_text()   # spans change no row

    rep = aggregate([trace])
    assert rep.spans["suite.run"].count == 1
    assert rep.spans["suite.registry"].count == 1
    assert rep.spans["suite.entry"].count == 45
    assert rep.spans["suite.prewarm"].count == 1
    for name in ("engine.cells", "engine.trace", "sim.many", "sim.profile",
                 "sim.scan", "capture.walk"):
        assert rep.spans[name].count > 0, name
    assert "capture.sync" not in rep.spans   # no card: nothing to sync
    assert rep.counter("store.recall.cold") == 0   # --no-store
    assert rep.counter("engine.trace.run") > 0
    assert rep.counter("capture.walk.calls") > 0
    assert 0 < rep.counter("profile.scan") <= rep.counter("profile.geom")
    assert rep.counter("profile.segments") >= 2
    # the CLI's two top-level stages cover its wall
    assert (rep.span_total("suite.registry") + rep.span_total("suite.run")
            >= 0.9 * rep.wall_s)


def test_serving_cli_trace(tmp_path, capsys):
    from repro_torch.serving.__main__ import main

    trace = tmp_path / "serving.jsonl"
    assert main(["--device", "cpu", "--scenario", "srv.moe.hot90",
                 "--trace", str(trace)]) == 0
    assert "phase timeline" in capsys.readouterr().out
    assert not obs.enabled()
    rep = aggregate([trace])
    assert rep.spans["serving.run"].count == 1
    assert rep.spans["serving.run"].total_s >= rep.span_total("capture.walk")
    assert rep.counter("engine.sim.run") > 0


def test_store_corrupt_counter_and_warning(tmp_path, capsys):
    from repro_torch.suite import ResultStore

    store = ResultStore(tmp_path)
    key = "ef" + "2" * 62
    store.put(key, {"row": []})
    (tmp_path / "ef" / f"{key}.json").write_text("{\"row\": [1")
    assert store.get(key) is None and store.get(key) is None
    assert obs.counters()["store.corrupt"] == 2
    assert capsys.readouterr().err.count("# repro_torch.obs: skipping "
                                         "corrupt store record") == 1
