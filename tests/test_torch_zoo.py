"""``repro_torch.capture.zoo`` and the ``models`` roster against the
reference's zoo.

- The 176 entries: the reference's names in its order, with its
  declarations.
- The pins: the port's own (measured by ``python -m
  repro_torch.capture.pin_zoo``), each AI within :data:`AI_TOL` of the
  reference's ``_PINS`` and each class equal to its class but those
  named in :data:`DIVERGENT` (none); the CI pair's and the named
  boundaries' classes equal to the reference's.
- The frontier and transition functions: the reference's algorithm over
  the port's pins.
- ``only=`` never changes a fingerprint; building the roster captures
  nothing.
- Live recomputes, as the reference's tests make them:
  ``qwen2.5-14b.decode.bs8`` classifies 1b, ``.c4096`` 1a with MPKI >= 11,
  and mamba2-780m's c256 and c1024 decode steps give identical metrics.
- ``python -m repro_torch.suite --sections models --filter`` against
  ``python -m repro.suite`` on name, class, mode, batch, geometry and the
  dense-op count.
"""

import dataclasses
import json


from repro.capture import zoo as jax_zoo
from repro_torch.capture import zoo
from repro_torch.core import classify
from repro_torch.suite import models_registry
from repro_torch.suite.__main__ import main

# Entries whose port class differs from the reference's pin, and why
# (none today: every class is the reference's).
DIVERGENT: dict[str, str] = {}


def test_entries_are_the_references():
    assert len(zoo.MODEL_ZOO) == len(jax_zoo.MODEL_ZOO) == 176
    for got, want in zip(zoo.MODEL_ZOO, jax_zoo.MODEL_ZOO):
        assert (got.name, got.config, got.mode, got.batch, got.geometry,
                got.domain, got.params(), got.target_refs, got.mlp,
                got.instr_overhead) == (
            want.name, want.config, want.mode, want.batch, want.geometry,
            want.domain, want.params(), want.target_refs, want.mlp,
            want.instr_overhead)
    assert list(zoo.ZOO_BY_NAME) == list(jax_zoo.ZOO_BY_NAME)


def test_pins_are_the_ports_and_agree_but_the_named():
    assert set(zoo._PINS) == set(jax_zoo._PINS)
    assert all(ai > 0 for ai, _ in zoo._PINS.values())
    differ = {n for n, (_, cls) in zoo._PINS.items()
              if cls != jax_zoo._PINS[n][1]}
    assert differ == set(DIVERGENT)
    assert zoo._PINS != jax_zoo._PINS          # measured, not copied


AI_TOL = 0.02     # a pin's AI against the reference's


def test_pin_ais_are_the_references():
    """Every pinned AI within :data:`AI_TOL` of the reference's (the other
    of DAMOV's two axes)."""
    gaps = {n: ai / jax_zoo._PINS[n][0] - 1
            for n, (ai, _) in zoo._PINS.items()}
    worst = max(gaps, key=lambda n: abs(gaps[n]))
    assert abs(gaps[worst]) <= AI_TOL, (worst, gaps[worst])


def test_ci_pair_and_named_boundaries_hold():
    for s in zoo.MODEL_ZOO:
        if s.config in zoo._LONG_CACHE_FULL:
            assert s.expected_class == jax_zoo.ZOO_BY_NAME[
                s.name].expected_class, s.name
    axis = {c: dict(zoo.geometry_frontier()[(c, "decode", 8)])
            for c in zoo._CONFIGS}
    assert [axis["qwen2.5-14b"][g] for g in (256, 1024, 4096, 16384)] == \
        ["1b", "1b", "1a", "1a"]
    assert [axis["nemotron-4-340b"][g] for g in (256, 1024, 4096, 16384)] \
        == ["1b", "1b", "1b", "1a"]
    for config in zoo._ASYMPTOTE_CONFIGS:
        assert 65536 in axis[config]
        assert set(axis[config].values()) == {"1b"}, config
    ais = {zoo.ZOO_BY_NAME[f"model.mamba2-780m.decode.bs8{sfx}"].ai
           for sfx in ("", ".c1024", ".c4096", ".c16384", ".c65536")}
    assert len(ais) == 1
    # the reference's pinned zamba2 flap at c4096 is the port's too
    assert [axis["zamba2-7b"][g] for g in (256, 1024, 4096, 16384)] == \
        ["1b", "1a", "1b", "1a"]


def test_frontiers_are_the_reference_algorithm_over_port_pins(monkeypatch):
    ported = tuple(dataclasses.replace(
        s, expected_class=zoo.ZOO_BY_NAME[s.name].expected_class)
        for s in jax_zoo.MODEL_ZOO)
    monkeypatch.setattr(jax_zoo, "MODEL_ZOO", ported)
    assert zoo.class_frontier() == jax_zoo.class_frontier()
    assert zoo.batch_transitions() == jax_zoo.batch_transitions()
    assert zoo.geometry_frontier() == jax_zoo.geometry_frontier()
    assert zoo.geometry_transitions() == jax_zoo.geometry_transitions()
    assert all(t == () for t in zoo.batch_transitions().values())


def test_filter_keeps_fingerprints_and_builds_trace_free():
    from repro_torch.study.engine import _fingerprint

    zoo._CAPTURES.clear()
    full = models_registry(refs=20_000, device="cpu")
    sub = models_registry(refs=20_000, only=("qwen2.5", "mamba2"),
                          device="cpu")
    assert len(zoo._CAPTURES) == 0            # nothing captured
    assert len(full) == 176 and len(sub) == 51 and sub.only == (
        "qwen2.5", "mamba2")
    kw = dict(seed=0, cores=(1, 4), backend="vectorized",
              sections=("models",))
    by_name = {e.name: e for e in full}
    for e in sub:
        assert e.fingerprint(**kw) == by_name[e.name].fingerprint(**kw)
        assert _fingerprint(e.workload) == _fingerprint(
            by_name[e.name].workload)


def _measure(name):
    (w,) = [w for w in zoo.model_workloads(only=(name,)) if w.name == name]
    return w, classify.measure(w, seed=0)


def test_live_recompute_qwen_boundary():
    w, m = _measure("model.qwen2.5-14b.decode.bs8")
    assert classify.classify(m) == w.expected_class == "1b"
    w, m = _measure("model.qwen2.5-14b.decode.bs8.c4096")
    assert classify.classify(m) == w.expected_class == "1a"
    assert m.mpki >= 11.0


def test_live_recompute_mamba2_is_cache_depth_invariant():
    _, a = _measure("model.mamba2-780m.decode.bs8")
    _, b = _measure("model.mamba2-780m.decode.bs8.c1024")
    assert (a.temporal, a.spatial, a.mpki, a.lfmr_by_cores) == \
        (b.temporal, b.spatial, b.mpki, b.lfmr_by_cores)


def test_cli_models_filter_against_reference(capsys, monkeypatch):
    from repro.suite.__main__ import main as jax_main

    flt = "qwen2.5-14b.decode.bs1,mamba2-780m.decode.bs4"
    args = ["--sections", "models", "--filter", flt, "--fast", "--check",
            "--no-store", "--json"]
    assert main(args + ["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert "--check only sees the filtered entries" in err
    got = json.loads(out)
    assert jax_main(args) == 0
    want = json.loads(capsys.readouterr().out)
    keys = ("name", "assigned", "expected", "mode", "batch", "geometry",
            "dense_ops")

    def rows(doc):
        (roster,) = [t for t in doc if t["name"] == "suite_roster"]
        at = [roster["columns"].index(k) for k in keys]
        return [tuple(r[i] for i in at) for r in roster["rows"]]

    assert rows(got) == rows(want)
    assert len(rows(got)) == 6       # "bs1" also picks bs16, with c1024


def test_cli_filter_needs_the_models_section(capsys):
    assert main(["--filter", "qwen", "--device", "cpu", "--no-store"]) == 2
    assert "only applies to the models roster" in capsys.readouterr().err
