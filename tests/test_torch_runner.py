"""The port's suite runner around its store and process pool
(``repro_torch.suite.runner``), on the CPU.

A warm rerun recalls every row of the 45-entry roster with no trace and no
simulation; a partial store computes only the missing rows; a corrupt or
wrong-shape record is a miss and is rewritten; rows written on one device
are never recalled on another; a hand-built registry is refused for
fan-out; ``REPRO_SIM_BACKEND=jax`` raises.  The pool itself is held in
``tests/test_torch_pool.py``."""

import dataclasses

import pytest

from repro_torch.capture.kernels import captured_workloads
from repro_torch.core import tracegen
from repro_torch.suite import (ResultStore, SuiteRegistry, SuiteRunner,
                               default_registry)
from repro_torch.suite.__main__ import main
from repro_torch.suite.registry import SUITE_SCHEMA

REFS = 2_000
CORES = (1, 4)


def _tiny_registry(*, with_captured: bool = False) -> SuiteRegistry:
    reg = SuiteRegistry()
    for w in tracegen.make_suite(refs=REFS)[:3]:
        reg.register(w, domain="synthetic-test", source="synthetic",
                     refs=REFS)
    if with_captured:
        w = next(x for x in captured_workloads(device="cpu")
                 if x.name == "pal.stream.copy.1MiB")
        reg.register(w, domain="TPU-kernel/streaming", source="captured")
    return reg


@pytest.fixture(scope="module")
def default():
    return default_registry(refs=REFS, device="cpu")


def test_warm_rerun_recalls_every_row(tmp_path, default):
    store = ResultStore(tmp_path)
    first = SuiteRunner(default, cores=CORES, store=store)
    rows = first.roster().rows
    assert first.stats.as_dict() == {"computed": 45, "recalled": 0}
    assert len(store) == 45
    assert {store.get(k)["schema"] for k in store.keys()} == {SUITE_SCHEMA}
    second = SuiteRunner(default, cores=CORES, store=store)
    assert second.roster().rows == rows
    assert second.stats.as_dict() == {"computed": 0, "recalled": 45}
    assert second.study.stats.sim_runs == 0
    assert second.study.stats.trace_runs == 0
    assert SuiteRunner(default, cores=CORES).roster().rows == rows


def test_rows_never_recalled_across_devices(tmp_path):
    reg = _tiny_registry()
    store = ResultStore(tmp_path)
    SuiteRunner(reg, cores=CORES, store=store).roster()
    card = SuiteRegistry(entries=[dataclasses.replace(e, device="cuda")
                                  for e in reg], device="cuda")
    runner = SuiteRunner(card, cores=CORES, store=store)
    assert all(runner._recall(e) is None for e in card)
    assert runner.stats.recalled == 0


def test_partial_store_simulates_only_missing(tmp_path):
    store = ResultStore(tmp_path)
    reg = _tiny_registry()
    SuiteRunner(SuiteRegistry(entries=reg.entries[:2]), cores=CORES,
                store=store).roster()
    full = SuiteRunner(_tiny_registry(), cores=CORES, store=store)
    full.roster()
    assert full.stats.as_dict() == {"computed": 1, "recalled": 2}


@pytest.mark.parametrize("damage", ["truncate", "short_row", "schema",
                                    "columns"])
def test_damaged_record_is_recomputed(tmp_path, capsys, damage):
    store = ResultStore(tmp_path)
    rows = SuiteRunner(_tiny_registry(), cores=CORES,
                       store=store).roster().rows
    key = next(iter(store.keys()))
    path = tmp_path / key[:2] / f"{key}.json"
    rec = store.get(key)
    if damage == "truncate":
        path.write_text(path.read_text()[:17])
    elif damage == "short_row":
        store.put(key, dict(rec, row=rec["row"][:-1]))
    elif damage == "schema":
        store.put(key, dict(rec, schema=SUITE_SCHEMA + 1))
    else:
        store.put(key, dict(rec, columns=rec["columns"][:-1] + ["x"]))
    second = SuiteRunner(_tiny_registry(), cores=CORES, store=store)
    assert second.roster().rows == rows
    assert second.stats.as_dict() == {"computed": 1, "recalled": 2}
    assert ("skipping corrupt store record" in capsys.readouterr().err) == (
        damage == "truncate")
    third = SuiteRunner(_tiny_registry(), cores=CORES, store=store)
    assert third.roster().rows == rows
    assert third.stats.recalled == 3


def test_captured_entry_and_divergence():
    runner = SuiteRunner(_tiny_registry(with_captured=True), cores=CORES)
    rec = runner.roster().records()[-1]
    assert (rec["source"], rec["assigned"], rec["match"]) == (
        "captured", "1a", 1)
    w = tracegen.make_suite(refs=REFS)[0]
    impostor = dataclasses.replace(w, name="pal.fake", expected_class="2c")
    reg = SuiteRegistry()
    reg.register(impostor, domain="x", source="captured")
    bad = SuiteRunner(reg, cores=CORES).divergent(source="captured")
    assert [r["name"] for r in bad] == ["pal.fake"]


def test_hand_built_registry_refused_for_fan_out():
    reg = _tiny_registry()
    assert reg.refs is None
    with pytest.raises(ValueError, match="refs"):
        SuiteRunner(reg, cores=CORES, processes=2).compute_all()
    assert len(SuiteRunner(reg, cores=CORES, processes=1).roster()) == 3


def test_jax_backend_raises(monkeypatch):
    monkeypatch.setenv("REPRO_SIM_BACKEND", "jax")
    with pytest.raises(ValueError, match="backend 'cuda'"):
        SuiteRunner(_tiny_registry(), cores=CORES)
    with pytest.raises(ValueError, match="backend 'cuda'"):
        main(["--device", "cpu", "--refs", str(REFS), "--cores", "1,4",
              "--no-store"])


def test_cli_no_store_and_stats(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_SUITE_STORE", str(tmp_path / "store"))
    assert main(["--device", "cpu", "--refs", str(REFS), "--cores", "1,4",
                 "--no-store", "--stats", "--backend", "vectorized"]) == 0
    err = capsys.readouterr().err
    assert "# store: {'computed': 45, 'recalled': 0}" in err
    assert "'sim_runs': 90" in err
    assert not (tmp_path / "store").exists()
