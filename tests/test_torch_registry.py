"""The port's suite registry (``repro_torch.suite.registry``) and result
store (``repro_torch.suite.store``) against the reference's.

The 45 entries' names, domains, sources, params and expected classes equal
the reference's, and so do the 16 serving entries'; a CPU entry's
fingerprint equals the reference's hex digest, and a card entry's differs
(pure hashing: no card is needed).  Also the registry's errors, the
store's round trip, corrupt records, key check, default root, ``prune``
and the CLI's ``--list`` and ``--gc``."""

import dataclasses

import pytest

from repro.suite import registry_for as jax_registry_for
from repro_torch.capture.kernels import CAPTURED_KERNELS
from repro_torch.core import tracegen
from repro_torch.serving import SCENARIOS
from repro_torch.suite import (ResultStore, SuiteEntry, SuiteRegistry,
                               default_registry, default_store_root,
                               registry_for)
from repro_torch.suite.__main__ import main
from repro_torch.suite.registry import (LEGACY_SCHEMA, SUITE_SCHEMA,
                                        _synthetic_grid)

REFS = 20_000
SEED, CORES = 0, (1, 4, 16, 64, 256)


def _reference(**kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_CAPTURE_PATH", "mirror")
        return jax_registry_for(**kw)


NAMES = ([w.name for w, _ in _synthetic_grid(REFS)]
         + [k.name for k in CAPTURED_KERNELS] + list(SCENARIOS))


@pytest.fixture(scope="module")
def rosters():
    """(port, reference) default and serving registries, built once."""
    return {
        "default": (default_registry(refs=REFS, device="cpu"),
                    _reference(refs=REFS)),
        "serving": (registry_for(refs=REFS, sections=("serving",),
                                 device="cpu"),
                    _reference(refs=REFS, sections=("serving",))),
    }


def test_rosters_are_the_reference_rosters(rosters):
    (port, ref), (port_srv, ref_srv) = rosters["default"], rosters["serving"]
    assert [e.name for e in port] == [e.name for e in ref] == NAMES[:45]
    assert len(port) == 45 and port.refs == ref.refs == REFS
    assert [len(port.by_source(s)) for s in ("synthetic", "captured")] == \
        [21, 24]
    assert [e.name for e in port_srv] == [e.name for e in ref_srv] == \
        NAMES[45:]
    assert len(port_srv) == 16
    assert port.device == port_srv.device == "cpu"


@pytest.mark.parametrize("name", NAMES)
def test_entry_and_fingerprint_equal_reference(name, rosters):
    roster = "default" if NAMES.index(name) < 45 else "serving"
    port, ref = rosters[roster]
    got = next(e for e in port if e.name == name)
    want = next(e for e in ref if e.name == name)
    assert (got.domain, got.source, got.params, got.expected_class) == (
        want.domain, want.source, want.params, want.expected_class)
    w, jw = got.workload, want.workload
    assert (w.family, w.ai_ops_per_access, w.instr_per_access,
            w.core_invariant) == (jw.family, jw.ai_ops_per_access,
                                  jw.instr_per_access, jw.core_invariant)
    for sections in ((), ("scalability", "energy")):
        kw = dict(seed=SEED, cores=CORES, backend="vectorized",
                  sections=sections)
        assert got.fingerprint(**kw) == want.fingerprint(**kw)
        card = dataclasses.replace(got, device="cuda")
        assert card.fingerprint(**kw) != got.fingerprint(**kw)
    assert got.fingerprint(seed=1, cores=CORES) != \
        got.fingerprint(seed=SEED, cores=CORES)
    assert got.fingerprint(seed=SEED, cores=CORES, backend="reference") != \
        got.fingerprint(seed=SEED, cores=CORES)


def test_registry_errors():
    w = tracegen.make_suite(refs=2_000)[0]
    reg = SuiteRegistry()
    reg.register(w, domain="x", source="synthetic")
    with pytest.raises(ValueError, match="already registered"):
        reg.register(w, domain="x", source="synthetic")
    with pytest.raises(ValueError, match="source"):
        SuiteRegistry().register(w, domain="x", source="bogus")
    with pytest.raises(ValueError, match="source"):
        SuiteEntry(workload=w, domain="x", source="model", params=())
    assert reg.refs is None and reg.entries[0].device == "cpu"
    card = SuiteRegistry(device="cuda:0")
    assert card.register(w, domain="x", source="synthetic").device == "cuda"


def test_store_round_trip(tmp_path):
    store = ResultStore(tmp_path)
    key = "ab" + "0" * 62
    assert store.get(key) is None and key not in store and len(store) == 0
    store.put(key, {"row": [1, "1a", 0.5]})
    assert store.get(key) == {"row": [1, "1a", 0.5]}
    assert key in store and len(store) == 1
    assert (tmp_path / "ab" / f"{key}.json").is_file()
    assert store.sub("cells").root == tmp_path / "cells"
    assert list(store.keys()) == [key]


@pytest.mark.parametrize("text", ["{\"row\": [1, 2", "[1, 2]", "\xff"])
def test_corrupt_record_is_a_miss(tmp_path, capsys, text):
    store = ResultStore(tmp_path)
    key = "cd" + "1" * 62
    store.put(key, {"row": []})
    (tmp_path / "cd" / f"{key}.json").write_text(text, encoding="latin-1")
    assert store.get(key) is None
    assert store.get(key) is None
    err = capsys.readouterr().err
    assert err.count("skipping corrupt store record") == 1


@pytest.mark.parametrize("key", ["", "XYZ", "../etc", "ab/cd", "0x12"])
def test_non_hex_key_rejected(tmp_path, key):
    with pytest.raises(ValueError, match="hex digest"):
        ResultStore(tmp_path).get(key)


def test_default_root(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SUITE_STORE", str(tmp_path / "s"))
    monkeypatch.setenv("REPRO_SUITE_STORE", str(tmp_path / "reference"))
    assert default_store_root() == tmp_path / "s"
    assert ResultStore().root == tmp_path / "s"
    monkeypatch.delenv("REPRO_TORCH_SUITE_STORE")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert default_store_root() == tmp_path / ".cache" / "repro-torch-suite"


def _fill_for_gc(store):
    keys = [f"{i:02x}" + "e" * 62 for i in range(4)]
    store.put(keys[0], {"schema": SUITE_SCHEMA, "row": []})
    store.put(keys[1], {"row": []})                      # legacy marker
    store.put(keys[2], {"schema": SUITE_SCHEMA + 1, "row": []})
    store.put(keys[3], {"schema": SUITE_SCHEMA, "row": []})
    (store.root / keys[3][:2] / f"{keys[3]}.json").write_text("{")
    return keys


def test_prune(tmp_path):
    store = ResultStore(tmp_path)
    keys = _fill_for_gc(store)
    removed = store.prune(
        lambda k, rec: rec.get("schema", LEGACY_SCHEMA) == SUITE_SCHEMA)
    assert removed == 2
    assert list(store.keys()) == keys[:2]


def test_cli_gc(tmp_path, capsys):
    keys = _fill_for_gc(ResultStore(tmp_path))
    assert main(["--gc", "--store", str(tmp_path)]) == 0
    assert "pruned 2 stale record(s), 2 kept" in capsys.readouterr().err
    assert list(ResultStore(tmp_path).keys()) == keys[:2]


def test_cli_list(capsys):
    assert main(["--list", "--fast", "--device", "cpu", "--no-store"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "# 45 entries (21 synthetic, 24 captured)"
    assert [ln.split()[0] for ln in lines[:-1]] == NAMES[:45]
    assert "refs=20000" in lines[0]


def test_cli_list_serving(capsys):
    assert main(["--list", "--sections", "serving", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "# 16 entries (16 serving)"
    assert [ln.split()[0] for ln in lines[:-1]] == NAMES[45:]
