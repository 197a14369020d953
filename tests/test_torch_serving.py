"""The port's serving roster (``repro_torch.serving``) against the
reference's (``repro.serving``), on the CPU through the plain versions.

For each of the 16 scenarios at seed 0: every window's word trace,
``raw_refs``, ``flops`` and batch equal the reference's byte for byte, and
``measure_windows`` gives the reference's timeline and whole-trace label.
Also the traffic draws, the capture hooks' ``page_table=`` /
``expert_ids=`` overrides and their validation (as in
``tests/test_serving.py``), and the CLI."""

import numpy as np
import pytest
import torch

from repro.serving import SCENARIOS as JAX_SCENARIOS
from repro.serving import TRAFFIC_FAMILIES as JAX_FAMILIES
from repro.serving import make_traffic as jax_make_traffic
from repro.serving import measure_windows as jax_measure_windows
from repro_torch.capture.grid import walk
from repro_torch.capture.launch import record
from repro_torch.kernels.moe_dispatch import capture as moe_capture
from repro_torch.kernels.paged_kv_decode import capture as paged_capture
from repro_torch.serving import (SCENARIOS, TRAFFIC_FAMILIES, make_traffic,
                                 measure_windows, window_seed)
from repro_torch.serving.__main__ import main

NAMES = list(SCENARIOS)
CORES = (1, 4)


@pytest.fixture(scope="module")
def timelines():
    """Both packages' full-sweep timelines, once per module."""
    return {n: (measure_windows(n, device="cpu"), jax_measure_windows(n))
            for n in NAMES}


def test_roster_is_the_reference_roster():
    assert NAMES == list(JAX_SCENARIOS)
    assert len(NAMES) == 16
    for name, s in SCENARIOS.items():
        j = JAX_SCENARIOS[name]
        assert (s.kernel, s.expected_class, s.geometry, s.n_windows,
                s.window_refs, s.max_batch, s.decode_steps, s.mlp,
                s.instr_overhead) == (
            j.kernel, j.expected_class, j.geometry, j.n_windows,
            j.window_refs, j.max_batch, j.decode_steps, j.mlp,
            j.instr_overhead)
        assert (s.traffic.name, s.traffic.family, s.traffic.keyspace,
                s.traffic.rate, s.traffic.params) == (
            j.traffic.name, j.traffic.family, j.traffic.keyspace,
            j.traffic.rate, j.traffic.params)


@pytest.mark.parametrize("name", NAMES)
def test_window_traces_byte_identical(name, timelines):
    got, want = timelines[name]
    assert len(got.windows) == len(want.windows) == SCENARIOS[name].n_windows
    for g, w in zip(got.windows, want.windows):
        assert g.addresses.dtype == w.addresses.dtype == np.int64
        assert g.addresses.tobytes() == w.addresses.tobytes()
        assert (g.raw_refs, g.flops, g.batch) == (w.raw_refs, w.flops,
                                                  w.batch)
        assert (g.demand.step, g.demand.arrivals, g.demand.intensity) == (
            w.demand.step, w.demand.arrivals, w.demand.intensity)


@pytest.mark.parametrize("name", NAMES)
def test_timeline_and_whole_label_equal_reference(name, timelines):
    got, want = timelines[name]
    assert got.timeline() == want.timeline()
    assert got.whole_label == want.whole_label
    assert got.mitigation_timeline() == want.mitigation_timeline()
    for g, w in zip(got.metrics, want.metrics):
        assert (g.temporal, g.spatial, g.ai, g.mpki, g.lfmr_by_cores) == (
            w.temporal, w.spatial, w.ai, w.mpki, w.lfmr_by_cores)


@pytest.mark.parametrize("family", sorted(JAX_FAMILIES))
def test_traffic_draws_equal_reference(family):
    assert set(TRAFFIC_FAMILIES) == set(JAX_FAMILIES)
    got = make_traffic(family, keyspace=300, rate=6).windows(7, 40, seed=4)
    want = jax_make_traffic(family, keyspace=300, rate=6).windows(7, 40,
                                                                   seed=4)
    for g, w in zip(got, want):
        assert (g.step, g.arrivals, g.intensity) == (w.step, w.arrivals,
                                                     w.intensity)
        assert g.keys.tobytes() == w.keys.tobytes()


def test_window_seed_and_whole_trace_concatenation():
    scen = SCENARIOS["srv.moe.burst"]
    assert window_seed(scen.name, 3) == window_seed(scen.name, 3)
    spec = scen.workload(device="cpu").trace(4, seed=3)
    concat = np.concatenate(
        [wt.addresses for wt in scen.window_traces(seed=3, device="cpu")])
    assert spec.addresses.tobytes() == concat.tobytes()
    assert scen.window_traces(seed=3, device="cpu") is scen.window_traces(
        seed=3, device="cpu")


def test_windows_launch_the_kernels():
    """A window build launches through the ops entry points: paged decode
    and MoE dispatch with the traffic's page tables and expert ids."""
    with record() as launched:
        measure_windows("srv.pagedkv.zipf1.1.occ25.bs4", seed=7, cores=CORES,
                        device="cpu")
        measure_windows("srv.moe.hot90", seed=7, cores=CORES, device="cpu")
    names = {spec.name for spec in launched}
    assert names == {"paged_kv_decode", "moe_dispatch"}
    assert all(len(spec.index) == (2 if spec.name == "moe_dispatch" else 1)
               for spec in launched)


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        measure_windows("srv.flash.unif", cores=CORES)


# --------------------------------------------------------------------------
# Capture-hook payload overrides
# --------------------------------------------------------------------------
def _paged(table):
    return walk(paged_capture.capture(
        n_pages=64, page=4, d=128, h=1, n_active=4,
        page_table=np.asarray(table, np.int64), device="cpu"))


def test_pagedkv_page_table_override_drives_the_stream():
    a, b, c = _paged([5, 9, 2, 40]), _paged([5, 9, 2, 40]), _paged(
        [6, 9, 2, 40])
    assert (a.addresses == b.addresses).all()
    assert (a.addresses != c.addresses).any()


def test_pagedkv_duplicate_pages_model_prefix_sharing():
    assert _paged([7, 7, 7, 7]).loads < _paged([1, 2, 3, 4]).loads


def test_pagedkv_page_table_validation():
    ok = dict(n_pages=64, page=4, d=128, h=1, n_active=4, device="cpu")
    with pytest.raises(ValueError, match="rng or page_table"):
        paged_capture.capture(**ok)
    with pytest.raises(ValueError, match="must be"):
        paged_capture.capture(**ok, page_table=np.array([1, 2]))
    with pytest.raises(ValueError, match="in \\[0, 64\\)"):
        paged_capture.capture(**ok, page_table=np.array([1, 2, 3, 99]))
    with pytest.raises(ValueError, match="in \\[0, 64\\)"):
        paged_capture.capture(**ok, page_table=np.array([1, -2, 3, 9]))


def _moe(ids):
    return walk(moe_capture.capture(
        n_tokens=4, d=128, f=128, n_experts=8, rng=np.random.default_rng(0),
        expert_ids=np.asarray(ids, np.int64), device="cpu"))


def test_moe_expert_ids_override_is_sorted_in():
    a, b, c = _moe([7, 3, 3, 1]), _moe([1, 3, 3, 7]), _moe([0, 3, 3, 7])
    assert (a.addresses == b.addresses).all()
    assert (a.addresses != c.addresses).any()


def test_moe_expert_ids_validation():
    kw = dict(n_tokens=4, d=128, f=128, n_experts=8,
              rng=np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError, match="in \\[0, 8\\)"):
        moe_capture.capture(**kw, expert_ids=np.array([0, 1, 2, 8]))
    with pytest.raises(ValueError, match="must be"):
        moe_capture.capture(**kw, expert_ids=np.array([[0, 1], [2, 3]]))


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def test_cli_list(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in SCENARIOS:
        assert name in out
    assert "# 16 scenarios" in out


def test_cli_timeline_on_cpu(capsys):
    assert main(["--scenario", "srv.pagedkv.burst", "--cores", "1,4",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "phase timeline : " in out
    assert "whole-trace    : " in out
