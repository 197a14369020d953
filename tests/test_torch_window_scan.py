"""The simulator's window count (``repro_torch.kernels.window_scan``).

Its plain version equals the reference's jitted ``_jax_window_counts``
(run through jax on the CPU, as ``tests/test_cachesim_seg_stream.py`` runs
the reference's ``jax`` backend) and the NumPy scan's gather, exactly, on
seeded rows: ragged spans, cold (-1) slots, rows whose window ends at
m - 1 and rows whose window runs past it (the index clamps).  The ``cuda``
backend raises without a card and never falls back to NumPy; ``jax``
raises and names ``cuda``.  Tests marked ``cuda`` hold the kernel against
the plain version on a card, at every (lanes, steps) its plan picks; they
skip here."""

import numpy as np
import pytest
import torch

from repro.core import cachesim_vec as jax_vec
from repro_torch.core import cachesim, cachesim_vec, tracegen
from repro_torch.kernels import window_scan
from repro_torch.kernels.window_scan import (window_count_cuda,
                                             window_counts,
                                             window_counts_ref, window_plan)
from repro_torch.study.engine import SimEngine
from repro_torch.suite.__main__ import main as suite_main

# (m, rows, chunk, seed): the scan's first step (chunk = min ways), later
# steps (chunk x 4), a wide one, and a tiny stream.
GEOMETRIES = [(5_000, 300, 8, 0), (5_000, 300, 16, 1), (20_000, 64, 128, 2),
              (20_000, 17, 1_024, 3), (40, 33, 64, 4), (1, 5, 8, 5)]


def _rows(m: int, n_rows: int, chunk: int, seed: int):
    """Seeded q [m] (set-local previous index or -1) and (lo, thr, span)
    rows: ragged spans in [0, chunk], some windows ending at m - 1, some
    running past it, thresholds from -2 up."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, max(m // 4, 1), m).astype(np.int32)
    q[rng.random(m) < 0.2] = -1
    lo = rng.integers(0, m, n_rows)
    span = rng.integers(0, chunk + 1, n_rows)
    span[: n_rows // 4] = chunk                      # full-chunk rows
    k = n_rows // 8
    lo[-k:] = np.maximum(m - span[-k:], 0)           # window ends at m - 1
    lo[-2 * k:-k] = m - 1                            # runs past the end
    thr = rng.integers(-2, max(m // 4, 1), n_rows)
    return q, lo.astype(np.int64), thr.astype(np.int64), span.astype(np.int64)


def _numpy_counts(q, lo, thr, span, chunk):
    """The NumPy scan's own gather (``_contested_sd``, ``mode="clip"``)."""
    offs = np.arange(chunk, dtype=np.int64)
    idx = lo[:, None] + offs
    return ((np.take(q, idx, mode="clip") <= thr[:, None])
            & (offs < span[:, None])).sum(axis=1)


def _ref(q, lo, thr, span, chunk, dtype=torch.int32):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    return window_counts_ref(t(q), t(lo), t(thr), t(span), chunk).numpy()


@pytest.mark.parametrize("m,n_rows,chunk,seed", GEOMETRIES)
def test_plain_version_equals_the_numpy_scan(m, n_rows, chunk, seed):
    q, lo, thr, span = _rows(m, n_rows, chunk, seed)
    want = _numpy_counts(q, lo, thr, span, chunk)
    got = _ref(q, lo, thr, span, chunk)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(_ref(q, lo, thr, span, chunk, torch.int64), want)


@pytest.mark.parametrize("m,n_rows,chunk,seed", GEOMETRIES)
def test_plain_version_equals_the_reference_jax_scan(m, n_rows, chunk, seed):
    jax = pytest.importorskip("jax")
    _, kern = jax_vec._jax_window_kernel()
    q, lo, thr, span = _rows(m, n_rows, chunk, seed)
    want = jax_vec._jax_window_counts(kern, jax.device_put(q), lo, thr, span,
                                      chunk)
    assert np.array_equal(_ref(q, lo, thr, span, chunk), want)


@pytest.mark.parametrize("qdtype", [np.int32, np.int64])
def test_entry_point_on_cpu_runs_the_plain_version(qdtype):
    q, lo, thr, span = _rows(5_000, 200, 16, 7)
    before = window_count_cuda.launches
    q_dev = window_scan.to_device(q.astype(qdtype), torch.device("cpu"))
    assert q_dev.dtype == (torch.int32 if qdtype == np.int32 else torch.int64)
    rows = torch.from_numpy(np.stack([lo, thr, span])).to(q_dev.dtype)
    with window_scan.record() as calls:
        got = window_counts(q_dev, rows, 16)
    assert got.dtype == q_dev.dtype
    assert np.array_equal(got.numpy(), _numpy_counts(q, lo, thr, span, 16))
    (q_rec, rows_rec, chunk), = calls
    assert q_rec is q_dev and rows_rec is rows and chunk == 16
    assert window_count_cuda.launches == before


def test_no_rows_no_launch():
    # every window shorter than skip_below: the scan makes no window count
    q_dev = window_scan.to_device(np.zeros(8, np.int32), torch.device("cpu"))
    lo = np.array([0, 2, 5], dtype=np.int64)
    with window_scan.record() as calls:
        got = window_scan.scan(q_dev, lo, np.zeros(3, np.int32), lo + 1,
                               skip_below=2, cap=4)
    assert got.dtype == np.int64 and np.array_equal(got, np.zeros(3))
    assert calls == []


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        window_count_cuda(q, torch.zeros(3, 2, dtype=torch.int32), 8)


def test_backends():
    assert cachesim.BACKENDS == ("reference", "vectorized", "cuda")


def test_default_backend_stays_vectorized(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_BACKEND", raising=False)
    assert cachesim.default_backend() == "vectorized"
    monkeypatch.setenv("REPRO_SIM_BACKEND", "cuda")
    assert cachesim.default_backend() == "cuda"


def test_jax_backend_raises_and_names_cuda(monkeypatch):
    monkeypatch.setenv("REPRO_SIM_BACKEND", "jax")
    with pytest.raises(ValueError, match="'cuda'"):
        cachesim.default_backend()
    with pytest.raises(ValueError, match="cuda"):
        cachesim.simulate(np.arange(64) * 8, cachesim.host_config(1))
    with pytest.raises(ValueError, match="unknown backend"):
        cachesim.simulate(np.arange(64) * 8, cachesim.host_config(1),
                          backend="jax")


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_backend_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    addr = tracegen.make_suite(refs=2_000)[0].trace(4).addresses
    cfg = cachesim.host_config(4)
    calls = [
        lambda: cachesim.simulate(addr, cfg, backend="cuda"),
        lambda: cachesim.simulate_batch(addr, [cfg], backend="cuda"),
        lambda: cachesim.simulate_many([(addr, [cfg], {})], backend="cuda"),
        lambda: cachesim_vec.simulate_many([(addr, [cfg], {})], scan="cuda"),
        lambda: cachesim_vec.simulate(addr, cfg, scan="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_cuda_env_backend_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    monkeypatch.setenv("REPRO_SIM_BACKEND", "cuda")
    w = tracegen.make_suite(refs=2_000)[0]
    with pytest.raises(RuntimeError, match="cuda"):
        cachesim.simulate(w.trace(4).addresses, cachesim.host_config(4))
    with pytest.raises(RuntimeError, match="cuda"):
        SimEngine().simulate(w, 4, cachesim.host_config(4))


def test_suite_cli_backend_cuda_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        suite_main(["--device", "cpu", "--refs", "2000", "--cores", "1,4",
                    "--no-store", "--backend", "cuda"])


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the window_scan kernel has no "
                    "CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.int32, torch.int64])
def test_kernel_equals_plain_version_on_the_card(qdtype):
    _needs_card()
    dev = torch.device("cuda")
    for m, n_rows, chunk, seed in GEOMETRIES:
        q, lo, thr, span = _rows(m, n_rows, chunk, seed)
        rows = torch.from_numpy(np.stack([lo, thr, span])).to(qdtype).to(dev)
        q_dev = torch.from_numpy(q).to(qdtype).to(dev)
        before = window_count_cuda.launches
        got = window_count_cuda(q_dev, rows, chunk)
        assert window_count_cuda.launches == before + 1
        want = window_counts_ref(q_dev, rows[0], rows[1], rows[2], chunk)
        assert torch.equal(got, want)
        assert np.array_equal(got.cpu().numpy(),
                              _numpy_counts(q, lo, thr, span, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 256,
                                   1024])
def test_kernel_at_every_lane_count_on_the_card(chunk, qdtype):
    """Each (lanes, steps) the plan picks, chunks below and above 32, on
    row counts that leave the last tile ragged and the grid several tiles
    a block."""
    _needs_card()
    dev = torch.device("cuda")
    plan = window_plan(1, chunk, qdtype.itemsize, n_sm=1)
    for n_rows in (plan["rows_per_tile"] - 1, 40 * plan["rows_per_tile"] + 3,
                   300_007):
        q, lo, thr, span = _rows(50_000, n_rows, chunk, chunk + n_rows)
        rows = torch.from_numpy(np.stack([lo, thr, span])).to(qdtype).to(dev)
        q_dev = torch.from_numpy(q).to(qdtype).to(dev)
        got = window_count_cuda(q_dev, rows, chunk)
        assert torch.equal(got, window_counts_ref(q_dev, rows[0], rows[1],
                                                  rows[2], chunk))
