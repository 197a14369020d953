"""The port's §5 case studies (``repro_torch.core.casestudies``): the
reference's shape and monotonicity tests (``tests/test_casestudies.py``),
run on the port, and each study's result equal to the reference's on the
same workloads.

Equality is exact: the studies are NumPy copies over counter-identical
simulations, so every float is computed by the same operations in the
same order.  Each side gets one engine of its own at 4 000 refs; the
engines' hit/miss counts are held equal too (case study 3 submits one
batch of three cells on both sides)."""

import dataclasses

import numpy as np
import pytest

from repro.core import casestudies as ref_casestudies
from repro.core import tracegen as ref_tracegen
from repro.study.engine import SimEngine as RefEngine
from repro_torch.core import casestudies, tracegen
from repro_torch.study.engine import SimEngine

REFS = 4_000


@pytest.fixture(scope="module")
def suite():
    return {w.name: w for w in tracegen.make_suite(refs=REFS)}


@pytest.fixture(scope="module")
def engine():
    return SimEngine()


# --------------------------------------------------------------------------
# Case study 1: inter-vault NoC traffic
# --------------------------------------------------------------------------
class TestNocStudy:
    def test_histogram_is_a_distribution(self, suite, engine):
        r = casestudies.noc_study(suite["STRCpy"], engine=engine)
        assert r.workload == "STRCpy"
        fracs = np.array(list(r.hop_histogram.values()))
        assert fracs.sum() == pytest.approx(1.0)
        assert (fracs >= 0).all()
        max_hops = 2 * (casestudies.MESH_DIM - 1)
        assert all(0 <= h <= max_hops for h in r.hop_histogram)

    def test_mean_hops_consistent_with_histogram(self, suite, engine):
        r = casestudies.noc_study(suite["LIGPrkEmd"], engine=engine)
        mean = sum(h * f for h, f in r.hop_histogram.items())
        assert r.mean_hops == pytest.approx(mean)
        assert 0.0 <= r.local_fraction <= 1.0
        assert r.local_fraction == pytest.approx(
            r.hop_histogram.get(0, 0.0))

    def test_overhead_nonnegative_and_scales_with_hop_cost(self, suite,
                                                          engine):
        w = suite["STRCpy"]
        cheap = casestudies.noc_study(w, cycles_per_hop=1.0, engine=engine)
        costly = casestudies.noc_study(w, cycles_per_hop=6.0, engine=engine)
        assert cheap.overhead_pct >= 0.0
        assert costly.overhead_pct > cheap.overhead_pct
        # hop geometry is independent of the per-hop cost
        assert costly.hop_histogram == cheap.hop_histogram


# --------------------------------------------------------------------------
# Case study 2: NDP vs compute-centric accelerators
# --------------------------------------------------------------------------
class TestAcceleratorStudy:
    def test_bandwidth_bound_kernels_gain(self, suite, engine):
        """Paper §5.2: memory-bound (1a) accelerators gain ~ the bandwidth
        ratio on NDP; the gain is bounded by it."""
        sp = casestudies.accelerator_study(suite["STRCpy"], engine=engine)
        ratio = 431.0 / 115.0
        assert 1.0 < sp <= ratio + 1e-6

    def test_compute_bound_kernels_do_not_gain(self, suite, engine):
        sp = casestudies.accelerator_study(suite["HPGSpm"], engine=engine)
        assert sp == pytest.approx(1.0, abs=0.05)

    def test_ordering_matches_memory_intensity(self, suite, engine):
        sp_stream = casestudies.accelerator_study(suite["STRCpy"],
                                                  engine=engine)
        sp_gemm = casestudies.accelerator_study(suite["HPGSpm"],
                                                engine=engine)
        assert sp_stream > sp_gemm


# --------------------------------------------------------------------------
# Case study 3: iso-area/iso-power NDP core models
# --------------------------------------------------------------------------
class TestCoreModelStudy:
    def test_shape_and_positivity(self, suite, engine):
        r = casestudies.core_model_study(suite["STRCpy"], engine=engine)
        assert set(r) == {"ndp_inorder_128", "ndp_ooo_6"}
        assert all(np.isfinite(v) and v > 0 for v in r.values())

    def test_many_inorder_cores_win_for_bandwidth_bound(self, suite, engine):
        """Paper §5.3: for 1a functions, 128 in-order NDP cores beat both
        the host and the 6 OoO NDP cores (throughput > latency)."""
        r = casestudies.core_model_study(suite["STRCpy"], engine=engine)
        assert r["ndp_inorder_128"] > 1.0
        assert r["ndp_inorder_128"] > r["ndp_ooo_6"]


# --------------------------------------------------------------------------
# Case study 4: fine-grained (hottest-basic-block) offloading
# --------------------------------------------------------------------------
class TestFinegrainedOffload:
    def test_shape_and_bounds(self, suite, engine):
        r = casestudies.finegrained_offload_study(suite["LIGPrkEmd"],
                                                  engine=engine)
        assert set(r) == {"hottest_block_miss_share",
                          "speedup_hottest_block", "speedup_full_function"}
        assert 0.0 < r["hottest_block_miss_share"] < 1.0
        # offloading one block can help at most as much as the whole
        # function (which NDP accelerates for this 1a workload)
        assert 1.0 <= r["speedup_hottest_block"] <= \
            r["speedup_full_function"]

    def test_monotonic_in_zipf_skew(self, suite, engine):
        """A more skewed block-miss profile concentrates more stalls in
        the hottest block -> larger fine-grained speedup."""
        w = suite["LIGPrkEmd"]
        flat = casestudies.finegrained_offload_study(w, zipf_s=1.1,
                                                     engine=engine)
        skewed = casestudies.finegrained_offload_study(w, zipf_s=2.5,
                                                      engine=engine)
        assert skewed["hottest_block_miss_share"] > \
            flat["hottest_block_miss_share"]
        assert skewed["speedup_hottest_block"] >= \
            flat["speedup_hottest_block"]
        # whole-function offload does not depend on the block profile
        assert skewed["speedup_full_function"] == pytest.approx(
            flat["speedup_full_function"])

    def test_more_blocks_dilute_the_hottest(self, suite, engine):
        w = suite["LIGPrkEmd"]
        few = casestudies.finegrained_offload_study(w, n_blocks=10,
                                                    engine=engine)
        many = casestudies.finegrained_offload_study(w, n_blocks=1000,
                                                     engine=engine)
        assert few["hottest_block_miss_share"] > \
            many["hottest_block_miss_share"]


# --------------------------------------------------------------------------
# Engine sharing across case studies
# --------------------------------------------------------------------------
def test_case_studies_share_engine_cells(suite):
    """All four studies on one engine: the 4-core host/ndp cells simulate
    once and are recalled by later studies."""
    engine = SimEngine()
    w = suite["STRCpy"]
    casestudies.noc_study(w, engine=engine)
    casestudies.finegrained_offload_study(w, engine=engine)
    casestudies.core_model_study(w, engine=engine)
    assert engine.stats.sim_hits > 0
    # the NoC study's cells are all cached now: a re-run simulates nothing
    runs_before_rerun = engine.stats.sim_runs
    casestudies.noc_study(w, engine=engine)
    assert engine.stats.sim_runs == runs_before_rerun


def test_default_engine_is_the_ports():
    """Without an engine the studies build the port's own SimEngine."""
    assert isinstance(casestudies._engine_or_new(None), SimEngine)


# --------------------------------------------------------------------------
# Equality with the reference
# --------------------------------------------------------------------------
# The workloads the driver's case sections run (benchmarks/paper_figures.py).
CASE_WORKLOADS = {
    "noc": ("STRCpy", "LIGPrkEmd", "CHAHsti", "PLYalu", "HPGSpm", "RODNw",
            "DRKRes", "HSJNPO"),
    "accelerator": ("STRCpy", "LIGPrkEmd", "CHAHsti", "PLYalu", "HPGSpm",
                    "RODNw"),
    "core_model": ("STRCpy", "LIGPrkEmd", "CHAHsti", "PLYalu", "PLYgemver",
                   "SPLLucb"),
    "finegrained_offload": ("LIGPrkEmd", "HSJNPO", "DRKRes"),
}


def _as_plain(result):
    return dataclasses.asdict(result) if dataclasses.is_dataclass(result) \
        else result


@pytest.mark.parametrize("study", list(CASE_WORKLOADS))
def test_study_equals_reference(study):
    port_suite = {w.name: w for w in tracegen.make_suite(refs=REFS)}
    ref_suite = {w.name: w for w in ref_tracegen.make_suite(refs=REFS)}
    port_engine, ref_engine = SimEngine(), RefEngine()
    fn = getattr(casestudies, f"{study}_study")
    ref_fn = getattr(ref_casestudies, f"{study}_study")
    for name in CASE_WORKLOADS[study]:
        got = _as_plain(fn(port_suite[name], engine=port_engine))
        want = _as_plain(ref_fn(ref_suite[name], engine=ref_engine))
        assert got == want, name
    assert port_engine.stats.as_dict() == ref_engine.stats.as_dict()


@pytest.mark.parametrize("kwargs", [
    {"cycles_per_hop": 6.0}, {"seed": 1, "cores": 16},
])
def test_noc_study_options_equal_reference(kwargs):
    w = tracegen.make_suite(refs=REFS)[3]
    rw = ref_tracegen.make_suite(refs=REFS)[3]
    assert dataclasses.asdict(casestudies.noc_study(w, **kwargs)) == \
        dataclasses.asdict(ref_casestudies.noc_study(rw, **kwargs))


@pytest.mark.parametrize("kwargs", [
    {"zipf_s": 2.5}, {"n_blocks": 10, "seed": 2},
])
def test_offload_study_options_equal_reference(kwargs):
    w = tracegen.make_suite(refs=REFS)[1]
    rw = ref_tracegen.make_suite(refs=REFS)[1]
    assert casestudies.finegrained_offload_study(w, **kwargs) == \
        ref_casestudies.finegrained_offload_study(rw, **kwargs)
