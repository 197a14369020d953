"""DAMOV §5 case studies, reimplemented on the simulator substrate
(counterpart of ``repro.core.casestudies``).

Case study 1 (§5.1): load balance / inter-vault NoC traffic for NDP cores on
a 6x6 2D-mesh over 32 HMC vaults with the default Row:Column:Bank:Vault
interleaving (consecutive lines round-robin across vaults).

Case study 2 (§5.2): NDP accelerator vs compute-centric accelerator — an
Aladdin-style dataflow model where the accelerator's critical path is
max(compute, memory), and only the memory system differs.

Case study 3 (§5.3): iso-area/iso-power NDP core models — 6 OoO cores vs
128 in-order cores in the logic-layer budget (4.4 mm^2 / 312 mW per vault).

Case study 4 (§5.4): fine-grained (hottest-basic-block) offloading — a
Zipf-distributed basic-block miss profile where offloading the hottest block
captures a fraction of the function's DRAM stalls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import scalability
from .cachesim import WORDS_PER_LINE, ndp_config
from .tracegen import Workload


def _engine_or_new(engine):
    if engine is None:
        # lazy: core stays a leaf
        from repro_torch.study.engine import SimEngine
        engine = SimEngine()
    return engine

__all__ = [
    "noc_study",
    "accelerator_study",
    "core_model_study",
    "finegrained_offload_study",
]

N_VAULTS = 32
MESH_DIM = 6  # 6x6 NoC (paper §5.1)


# --------------------------------------------------------------------------
# Case study 1: inter-vault communication.
# --------------------------------------------------------------------------
def _vault_of_line(line: np.ndarray) -> np.ndarray:
    # HMC default interleaving: consecutive 256 B blocks across vaults.
    return (line // 4) % N_VAULTS


def _hops(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    sx, sy = src % MESH_DIM, src // MESH_DIM
    dx, dy = dst % MESH_DIM, dst // MESH_DIM
    return np.abs(sx - dx) + np.abs(sy - dy)


@dataclass
class NocResult:
    workload: str
    hop_histogram: dict[int, float]   # hops -> fraction of requests
    mean_hops: float
    local_fraction: float
    overhead_pct: float               # slowdown vs zero-latency NoC


def noc_study(workload: Workload, *, cores: int = 32, seed: int = 0,
              cycles_per_hop: float = 3.0, engine=None) -> NocResult:
    engine = _engine_or_new(engine)
    spec = engine.trace(workload, cores, seed=seed)
    sim = engine.simulate(workload, cores, ndp_config(cores), seed=seed)
    lines = np.asarray(spec.addresses, dtype=np.int64) // WORDS_PER_LINE
    # The NDP core is statically mapped to one vault; every L1 miss targets
    # the vault that owns its line.
    rng = np.random.default_rng(seed)
    core_vault = int(rng.integers(0, N_VAULTS))
    dest = _vault_of_line(lines)
    hops = _hops(np.full_like(dest, core_vault), dest)

    hist_vals, hist_counts = np.unique(hops, return_counts=True)
    frac = hist_counts / hops.size
    mean_hops = float(hops.mean())
    local = float(frac[hist_vals == 0].sum()) if (hist_vals == 0).any() else 0.0

    # Overhead: extra NoC cycles on the memory path vs an ideal NoC.
    miss_rate = sim.l1_misses / max(1, sim.accesses)
    base = scalability.LAT_DRAM_CORE
    extra = mean_hops * cycles_per_hop * 2.0  # request + response
    overhead = miss_rate * extra / (workload.instr_per_access / 3.0
                                    + miss_rate * base) * 100.0
    return NocResult(
        workload=workload.name,
        hop_histogram={int(v): float(f) for v, f in zip(hist_vals, frac)},
        mean_hops=mean_hops,
        local_fraction=local,
        overhead_pct=float(overhead),
    )


# --------------------------------------------------------------------------
# Case study 2: NDP accelerators.
# --------------------------------------------------------------------------
def accelerator_study(workload: Workload, *, seed: int = 0,
                      engine=None) -> float:
    """Speedup of an NDP-placed accelerator over the compute-centric one.

    Aladdin-style bound model: the accelerator datapath is identical; only
    the memory interface differs (internal vs off-chip bandwidth and
    latency).  Returns NDP-accel / CC-accel speedup.
    """
    engine = _engine_or_new(engine)
    spec = engine.trace(workload, 1, seed=seed)
    sim = engine.simulate(workload, 1, ndp_config(1), seed=seed)
    flops = workload.ai_ops_per_access * sim.accesses
    accel_flops_per_cycle = 16.0
    t_compute = flops / accel_flops_per_cycle

    bytes_dram = sim.dram_bytes
    bpc_cc = scalability.HOST_PEAK_GBS * 1e9 / scalability.CLOCK_HZ
    bpc_ndp = scalability.NDP_PEAK_GBS * 1e9 / scalability.CLOCK_HZ
    lat_cc = scalability.LAT_LINK + scalability.LAT_DRAM_CORE
    lat_ndp = scalability.LAT_DRAM_CORE
    # Accelerator datapaths pipeline regular access streams arbitrarily
    # deep (SIMD/streaming, §3.3.1); dependent/irregular patterns keep the
    # workload's intrinsic MLP.
    mlp = max(1.0, spec.mlp) if spec.dram_rows_irregular else 128.0

    t_cc = max(t_compute, bytes_dram / bpc_cc, sim.llc_misses * lat_cc / mlp)
    t_ndp = max(t_compute, bytes_dram / bpc_ndp, sim.llc_misses * lat_ndp / mlp)
    return float(t_cc / t_ndp)


# --------------------------------------------------------------------------
# Case study 3: iso-area/iso-power core models.
# --------------------------------------------------------------------------
def core_model_study(workload: Workload, *, seed: int = 0,
                     engine=None) -> dict[str, float]:
    """Speedups of NDP+in-order (128 cores) and NDP+OoO (6 cores) over a
    4-core OoO host (the paper's iso-area/power budgets).

    Exactly the three needed cells run as one engine batch (the old
    per-point ``analyze`` round-trips simulated nine); the timing model is
    applied per point via :func:`scalability.evaluate_point`.
    """
    engine = _engine_or_new(engine)
    from .cachesim import host_config

    cells = [(4, host_config(4)), (6, ndp_config(6)), (128, ndp_config(128))]
    sims = engine.simulate_batch(workload, cells, seed=seed)

    def perf(i: int, *, ndp: bool, core_model: str) -> float:
        cores = cells[i][0]
        spec = engine.trace(workload, cores, seed=seed)
        ipc = (scalability.OOO_IPC if core_model == "ooo"
               else scalability.INORDER_IPC)
        mlp_cap = (scalability.OOO_MLP_CAP if core_model == "ooo"
                   else scalability.INORDER_MLP_CAP)
        return scalability.evaluate_point(
            sims[i], spec, cores, ndp=ndp, ipc=ipc, mlp_cap=mlp_cap).perf

    host = perf(0, ndp=False, core_model="ooo")
    ndp_ooo = perf(1, ndp=True, core_model="ooo")
    ndp_io = perf(2, ndp=True, core_model="inorder")
    return {
        "ndp_inorder_128": float(ndp_io / host),
        "ndp_ooo_6": float(ndp_ooo / host),
    }


# --------------------------------------------------------------------------
# Case study 4: fine-grained offloading.
# --------------------------------------------------------------------------
def finegrained_offload_study(
    workload: Workload, *, n_blocks: int = 100, zipf_s: float = 1.6,
    seed: int = 0, engine=None,
) -> dict[str, float]:
    """Speedup of offloading (a) the hottest basic block vs (b) the whole
    function, over host execution.

    LLC misses concentrate in few static blocks (paper cites 1-10% of
    blocks causing up to 95% of misses); we model the block-miss profile as
    Zipf(s) and apply NDP's latency/bandwidth advantage only to the stalls
    attributable to the offloaded block(s).
    """
    ranks = np.arange(1, n_blocks + 1, dtype=np.float64)
    weights = ranks ** (-zipf_s)
    weights /= weights.sum()
    hottest_share = float(weights[0])

    r = scalability.analyze(workload, cores=(4,), seed=seed,
                            engine=_engine_or_new(engine))
    t_host = 1.0 / r.points["host"][0].perf
    t_ndp = 1.0 / r.points["ndp"][0].perf
    full_speedup = t_host / t_ndp

    # Memory-stall share of host time that the hottest block owns.
    sim = r.points["host"][0].sim
    stall_share = min(0.9, sim.llc_misses * (scalability.LAT_LINK +
                      scalability.LAT_DRAM_CORE) /
                      (r.points["host"][0].thread_cycles))
    saved = stall_share * hottest_share * (1.0 - t_ndp / t_host)
    bb_speedup = 1.0 / (1.0 - saved)
    return {
        "hottest_block_miss_share": hottest_share,
        "speedup_hottest_block": float(bb_speedup),
        "speedup_full_function": float(full_speedup),
    }
