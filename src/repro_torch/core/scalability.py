"""Step-3 scalability analysis (DAMOV §2.4.2; counterpart of
``repro.core.scalability``).

Analytical core/memory timing model layered on the functional cache
simulator.  For each workload we sweep {1, 4, 16, 64, 256} cores across the
three system configurations (Host CPU / Host CPU + prefetcher / NDP) and two
core models (out-of-order / in-order), producing performance and energy
curves plus the three classification metrics (AI, LLC MPKI, LFMR).

Timing model (per thread, in 2.4 GHz core cycles):

    T = N_instr / issue_rate  +  sum_level( accesses_level * latency_level ) / MLP_eff

- ``issue_rate``: 4-wide OoO retires ~3 IPC on cache-resident code; the
  4-wide in-order pipeline is modeled at 2 IPC.
- ``latency_level``: cumulative lookup latencies from Table 1 (L1 4, L2 11,
  L3 38 cycles); DRAM adds t_CAS-class core latency plus, for the host, the
  off-chip SerDes link hop.  NDP L1 misses go straight to the vault.
- ``MLP_eff``: min(workload MLP, window MLP) — OoO can overlap up to 10
  outstanding misses (128-entry ROB / 20 MSHRs), in-order up to 2 (paper
  §3.5.2: in-order cores have little latency tolerance).
- Bandwidth: aggregate demand above the peak (115 GB/s off-chip for host,
  431 GB/s internal for NDP — the paper's measured STREAM-Copy envelopes)
  stretches execution; an M/D/1 queueing term inflates DRAM latency as
  utilization rises (the paper's §3.3.4 memory-controller queueing).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import cachesim, energy
from .cachesim import SimResult
from .sweep import CORE_SWEEP
from .tracegen import TraceSpec, Workload

__all__ = [
    "CORE_SWEEP",  # re-exported from repro_torch.core.sweep
    "SystemPoint",
    "ScalabilityResult",
    "analyze",
    "evaluate_point",
    "sweep_configs",
    "HOST_PEAK_GBS",
    "NDP_PEAK_GBS",
]

CLOCK_HZ = 2.4e9

# Peak DRAM bandwidth envelopes (paper §1: STREAM Copy measured 115 GB/s
# host vs 431 GB/s NDP on one HMC, a 3.7x gap).
HOST_PEAK_GBS = 115.0
NDP_PEAK_GBS = 431.0

# Cumulative hit latencies (cycles), Table 1.
LAT_L1 = 4.0
LAT_L2 = 4.0 + 7.0
LAT_L3 = 4.0 + 7.0 + 27.0
LAT_LINK = 16.0          # off-chip SerDes hop (host only)
LAT_DRAM_CORE = 110.0    # DRAM core access (row activate + CAS class)
LAT_DRAM_ROWMISS = 45.0  # extra for row-buffer-hostile (irregular) streams

OOO_IPC = 3.0
INORDER_IPC = 2.0
OOO_MLP_CAP = 10.0
INORDER_MLP_CAP = 2.0


@dataclass
class SystemPoint:
    """One (config, cores) evaluation."""

    config: str
    cores: int
    sim: SimResult
    thread_cycles: float
    perf: float            # aggregate throughput (refs/sec, all cores)
    dram_gbs: float        # aggregate DRAM bandwidth demand actually served
    amat_cycles: float
    energy: energy.EnergyBreakdown

    @property
    def lfmr(self) -> float:
        return self.sim.lfmr

    @property
    def mpki(self) -> float:
        return self.sim.mpki


@dataclass
class ScalabilityResult:
    workload: str
    expected_class: str
    core_model: str
    points: dict[str, list[SystemPoint]] = field(default_factory=dict)

    def perf_normalized(self, config: str) -> list[float]:
        """Performance normalized to 1-core host (paper Fig. 5 axes)."""
        base = self.points["host"][0].perf
        return [p.perf / base for p in self.points[config]]

    def speedup_ndp_vs_host(self) -> list[float]:
        return [
            n.perf / h.perf
            for n, h in zip(self.points["ndp"], self.points["host"])
        ]


def _amat_and_stalls(
    sim: SimResult,
    spec: TraceSpec,
    *,
    ndp: bool,
    mlp_cap: float,
    queue_inflation: float,
) -> tuple[float, float]:
    """Return (AMAT cycles, total memory stall cycles) for one thread."""
    hits = sim.level_hits
    misses = sim.level_misses
    t_dram = LAT_DRAM_CORE + (LAT_DRAM_ROWMISS if spec.dram_rows_irregular else 0.0)
    t_dram *= queue_inflation

    if ndp:
        # L1 -> vault DRAM
        lat = [LAT_L1, LAT_L1 + t_dram]
        counts = [hits[0], misses[0]]
    else:
        lat = [LAT_L1, LAT_L2, LAT_L3, LAT_L3 + LAT_LINK + t_dram]
        counts = [hits[0], hits[1], hits[2], misses[2]]

    total_accesses = max(1, sim.accesses)
    amat = sum(l * c for l, c in zip(lat, counts)) / total_accesses
    # Stall time: everything beyond the L1 hit latency, overlapped by MLP.
    mlp = max(1.0, min(spec.mlp, mlp_cap))
    stall = sum((l - LAT_L1) * c for l, c in zip(lat, counts)) / mlp
    return amat, stall


def evaluate_point(
    sim: SimResult,
    spec: TraceSpec,
    cores: int,
    *,
    ndp: bool,
    ipc: float,
    mlp_cap: float,
    nuca_hops: float = 0.0,
) -> SystemPoint:
    """Timing/energy model over one already-simulated cell.

    Public so consumers that batch their own cells (e.g. the §5.3
    iso-area core-model study) can evaluate exactly the cells they need
    instead of round-tripping through a full :func:`analyze` sweep.
    """
    peak_gbs = NDP_PEAK_GBS if ndp else HOST_PEAK_GBS
    peak_bytes_per_cycle = peak_gbs * 1e9 / CLOCK_HZ

    # Single-pass bandwidth model (no fixed-point oscillation):
    # 1. base execution time with unloaded DRAM latency;
    # 2. utilization at that rate sets the M/D/1 queueing inflation (capped:
    #    once the system saturates, the explicit bandwidth bound — not the
    #    queue term — governs throughput);
    # 3. final time = max(latency-limited, bandwidth-limited).
    compute = sim.instructions / ipc
    _, stall0 = _amat_and_stalls(
        sim, spec, ndp=ndp, mlp_cap=mlp_cap, queue_inflation=1.0
    )
    base_cycles = compute + stall0
    bytes_per_thread = sim.dram_bytes
    bw_cycles = bytes_per_thread * cores / peak_bytes_per_cycle

    util = min(bytes_per_thread * cores / max(base_cycles, 1.0)
               / peak_bytes_per_cycle, 0.95)
    # Cap calibrated so Class-1a hosts saturate DRAM bandwidth at 64 cores
    # (paper Fig. 6) rather than staying latency-limited.
    queue_inflation = min(1.0 + util / (2.0 * (1.0 - util)), 2.0)

    amat, stall = _amat_and_stalls(
        sim, spec, ndp=ndp, mlp_cap=mlp_cap, queue_inflation=queue_inflation
    )
    thread_cycles = max(compute + stall, bw_cycles)
    perf = cores * sim.accesses / (thread_cycles / CLOCK_HZ)
    served_gbs = min(
        sim.dram_bytes * cores / (thread_cycles / CLOCK_HZ) / 1e9, peak_gbs
    )
    ebd = energy.energy_for(sim, ndp=ndp, nuca_hops=nuca_hops).scaled(cores)
    return SystemPoint(
        config=sim.name,
        cores=cores,
        sim=sim,
        thread_cycles=thread_cycles,
        perf=perf,
        dram_gbs=served_gbs,
        amat_cycles=amat,
        energy=ebd,
    )


def sweep_configs(*, nuca: bool = False) -> dict[str, object]:
    """Factories for the three paper configs, keyed by name."""

    def host(cores):
        return cachesim.host_config(cores, nuca_mb_per_core=2.0 if nuca else None)

    def host_pf(cores):
        return cachesim.host_config(
            cores, prefetcher=True, nuca_mb_per_core=2.0 if nuca else None
        )

    def ndp(cores):
        return cachesim.ndp_config(cores)

    return {"host": host, "host+pf": host_pf, "ndp": ndp}


def analyze(
    workload: Workload,
    *,
    core_model: str = "ooo",
    cores: tuple[int, ...] = CORE_SWEEP,
    nuca: bool = False,
    seed: int = 0,
    engine=None,
) -> ScalabilityResult:
    """Full Step-3 sweep for one workload.

    ``engine``: a :class:`repro_torch.study.SimEngine`; the underlying
    simulation cells are core-model independent, so a shared engine serves
    the ``ooo`` and ``inorder`` analyses (and ``classify.measure``) from one
    pass.
    """
    cores = tuple(cores)
    if engine is None:
        from repro_torch.study.engine import SimEngine  # core stays a leaf
        engine = SimEngine()
    ipc = OOO_IPC if core_model == "ooo" else INORDER_IPC
    mlp_cap = OOO_MLP_CAP if core_model == "ooo" else INORDER_MLP_CAP

    result = ScalabilityResult(
        workload=workload.name,
        expected_class=workload.expected_class,
        core_model=core_model,
    )
    factories = sweep_configs(nuca=nuca)
    # One batch for the whole (config x cores) grid: the engine groups the
    # missing cells by trace, so each core count's host / host+pf / NDP
    # variants share a single replay of their common level prefixes.
    cells = [
        (c, factory(c)) for factory in factories.values() for c in cores
    ]
    sims = engine.simulate_batch(workload, cells, seed=seed)
    for k, (cfg_name, _) in enumerate(factories.items()):
        is_ndp = cfg_name == "ndp"
        pts: list[SystemPoint] = []
        for c, sim in zip(cores, sims[k * len(cores):(k + 1) * len(cores)]):
            spec = engine.trace(workload, c, seed=seed)
            nuca_hops = (np.sqrt(c) * 1.5) if (nuca and not is_ndp) else 0.0
            pts.append(
                evaluate_point(
                    sim, spec, c,
                    ndp=is_ndp, ipc=ipc, mlp_cap=mlp_cap, nuca_hops=nuca_hops,
                )
            )
        result.points[cfg_name] = pts
    return result
