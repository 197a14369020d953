"""Energy model (DAMOV Table 1; counterpart of ``repro.core.energy``).

Per-access cache energies and per-bit DRAM energies, exactly the constants
the paper uses:

- L1: 15 / 33 pJ per hit / miss
- L2: 46 / 93 pJ per hit / miss
- L3: 945 / 1904 pJ per hit / miss
- DRAM: 2 pJ/bit internal, 8 pJ/bit logic layer, 2 pJ/bit SerDes links
  (host accesses pay internal + logic + links; NDP accesses pay internal +
  logic only — NDP cores sit in the logic layer)
- NUCA NoC (§3.4): 63 pJ per router traversal + 71 pJ per link traversal
"""

from __future__ import annotations

from dataclasses import dataclass

from .cachesim import SimResult

__all__ = ["EnergyBreakdown", "energy_for"]

_PJ = 1e-12
L1_HIT, L1_MISS = 15.0, 33.0
L2_HIT, L2_MISS = 46.0, 93.0
L3_HIT, L3_MISS = 945.0, 1904.0
DRAM_INTERNAL_PJ_BIT = 2.0
DRAM_LOGIC_PJ_BIT = 8.0
LINK_PJ_BIT = 2.0
NOC_ROUTER_PJ = 63.0
NOC_LINK_PJ = 71.0


@dataclass
class EnergyBreakdown:
    l1_j: float = 0.0
    l2_j: float = 0.0
    l3_j: float = 0.0
    dram_j: float = 0.0
    link_j: float = 0.0
    noc_j: float = 0.0

    @property
    def total_j(self) -> float:
        return self.l1_j + self.l2_j + self.l3_j + self.dram_j + self.link_j + self.noc_j

    def scaled(self, k: float) -> "EnergyBreakdown":
        return EnergyBreakdown(*(k * v for v in (
            self.l1_j, self.l2_j, self.l3_j, self.dram_j, self.link_j, self.noc_j)))


def energy_for(sim: SimResult, *, ndp: bool = False, nuca_hops: float = 0.0) -> EnergyBreakdown:
    """Energy of one thread's trace under a given hierarchy result.

    ``nuca_hops``: mean NoC hops per L3 access in the §3.4 NUCA config
    (0 disables the NoC term).
    """
    e = EnergyBreakdown()
    hits, misses = sim.level_hits, sim.level_misses
    e.l1_j = (hits[0] * L1_HIT + misses[0] * L1_MISS) * _PJ
    if len(hits) >= 2:
        e.l2_j = (hits[1] * L2_HIT + misses[1] * L2_MISS) * _PJ
    if len(hits) >= 3:
        e.l3_j = (hits[2] * L3_HIT + misses[2] * L3_MISS) * _PJ
        if nuca_hops > 0:
            l3_accesses = hits[2] + misses[2]
            e.noc_j = l3_accesses * nuca_hops * (NOC_ROUTER_PJ + NOC_LINK_PJ) * _PJ

    bits = sim.dram_bytes * 8
    if ndp:
        e.dram_j = bits * (DRAM_INTERNAL_PJ_BIT + DRAM_LOGIC_PJ_BIT) * _PJ
    else:
        e.dram_j = bits * (DRAM_INTERNAL_PJ_BIT + DRAM_LOGIC_PJ_BIT) * _PJ
        e.link_j = bits * LINK_PJ_BIT * _PJ
    return e
