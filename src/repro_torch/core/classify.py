"""Six-class memory-bottleneck classifier (DAMOV §3.3; counterpart of
``repro.core.classify``).

The fixed-threshold decision procedure with the paper's published phase-1
thresholds (temporal locality 0.48, LFMR 0.56, LLC MPKI 11.0, AI 8.5) plus
the LFMR-vs-core-count slope.

Metric conventions:
- temporal locality: architecture-independent Eq. 2 on the 1-core trace;
- AI: workload property (ops per L1 line access);
- MPKI: LLC MPKI on the 4-core host baseline (the paper's Step-1 machine);
- LFMR: host values across the core sweep; the slope label is
  ``decreasing`` / ``increasing`` / ``flat`` over 1 -> 256 cores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import cachesim, locality
from .sweep import CORE_SWEEP
from .tracegen import Workload

__all__ = [
    "PAPER_THRESHOLDS",
    "Thresholds",
    "FunctionMetrics",
    "measure",
    "classify",
    "CLASSES",
    "MITIGATIONS",
]

CLASSES = ("1a", "1b", "1c", "2a", "2b", "2c")

# class -> the data-movement mitigation the paper's §5 case studies match
# to it: 1a/1c are DRAM-bandwidth / LLC-pressure bound and want NDP; 1b is
# latency-bound and wants prefetch+NUCA; 2a thrashes the shared LLC as
# cores scale (NUCA); 2b/2c need no data-movement mitigation.
MITIGATIONS = {
    "1a": "ndp",
    "1b": "prefetch+nuca",
    "1c": "ndp",
    "2a": "nuca",
    "2b": "none",
    "2c": "none",
}


@dataclass(frozen=True)
class Thresholds:
    temporal: float = 0.48
    lfmr: float = 0.56
    mpki: float = 11.0
    ai: float = 8.5
    slope: float = 0.25  # |ΔLFMR| over the sweep below this counts as flat


PAPER_THRESHOLDS = Thresholds()


@dataclass
class FunctionMetrics:
    name: str
    temporal: float
    spatial: float
    ai: float
    mpki: float                  # 4-core host baseline
    lfmr_by_cores: tuple[float, ...]
    expected_class: str | None = None

    @property
    def lfmr_mean(self) -> float:
        return float(np.mean(self.lfmr_by_cores))

    @property
    def lfmr_slope(self) -> float:
        """Signed end-to-end LFMR change across the core sweep."""
        return self.lfmr_by_cores[-1] - self.lfmr_by_cores[0]


def measure(workload: Workload, *, seed: int = 0,
            cores: tuple[int, ...] = CORE_SWEEP,
            engine=None) -> FunctionMetrics:
    """Steps 2+3 metric collection for one workload (host config).

    ``engine``: a :class:`repro_torch.study.engine.SimEngine` whose
    memoized traces and cells are shared with other consumers; a private
    one is used when omitted.
    """
    if engine is None:
        from repro_torch.study.engine import SimEngine  # core stays a leaf
        engine = SimEngine()
    spec1 = engine.trace(workload, 1, seed=seed)
    temporal = locality.temporal_locality(spec1.addresses)
    spatial = locality.spatial_locality(spec1.addresses)

    sims = engine.simulate_batch(
        workload, [(c, cachesim.host_config(c)) for c in cores], seed=seed)
    lfmrs = [s.lfmr for s in sims]
    # MPKI baseline is the 4-core host; for a custom sweep without 4, take
    # the closest core count.
    baseline = min(range(len(sims)), key=lambda i: abs(cores[i] - 4))
    return FunctionMetrics(
        name=workload.name,
        temporal=temporal,
        spatial=spatial,
        ai=workload.ai_ops_per_access,
        mpki=sims[baseline].mpki,
        lfmr_by_cores=tuple(lfmrs),
        expected_class=workload.expected_class,
    )


def classify(m: FunctionMetrics, t: Thresholds = PAPER_THRESHOLDS) -> str:
    """The §3.3 decision procedure."""
    decreasing = m.lfmr_slope < -t.slope
    increasing = m.lfmr_slope > t.slope

    if m.temporal < t.temporal:
        # Low temporal locality: Classes 1a / 1b / 1c.
        if decreasing:
            return "1c"
        if m.mpki >= t.mpki:
            return "1a"
        return "1b"
    # High temporal locality: Classes 2a / 2b / 2c.
    if increasing:
        return "2a"
    if m.ai >= t.ai:
        return "2c"
    return "2b"
