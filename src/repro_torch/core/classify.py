"""Six-class memory-bottleneck classifier (DAMOV §3.3, §3.5; counterpart of
``repro.core.classify``).

1. The fixed-threshold decision procedure with the paper's published
   phase-1 thresholds (temporal locality 0.48, LFMR 0.56, LLC MPKI 11.0,
   AI 8.5) plus the LFMR-vs-core-count slope;
2. the two-phase validation protocol: derive thresholds from a labeled
   training set (midpoint between low-class and high-class means), then
   score a held-out set.

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
    "derive_thresholds",
    "validate",
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

    @property
    def lfmr_low(self) -> float:
        """LFMR at low core counts (class definitions reference it)."""
        return float(np.mean(self.lfmr_by_cores[:2]))


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


# --------------------------------------------------------------------------
# §3.5 two-phase validation.
# --------------------------------------------------------------------------
_LOW_T = {"1a", "1b", "1c"}
_HIGH_MPKI = {"1a"}
_HIGH_AI = {"2c"}
_HIGH_LFMR = {"1a", "1b"}


def derive_thresholds(train: list[FunctionMetrics]) -> Thresholds:
    """Phase 1: midpoint between low-group and high-group means per metric.

    Bounded metrics (temporal locality, LFMR in [0, 1]) use the arithmetic
    midpoint; ratio-scale metrics (MPKI, AI) use the geometric midpoint so
    one extreme workload cannot drag the threshold past its group."""

    def midpoint(vals_low: list[float], vals_high: list[float],
                 default: float, *, geometric: bool = False) -> float:
        if not vals_low or not vals_high:
            return default
        lo, hi = float(np.mean(vals_low)), float(np.mean(vals_high))
        if geometric and lo > 0 and hi > 0:
            return float(np.sqrt(lo * hi))
        return 0.5 * (lo + hi)

    def by(pred, attr: str) -> list[float]:
        return [getattr(m, attr) for m in train
                if m.expected_class and pred(m.expected_class)]

    return Thresholds(
        temporal=midpoint(by(lambda c: c in _LOW_T, "temporal"),
                          by(lambda c: c not in _LOW_T, "temporal"), 0.48),
        mpki=midpoint(by(lambda c: c not in _HIGH_MPKI, "mpki"),
                      by(lambda c: c in _HIGH_MPKI, "mpki"), 11.0,
                      geometric=True),
        ai=midpoint(by(lambda c: c not in _HIGH_AI, "ai"),
                    by(lambda c: c in _HIGH_AI, "ai"), 8.5,
                    geometric=True),
        lfmr=midpoint(by(lambda c: c not in _HIGH_LFMR, "lfmr_low"),
                      by(lambda c: c in _HIGH_LFMR, "lfmr_low"), 0.56),
    )


def validate(held_out: list[FunctionMetrics],
             thresholds: Thresholds) -> tuple[float, list[tuple[str, str, str]]]:
    """Phase 2: accuracy + (name, expected, predicted) table."""
    rows = []
    correct = 0
    for m in held_out:
        pred = classify(m, thresholds)
        correct += pred == m.expected_class
        rows.append((m.name, m.expected_class or "?", pred))
    acc = correct / len(held_out) if held_out else 0.0
    return acc, rows
