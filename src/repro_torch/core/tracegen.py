"""Workload records (counterpart of ``repro.core.tracegen``).

A :class:`Workload` is a parameterized generator of per-thread word-address
traces: it receives the core count (strong scaling) and a seeded numpy
generator and returns a :class:`TraceSpec` carrying the trace plus the
contention metadata the Step-3 analysis needs.  In this slice every
workload is a captured kernel (:mod:`repro_torch.capture.kernels`); the
synthetic families of the reference are not ported yet.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

__all__ = ["TraceSpec", "Workload", "DEFAULT_REFS", "stable_name_seed"]

# Default synthetic trace length of the reference suite.
DEFAULT_REFS = 250_000


def stable_name_seed(name: str) -> int:
    """Deterministic per-workload RNG offset.

    Built on ``zlib.crc32`` rather than builtin ``hash()``, which is salted
    per interpreter run (PYTHONHASHSEED).
    """
    return zlib.crc32(name.encode("utf-8")) % 7919


@dataclass
class TraceSpec:
    """Per-thread trace + metadata for one (workload, cores) point."""

    addresses: np.ndarray      # word addresses
    l3_factor: float           # effective shared-LLC fraction for this thread
    mlp: float                 # intrinsic memory-level parallelism
    dram_rows_irregular: bool  # row-buffer locality hint for the timing model


@dataclass(frozen=True)
class Workload:
    name: str
    family: str
    expected_class: str
    ai_ops_per_access: float   # AI numerator (workload ALU/FP ops per ref)
    instr_per_access: float    # total dynamic instructions per ref (MPKI denom)
    gen: Callable[[int, np.random.Generator], TraceSpec]
    # True when gen ignores `cores` entirely (trace AND metadata, incl.
    # l3_factor): the engine then shares one trace across the core sweep.
    core_invariant: bool = False

    def trace(self, cores: int, seed: int = 0) -> TraceSpec:
        return self.gen(
            cores, np.random.default_rng(seed + stable_name_seed(self.name))
        )
