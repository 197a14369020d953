"""Shared Step-3 sweep constants (counterpart of ``repro.core.sweep``).

The paper's core sweep {1, 4, 16, 64, 256} (§2.4.2) drives the
classification metrics (LFMR-vs-cores slope).
"""

from __future__ import annotations

__all__ = ["CORE_SWEEP"]

CORE_SWEEP: tuple[int, ...] = (1, 4, 16, 64, 256)
