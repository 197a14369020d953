"""``repro_torch.study`` — the DAMOV characterization API (counterpart of
``repro.study``).

- :class:`Study` — a suite of workloads bound to a shared engine; cached
  ``locality`` / ``metrics`` / ``classify`` / ``scalability`` queries and
  the canonical columnar tables;
- :class:`SimEngine` — the content-addressed, memoized simulation engine:
  each (workload, seed) x cores x hierarchy cell is simulated once per
  study and shared by every consumer;
- :class:`StudyResult` — the columnar result table (``to_rows`` /
  ``to_dict`` / ``to_csv`` / ``to_json``).

The reference's substrates (``TraceSubstrate``, ``HloSubstrate``) and its
``python -m repro.study`` CLI are not ported yet (ROADMAP.md queue 1).
"""

from .engine import CellKey, EngineStats, SimEngine  # noqa: F401
from .result import StudyResult  # noqa: F401
from .study import Study  # noqa: F401

__all__ = [
    "CellKey",
    "EngineStats",
    "SimEngine",
    "StudyResult",
    "Study",
]
