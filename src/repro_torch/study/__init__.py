"""``repro_torch.study`` — the DAMOV characterization API (counterpart of
``repro.study``).

- :class:`Study` — a suite of workloads bound to a shared engine; cached
  ``locality`` / ``metrics`` / ``classify`` / ``scalability`` queries and
  the canonical columnar tables;
- :class:`SimEngine` — the content-addressed, memoized simulation engine:
  each (workload, seed) x cores x hierarchy cell is simulated once per
  study and shared by every consumer;
- :class:`StudyResult` — the columnar result table (``to_rows`` /
  ``to_dict`` / ``to_csv`` / ``to_json``);
- :class:`Substrate` protocol with two backends: :class:`TraceSubstrate`
  (trace-driven cache simulation) and :class:`SuiteSubstrate` (the
  registered roster, its captured entries launched on the card) —
  ``--substrate trace|suite`` on the CLI.  The reference's ``hlo``
  substrate waits for the cost substrate (ROADMAP.md's "the cost substrate").

CLI::

    python -m repro_torch.study --substrate trace --refs 20000 \
        --sections metrics,classify --format csv
"""

from .engine import CellKey, EngineStats, SimEngine  # noqa: F401
from .result import StudyResult  # noqa: F401
from .study import Study  # noqa: F401
from .substrate import (  # noqa: F401
    Substrate,
    SuiteSubstrate,
    TraceSubstrate,
    get_substrate,
)

__all__ = [
    "CellKey",
    "EngineStats",
    "SimEngine",
    "StudyResult",
    "Study",
    "Substrate",
    "TraceSubstrate",
    "SuiteSubstrate",
    "get_substrate",
]
