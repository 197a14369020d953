"""``repro_torch.suite`` — the benchmark-suite registry and runner
(counterpart of ``repro.suite``).

Binds the seven synthetic DAMOV access-pattern families (expanded into
parameter grids) and the port's CUDA kernels (captured as HBM word streams
walked from their launches) into one roster, characterized by one
methodology, with a content-addressed on-disk result store and a
``python -m repro_torch.suite`` CLI emitting the Table-3-style roster.
"""

from .registry import (  # noqa: F401
    SUITE_SCHEMA,
    SuiteEntry,
    SuiteRegistry,
    default_registry,
    registry_for,
    serving_registry,
)
from .runner import (  # noqa: F401
    ROSTER_COLUMNS,
    SECTION_COLUMNS,
    SuiteRunner,
)
from .store import ResultStore, default_store_root  # noqa: F401

__all__ = [
    "SuiteEntry",
    "SuiteRegistry",
    "default_registry",
    "serving_registry",
    "registry_for",
    "SuiteRunner",
    "ResultStore",
    "default_store_root",
    "ROSTER_COLUMNS",
    "SECTION_COLUMNS",
    "SUITE_SCHEMA",
]
