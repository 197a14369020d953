"""Suite runner: characterize the captured roster (counterpart of
``repro.suite.runner``).

:class:`SuiteRunner` builds the captured workloads on one device (their
traces come from kernel launches there), characterizes every entry with
the Step-2/Step-3 pipeline — locality on the 1-core trace, then the host
core sweep through one memoized :class:`~repro_torch.study.engine
.SimEngine` — and assigns the six-class verdict.  Rows have the
reference's roster columns, so the two rosters diff row by row.
"""

from __future__ import annotations

import csv
import io
from dataclasses import dataclass, field

import torch

from repro_torch.capture.kernels import (CAPTURED_KERNELS, CapturedKernel,
                                         captured_workloads)
from repro_torch.core import classify
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.device import resolve_device
from repro_torch.study.engine import SimEngine

__all__ = ["SuiteRunner", "Table", "ROSTER_COLUMNS", "CLASSES"]

ROSTER_COLUMNS = (
    "name", "domain", "source", "expected", "assigned", "match",
    "spatial", "temporal", "ai", "mpki", "lfmr_mean", "lfmr_slope",
)
CLASSES = classify.CLASSES
SOURCE = "captured"


@dataclass
class Table:
    """A named table with a fixed column tuple (the reference's
    ``StudyResult`` as far as the roster needs it)."""

    name: str
    columns: tuple[str, ...]
    rows: list[tuple] = field(default_factory=list)

    def records(self) -> list[dict]:
        return [dict(zip(self.columns, r)) for r in self.rows]

    def to_dict(self) -> dict:
        return {"name": self.name, "columns": list(self.columns),
                "rows": [list(r) for r in self.rows]}

    def to_csv(self) -> str:
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(self.columns)
        w.writerows(self.rows)
        return buf.getvalue()


class SuiteRunner:
    """The captured roster x one memoized engine, on one device."""

    def __init__(
        self,
        entries: tuple[CapturedKernel, ...] = CAPTURED_KERNELS,
        *,
        seed: int = 0,
        cores: tuple[int, ...] = CORE_SWEEP,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.entries = tuple(entries)
        self.seed = seed
        self.cores = tuple(cores)
        self.workloads = captured_workloads(self.entries, device=self.device)
        self.engine = SimEngine()
        self._rows: dict[str, tuple] | None = None

    def _row(self, entry: CapturedKernel, w) -> tuple:
        m = classify.measure(w, seed=self.seed, cores=self.cores,
                             engine=self.engine)
        assigned = classify.classify(m)
        return (
            entry.name, entry.domain, SOURCE, entry.expected_class,
            assigned, int(assigned == entry.expected_class),
            round(m.spatial, 3), round(m.temporal, 3), round(m.ai, 3),
            round(m.mpki, 2), round(m.lfmr_mean, 3), round(m.lfmr_slope, 3),
        )

    def roster(self) -> Table:
        """The Table-3-style roster: one row per entry."""
        if self._rows is None:
            self._rows = {e.name: self._row(e, w)
                          for e, w in zip(self.entries, self.workloads)}
        return Table("suite_roster", ROSTER_COLUMNS, list(self._rows.values()))

    def histogram(self) -> Table:
        """Per-class entry counts (Fig. 2-style census)."""
        counts = dict.fromkeys(CLASSES, 0)
        for rec in self.roster().records():
            counts[rec["assigned"]] = counts.get(rec["assigned"], 0) + 1
        return Table("class_histogram", ("class", SOURCE, "total"),
                     [(cls, n, n) for cls, n in sorted(counts.items())])

    def divergent(self) -> list[dict]:
        """Entries whose assigned class != expected class."""
        return [rec for rec in self.roster().records() if not rec["match"]]
