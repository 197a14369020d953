"""Columnar result container for characterization queries (counterpart of
``repro.study.result``).

Every table query over a :class:`~repro_torch.study.Study` or a
:class:`~repro_torch.suite.SuiteRunner` returns a :class:`StudyResult` — a
named table with a fixed column tuple and one row per record.  The
container round-trips through CSV and JSON, so results can be exported,
diffed against the reference's, and re-imported losslessly.
"""

from __future__ import annotations

import csv
import io
import json
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, Mapping, Sequence

__all__ = ["StudyResult"]


@dataclass
class StudyResult:
    """A named, columnar table of per-function (or per-cell) records."""

    name: str
    columns: tuple[str, ...]
    rows: list[tuple] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.columns = tuple(str(c) for c in self.columns)
        self.rows = [tuple(r) for r in self.rows]
        for r in self.rows:
            if len(r) != len(self.columns):
                raise ValueError(
                    f"{self.name}: row width {len(r)} != "
                    f"{len(self.columns)} columns"
                )

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_records(
        cls,
        name: str,
        records: Sequence[Mapping[str, Any]],
        columns: Sequence[str] | None = None,
    ) -> "StudyResult":
        """Build from a list of dicts; columns default to the first record's
        key order."""
        if columns is None:
            columns = tuple(records[0].keys()) if records else ()
        rows = [tuple(rec.get(c) for c in columns) for rec in records]
        return cls(name=name, columns=tuple(columns), rows=rows)

    @classmethod
    def from_json(cls, text: str) -> "StudyResult":
        d = json.loads(text)
        return cls(
            name=d["name"],
            columns=tuple(d["columns"]),
            rows=[tuple(r) for r in d["rows"]],
        )

    def append(self, row: Iterable[Any]) -> None:
        row = tuple(row)
        if len(row) != len(self.columns):
            raise ValueError(
                f"{self.name}: row width {len(row)} != "
                f"{len(self.columns)} columns"
            )
        self.rows.append(row)

    # ---- access ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[tuple]:
        return iter(self.rows)

    def to_rows(self) -> list[tuple]:
        """The raw row tuples (no header)."""
        return list(self.rows)

    def records(self) -> list[dict[str, Any]]:
        """Row-major view: one dict per record."""
        return [dict(zip(self.columns, r)) for r in self.rows]

    def column(self, name: str) -> list[Any]:
        """Column-major view of one column."""
        i = self.columns.index(name)
        return [r[i] for r in self.rows]

    # ---- export ---------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "columns": list(self.columns),
            "rows": [list(r) for r in self.rows],
        }

    def to_json(self, *, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_csv(self) -> str:
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(self.columns)
        w.writerows(self.rows)
        return buf.getvalue()
