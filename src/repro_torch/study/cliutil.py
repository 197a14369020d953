"""Shared CLI helpers of the port's entry points (counterpart of
``repro.study.cliutil``): core-sweep parsing and table emission."""

from __future__ import annotations

import argparse
import json
import sys

from .result import StudyResult

__all__ = ["parse_cores", "emit_tables"]


def parse_cores(text: str) -> tuple[int, ...]:
    """argparse type for ``--cores 1,4,16``."""
    cores = tuple(int(x) for x in text.split(",") if x)
    if not cores:
        raise argparse.ArgumentTypeError("need at least one core count")
    return cores


def emit_tables(tables: list[StudyResult], *, fmt: str,
                out: str | None) -> None:
    """Write tables as CSV sections or a JSON array, to ``out`` or stdout."""
    if fmt == "json":
        text = json.dumps([t.to_dict() for t in tables], indent=2)
    else:
        text = "\n".join(f"## {t.name}\n{t.to_csv()}" for t in tables)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")
