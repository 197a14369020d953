"""Shared CLI helpers of the port's entry points (counterpart of
``repro.study.cliutil``)."""

from __future__ import annotations

import argparse

__all__ = ["parse_cores"]


def parse_cores(text: str) -> tuple[int, ...]:
    """argparse type for ``--cores 1,4,16``."""
    cores = tuple(int(x) for x in text.split(",") if x)
    if not cores:
        raise argparse.ArgumentTypeError("need at least one core count")
    return cores
