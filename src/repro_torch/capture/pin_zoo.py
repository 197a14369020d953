"""Measure the model zoo's pinned (AI, class) table (counterpart of the
reference's ``scripts/pin_zoo.py``).

Runs every selected zoo entry through this package's capture -> locality
-> core-sweep -> classify pipeline, computing AI from live captures (any
existing pin ignored), and prints the ``_PINS`` literal for
``repro_torch/capture/zoo.py`` followed by the measured class-transition
boundaries.  Per-entry lines (AI, class, the metrics behind it, seconds)
go to stderr.

Usage::

    python -m repro_torch.capture.pin_zoo [--only SUB[,SUB]] [--backend B]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace


def measure(only: tuple[str, ...] | None = None, *,
            backend: str | None = None, out=sys.stderr) -> dict:
    """name -> (ai, class, metrics) for the selected entries, AI and class
    measured (not read from the pins)."""
    from repro_torch.core import classify
    from repro_torch.study.study import Study

    from . import zoo

    specs = [replace(s, ai=None) for s in zoo.select(only)]
    workloads = zoo.model_workloads(tuple(specs))
    study = Study(suite=workloads, backend=backend)
    got = {}
    for spec, w in zip(specs, workloads):
        t0 = time.time()
        m = study.metrics(w)
        cls = classify.classify(m)
        got[spec.name] = (w.ai_ops_per_access, cls, m)
        print(f"{spec.name:48s} ai={w.ai_ops_per_access:8.3f} -> {cls} "
              f"(t={m.temporal:.3f} mpki={m.mpki:.1f} "
              f"lfmr={m.lfmr_mean:.3f} slope={m.lfmr_slope:.3f}) "
              f"[{time.time() - t0:.1f}s]", file=out, flush=True)
    return got


def transitions(classes: dict[str, str]) -> dict:
    """(config, mode, batch) -> the measured geometry-axis transitions."""
    from . import zoo

    axes: dict = {}
    for s in zoo.MODEL_ZOO:
        if s.name in classes:
            axes.setdefault((s.config, s.mode, s.batch), []).append(
                (s.geometry, classes[s.name]))
    return {k: tuple((g0, c0, g1, c1) for (g0, c0), (g1, c1)
                     in zip(sorted(v), sorted(v)[1:]) if c0 != c1)
            for k, v in axes.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.capture.pin_zoo")
    ap.add_argument("--only", default=None, metavar="SUB[,SUB]",
                    help="entries whose name contains any substring")
    ap.add_argument("--backend", default=None,
                    help="cache-simulation backend (default vectorized)")
    args = ap.parse_args(argv)
    only = tuple(args.only.split(",")) if args.only else None
    t0 = time.time()
    got = measure(only, backend=args.backend)
    print(f"# {len(got)} entries in {time.time() - t0:.0f}s", file=sys.stderr)
    print("_PINS: dict[str, tuple[float, str]] = {")
    for name, (ai, cls, _) in got.items():
        print(f'    "{name}": ({ai}, "{cls}"),')
    print("}")
    for key, trans in transitions({n: c for n, (_, c, _) in
                                   got.items()}).items():
        if trans:
            print(f"# boundary {key}: {trans}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
