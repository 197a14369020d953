"""Timing smoke of the port's simulator: a cold cell stays fast
(counterpart of the reference's ``benchmarks/timing_smoke.py``).

Times one full-length host-config simulation cell per workload family —
at the pipeline's default trace length, ``tracegen.DEFAULT_REFS`` (250k
refs) — under each backend asked for (``vectorized`` by default; ``cuda``
runs the window scans on the card), and fails if any cell takes longer
than the budget (default 2.0 s, the reference's).  With ``--compare`` it
also times the reference loop and reports the speedup per family.

Each timed call passes a *fresh* address array, which defeats the
identity-keyed per-trace memo of ``cachesim_vec``: the gate times a cold
cell, not a memo recall.

Usage::

    python -m repro_torch.benchmarks.timing_smoke [--budget 2.0]
        [--backend vectorized[,cuda]] [--compare]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core import cachesim, tracegen

REFS = tracegen.DEFAULT_REFS


def _time(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def family_cells(refs: int = REFS) -> dict[str, tracegen.TraceSpec]:
    """One 1-core trace per workload family of the synthetic suite."""
    byfam: dict[str, tracegen.Workload] = {}
    for w in tracegen.make_suite(refs=refs):
        byfam.setdefault(w.family, w)
    return {fam: w.trace(1) for fam, w in sorted(byfam.items())}


def time_cells(backends: tuple[str, ...], *, compare: bool = False,
               refs: int = REFS) -> dict[str, dict[str, float]]:
    """family -> {backend: best seconds of a cold cell}, plus
    ``"reference"`` with ``compare``."""
    cfg = cachesim.host_config(1)
    out: dict[str, dict[str, float]] = {}
    for family, spec in family_cells(refs).items():
        row: dict[str, float] = {}
        for backend in backends:
            def cell(b=backend):
                # fresh array each call: a cold cell, not a memo recall
                cachesim.simulate(np.array(spec.addresses), cfg, backend=b,
                                  l3_factor=spec.l3_factor)
            cell()                                      # warm the code path
            row[backend] = _time(cell, repeats=3)
        if compare:
            row["reference"] = _time(
                lambda: cachesim.simulate(spec.addresses, cfg,
                                          backend="reference",
                                          l3_factor=spec.l3_factor),
                repeats=2)
        out[family] = row
    return out


def verdict(times: dict[str, dict[str, float]], backends: tuple[str, ...],
            *, budget: float, compare: bool, min_speedup: float = 0.0,
            min_best_speedup: float = 0.0, out=None, err=None) -> int:
    """Print the per-family lines and the gate's verdict (to stdout and
    stderr unless ``out``/``err`` are given); 0 when every cell is within
    the budget (and the speedup floors hold)."""
    out = out or sys.stdout
    err = err or sys.stderr
    failures = []
    totals = {b: 0.0 for b in backends}
    total_ref = 0.0
    best_speedup = 0.0
    base = backends[0]
    for family, row in times.items():
        line = f"{family:10s}"
        for b in backends:
            totals[b] += row[b]
            line += f" {b}={row[b] * 1e3:7.1f}ms"
            if row[b] > budget:
                failures.append((family, b, row[b]))
        if compare:
            total_ref += row["reference"]
            speedup = row["reference"] / row[base]
            best_speedup = max(best_speedup, speedup)
            line += (f"  ref={row['reference'] * 1e3:7.1f}ms  "
                     f"speedup={speedup:5.1f}x")
        print(line, file=out)
    for family, b, t in failures:
        print(f"FAIL: {family} {b} {REFS}-ref cell took {t:.2f}s "
              f"(> {budget:.2f}s budget)", file=err)
    if compare:
        aggregate = total_ref / totals[base]
        print(f"aggregate speedup over {len(times)} families: "
              f"{aggregate:.1f}x (best family: {best_speedup:.1f}x)",
              file=out)
        if min_speedup and aggregate < min_speedup:
            print(f"FAIL: aggregate speedup {aggregate:.1f}x < "
                  f"{min_speedup:.1f}x floor", file=err)
            return 1
        if min_best_speedup and best_speedup < min_best_speedup:
            print(f"FAIL: best-family speedup {best_speedup:.1f}x < "
                  f"{min_best_speedup:.1f}x floor", file=err)
            return 1
    if failures:
        return 1
    print(f"ok: all families within the {budget:.2f}s budget", file=out)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.timing_smoke")
    ap.add_argument("--budget", type=float, default=2.0,
                    help=f"max seconds per {REFS}-ref cell")
    ap.add_argument("--backend", default="vectorized", metavar="B[,B]",
                    help="backends to time (vectorized, cuda); the first "
                         "is the one --compare divides by")
    ap.add_argument("--compare", action="store_true",
                    help="also time the reference loop and print speedups")
    ap.add_argument("--min-speedup", type=float, default=0.0,
                    help="with --compare: fail if the aggregate "
                         "reference/first-backend time ratio drops below "
                         "this")
    ap.add_argument("--min-best-speedup", type=float, default=0.0,
                    help="with --compare: fail if no family reaches this "
                         "speedup")
    args = ap.parse_args(argv)
    backends = tuple(b.strip() for b in args.backend.split(",") if b.strip())
    bad = [b for b in backends if b not in cachesim.BACKENDS]
    if bad or not backends:
        ap.error(f"unknown backend(s) {bad}; expected some of "
                 f"{list(cachesim.BACKENDS)}")
    times = time_cells(backends, compare=args.compare)
    return verdict(times, backends, budget=args.budget, compare=args.compare,
                   min_speedup=args.min_speedup,
                   min_best_speedup=args.min_best_speedup)


if __name__ == "__main__":
    raise SystemExit(main())
