"""Perf-regression gate over the port driver's section record
(counterpart of the reference's ``benchmarks/perf_gate.py``).

``python -m repro_torch.benchmarks.run`` writes a perf record
(per-section wall-clock, bucketed per configuration) to
``build/repro_torch_bench.json``; the repository commits one measured on
the card as the baseline, ``src/repro_torch/benchmarks/baseline_h100.json``
(its ``meta`` names the card and its power limit).  This gate::

    python -m repro_torch.benchmarks.run --fast
    python -m repro_torch.benchmarks.perf_gate \\
        [--current build/repro_torch_bench.json]

compares every section's wall-clock in the fresh record against the
baseline under the same configuration bucket (default
``fast-refs20000-vectorized-cuda``) and exits non-zero when any section
regressed by more than ``--max-ratio`` (default 2.0).  Sections faster
than ``--min-seconds`` in the baseline are compared against that floor
instead; sections present on only one side are reported but never fail
the gate.  The baseline is scaled by the two records' NumPy calibration
times (``meta.calibration_seconds``), capped to [1/4, 4], so a host of
another speed is compared fairly.  The kernel-timing sections
(``kernels_stream``, ``kernels_attention``) time the card's kernels, not
the simulator, and are skipped by default (``--skip``).

Counter gates over a ``repro_torch.obs`` trace (``REPRO_TORCH_TRACE`` or
``--trace``)::

    python -m repro_torch.benchmarks.perf_gate --obs-trace t.jsonl \\
        --obs-require capture.model.concat==0 \\
        --obs-min-coverage suite.registry+suite.run=0.9

``--obs-require`` takes ``NAME OP NAME-or-NUMBER`` (``== != <= >= < >``;
a name is the merged counter value, 0 when missing; ``span:NAME`` is that
span's total seconds).  ``--obs-min-coverage A+B=F`` requires the named
spans' summed totals to cover at least fraction ``F`` of the trace's wall.
With ``--obs-trace`` given and no ``--current``, only the counters are
gated.
"""

from __future__ import annotations

import argparse
import json
import operator
import sys
from pathlib import Path

from .run import DEFAULT_BENCH_JSON

DEFAULT_BASELINE = str(Path(__file__).resolve().with_name(
    "baseline_h100.json"))
DEFAULT_CONFIG = "fast-refs20000-vectorized-cuda"
DEFAULT_SKIP = "kernels_stream,kernels_attention"


def _load_bucket(path: str, config: str) -> tuple[dict[str, float], float]:
    """(per-section seconds, meta calibration seconds or 0.0)."""
    with open(path) as f:
        record = json.load(f)
    bucket = record.get("runs", {}).get(config)
    if bucket is None:
        raise SystemExit(
            f"{path}: no '{config}' bucket under 'runs' "
            f"(have: {sorted(record.get('runs', {}))})")
    sections = {name: float(entry["seconds"])
                for name, entry in bucket.get("sections", {}).items()}
    cal = float(bucket.get("meta", {}).get("calibration_seconds", 0.0))
    return sections, cal


def speed_factor(base_cal: float, cur_cal: float) -> float:
    """Baseline scaling for host-speed difference, capped to [1/4, 4]
    (> 1: this host is slower than the recording one); 0 or absent
    calibration on either side disables it."""
    if base_cal <= 0.0 or cur_cal <= 0.0:
        return 1.0
    return min(4.0, max(0.25, cur_cal / base_cal))


def gate(baseline: dict[str, float], current: dict[str, float], *,
         max_ratio: float, min_seconds: float, factor: float = 1.0,
         out=None) -> list[str]:
    """Compare per-section wall-clock; return the failing section names."""
    out = out or sys.stdout
    failures: list[str] = []
    if factor != 1.0:
        print(f"machine-speed normalization: baseline x {factor:.2f}",
              file=out)
    print(f"{'section':18s} {'base_s':>8s} {'now_s':>8s} {'ratio':>7s}",
          file=out)
    for name in sorted(set(baseline) | set(current)):
        if name not in current:
            print(f"{name:18s} {baseline[name]:8.2f} {'-':>8s} {'-':>7s}  "
                  f"(absent from current run)", file=out)
            continue
        if name not in baseline:
            print(f"{name:18s} {'-':>8s} {current[name]:8.2f} {'-':>7s}  "
                  f"(no baseline; informational)", file=out)
            continue
        floor = max(baseline[name] * factor, min_seconds)
        ratio = current[name] / floor
        verdict = ""
        if current[name] > max_ratio * floor:
            failures.append(name)
            verdict = f"  REGRESSION (> {max_ratio:g}x)"
        print(f"{name:18s} {baseline[name]:8.2f} {current[name]:8.2f} "
              f"{ratio:7.2f}{verdict}", file=out)
    return failures


_OBS_OPS = {
    "==": operator.eq, "!=": operator.ne, "<=": operator.le,
    ">=": operator.ge, "<": operator.lt, ">": operator.gt,
}


def parse_require(expr: str) -> tuple[str, str, str]:
    """``"profile.scan==profile.geom"`` -> ``(lhs, op, rhs)``."""
    for op in ("==", "!=", "<=", ">=", "<", ">"):  # 2-char ops first
        if op in expr:
            lhs, rhs = expr.split(op, 1)
            lhs, rhs = lhs.strip(), rhs.strip()
            if lhs and rhs:
                return lhs, op, rhs
    raise SystemExit(
        f"bad --obs-require {expr!r}; expected NAME OP NAME-or-NUMBER "
        f"with OP in {sorted(_OBS_OPS)}")


def _resolve(rep, token: str) -> float:
    """Numeric literal, ``span:NAME`` total seconds, or counter value."""
    try:
        return float(token)
    except ValueError:
        pass
    if token.startswith("span:"):
        return rep.span_total(token[len("span:"):])
    return rep.counter(token, 0.0)


def obs_gate(rep, requires: list[str], coverages: list[str], *,
             out=None) -> list[str]:
    """Check counter invariants + span coverage over an
    :class:`~repro_torch.obs.report.ObsReport`; return the failed
    checks."""
    out = out or sys.stdout
    failures: list[str] = []
    for expr in requires:
        lhs, op, rhs = parse_require(expr)
        lv, rv = _resolve(rep, lhs), _resolve(rep, rhs)
        ok = _OBS_OPS[op](lv, rv)
        verdict = "ok" if ok else "VIOLATED"
        print(f"obs require  {expr:44s} [{lv:g} {op} {rv:g}]  {verdict}",
              file=out)
        if not ok:
            failures.append(expr)
    for spec in coverages:
        names, _, frac_text = spec.partition("=")
        try:
            frac = float(frac_text)
        except ValueError:
            raise SystemExit(
                f"bad --obs-min-coverage {spec!r}; expected "
                f"NAME[+NAME...]=FRACTION")
        total = sum(rep.span_total(n.strip())
                    for n in names.split("+") if n.strip())
        cov = total / rep.wall_s if rep.wall_s else 0.0
        ok = cov >= frac
        verdict = "ok" if ok else "VIOLATED"
        print(f"obs coverage {names:44s} [{total:.3f}s / "
              f"{rep.wall_s:.3f}s = {cov:.1%} >= {frac:.0%}]  {verdict}",
              file=out)
        if not ok:
            failures.append(spec)
    return failures


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.perf_gate",
        description="fail when a repro_torch.benchmarks.run section's "
                    "wall-clock regresses against the committed record "
                    "measured on the card")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="committed perf record (default "
                         "src/repro_torch/benchmarks/baseline_h100.json)")
    ap.add_argument("--current", default=None,
                    help="perf record of the run to gate (default "
                         f"{DEFAULT_BENCH_JSON.relative_to(DEFAULT_BENCH_JSON.parents[1])}"
                         " in the checkout, unless --obs-trace is gated "
                         "alone)")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help=f"runs bucket to compare (default {DEFAULT_CONFIG})")
    ap.add_argument("--max-ratio", type=float, default=2.0,
                    help="fail when current > max-ratio * baseline "
                         "(default 2.0)")
    ap.add_argument("--min-seconds", type=float, default=0.75,
                    help="baseline floor; faster baseline sections are "
                         "compared against this instead (default 0.75)")
    ap.add_argument("--skip", default=DEFAULT_SKIP, metavar="S[,S]",
                    help="comma list of sections to exclude (default: the "
                         "kernel-timing sections; '' gates every section)")
    ap.add_argument("--obs-trace", default=None, metavar="TRACE.jsonl",
                    action="append",
                    help="repro_torch.obs trace file(s) to merge and gate "
                         "counter invariants over (repeatable)")
    ap.add_argument("--obs-require", default=[], action="append",
                    metavar="EXPR",
                    help="counter invariant, e.g. capture.model.concat==0 "
                         "(repeatable; needs --obs-trace)")
    ap.add_argument("--obs-min-coverage", default=[], action="append",
                    metavar="NAME[+NAME..]=FRACTION",
                    help="require the named spans' summed total to cover "
                         "at least FRACTION of the trace wall-clock "
                         "(repeatable; needs --obs-trace)")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.obs_require or args.obs_min_coverage) and not args.obs_trace:
        ap.error("--obs-require/--obs-min-coverage need --obs-trace")
    current_path = args.current
    if current_path is None and not args.obs_trace:
        current_path = str(DEFAULT_BENCH_JSON)

    failures: list[str] = []
    current: dict[str, float] = {}
    if current_path is not None:
        skip = {s.strip() for s in args.skip.split(",") if s.strip()}
        base_sections, base_cal = _load_bucket(args.baseline, args.config)
        cur_sections, cur_cal = _load_bucket(current_path, args.config)
        baseline = {k: v for k, v in base_sections.items() if k not in skip}
        current = {k: v for k, v in cur_sections.items() if k not in skip}
        failures += gate(baseline, current, max_ratio=args.max_ratio,
                         min_seconds=args.min_seconds,
                         factor=speed_factor(base_cal, cur_cal))

    obs_failures: list[str] = []
    if args.obs_trace:
        from repro_torch.obs.report import aggregate

        rep = aggregate(args.obs_trace)
        obs_failures = obs_gate(rep, args.obs_require,
                                args.obs_min_coverage)
        failures += obs_failures

    if failures:
        wall = [f for f in failures if f not in obs_failures]
        parts = []
        if wall:
            parts.append(f"{', '.join(wall)} regressed beyond "
                         f"{args.max_ratio:g}x")
        if obs_failures:
            parts.append(f"counter invariant(s) violated: "
                         f"{'; '.join(obs_failures)}")
        print(f"perf gate FAILED: {'; '.join(parts)}", file=sys.stderr)
        return 1
    checked = []
    if current_path is not None:
        checked.append(f"{len(current)} section(s) within "
                       f"{args.max_ratio:g}x of baseline")
    if args.obs_trace:
        checked.append(f"{len(args.obs_require) + len(args.obs_min_coverage)}"
                       f" counter invariant(s) hold")
    print(f"perf gate OK: {'; '.join(checked)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
