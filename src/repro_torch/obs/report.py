"""Trace-file readers: aggregation + Chrome trace-event export
(counterpart of ``repro.obs.report``).

A ``repro_torch.obs`` trace is JSONL — one event object per line, appended by
every participating process (see the package docstring for the schema).
This module turns one or more such files into

- an :class:`ObsReport`: per-span-name wall-clock statistics, merged
  counters, and the end-to-end wall of the trace (used by
  ``python -m repro_torch.obs report`` and ``chip_smoke.py``'s span
  split);
- a Chrome trace-event JSON object (``ph: "X"`` complete events),
  loadable in Perfetto / ``chrome://tracing``.

Corrupt lines (a process killed mid-write, disk-full truncation) are
skipped and counted, never fatal — the reader applies the same
skip-and-recompute posture the result store does.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class SpanStat:
    """Aggregate of every span event sharing one name."""

    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def add(self, dur_s: float) -> None:
        self.count += 1
        self.total_s += dur_s
        self.min_s = min(self.min_s, dur_s)
        self.max_s = max(self.max_s, dur_s)


@dataclass
class ObsReport:
    """Everything ``report`` needs from a trace stream."""

    spans: dict[str, SpanStat] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    pids: set[int] = field(default_factory=set)
    wall_s: float = 0.0
    events: int = 0
    skipped_lines: int = 0

    def span_total(self, name: str) -> float:
        st = self.spans.get(name)
        return st.total_s if st is not None else 0.0

    def counter(self, name: str, default: float = 0.0) -> float:
        return self.counters.get(name, default)

    def to_dict(self) -> dict:
        """JSON-friendly form (``report --json``), fully sorted."""
        return {
            "wall_seconds": round(self.wall_s, 6),
            "events": self.events,
            "skipped_lines": self.skipped_lines,
            "pids": sorted(self.pids),
            "spans": {
                name: {
                    "count": st.count,
                    "total_seconds": round(st.total_s, 6),
                    "mean_seconds": round(st.mean_s, 6),
                    "min_seconds": round(st.min_s, 6),
                    "max_seconds": round(st.max_s, 6),
                }
                for name, st in sorted(self.spans.items())
            },
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
        }


def load_events(paths) -> tuple[list[dict], int]:
    """Parse JSONL events from ``paths``; (events, corrupt-line count)."""
    events: list[dict] = []
    skipped = 0
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    skipped += 1
                    continue
                if isinstance(ev, dict) and "ev" in ev:
                    events.append(ev)
                else:
                    skipped += 1
    return events, skipped


def aggregate_events(events: list[dict], *, skipped: int = 0) -> ObsReport:
    rep = ObsReport(skipped_lines=skipped)
    t_lo = float("inf")
    t_hi = float("-inf")
    for ev in events:
        rep.events += 1
        pid = ev.get("pid")
        if isinstance(pid, int):
            rep.pids.add(pid)
        kind = ev.get("ev")
        if kind == "span":
            try:
                ts = float(ev["ts"])
                dur = float(ev["dur"])
                name = ev["name"]
            except (KeyError, TypeError, ValueError):
                rep.skipped_lines += 1
                continue
            rep.spans.setdefault(name, SpanStat()).add(dur / 1e6)
            t_lo = min(t_lo, ts)
            t_hi = max(t_hi, ts + dur)
        elif kind == "counters":
            for k, v in (ev.get("counters") or {}).items():
                try:
                    rep.counters[k] = rep.counters.get(k, 0) + float(v)
                except (TypeError, ValueError):
                    rep.skipped_lines += 1
    if t_hi > t_lo:
        rep.wall_s = (t_hi - t_lo) / 1e6
    return rep


def aggregate(paths) -> ObsReport:
    """Load + aggregate one or more trace files into an :class:`ObsReport`."""
    events, skipped = load_events(paths)
    return aggregate_events(events, skipped=skipped)


def format_report(rep: ObsReport, *, sort: str = "total") -> str:
    """The per-stage breakdown table ``python -m repro_torch.obs report`` prints.

    ``%wall`` is each name's *total* span time over the trace's
    end-to-end wall — overlapping/nested spans can legitimately exceed
    100% in aggregate; the per-stage rows are what the acceptance check
    reads (stage total within 10% of end-to-end wall-clock).
    """
    lines: list[str] = []
    key = {
        "total": lambda kv: -kv[1].total_s,
        "count": lambda kv: -kv[1].count,
        "name": lambda kv: kv[0],
    }[sort]
    lines.append(
        f"{'span':32s} {'count':>7s} {'total_s':>9s} {'mean_ms':>9s} "
        f"{'max_ms':>9s} {'%wall':>6s}")
    for name, st in sorted(rep.spans.items(), key=key):
        pct = 100.0 * st.total_s / rep.wall_s if rep.wall_s else 0.0
        lines.append(
            f"{name:32s} {st.count:7d} {st.total_s:9.3f} "
            f"{st.mean_s * 1e3:9.3f} {st.max_s * 1e3:9.3f} {pct:5.1f}%")
    if not rep.spans:
        lines.append("(no span events)")
    lines.append("")
    lines.append(f"{'counter':44s} {'value':>14s}")
    for name in sorted(rep.counters):
        v = rep.counters[name]
        text = f"{v:.3f}".rstrip("0").rstrip(".") if v % 1 else f"{int(v)}"
        lines.append(f"{name:44s} {text:>14s}")
    if not rep.counters:
        lines.append("(no counter events)")
    lines.append("")
    lines.append(
        f"wall {rep.wall_s:.3f}s over {rep.events} event(s) from "
        f"{len(rep.pids)} process(es)"
        + (f"; {rep.skipped_lines} corrupt line(s) skipped"
           if rep.skipped_lines else ""))
    return "\n".join(lines)


def to_chrome(events: list[dict]) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable) from raw obs events.

    Span events become ``ph: "X"`` complete events (ts/dur already in
    microseconds — the trace-event unit); counter deltas become ``ph:
    "C"`` counter samples so cumulative counters plot as steps.
    """
    trace_events: list[dict] = []
    running: dict[tuple[int, str], float] = {}
    for ev in events:
        kind = ev.get("ev")
        if kind == "span":
            try:
                trace_events.append({
                    "name": ev["name"],
                    "ph": "X",
                    "ts": float(ev["ts"]),
                    "dur": float(ev["dur"]),
                    "pid": int(ev.get("pid", 0)),
                    "tid": int(ev.get("tid", 0)),
                    "args": ev.get("tags", {}),
                })
            except (KeyError, TypeError, ValueError):
                continue
        elif kind == "counters":
            pid = int(ev.get("pid", 0))
            ts = float(ev.get("ts", 0))
            for k, v in (ev.get("counters") or {}).items():
                try:
                    running[(pid, k)] = running.get((pid, k), 0) + float(v)
                except (TypeError, ValueError):
                    continue
                trace_events.append({
                    "name": k,
                    "ph": "C",
                    "ts": ts,
                    "pid": pid,
                    "args": {"value": running[(pid, k)]},
                })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
