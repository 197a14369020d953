"""Phase-aware classification: a DAMOV verdict per scheduling window
(counterpart of ``repro.serving.phases``).

Each fixed-ref window of a :class:`~repro_torch.serving.scenario
.ServingScenario` runs through the standard pipeline
(``classify.measure`` -> host core sweep -> §3.3 decision procedure),
yielding a :class:`PhaseTimeline` — class per window, transition matrix,
dominant phase — next to the whole-trace label.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import classify
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.core.tracegen import TraceSpec, Workload

from .scenario import SCENARIOS, ServingScenario, WindowTrace

__all__ = ["PhaseTimeline", "measure_windows", "MITIGATIONS"]

# class -> matching data-movement mitigation, rendered per window.
MITIGATIONS = classify.MITIGATIONS


@dataclass
class PhaseTimeline:
    """Per-window verdicts of one scenario + derived phase structure."""

    name: str
    labels: tuple[str, ...]                   # class per window, in order
    metrics: tuple[classify.FunctionMetrics, ...]
    windows: tuple[WindowTrace, ...]
    whole_label: str                          # the whole-trace verdict

    @property
    def n_phases(self) -> int:
        return len(set(self.labels))

    @property
    def dominant(self) -> str:
        counts: dict[str, int] = {}
        for lab in self.labels:
            counts[lab] = counts.get(lab, 0) + 1
        # ties break to the earliest-seen phase, deterministically
        return max(counts, key=lambda k: (counts[k], -self.labels.index(k)))

    @property
    def switches(self) -> int:
        return sum(a != b for a, b in zip(self.labels, self.labels[1:]))

    def timeline(self) -> str:
        return "-".join(self.labels)

    def transition_matrix(self) -> tuple[tuple[str, ...], np.ndarray]:
        """(classes, counts): counts[i, j] = windows going class_i ->
        class_j, over consecutive window pairs."""
        classes = tuple(sorted(set(self.labels)))
        idx = {c: i for i, c in enumerate(classes)}
        mat = np.zeros((len(classes), len(classes)), dtype=np.int64)
        for a, b in zip(self.labels, self.labels[1:]):
            mat[idx[a], idx[b]] += 1
        return classes, mat

    def mitigation_timeline(self) -> str:
        return "-".join(MITIGATIONS[lab] for lab in self.labels)


def _window_workload(scen: ServingScenario, index: int,
                     wt: WindowTrace) -> Workload:
    """One window as a standalone workload: its fixed-ref trace, its own
    offered AI — measured by the standard pipeline like any entry."""
    ai = round(wt.ai, 3)

    def gen(cores: int, rng: np.random.Generator,
            _wt: WindowTrace = wt, _mlp: float = scen.mlp) -> TraceSpec:
        del cores, rng  # the composed window trace is already concrete
        return TraceSpec(_wt.addresses, l3_factor=1.0, mlp=_mlp,
                         dram_rows_irregular=True)

    return Workload(
        name=f"{scen.name}#w{index:02d}",
        family="serving-window",
        expected_class=scen.expected_class,
        ai_ops_per_access=ai,
        instr_per_access=round(ai + scen.instr_overhead, 3),
        gen=gen,
        core_invariant=True,    # gen ignores cores; l3_factor pinned at 1.0
    )


def measure_windows(
    scenario: ServingScenario | str,
    *,
    seed: int = 0,
    cores: tuple[int, ...] = CORE_SWEEP,
    engine=None,
    thresholds: classify.Thresholds = classify.PAPER_THRESHOLDS,
    device: str | torch.device = "cuda",
) -> PhaseTimeline:
    """Classify every window of ``scenario`` and the whole trace, from
    kernel launches on ``device``.

    ``engine``: share a :class:`repro_torch.study.engine.SimEngine` to
    reuse its memoized cells; omitted, a private engine keeps the call
    standalone.
    """
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    if engine is None:
        from repro_torch.study.engine import SimEngine
        engine = SimEngine()
    wts = scenario.window_traces(seed=seed, device=device)
    labels, metrics = [], []
    for i, wt in enumerate(wts):
        m = classify.measure(_window_workload(scenario, i, wt),
                             seed=seed, cores=cores, engine=engine)
        metrics.append(m)
        labels.append(classify.classify(m, thresholds))
    whole = classify.classify(
        classify.measure(scenario.workload(device=device), seed=seed,
                         cores=cores, engine=engine), thresholds)
    return PhaseTimeline(
        name=scenario.name,
        labels=tuple(labels),
        metrics=tuple(metrics),
        windows=tuple(wts),
        whole_label=whole,
    )
