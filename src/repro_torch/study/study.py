"""The :class:`Study` — one suite, one engine, every pipeline consumer
(counterpart of ``repro.study.study``).

A Study binds a suite of workloads to a shared, memoized
:class:`~repro_torch.study.engine.SimEngine` and exposes the DAMOV
pipeline (locality metrics -> classification -> core-sweep
scalability/energy) as cached queries.  Every consumer — the suite runner,
the CLI, ad-hoc notebooks — reads from the same study, and each simulation
cell runs exactly once per study, no matter how many queries touch it.

Quickstart::

    from repro_torch.study import Study

    study = Study(refs=20_000)            # synthetic DAMOV suite
    for w in study:
        print(w.name, study.classify(w))  # six-class verdict
    fig4 = study.metrics_table()          # columnar StudyResult
    print(fig4.to_csv())
    print(study.stats.as_dict())          # cell hit/miss accounting
"""

from __future__ import annotations

from typing import Iterable, Iterator

from repro_torch.core import classify as _classify
from repro_torch.core import locality as _locality
from repro_torch.core import scalability as _scalability
from repro_torch.core import tracegen
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.core.tracegen import Workload

from .engine import EngineStats, SimEngine
from .result import StudyResult

__all__ = ["Study"]


class Study:
    """A characterization study: suite x memoized engine x cached queries."""

    def __init__(
        self,
        suite: Iterable[Workload] | None = None,
        *,
        refs: int | None = None,
        variants: int = 1,
        suite_seed: int = 0,
        seed: int = 0,
        cores: tuple[int, ...] = CORE_SWEEP,
        engine: SimEngine | None = None,
        backend: str | None = None,
    ) -> None:
        """``suite``: explicit workloads; otherwise the synthetic DAMOV suite
        ``tracegen.make_suite(refs, variants=variants, seed=suite_seed)``
        (``refs`` defaults to
        :data:`repro_torch.core.tracegen.DEFAULT_REFS`).  ``seed`` is the
        *trace* seed and ``cores`` the core sweep shared by every query.
        ``backend`` picks the cache-simulation implementation for the
        engine this study builds (``"vectorized"``/``"reference"``;
        ignored when an ``engine`` is supplied)."""
        if suite is None:
            if refs is None:
                refs = tracegen.DEFAULT_REFS
            suite = tracegen.make_suite(refs=refs, variants=variants,
                                        seed=suite_seed)
            self.refs: int | None = refs
        else:
            self.refs = None  # trace length unknown for an explicit suite
        self.suite: list[Workload] = list(suite)
        self.seed = seed
        self.cores = tuple(cores)
        self.engine = engine if engine is not None else SimEngine(backend=backend)
        for w in self.suite:
            self.engine.register(w)
        self._by_name = {w.name: w for w in self.suite}
        self._locality: dict[str, tuple[float, float]] = {}
        self._metrics: dict[tuple, _classify.FunctionMetrics] = {}
        self._scalability: dict[tuple, _scalability.ScalabilityResult] = {}

    # ---- suite access ---------------------------------------------------
    def __iter__(self) -> Iterator[Workload]:
        return iter(self.suite)

    def __len__(self) -> int:
        return len(self.suite)

    def names(self) -> list[str]:
        return [w.name for w in self.suite]

    def workload(self, name: str) -> Workload:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(
                f"no workload {name!r} in this study; available: "
                f"{', '.join(sorted(self._by_name))}"
            ) from None

    def _resolve(self, w: Workload | str) -> Workload:
        return self._by_name[w] if isinstance(w, str) else w

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats

    # ---- Step 2: architecture-independent locality ----------------------
    def locality(self, w: Workload | str) -> tuple[float, float]:
        """(spatial, temporal) locality of the 1-core trace, memoized."""
        w = self._resolve(w)
        got = self._locality.get(w.name)
        if got is None:
            spec = self.engine.trace(w, 1, seed=self.seed)
            got = (
                _locality.spatial_locality(spec.addresses),
                _locality.temporal_locality(spec.addresses),
            )
            self._locality[w.name] = got
        return got

    # ---- Step 3: metrics / classification -------------------------------
    def metrics(
        self, w: Workload | str, *, cores: tuple[int, ...] | None = None
    ) -> _classify.FunctionMetrics:
        """Classification metrics (AI, MPKI, LFMR sweep), engine-shared."""
        w = self._resolve(w)
        cores = self.cores if cores is None else cores
        key = (w.name, cores)
        got = self._metrics.get(key)
        if got is None:
            got = _classify.measure(w, seed=self.seed, cores=cores,
                                    engine=self.engine)
            self._metrics[key] = got
        return got

    def metrics_all(self) -> list[_classify.FunctionMetrics]:
        return [self.metrics(w) for w in self.suite]

    def classify(
        self,
        w: Workload | str,
        thresholds: _classify.Thresholds = _classify.PAPER_THRESHOLDS,
    ) -> str:
        """Six-class bottleneck verdict (§3.3 decision procedure)."""
        return _classify.classify(self.metrics(w), thresholds)

    def thresholds(self) -> _classify.Thresholds:
        """§3.5 phase-1: thresholds derived from this suite's metrics."""
        return _classify.derive_thresholds(self.metrics_all())

    def validate(self, thresholds: _classify.Thresholds | None = None):
        """§3.5 phase-2 over this suite: (accuracy, rows)."""
        t = thresholds if thresholds is not None else self.thresholds()
        return _classify.validate(self.metrics_all(), t)

    # ---- Step 3: scalability / energy -----------------------------------
    def scalability(
        self,
        w: Workload | str,
        *,
        core_model: str = "ooo",
        nuca: bool = False,
        cores: tuple[int, ...] | None = None,
    ) -> _scalability.ScalabilityResult:
        """Host / Host+PF / NDP sweep, engine-shared and result-cached."""
        w = self._resolve(w)
        cores = self.cores if cores is None else cores
        key = (w.name, core_model, nuca, cores)
        got = self._scalability.get(key)
        if got is None:
            got = _scalability.analyze(
                w, core_model=core_model, cores=cores, nuca=nuca,
                seed=self.seed, engine=self.engine,
            )
            self._scalability[key] = got
        return got

    # ---- canonical tables ------------------------------------------------
    def metrics_table(self, *, digits: int = 3) -> StudyResult:
        """One row per function: locality + the three Step-3 metrics."""
        cols = ("name", "family", "class", "spatial", "temporal", "ai",
                "mpki") + tuple(f"lfmr@{c}" for c in self.cores)
        res = StudyResult("metrics", cols)
        for w in self.suite:
            s, t = self.locality(w)
            m = self.metrics(w)
            res.append(
                (w.name, w.family, w.expected_class, round(s, digits),
                 round(t, digits), round(m.ai, digits), round(m.mpki, 2))
                + tuple(round(x, digits) for x in m.lfmr_by_cores)
            )
        return res

    def classification_table(
        self, thresholds: _classify.Thresholds | None = None
    ) -> StudyResult:
        """One row per function: expected vs predicted class."""
        t = thresholds if thresholds is not None else _classify.PAPER_THRESHOLDS
        res = StudyResult("classification",
                          ("name", "expected", "predicted", "correct"))
        for w in self.suite:
            pred = self.classify(w, t)
            res.append((w.name, w.expected_class, pred,
                        int(pred == w.expected_class)))
        return res

    def scalability_table(
        self, *, core_model: str = "ooo", nuca: bool = False,
        digits: int = 2,
    ) -> StudyResult:
        """One row per (function, system): normalized performance curve."""
        cols = ("name", "class", "system") + tuple(
            f"perf@{c}" for c in self.cores)
        res = StudyResult("scalability", cols)
        for w in self.suite:
            r = self.scalability(w, core_model=core_model, nuca=nuca)
            for cfg in r.points:
                res.append((w.name, w.expected_class, cfg) + tuple(
                    round(p, digits) for p in r.perf_normalized(cfg)))
        return res

    def energy_table(self, *, nuca: bool = False, digits: int = 4) -> StudyResult:
        """One row per (function, system, cores): energy breakdown in mJ."""
        cols = ("name", "class", "system", "cores", "l1_mJ", "l2_mJ",
                "l3_mJ", "dram_mJ", "link_mJ", "total_mJ")
        res = StudyResult("energy", cols)
        for w in self.suite:
            r = self.scalability(w, nuca=nuca)
            for cfg in ("host", "ndp"):
                for p in r.points[cfg]:
                    e = p.energy
                    res.append((w.name, w.expected_class, cfg, p.cores,
                                round(e.l1_j * 1e3, digits),
                                round(e.l2_j * 1e3, digits),
                                round(e.l3_j * 1e3, digits),
                                round(e.dram_j * 1e3, digits),
                                round(e.link_j * 1e3, digits),
                                round(e.total_j * 1e3, digits)))
        return res
