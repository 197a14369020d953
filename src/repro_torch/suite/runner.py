"""Suite runner: fan the roster over the memoized engine, persist results
(counterpart of ``repro.suite.runner``).

:class:`SuiteRunner` characterizes every entry of a
:class:`~repro_torch.suite.registry.SuiteRegistry` with the standard
Step-2/Step-3 pipeline — locality on the 1-core trace, then the host core
sweep through one memoized :class:`~repro_torch.study.engine.SimEngine`
(via ``classify.measure``) — and assigns the six-class verdict.  Rows have
the reference's columns, so the two rosters diff row by row.  Captured
entries walk launches of the port's kernels on the registry's device;
synthetic entries are host traces drawn with numpy from the seed.

Each finished row is persisted to a content-addressed :class:`ResultStore`
(when given), so a rerun re-simulates only the missing entries; recalled
rows are byte-identical to freshly computed ones (they store the rounded
values).

Optional roster sections (``sections=("scalability", "energy")``) append
per-entry scalability and energy columns computed from the same engine
cells, under section-specific record keys.  The ``serving`` section swaps
the roster itself to the production-traffic scenarios (see
:func:`~repro_torch.suite.registry.registry_for`) and adds each scenario's
phase timeline plus the best data-movement mitigation measured across the
host+pf / NUCA / NDP substrates.

Entry-level process fan-out: with ``processes > 1`` whole entries are
characterized across a spawn-context :class:`ProcessPoolExecutor`.  Each
worker rebuilds the registry from its ``refs`` and ``device`` markers
(cached per process), launching its captured entries itself, and returns
finished rows, which the parent persists.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import torch

from repro_torch import obs
from repro_torch.core import cachesim, classify
from repro_torch.core.scalability import sweep_configs
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.study.engine import SimEngine
from repro_torch.study.engine import _fingerprint as workload_fingerprint
from repro_torch.study.result import StudyResult
from repro_torch.study.study import Study

from .registry import (LEGACY_SCHEMA, SOURCES, SUITE_SCHEMA, SuiteEntry,
                       SuiteRegistry, registry_for)
from .store import ResultStore

__all__ = ["SuiteRunner", "RunStats", "ROSTER_COLUMNS", "SECTION_COLUMNS",
           "CLASSES"]

ROSTER_COLUMNS = (
    "name", "domain", "source", "expected", "assigned", "match",
    "spatial", "temporal", "ai", "mpki", "lfmr_mean", "lfmr_slope",
)

# Optional per-entry roster sections: extra columns appended to every row,
# computed from the same memoized engine cells.  ``scalability``: host
# strong-scaling speedup and the NDP-vs-host speedup at the sweep's top
# core count (paper Figs. 5/16).  ``energy``: per-thread host and NDP
# energy at the top core count plus their ratio (Figs. 7-17).
# ``serving``: phase structure (window count, distinct phases, dominant
# phase, the per-window class timeline) and the best data-movement
# mitigation with its speedup over the plain host at the top core count;
# requesting it swaps the roster to the serving scenarios.  ``models``: the
# entry's swept axes (mode, batch, cache/sequence geometry) plus the
# whole-step op census (total / dense / stream / pallas op counts and the
# shared address-space footprint) from the zoo's capture census;
# requesting it swaps the roster to the model zoo.
SECTION_COLUMNS: dict[str, tuple[str, ...]] = {
    "scalability": ("host_speedup", "ndp_speedup"),
    "energy": ("host_mj", "ndp_mj", "ndp_energy_ratio"),
    "serving": ("windows", "phases", "dominant_phase", "phase_timeline",
                "best_mitigation", "best_speedup"),
    "models": ("mode", "batch", "geometry", "model_ops", "dense_ops",
               "stream_ops", "pallas_ops", "footprint_mib"),
}

# A mitigation must beat the plain host by this factor before the roster
# recommends it; below the bar the row reports "none".
_MITIGATION_BAR = 1.05
CLASSES = classify.CLASSES


@dataclass
class RunStats:
    computed: int = 0
    recalled: int = 0

    def as_dict(self) -> dict[str, int]:
        return {"computed": self.computed, "recalled": self.recalled}


@functools.lru_cache(maxsize=1)
def _worker_runner(refs: int, seed: int, cores: tuple[int, ...],
                   backend: str, sections: tuple[str, ...],
                   store_root: str | None, device: str,
                   only: tuple[str, ...] | None = None) -> "SuiteRunner":
    """Per-process runner over the rebuilt registry (built on the first
    task, reused for every entry the worker gets): the parent's roster,
    the models roster with the parent's ``only`` filter included, so a
    filtered run never rebuilds the whole zoo in a worker.  ``store_root``
    reconnects the worker to the shared cell store, so cells finished by
    any pool member are recalled instead of re-run."""
    runner = SuiteRunner(registry_for(refs=refs, sections=sections,
                                      only=only, device=device),
                         seed=seed, cores=cores, backend=backend,
                         store=None, sections=sections)
    if store_root is not None:
        runner.study.engine.profile_store = \
            ResultStore(store_root).sub("cells")
    return runner


def _characterize_entry(task: tuple) -> tuple:
    """Process-pool task: one entry's roster row, by name.

    Workers inherit the parent's trace sink through ``REPRO_TORCH_TRACE``
    (set by :func:`repro_torch.obs.enable` before the pool spawns), so
    their spans land in the same stream, pid-tagged.  Counters are flushed
    per task, so pool busy time sums across workers however the pool is
    torn down.
    """
    (name, refs, seed, cores, backend, sections, store_root, device,
     only) = task
    t0 = time.perf_counter()
    with obs.span("suite.worker.entry", entry=name):
        runner = _worker_runner(refs, seed, cores, backend, sections,
                                store_root, device, only)
        entry = next(e for e in runner.registry if e.name == name)
        row = runner._characterize(entry)
    obs.count("pool.tasks")
    obs.count("pool.busy_s", time.perf_counter() - t0)
    obs.flush()
    return row


class SuiteRunner:
    """One registry x one memoized engine x one (optional) result store."""

    def __init__(
        self,
        registry: SuiteRegistry,
        *,
        seed: int = 0,
        cores: tuple[int, ...] = CORE_SWEEP,
        backend: str | None = None,
        store: ResultStore | None = None,
        processes: int | None = None,
        sections: tuple[str, ...] = (),
    ) -> None:
        self.registry = registry
        self.seed = seed
        self.cores = tuple(cores)
        self.store = store
        # Resolved now so the store fingerprint names the implementation
        # that actually runs (REPRO_SIM_BACKEND included).
        self.backend = backend if backend is not None else \
            cachesim.default_backend()
        self.processes = processes
        unknown = set(sections) - set(SECTION_COLUMNS)
        if unknown:
            raise ValueError(
                f"unknown roster section(s) {sorted(unknown)}; expected a "
                f"subset of {sorted(SECTION_COLUMNS)}")
        # canonical order, so column layout never depends on CLI order
        self.sections = tuple(s for s in SECTION_COLUMNS if s in sections)
        self.columns: tuple[str, ...] = ROSTER_COLUMNS + tuple(
            c for s in self.sections for c in SECTION_COLUMNS[s])
        # Cell store: content-addressed SimResult records shared across
        # process-pool workers.  Scoped to pool runs; in-process runs share
        # cells through the engine memo.
        pool = processes is not None and (processes == 0 or processes > 1)
        cell_store = (store.sub("cells")
                      if store is not None and pool else None)
        self.study = Study(
            suite=registry.workloads(), seed=seed, cores=self.cores,
            engine=SimEngine(backend=self.backend,
                             profile_store=cell_store),
        )
        self.stats = RunStats()
        self._rows: dict[str, tuple] = {}
        self._rebuilt: dict[str, SuiteEntry] | None = None

    @property
    def device(self) -> str:
        """Where the registry's captured and serving entries launch."""
        return self.registry.device

    # ---- characterization ------------------------------------------------
    def _characterize(self, entry: SuiteEntry) -> tuple:
        with obs.span("suite.entry", entry=entry.name, source=entry.source):
            return self._characterize_inner(entry)

    def _characterize_inner(self, entry: SuiteEntry) -> tuple:
        w = entry.workload
        spatial, temporal = self.study.locality(w)
        m = self.study.metrics(w)
        assigned = classify.classify(m)
        row = (
            entry.name, entry.domain, entry.source, entry.expected_class,
            assigned, int(assigned == entry.expected_class),
            round(spatial, 3), round(temporal, 3), round(m.ai, 3),
            round(m.mpki, 2), round(m.lfmr_mean, 3), round(m.lfmr_slope, 3),
        )
        for section in self.sections:
            row += self._section_values(section, entry)
        return row

    def _section_values(self, section: str, entry: SuiteEntry) -> tuple:
        """Extra per-entry columns, from the same memoized engine cells."""
        if section == "serving":
            return self._serving_values(entry)
        if section == "models":
            return self._model_values(entry)
        r = self.study.scalability(entry.workload)
        host = r.points["host"]
        ndp = r.points["ndp"]
        if section == "scalability":
            return (round(host[-1].perf / host[0].perf, 3),
                    round(ndp[-1].perf / host[-1].perf, 3))
        # energy: per-thread J -> mJ at the sweep's top core count; the
        # ratio is derived from the rounded columns so the row is
        # internally consistent after a store round-trip
        host_mj = round(host[-1].energy.total_j * 1e3, 6)
        ndp_mj = round(ndp[-1].energy.total_j * 1e3, 6)
        return (host_mj, ndp_mj,
                round(ndp_mj / host_mj if host_mj else 0.0, 3))

    def _model_values(self, entry: SuiteEntry) -> tuple:
        """Swept axes + whole-step op census for a model entry
        (placeholder columns on any other source)."""
        if entry.source != "model":
            return ("-", 0, "-", 0, 0, 0, 0, 0.0)
        from repro_torch.capture.zoo import census_for

        p = dict(entry.params)
        return (p["mode"], p["batch"], p["geometry"]) + census_for(entry.name)

    def _serving_values(self, entry: SuiteEntry) -> tuple:
        """Phase timeline + best measured mitigation for a serving entry;
        other sources have no scheduling windows and report placeholder
        phase columns next to a real best-mitigation measurement."""
        if entry.source == "serving":
            from repro_torch.serving.phases import measure_windows

            tl = measure_windows(entry.name, seed=self.seed,
                                 cores=self.cores, engine=self.study.engine,
                                 device=self.device)
            phase_cols = (len(tl.labels), tl.n_phases, tl.dominant,
                          tl.timeline())
        else:
            phase_cols = (0, 0, "-", "-")
        return phase_cols + self._best_mitigation(entry)

    def _best_mitigation(self, entry: SuiteEntry) -> tuple:
        """(name, speedup) of the best substrate vs the plain host at the
        sweep's top core count: NDP, prefetch+NUCA host, or NUCA alone,
        gated on :data:`_MITIGATION_BAR`."""
        plain = self.study.scalability(entry.workload)
        tuned = self.study.scalability(entry.workload, nuca=True)
        base = plain.points["host"][-1].perf
        candidates = {
            "ndp": plain.points["ndp"][-1].perf / base,
            "prefetch+nuca": tuned.points["host+pf"][-1].perf / base,
            "nuca": tuned.points["host"][-1].perf / base,
        }
        best = max(candidates, key=lambda k: candidates[k])
        if candidates[best] < _MITIGATION_BAR:
            return ("none", 1.0)
        return (best, round(candidates[best], 3))

    def _fingerprint(self, entry: SuiteEntry) -> str:
        return entry.fingerprint(seed=self.seed, cores=self.cores,
                                 backend=self.backend,
                                 sections=self.sections)

    def _recall(self, entry: SuiteEntry) -> tuple | None:
        """Store lookup for one entry; caches and counts on hit.  A record
        of the wrong shape (schema, columns, row length) is a miss: the
        entry recomputes and the fresh row overwrites it."""
        if self.store is None:
            return None
        rec = self.store.get(self._fingerprint(entry))
        if (rec is not None
                and rec.get("schema", LEGACY_SCHEMA) == SUITE_SCHEMA
                and rec.get("columns") == list(self.columns)
                and isinstance(rec.get("row"), list)
                and len(rec["row"]) == len(self.columns)):
            obs.count("store.recall.warm")
            row = tuple(rec["row"])
            self._rows[entry.name] = row
            self.stats.recalled += 1
            return row
        obs.count("store.recall.cold")
        return None

    def _persist(self, entry: SuiteEntry, row: tuple) -> None:
        self._rows[entry.name] = row
        self.stats.computed += 1
        if self.store is not None:
            self.store.put(self._fingerprint(entry),
                           {"schema": SUITE_SCHEMA,
                            "columns": list(self.columns),
                            "row": list(row)})

    def row(self, entry: SuiteEntry) -> tuple:
        """One roster row, store-first (computed and persisted on miss)."""
        got = self._rows.get(entry.name)
        if got is not None:
            return got
        got = self._recall(entry)
        if got is not None:
            return got
        row = self._characterize(entry)
        self._persist(entry, row)
        return row

    def compute_all(self, *, processes: int | None = None) -> None:
        """Materialize every entry row, fanning misses across processes.

        ``processes`` (default: the constructor's) > 1 fans whole entries
        over a spawn-context process pool; ``0`` means one process per
        CPU.  Each worker rebuilds the registry from its ``refs`` and
        ``device`` markers (required: a hand-built registry cannot cross
        the pickle boundary).  Store-recalled entries never reach the
        pool, nor does an entry the rebuilt registry would not reproduce
        identically; those are characterized in-process.
        """
        processes = self.processes if processes is None else processes
        if processes == 0:
            processes = os.cpu_count() or 1
        todo = [
            e for e in self.registry
            if e.name not in self._rows and self._recall(e) is None
        ]
        if not todo:
            return
        if processes is None or processes <= 1 or len(todo) == 1:
            self._prewarm(todo)
            for entry in todo:
                self._persist(entry, self._characterize(entry))
            return
        if self.registry.refs is None:
            raise ValueError(
                "process fan-out needs a registry reconstructible from "
                "registry_for(refs=..., device=...); this registry has no "
                "refs marker — run with processes=1")
        remote, local = [], []
        for entry in todo:
            (remote if self._reconstructible(entry) else local).append(entry)
        if remote:
            if torch.device(self.device).type == "cuda":
                # Workers only load the kernel libraries built here.
                from repro_torch.kernels import KERNELS, _build
                _build.build(list(KERNELS))
            tasks = [
                (e.name, self.registry.refs, self.seed, self.cores,
                 self.backend, self.sections,
                 str(self.store.root) if self.store is not None else None,
                 self.device, self.registry.only)
                for e in remote
            ]
            # spawn, not fork: a child forked after CUDA is initialised
            # cannot use the card.  Workers rebuild everything from the
            # pickled task tuple anyway.
            # Spawned workers inherit REPRO_TORCH_TRACE from this process's
            # environment, so their spans merge into its trace file.
            ctx = multiprocessing.get_context("spawn")
            n_workers = min(processes, len(remote))
            t0 = time.perf_counter()
            with obs.span("suite.pool", entries=len(remote),
                          processes=n_workers), \
                    ProcessPoolExecutor(max_workers=n_workers,
                                        mp_context=ctx) as pool:
                for entry, row in zip(remote,
                                      pool.map(_characterize_entry, tasks)):
                    self._persist(entry, tuple(row))
            # pool.busy_s (summed in the workers) over workers x wall is the
            # pool's busy share
            obs.count("pool.wall_s", time.perf_counter() - t0)
            obs.count("pool.workers", n_workers)
        for entry in local:
            self._persist(entry, self._characterize(entry))

    def _prewarm(self, entries: list[SuiteEntry]) -> None:
        """One cross-workload batch over every cell the roster pass needs
        (``classify.measure``'s host sweep always; the scalability /
        energy / serving sweeps and the serving windows when requested),
        so the per-entry characterization that follows runs on engine
        hits and no cell is simulated that would not have been."""
        factories = []
        if set(self.sections) & {"scalability", "energy", "serving"}:
            factories += list(sweep_configs(nuca=False).values())
        if "serving" in self.sections:
            # _best_mitigation also sweeps the NUCA variants
            factories += list(sweep_configs(nuca=True).values())
        items = [
            (e.workload, c, cfg)
            for e in entries
            for c in self.cores
            for cfg in ([cachesim.host_config(c)]
                        + [f(c) for f in factories])
        ]
        if "serving" in self.sections:
            # The phase timeline measures every scheduling window as a
            # standalone workload (host sweep only).
            from repro_torch.serving.phases import _window_workload
            from repro_torch.serving.scenario import SCENARIOS
            for e in entries:
                if e.source != "serving" or e.name not in SCENARIOS:
                    continue
                scen = SCENARIOS[e.name]
                items += [
                    (_window_workload(scen, i, wt), c,
                     cachesim.host_config(c))
                    for i, wt in enumerate(
                        scen.window_traces(seed=self.seed,
                                           device=self.device))
                    for c in self.cores
                ]
        if items:
            with obs.span("suite.prewarm", entries=len(entries),
                          cells=len(items)):
                self.study.engine.simulate_cells(items, seed=self.seed)

    def _reconstructible(self, entry: SuiteEntry) -> bool:
        """Would a worker's rebuilt registry reproduce ``entry`` exactly?
        Checked on the entry fingerprint and the workload-generator
        fingerprint (code object + closed-over parameters, the device
        included), so a swapped generator under an unchanged name is
        caught, not silently mischaracterized."""
        other = self._rebuilt_registry().get(entry.name)
        if other is None:
            return False
        kw = dict(seed=self.seed, cores=self.cores, backend=self.backend)
        return (other.fingerprint(**kw) == entry.fingerprint(**kw)
                and workload_fingerprint(other.workload)
                == workload_fingerprint(entry.workload))

    def _rebuilt_registry(self) -> dict[str, SuiteEntry]:
        if self._rebuilt is None:
            self._rebuilt = {
                e.name: e
                for e in registry_for(refs=self.registry.refs,
                                      sections=self.sections,
                                      only=self.registry.only,
                                      device=self.device)
            }
        return self._rebuilt

    # ---- tables ----------------------------------------------------------
    def roster(self) -> StudyResult:
        """The Table-3-style roster: one row per entry, every source."""
        self.compute_all()
        res = StudyResult("suite_roster", self.columns)
        for entry in self.registry:
            res.append(self.row(entry))
        return res

    def histogram(self) -> StudyResult:
        """Per-class entry counts, split by source (Fig. 2-style census).
        Columns follow the registry's sources in canonical order."""
        roster = self.roster()
        present = {e.source for e in self.registry}
        sources = tuple(s for s in SOURCES if s in present) or (
            "synthetic", "captured")
        counts: dict[str, dict[str, int]] = {
            c: dict.fromkeys(sources, 0) for c in CLASSES
        }
        for rec in roster.records():
            counts.setdefault(rec["assigned"], dict.fromkeys(sources, 0))
            counts[rec["assigned"]][rec["source"]] += 1
        res = StudyResult("class_histogram", ("class",) + sources + ("total",))
        for cls in sorted(counts):
            vals = tuple(counts[cls][s] for s in sources)
            if cls in CLASSES or any(vals):
                res.append((cls,) + vals + (sum(vals),))
        return res

    def divergent(self, *, source: str = "captured") -> list[dict]:
        """Entries of ``source`` whose assigned class != expected class."""
        return [
            rec for rec in self.roster().records()
            if rec["source"] == source and not rec["match"]
        ]
