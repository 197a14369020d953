"""Content-addressed, memoized simulation engine (counterpart of
``repro.study.engine``).

The DAMOV pipeline evaluates many *simulation cells* — one functional
cache-hierarchy simulation per (workload, seed) x cores x hierarchy config.
The same cells are needed by several consumers (locality metrics,
classification, scalability curves, energy breakdowns, the serving phase
timelines), so :class:`SimEngine` runs each cell exactly once and shares
the result:

- traces are memoized on ``(workload.name, cores, seed)``; a core-invariant
  workload shares its 1-core trace across the whole sweep;
- simulations are memoized on ``(workload.name, seed, cores, hierarchy)``,
  where the hierarchy is the frozen :class:`~repro_torch.core.cachesim
  .HierarchyConfig` itself (content, not identity);
- :meth:`SimEngine.simulate_cells` / :meth:`SimEngine.simulate_batch`
  accept many cells at once, group the missing ones by trace and hand each
  group to the backend's batched single pass;
- :class:`EngineStats` counts hits/misses for both layers.

Workload identity is its *name*: the engine fingerprints each workload
(family, expected class, AI, instructions-per-access, plus the trace
generator's code and closed-over parameters such as trace length or the
device a captured kernel launches on) and refuses to mix two different
workloads under one name.  For any (name, seed, cores, hierarchy) key the
simulation runs at most once per engine; duplicate cells in one call count
as hits.  The memo is not locked: submit overlapping cells from one thread.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import Executor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch import obs
from repro_torch.core import cachesim
from repro_torch.core.cachesim import HierarchyConfig, SimResult
from repro_torch.core.tracegen import TraceSpec, Workload

__all__ = ["CellKey", "EngineStats", "SimEngine"]


@dataclass(frozen=True)
class CellKey:
    """Content address of one simulation cell."""

    workload: str
    seed: int
    cores: int
    hierarchy: HierarchyConfig


@dataclass
class EngineStats:
    """Hit/miss accounting for the two memoization layers."""

    trace_runs: int = 0
    trace_hits: int = 0
    sim_runs: int = 0
    sim_hits: int = 0

    @property
    def sim_hit_rate(self) -> float:
        total = self.sim_runs + self.sim_hits
        return self.sim_hits / total if total else 0.0

    def as_dict(self) -> dict[str, float]:
        return {
            "trace_runs": self.trace_runs,
            "trace_hits": self.trace_hits,
            "sim_runs": self.sim_runs,
            "sim_hits": self.sim_hits,
            "sim_hit_rate": round(self.sim_hit_rate, 4),
        }


def _gen_signature(w: Workload) -> tuple:
    """Content signature of the trace generator: its code object plus the
    closed-over parameters (trace length, footprint, device, ...), so two
    suites built with different ``refs`` cannot alias under one name."""
    gen = w.gen
    code = getattr(gen, "__code__", None)
    code_id = (code.co_filename, code.co_firstlineno,
               code.co_code) if code is not None else None
    cells: tuple = ()
    for cell in getattr(gen, "__closure__", None) or ():
        try:
            hash(cell.cell_contents)
            cells += (cell.cell_contents,)
        except TypeError:
            cells += (repr(cell.cell_contents),)
    return (code_id, cells)


def _fingerprint(w: Workload) -> tuple:
    return (w.family, w.expected_class, w.ai_ops_per_access,
            w.instr_per_access, w.core_invariant, _gen_signature(w))


# Schema version of the engine's cell-record store (``profile_store``).
# Bump when SimResult gains fields or the digest recipe changes: old
# records become unreachable and are simply recomputed.
_CELL_SCHEMA = 1


def _cell_digest(fp: tuple, key: CellKey) -> str:
    """Content address of one simulation cell's *result*: the cell schema,
    the workload fingerprint and the cell key.  No trace needs to be
    generated to compute it, so a pool worker can recall a sibling's
    finished cell without paying for the trace."""
    h = key.hierarchy
    text = repr((_CELL_SCHEMA, fp, key.workload, key.seed, key.cores,
                 h.levels, h.prefetcher, h.prefetch_degree,
                 h.prefetch_streams, h.name, h.shared_llc))
    return hashlib.sha256(text.encode()).hexdigest()


def _sim_to_record(sim: SimResult) -> dict:
    return {
        "schema": _CELL_SCHEMA,
        "accesses": sim.accesses,
        "instructions": sim.instructions,
        "ai": sim.ai,
        "level_hits": list(sim.level_hits),
        "level_misses": list(sim.level_misses),
        "lines": sim.lines_touched,
        "pf": [sim.prefetch_issued, sim.prefetch_useful],
    }


def _record_to_sim(rec: dict, name: str) -> SimResult | None:
    if not isinstance(rec, dict) or rec.get("schema") != _CELL_SCHEMA:
        return None
    try:
        return SimResult(
            name=name,
            accesses=int(rec["accesses"]),
            instructions=int(rec["instructions"]),
            ai=float(rec["ai"]),
            level_misses=tuple(int(m) for m in rec["level_misses"]),
            level_hits=tuple(int(h) for h in rec["level_hits"]),
            lines_touched=int(rec["lines"]),
            prefetch_issued=int(rec["pf"][0]),
            prefetch_useful=int(rec["pf"][1]),
        )
    except (KeyError, TypeError, ValueError, IndexError):
        return None


class SimEngine:
    """Memoized trace + simulation cache shared by all pipeline consumers.

    ``backend``: ``"vectorized"``, ``"reference"`` or ``None`` (resolved
    per call by :func:`repro_torch.core.cachesim.default_backend`).
    ``profile_store``: an optional cross-process cell cache (a
    ``ResultStore``-shaped object with get/put); finished cells are
    published as content-addressed records and recalled by digest before
    any trace is generated, which is how process-pool workers share work.
    """

    def __init__(self, *, backend: str | None = None,
                 profile_store=None) -> None:
        if backend is not None and backend not in cachesim.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{cachesim.BACKENDS}")
        self.backend = backend
        self.profile_store = profile_store
        self._traces: dict[tuple[str, int, int], TraceSpec] = {}
        self._sims: dict[CellKey, SimResult] = {}
        self._fingerprints: dict[str, tuple] = {}
        self.stats = EngineStats()

    # ---- identity -------------------------------------------------------
    def register(self, workload: Workload) -> None:
        """Pin ``workload.name`` to this workload's parameters; raises
        ``ValueError`` if a different workload already owns the name."""
        fp = _fingerprint(workload)
        prev = self._fingerprints.get(workload.name)
        if prev is None:
            self._fingerprints[workload.name] = fp
        elif prev != fp:
            raise ValueError(
                f"workload name {workload.name!r} already registered with "
                f"different parameters {prev} != {fp}; use distinct names "
                f"or a fresh SimEngine")

    # ---- memoized layers ------------------------------------------------
    @staticmethod
    def _trace_cores(workload: Workload, cores: int) -> int:
        return 1 if workload.core_invariant else cores

    def trace(self, workload: Workload, cores: int, *,
              seed: int = 0) -> TraceSpec:
        """Per-thread trace for one (workload, cores, seed), memoized."""
        self.register(workload)
        key = (workload.name, self._trace_cores(workload, cores), seed)
        spec = self._traces.get(key)
        if spec is None:
            obs.count("engine.trace.run")
            with obs.span("engine.trace", workload=workload.name,
                          cores=cores):
                spec = workload.trace(cores, seed=seed)
            self._traces[key] = spec
            self.stats.trace_runs += 1
        else:
            obs.count("engine.trace.hit")
            self.stats.trace_hits += 1
        return spec

    def simulate(self, workload: Workload, cores: int,
                 hierarchy: HierarchyConfig, *, seed: int = 0) -> SimResult:
        """Run (or recall) one simulation cell."""
        self.register(workload)
        key = CellKey(workload.name, seed, cores, hierarchy)
        sim = self._sims.get(key)
        if sim is None:
            spec = self.trace(workload, cores, seed=seed)
            obs.count("engine.sim.run")
            with obs.span("engine.cell", workload=workload.name,
                          cores=cores):
                sim = cachesim.simulate(
                    spec.addresses,
                    hierarchy,
                    ai_ops_per_access=workload.ai_ops_per_access,
                    instr_per_access=workload.instr_per_access,
                    l3_factor=spec.l3_factor,
                    name=hierarchy.name,
                    backend=self.backend,
                )
            self._sims[key] = sim
            self.stats.sim_runs += 1
        else:
            obs.count("engine.sim.hit")
            self.stats.sim_hits += 1
        return sim

    def _run_group(self, workload: Workload, spec: TraceSpec,
                   hierarchies: list[HierarchyConfig]) -> list[SimResult]:
        """All of one trace's un-memoized cells in a single backend pass.
        Writes nothing on the engine, so threads may run it concurrently."""
        return cachesim.simulate_batch(
            spec.addresses,
            hierarchies,
            ai_ops_per_access=workload.ai_ops_per_access,
            instr_per_access=workload.instr_per_access,
            l3_factor=spec.l3_factor,
            backend=self.backend,
        )

    def simulate_cells(
        self,
        items: Iterable[tuple[Workload, int, HierarchyConfig]],
        *,
        seed: int = 0,
    ) -> list[SimResult]:
        """Run (or recall) cells spanning many workloads in one call.

        Missing cells are first looked up in ``profile_store`` (when set;
        ``store.profile.hit``/``miss`` counters) and freshly-run cells are
        published back.  The rest are grouped by trace and all groups go
        to :func:`~repro_torch.core.cachesim.simulate_many` at once, the
        cross-trace segmented forest: one collapse + sort + capped window
        scan per unique hierarchy geometry across the whole call instead
        of one per trace.  Results, memoization and stats equal per-cell
        :meth:`simulate` calls.
        """
        items = list(items)
        keys: list[CellKey] = []
        for w, c, h in items:
            self.register(w)
            keys.append(CellKey(w.name, seed, c, h))

        missing: dict[CellKey, tuple[Workload, int, HierarchyConfig]] = {}
        hits = 0
        for key, (w, c, h) in zip(keys, items):
            if key in self._sims or key in missing:
                hits += 1  # memoized, or a duplicate within this call
            else:
                missing[key] = (w, c, h)

        if missing and self.profile_store is not None:
            recalled = 0
            for key in list(missing):
                w, _, h = missing[key]
                rec = self.profile_store.get(
                    _cell_digest(self._fingerprints[w.name], key))
                sim = _record_to_sim(rec, h.name) if rec is not None else None
                if sim is not None:
                    self._sims[key] = sim
                    del missing[key]
                    recalled += 1
            if recalled:
                obs.count("store.profile.hit", recalled)
                hits += recalled
            if missing:
                obs.count("store.profile.miss", len(missing))

        if missing:
            groups: dict[tuple, list] = {}
            for key, (w, c, h) in missing.items():
                gkey = (w.name, self._trace_cores(w, c))
                groups.setdefault(gkey, []).append((key, w, c, h))
            with obs.span("engine.cells", traces=len(groups),
                          cells=len(missing)):
                requests = []
                for batch in groups.values():
                    _, w, c, _ = batch[0]
                    spec = self.trace(w, c, seed=seed)
                    requests.append((
                        spec.addresses,
                        [h for *_, h in batch],
                        {"ai_ops_per_access": w.ai_ops_per_access,
                         "instr_per_access": w.instr_per_access,
                         "l3_factor": spec.l3_factor},
                    ))
                results = cachesim.simulate_many(requests,
                                                 backend=self.backend)
                for batch, sims in zip(groups.values(), results):
                    for (key, *_), sim in zip(batch, sims):
                        self._sims[key] = sim
            if self.profile_store is not None:
                for key, (w, _, _) in missing.items():
                    self.profile_store.put(
                        _cell_digest(self._fingerprints[w.name], key),
                        _sim_to_record(self._sims[key]))
            self.stats.sim_runs += len(missing)
            obs.count("engine.sim.run", len(missing))
        self.stats.sim_hits += hits
        if hits:
            obs.count("engine.sim.hit", hits)
        return [self._sims[key] for key in keys]

    def simulate_batch(
        self,
        workload: Workload,
        cells: Iterable[tuple[int, HierarchyConfig]],
        *,
        seed: int = 0,
        max_workers: int | None = None,
        executor: Executor | None = None,
    ) -> list[SimResult]:
        """Run (or recall) many ``(cores, hierarchy)`` cells of one workload.

        With no executor (the common case) this is :meth:`simulate_cells`
        on a single workload.  With ``executor`` or ``max_workers`` the
        per-trace groups are submitted to a thread pool (NumPy releases
        the GIL in the backend's hot loops); only this thread writes the
        memo.  Results, memoization and stats are identical either way.
        """
        self.register(workload)
        cells = list(cells)
        if executor is None and max_workers is None:
            return self.simulate_cells(
                [(workload, c, h) for c, h in cells], seed=seed)
        keys = [CellKey(workload.name, seed, c, h) for c, h in cells]
        specs = {c: self.trace(workload, c, seed=seed) for c, _ in cells}

        missing: dict[CellKey, tuple[int, HierarchyConfig]] = {}
        hits = 0
        for key, (c, h) in zip(keys, cells):
            if key in self._sims or key in missing:
                hits += 1
            else:
                missing[key] = (c, h)

        if missing:
            groups: dict[int, list[tuple[CellKey, HierarchyConfig]]] = {}
            for key, (c, h) in missing.items():
                groups.setdefault(c, []).append((key, h))

            def run(c: int, batch: list[tuple[CellKey, HierarchyConfig]]):
                with obs.span("engine.batch", workload=workload.name,
                              cores=c, cells=len(batch)):
                    return self._run_group(workload, specs[c],
                                           [h for _, h in batch])

            own_pool = executor is None
            pool = executor if executor is not None else ThreadPoolExecutor(
                max_workers=max_workers or min(os.cpu_count() or 1, 8))
            try:
                futures = [(batch, pool.submit(run, c, batch))
                           for c, batch in groups.items()]
                for batch, fut in futures:
                    for (key, _), sim in zip(batch, fut.result()):
                        self._sims[key] = sim
            finally:
                if own_pool:
                    pool.shutdown()
            self.stats.sim_runs += len(missing)
            obs.count("engine.sim.run", len(missing))
        self.stats.sim_hits += hits
        if hits:
            obs.count("engine.sim.hit", hits)
        return [self._sims[key] for key in keys]

    def sweep(
        self,
        workload: Workload,
        cores: Iterable[int],
        config_factory: Callable[[int], HierarchyConfig],
        *,
        seed: int = 0,
    ) -> list[SimResult]:
        """One simulation per core count — the shared Step-3 sweep loop."""
        return [self.simulate(workload, c, config_factory(c), seed=seed)
                for c in cores]

    def sweep_parallel(
        self,
        workload: Workload,
        cores: Iterable[int],
        config_factory: Callable[[int], HierarchyConfig],
        *,
        seed: int = 0,
        max_workers: int | None = None,
        executor: Executor | None = None,
    ) -> list[SimResult]:
        """:meth:`sweep` as one :meth:`simulate_batch` call, its missing
        cells fanned across ``executor`` or a thread pool of
        ``max_workers`` when either is given; results, memo and stats
        equal the sequential sweep's."""
        return self.simulate_batch(
            workload,
            [(c, config_factory(c)) for c in cores],
            seed=seed,
            max_workers=max_workers,
            executor=executor,
        )

    # ---- introspection --------------------------------------------------
    @property
    def cells(self) -> int:
        """Distinct simulation cells materialized so far."""
        return len(self._sims)

    def clear(self) -> None:
        self._traces.clear()
        self._sims.clear()
        self._fingerprints.clear()
        self.stats = EngineStats()
