"""Memoized simulation engine (a minimal counterpart of
``repro.study.engine``).

One trace per ``(workload.name, cores, seed)`` and one simulation per
``(workload.name, seed, cores, hierarchy)``.  A core-invariant workload
shares its 1-core trace across the whole sweep, so the per-trace memo of
:mod:`repro_torch.core.cachesim_vec` answers every sweep point from one
array.  Workload identity is its name: build one engine per roster.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.core import cachesim
from repro_torch.core.cachesim import HierarchyConfig, SimResult
from repro_torch.core.tracegen import TraceSpec, Workload

__all__ = ["SimEngine"]


class SimEngine:
    """Trace and simulation memo shared by the roster's consumers."""

    def __init__(self, *, backend: str = "vectorized") -> None:
        if backend not in cachesim.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of "
                f"{cachesim.BACKENDS}")
        self.backend = backend
        self._traces: dict[tuple[str, int, int], TraceSpec] = {}
        self._sims: dict[tuple, SimResult] = {}

    @staticmethod
    def _trace_cores(workload: Workload, cores: int) -> int:
        return 1 if workload.core_invariant else cores

    def trace(self, workload: Workload, cores: int, *,
              seed: int = 0) -> TraceSpec:
        """Per-thread trace for one (workload, cores, seed), memoized."""
        key = (workload.name, self._trace_cores(workload, cores), seed)
        spec = self._traces.get(key)
        if spec is None:
            spec = self._traces[key] = workload.trace(cores, seed=seed)
        return spec

    def simulate_batch(
        self,
        workload: Workload,
        cells: Iterable[tuple[int, HierarchyConfig]],
        *,
        seed: int = 0,
    ) -> list[SimResult]:
        """Run (or recall) many ``(cores, hierarchy)`` cells of one
        workload; the missing cells of each trace go to the backend in one
        batched pass."""
        cells = list(cells)
        keys = [(workload.name, seed, c, h) for c, h in cells]
        groups: dict[int, list[tuple[tuple, HierarchyConfig]]] = {}
        for key, (c, h) in zip(keys, cells):
            if key not in self._sims:
                group = groups.setdefault(self._trace_cores(workload, c), [])
                if key not in (k for k, _ in group):
                    group.append((key, h))
        for batch in groups.values():
            spec = self.trace(workload, batch[0][0][2], seed=seed)
            sims = cachesim.simulate_batch(
                spec.addresses,
                [h for _, h in batch],
                ai_ops_per_access=workload.ai_ops_per_access,
                instr_per_access=workload.instr_per_access,
                l3_factor=spec.l3_factor,
                backend=self.backend,
            )
            for (key, _), sim in zip(batch, sims):
                self._sims[key] = sim
        return [self._sims[key] for key in keys]
