"""Trace-driven cache hierarchy simulator (counterpart of ``repro.core.cachesim``).

Extracts the paper's three architecture-dependent metrics (AI, LLC MPKI,
LFMR) from word-address traces.  Models:

- Set-associative LRU caches with 64 B lines (paper Table 1 geometry):
  per-core private L1 32 KB/8-way and L2 256 KB/8-way, shared L3 8 MB/16-way
  (fixed) or the §3.4 NUCA variant (2 MB/core).
- A stream prefetcher (Palacharla & Kessler): ``degree``-deep, N stream
  buffers trained on L1-miss streams, prefetching into L2.
- The NDP configuration: a single 32 KB L1, misses go straight to DRAM.

Multicore behaviour is simulated from a *per-thread* trace: private L1/L2
are per-core constants, and shared-L3 contention is expressed through
``l3_factor`` — the fraction of the shared LLC effectively available to the
modeled thread (1.0 for a lone thread or fully shared data; ~1/cores for
partitioned data).

Three backends, counter-identical cell for cell: ``reference`` (the
per-line loop in this module), ``vectorized`` (:mod:`.cachesim_vec`, the
default; host NumPy) and ``cuda`` (the vectorized backend with its window
scan in the ``window_scan`` CUDA kernel; the counterpart of the
reference's ``jax`` backend).  ``cuda`` raises without a card: it never
falls back to NumPy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

LINE_BYTES = 64
WORDS_PER_LINE = LINE_BYTES // 8

BACKENDS = ("reference", "vectorized", "cuda")

__all__ = [
    "CacheLevelConfig",
    "HierarchyConfig",
    "SimResult",
    "simulate",
    "simulate_batch",
    "simulate_many",
    "host_config",
    "ndp_config",
    "BACKENDS",
    "default_backend",
    "WORDS_PER_LINE",
]


def default_backend() -> str:
    """Backend used when ``backend=None``: ``REPRO_SIM_BACKEND``
    (``reference`` | ``vectorized`` | ``cuda``) overrides the built-in
    vectorized default.  The reference package's ``jax`` (its jitted
    window scan) is ``cuda`` here, so asking for ``jax`` raises rather
    than running another backend under its name."""
    backend = os.environ.get("REPRO_SIM_BACKEND", "vectorized")
    if backend == "jax":
        raise ValueError(
            "REPRO_SIM_BACKEND='jax': the port runs the window scan on the "
            "card as backend 'cuda'; use 'cuda', 'vectorized' or "
            "'reference'")
    if backend not in BACKENDS:
        raise ValueError(
            f"REPRO_SIM_BACKEND={backend!r} invalid; expected one of "
            f"{BACKENDS}")
    return backend


@dataclass(frozen=True)
class CacheLevelConfig:
    size_bytes: int
    ways: int

    @property
    def sets(self) -> int:
        return max(1, self.size_bytes // (LINE_BYTES * self.ways))

    def scaled(self, factor: float) -> "CacheLevelConfig":
        return CacheLevelConfig(
            max(LINE_BYTES * self.ways, int(self.size_bytes * factor)), self.ways
        )


@dataclass(frozen=True)
class HierarchyConfig:
    """Host = [L1, L2, L3]; NDP = [L1] only."""

    levels: tuple[CacheLevelConfig, ...]
    prefetcher: bool = False
    prefetch_degree: int = 2
    prefetch_streams: int = 16
    name: str = "host"
    shared_llc: bool = True  # last level is shared -> subject to l3_factor


def host_config(
    cores: int = 1,
    *,
    prefetcher: bool = False,
    nuca_mb_per_core: float | None = None,
) -> HierarchyConfig:
    """Paper Table 1 host config (per-thread view).

    Private L1/L2 are per-core and do not change with ``cores``; the shared
    L3 is fixed at 8 MB, or ``nuca_mb_per_core * cores`` in the §3.4 NUCA
    configuration.
    """
    l3_bytes = (
        int(nuca_mb_per_core * cores * 2**20)
        if nuca_mb_per_core is not None
        else 8 * 2**20
    )
    return HierarchyConfig(
        levels=(
            CacheLevelConfig(32 * 1024, 8),
            CacheLevelConfig(256 * 1024, 8),
            CacheLevelConfig(l3_bytes, 16),
        ),
        prefetcher=prefetcher,
        name=("host+pf" if prefetcher else "host")
        + ("" if nuca_mb_per_core is None else "+nuca"),
    )


def ndp_config(cores: int = 1) -> HierarchyConfig:
    del cores  # per-thread view: one 32 KB L1 per NDP core
    return HierarchyConfig(
        levels=(CacheLevelConfig(32 * 1024, 8),), name="ndp", shared_llc=False
    )


@dataclass
class SimResult:
    name: str
    accesses: int                  # word-level memory references
    instructions: int              # total dynamic instructions
    ai: float                      # arithmetic/logic ops per L1 line access
    level_misses: tuple[int, ...]  # misses at each level (L1[, L2, L3])
    level_hits: tuple[int, ...]
    lines_touched: int             # distinct lines referenced
    prefetch_issued: int = 0
    prefetch_useful: int = 0

    @property
    def l1_misses(self) -> int:
        return self.level_misses[0]

    @property
    def llc_misses(self) -> int:
        return self.level_misses[-1]

    @property
    def lfmr(self) -> float:
        """Last-to-First Miss Ratio = LLC misses / L1 misses (paper §2.4.1)."""
        return self.llc_misses / self.l1_misses if self.l1_misses else 0.0

    @property
    def mpki(self) -> float:
        """LLC misses per kilo-instruction."""
        if not self.instructions:
            return 0.0
        return 1000.0 * self.llc_misses / self.instructions

    @property
    def dram_lines(self) -> int:
        # Demand misses; prefetch traffic is accounted separately.
        return self.llc_misses

    @property
    def dram_bytes(self) -> int:
        return (self.llc_misses + self.prefetch_issued) * LINE_BYTES


def broadcast_l3_factor(l3_factor, n: int) -> list[float]:
    """A scalar ``l3_factor`` is shared by all ``n`` configs; a sequence
    must match them one to one."""
    if isinstance(l3_factor, (int, float)):
        return [float(l3_factor)] * n
    factors = [float(f) for f in l3_factor]
    if len(factors) != n:
        raise ValueError(
            f"l3_factor sequence length {len(factors)} != {n} configs")
    return factors


def broadcast_names(names, n: int) -> list:
    """``None`` -> one ``None`` per config; a sequence must match the
    configs one to one."""
    if names is None:
        return [None] * n
    names = list(names)
    if len(names) != n:
        raise ValueError(f"names length {len(names)} != {n} configs")
    return names


def _check_backend(backend: str | None) -> str:
    if backend is None:
        return default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return backend


def _scan(backend: str) -> str | None:
    """The vectorized backend's window-scan option for ``backend``."""
    return "cuda" if backend == "cuda" else None


def simulate_many(requests, *, backend: str | None = None):
    """Run many ``(addresses, configs, opts)`` requests in one call.

    Each request is one trace with its hierarchy configs and the keyword
    arguments of :func:`simulate_batch` as an ``opts`` dict.  On the
    vectorized and cuda backends this is the cross-trace segmented forest
    walk (:func:`repro_torch.core.cachesim_vec.simulate_many`): same-geometry
    nodes from different traces share one stream-profile pass.  On the
    reference backend each request runs through the per-config loop;
    counters are identical either way.  Returns one ``list[SimResult]``
    per request.
    """
    backend = _check_backend(backend)
    if backend != "reference":
        from . import cachesim_vec  # deferred: cachesim_vec imports us

        return cachesim_vec.simulate_many(list(requests),
                                          scan=_scan(backend))
    return [
        simulate_batch(addresses, configs, backend="reference", **opts)
        for addresses, configs, opts in requests
    ]


def simulate_batch(
    addresses: np.ndarray,
    configs,
    *,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor=1.0,
    names=None,
    backend: str | None = None,
) -> list[SimResult]:
    """Run one trace through several hierarchy configs in one call.

    On the vectorized backend shared level prefixes are replayed once and
    same-set-count geometries share one capped stack-distance scan; on the
    reference backend it is the equivalent per-config loop, so the two
    stay counter-identical cell for cell.
    """
    backend = _check_backend(backend)
    if backend != "reference":
        from . import cachesim_vec  # deferred: cachesim_vec imports us

        return cachesim_vec.simulate_batch(
            addresses,
            configs,
            ai_ops_per_access=ai_ops_per_access,
            instr_per_access=instr_per_access,
            l3_factor=l3_factor,
            names=names,
            scan=_scan(backend),
        )
    configs = list(configs)
    factors = broadcast_l3_factor(l3_factor, len(configs))
    names = broadcast_names(names, len(configs))
    return [
        simulate(
            addresses,
            cfg,
            ai_ops_per_access=ai_ops_per_access,
            instr_per_access=instr_per_access,
            l3_factor=f,
            name=nm,
            backend="reference",
        )
        for cfg, f, nm in zip(configs, factors, names)
    ]


class _LRUCache:
    """Set-associative LRU cache over line addresses (functional model)."""

    __slots__ = ("sets", "ways", "_sets", "hits", "misses")

    def __init__(self, cfg: CacheLevelConfig):
        self.sets = cfg.sets
        self.ways = cfg.ways
        # dict preserves insertion order -> cheap LRU via pop/re-insert
        self._sets: list[dict[int, None]] = [dict() for _ in range(self.sets)]
        self.hits = 0
        self.misses = 0

    def access(self, line: int, *, count: bool = True) -> bool:
        s = self._sets[line % self.sets]
        if line in s:
            del s[line]  # refresh recency
            s[line] = None
            if count:
                self.hits += 1
            return True
        if count:
            self.misses += 1
        if len(s) >= self.ways:
            s.pop(next(iter(s)))  # evict LRU (first key)
        s[line] = None
        return False

    def contains(self, line: int) -> bool:
        return line in self._sets[line % self.sets]


class _StreamPrefetcher:
    """Stream-buffer prefetcher trained on L1 misses, filling L2."""

    def __init__(self, streams: int, degree: int):
        self.streams = streams
        self.degree = degree
        self._last: dict[int, int] = {}  # region -> last miss line
        self.issued = 0

    def on_l1_miss(self, line: int) -> list[int]:
        region = line >> 6
        prev = self._last.get(region)
        self._last[region] = line
        if len(self._last) > self.streams:
            self._last.pop(next(iter(self._last)))
        if prev is not None and 0 < line - prev <= 2:
            out = [line + i + 1 for i in range(self.degree)]
            self.issued += len(out)
            return out
        return []


def simulate(
    addresses: np.ndarray,
    config: HierarchyConfig,
    *,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor: float = 1.0,
    name: str | None = None,
    backend: str | None = None,
) -> SimResult:
    """Run a word-address trace through a cache hierarchy.

    ``ai_ops_per_access``: arithmetic/logic ops per memory reference (the
    numerator of the paper's AI metric).  ``instr_per_access``: total
    dynamic instructions per memory reference (the MPKI denominator).
    ``l3_factor``: effective fraction of the shared LLC available to this
    thread (contention model; ignored for NDP).
    """
    backend = _check_backend(backend)
    if backend != "reference":
        from . import cachesim_vec  # deferred: cachesim_vec imports us

        return cachesim_vec.simulate(
            addresses,
            config,
            ai_ops_per_access=ai_ops_per_access,
            instr_per_access=instr_per_access,
            l3_factor=l3_factor,
            name=name,
            scan=_scan(backend),
        )
    addr = np.asarray(addresses, dtype=np.int64)
    lines = addr // WORDS_PER_LINE

    level_cfgs = list(config.levels)
    if config.shared_llc and len(level_cfgs) >= 2 and l3_factor < 1.0:
        level_cfgs[-1] = level_cfgs[-1].scaled(l3_factor)
    levels = [_LRUCache(c) for c in level_cfgs]

    pf = (
        _StreamPrefetcher(config.prefetch_streams, config.prefetch_degree)
        if config.prefetcher and len(levels) >= 2
        else None
    )
    pf_useful = 0
    prefetched: set[int] = set()

    for line in lines.tolist():
        hit_level = None
        for li, cache in enumerate(levels):
            if cache.access(line):
                hit_level = li
                break
        if hit_level != 0 and pf is not None:
            if line in prefetched:
                pf_useful += 1
                prefetched.discard(line)
            for pline in pf.on_l1_miss(line):
                if levels[1].contains(pline):
                    pf.issued -= 1  # duplicate filter: already resident
                    continue
                levels[1].access(pline, count=False)
                prefetched.add(pline)
                if len(prefetched) > 4096:
                    prefetched.pop()

    n = int(addr.size)
    instructions = int(round(n * max(1.0, instr_per_access)))
    return SimResult(
        name=name or config.name,
        accesses=n,
        instructions=instructions,
        ai=float(ai_ops_per_access),
        level_misses=tuple(c.misses for c in levels),
        level_hits=tuple(c.hits for c in levels),
        lines_touched=int(np.unique(lines).size),
        prefetch_issued=pf.issued if pf else 0,
        prefetch_useful=pf_useful,
    )
