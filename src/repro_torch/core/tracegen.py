"""Synthetic DAMOV workload families and the workload records (counterpart
of ``repro.core.tracegen``).

A :class:`Workload` is a parameterized generator of per-thread word-address
traces: it receives the core count (strong scaling) and a seeded numpy
generator and returns a :class:`TraceSpec` carrying the trace plus the
contention metadata the Step-3 analysis needs.  The roster has two kinds:
captured kernels (:mod:`repro_torch.capture.kernels`, traces walked from
launches on the device) and the seven synthetic access-pattern families
here, host traces drawn with numpy from the seed exactly as the reference
draws them, so their addresses are byte-identical to its:

- ``stream``    (1a) sequential, huge footprint, no reuse;
- ``irregular`` (1a) random lines over a huge footprint;
- ``chase``     (1b) dependent random accesses at low memory intensity,
                MLP = 1, hot locals in L1;
- ``blocked``   (1c) per-thread tile swept repeatedly; it fits the private
                L2 once partitioned across many cores (LFMR decreases);
- ``contended`` (2a) shared block re-swept with short-distance reuse;
                the shared LLC thrashes as cores grow (LFMR rises);
- ``l1cap``     (2b) working set slightly above L1, short reuse, plus a
                thin streaming component;
- ``gemm``      (2c) L1-blocked, very high AI, negligible DRAM traffic.

The windowed temporal-locality metric (Eq. 2) weighs an address reused N
times by 2^floor(log2 N), so reuse runs of length 2^k + 1 maximize the
score; the run lengths below are chosen with that quantization in mind.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .cachesim import WORDS_PER_LINE

__all__ = ["TraceSpec", "Workload", "make_suite", "FAMILIES", "DEFAULT_REFS",
           "stable_name_seed"]


def stable_name_seed(name: str) -> int:
    """Deterministic per-workload RNG offset.

    Built on ``zlib.crc32`` rather than builtin ``hash()``, which is salted
    per interpreter run (PYTHONHASHSEED).
    """
    return zlib.crc32(name.encode("utf-8")) % 7919


@dataclass
class TraceSpec:
    """Per-thread trace + metadata for one (workload, cores) point."""

    addresses: np.ndarray      # word addresses
    l3_factor: float           # effective shared-LLC fraction for this thread
    mlp: float                 # intrinsic memory-level parallelism
    dram_rows_irregular: bool  # row-buffer locality hint for the timing model


@dataclass(frozen=True)
class Workload:
    name: str
    family: str
    expected_class: str
    ai_ops_per_access: float   # AI numerator (workload ALU/FP ops per ref)
    instr_per_access: float    # total dynamic instructions per ref (MPKI denom)
    gen: Callable[[int, np.random.Generator], TraceSpec]
    # True when gen ignores `cores` entirely (trace AND metadata, incl.
    # l3_factor): the engine then shares one trace across the core sweep.
    core_invariant: bool = False

    def trace(self, cores: int, seed: int = 0) -> TraceSpec:
        return self.gen(
            cores, np.random.default_rng(seed + stable_name_seed(self.name))
        )


# --------------------------------------------------------------------------
# Generators.  All sizes in words (8 B).
# --------------------------------------------------------------------------
_L1_WORDS = 32 * 1024 // 8          # 4096 words
_HOT_WORDS = 2048                   # 16 KB locals region (always L1-resident)


def _mix_hot_cold(hot: np.ndarray, cold: np.ndarray, every: int) -> np.ndarray:
    """Interleave: one `cold` ref every `every` refs, `hot` refs elsewhere."""
    n = hot.size + cold.size
    addr = np.empty(n, dtype=np.int64)
    cold_slots = np.arange(0, n, every)[: cold.size]
    mask = np.zeros(n, dtype=bool)
    mask[cold_slots] = True
    addr[mask] = np.resize(cold, int(mask.sum()))
    addr[~mask] = np.resize(hot, int((~mask).sum()))
    return addr


def _stream(total_words: int, n_refs: int):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        del cores  # single sweep: no reuse regardless of partitioning
        start = int(rng.integers(0, 2**28))
        addr = start + np.arange(n_refs, dtype=np.int64) % max(total_words, n_refs)
        return TraceSpec(addr, l3_factor=1.0, mlp=8.0, dram_rows_irregular=False)
    return gen


def _irregular(total_words: int, n_refs: int):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        del cores  # shared edge array: random lines across the whole footprint
        addr = rng.integers(0, total_words, size=n_refs, dtype=np.int64)
        return TraceSpec(addr, l3_factor=1.0, mlp=6.0, dram_rows_irregular=True)
    return gen


def _chase(total_words: int, n_refs: int, cold_every: int = 8):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        n_cold = n_refs // cold_every
        cold = rng.integers(_HOT_WORDS, total_words, size=n_cold, dtype=np.int64)
        hot = rng.integers(0, _HOT_WORDS, size=n_refs - n_cold, dtype=np.int64)
        addr = _mix_hot_cold(hot, cold, cold_every)
        return TraceSpec(addr, l3_factor=1.0, mlp=1.0, dram_rows_irregular=True)
    return gen


def _blocked(total_words: int, n_refs: int, tile_every: int = 8):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        # Per-thread tile (partitioned problem), swept cyclically one line
        # per tile reference.  At low core counts the tile exceeds every
        # cache; at high counts it fits the private L2 and LFMR collapses.
        tile_lines = max(total_words // cores // WORDS_PER_LINE, 8)
        n_tile = n_refs // tile_every
        tl = (np.arange(n_tile, dtype=np.int64) % tile_lines) * WORDS_PER_LINE
        hot = rng.integers(0, _HOT_WORDS, size=n_refs - n_tile, dtype=np.int64)
        addr = _mix_hot_cold(hot, 2**27 + tl, tile_every)
        return TraceSpec(addr, l3_factor=1.0 / cores, mlp=4.0,
                         dram_rows_irregular=False)
    return gen


def _contended(distinct_lines: int, run: int = 3, sweeps: int = 5):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        # Shared hot block: `distinct_lines` random lines, each re-touched
        # `run` times back-to-back (short-distance reuse -> high temporal
        # locality), and the whole block re-swept `sweeps` times (long-
        # distance reuse that only the shared LLC can capture).
        pool = rng.integers(0, 4 * distinct_lines, size=distinct_lines,
                            dtype=np.int64) * WORDS_PER_LINE
        one_sweep = np.repeat(pool, run)
        addr = np.tile(one_sweep, sweeps)
        return TraceSpec(addr, l3_factor=1.0 / cores, mlp=4.0,
                         dram_rows_irregular=False)
    return gen


def _l1cap(ws_words: int, n_refs: int, run: int = 5, stream_every: int = 10):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        n_stream = n_refs // stream_every
        n_hot = n_refs - n_stream
        base = rng.integers(0, ws_words, size=max(n_hot // run, 1),
                            dtype=np.int64)
        hot = np.repeat(base, run)[:n_hot]
        stream = 2**27 + np.arange(n_stream, dtype=np.int64)
        addr = _mix_hot_cold(hot, stream, stream_every)
        return TraceSpec(addr, l3_factor=1.0, mlp=4.0, dram_rows_irregular=False)
    return gen


def _gemm(block_words: int, n_refs: int, run: int = 9):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        base = rng.integers(0, block_words, size=max(n_refs // run, 1),
                            dtype=np.int64)
        addr = np.repeat(base, run)[:n_refs]
        return TraceSpec(addr, l3_factor=1.0, mlp=4.0, dram_rows_irregular=False)
    return gen


# --------------------------------------------------------------------------
# The suite.
# --------------------------------------------------------------------------
# References per trace.  The vectorized cachesim backend made the Step-3
# sweep loop cheap enough to grow this from the original 60k to 250k,
# which tightens the LFMR/MPKI estimates toward the paper's reported class
# boundaries (cold misses stop dominating the shorter traces).
DEFAULT_REFS = 250_000
_N = DEFAULT_REFS

FAMILIES: dict[str, str] = {
    "stream": "1a", "irregular": "1a", "chase": "1b", "blocked": "1c",
    "contended": "2a", "l1cap": "2b", "gemm": "2c",
}


def make_suite(refs: int = _N, *, variants: int = 1, seed: int = 0) -> list[Workload]:
    """Build the synthetic DAMOV suite.

    ``variants > 1`` adds jittered clones of every family (used by the §3.5
    held-out validation benchmark, mirroring the paper's 44-train /
    100-validate split).
    """
    rng = np.random.default_rng(seed)
    out: list[Workload] = []

    # Families whose generators ignore `cores` (addresses and l3_factor
    # alike): stream/irregular share the whole footprint, chase's hot
    # locals and l1cap/gemm's working sets are per-thread constants.
    # blocked partitions its tile per core and contended scales l3_factor.
    invariant = {"stream", "irregular", "chase", "l1cap", "gemm"}

    def add(name, family, ai, ipa, gen):
        out.append(Workload(name, family, FAMILIES[family], ai, ipa, gen,
                            core_invariant=family in invariant))

    for v in range(variants):
        tag = "" if v == 0 else f".v{v}"
        j = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
        big = int(64 * 2**20 // 8 * j(0.8, 1.6))       # ~64 MiB footprint

        add(f"STRCpy{tag}", "stream", j(0.3, 0.8), j(1.5, 2.5),
            _stream(big, refs))
        add(f"STRTriad{tag}", "stream", j(0.8, 1.8), j(1.8, 2.8),
            _stream(big, refs))
        add(f"LIGPrkEmd{tag}", "irregular", j(0.8, 1.8), j(2.0, 3.0),
            _irregular(big, refs))
        add(f"HSJNPO{tag}", "irregular", j(0.6, 1.4), j(2.0, 3.0),
            _irregular(big // 2, refs))
        add(f"CHAHsti{tag}", "chase", j(0.5, 1.5), j(14.0, 22.0),
            _chase(big, refs))
        add(f"PLYalu{tag}", "chase", j(0.5, 1.5), j(14.0, 20.0),
            _chase(big // 2, refs))
        add(f"DRKRes{tag}", "blocked", j(0.6, 1.6), j(12.0, 18.0),
            _blocked(int(12 * 2**20 // 8 * j(0.8, 1.3)), 2 * refs))
        add(f"PRSFlu{tag}", "blocked", j(0.6, 1.6), j(12.0, 18.0),
            _blocked(int(48 * 2**20 // 8 * j(0.8, 1.3)), 2 * refs))
        add(f"PLYGramSch{tag}", "contended", j(0.8, 2.0), j(9.0, 14.0),
            _contended(int(8000 * j(0.8, 1.3))))
        add(f"SPLFftRev{tag}", "contended", j(0.8, 2.0), j(9.0, 14.0),
            _contended(int(6000 * j(0.8, 1.3)), run=3, sweeps=6))
        # Working set slightly above L1 (run-9 short reuse keeps most refs
        # L1-resident; the stream component supplies the paper's medium
        # LFMR and makes host vs NDP latency comparable -> perf parity).
        add(f"PLYgemver{tag}", "l1cap", j(0.8, 2.0), j(6.0, 12.0),
            _l1cap(int(_L1_WORDS * j(1.2, 2.2)), refs, run=9, stream_every=6))
        add(f"SPLLucb{tag}", "l1cap", j(0.8, 2.0), j(6.0, 12.0),
            _l1cap(int(_L1_WORDS * j(1.2, 2.0)), refs, run=9, stream_every=6))
        # Block sized just above L1 (fits L2) so repeat misses hit L2 and
        # LFMR is low, as the paper reports for Class 2c.
        add(f"HPGSpm{tag}", "gemm", j(12.0, 24.0), j(16.0, 30.0),
            _gemm(int(_L1_WORDS * j(1.5, 3.0)), refs))
        add(f"RODNw{tag}", "gemm", j(12.0, 44.0), j(16.0, 30.0),
            _gemm(int(_L1_WORDS * j(1.5, 3.0)), refs))

    return out
