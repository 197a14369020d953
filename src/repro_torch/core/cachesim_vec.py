"""Vectorized NumPy backend of the cache simulator
(counterpart of ``repro.core.cachesim_vec``).

Produces :class:`~repro_torch.core.cachesim.SimResult`\\ s whose hit/miss
counters are exactly those of the reference per-line loop in
:mod:`repro_torch.core.cachesim`.

LRU is a *stack algorithm*: a set-associative LRU cache holds, per set, the
``ways`` most recently touched distinct lines, so an access hits iff the
number of distinct lines touched in its set since the previous touch of the
same line (its *stack distance*) is ``< ways``.  Simulation becomes
counting:

1. Consecutive same-line accesses collapse: every repeat is a hit.
2. First touches of a line are cold misses.
3. A set whose lifetime distinct-line count is ``<= ways`` never evicts, so
   every revisit in it hits.
4. The remaining *contested revisits* are resolved with a set-partitioned
   window scan in geometrically growing chunks, stopping a query as soon as
   its count reaches the associativity cap (miss) or its window ends (hit).

Steps 1-2 depend only on the demand stream and are factored into a
:class:`StreamProfile` computed once per stream; several configs sharing a
set count are answered from one scan capped at their largest ``ways``.

Segmented batching (:func:`simulate_many`)
------------------------------------------
A :class:`StreamProfile` also takes *segment offsets*: many traces stacked
into one concatenated stream, every stream-dependent step run once over
the whole roster.  Boundaries reset reuse windows (the collapse never
merges across one, the previous-occurrence sort groups by ``(segment,
line)``, the "never evicts" test counts distinct lines per ``(segment,
set)``), and since segments are contiguous in time every reuse window
lies in one segment, so the window scan is unchanged and counters equal
the per-trace path's.  :func:`simulate_many` walks the hierarchy forests
of many (trace, configs) requests depth by depth and runs one segmented
profile and scan per unique set count across the traces that still need
it: one profile pass per unique geometry, not one per trace
(``profile.scan <= profile.geom``).

Multi-level hierarchies factor exactly: level N+1's demand stream is level
N's ordered miss sub-sequence.  :func:`simulate_batch` walks the requested
hierarchies as a tree of level prefixes, and a per-trace memo
(:class:`_TraceMemo`, keyed on array identity and revalidated by CRC)
keeps every prefix's miss stream and profile across calls, bounded by
resident bytes (``memo.bytes`` is its gauge).

The window scan on the card (``scan="cuda"``)
---------------------------------------------
The scan's inner step is a (rows x chunk) gather-compare-reduce.  Under
``scan="cuda"`` (the ``cuda`` simulation backend) the whole chunk loop
runs on the card (:func:`repro_torch.kernels.window_scan.scan`): the
set-major ``q`` array and the queries' (lo, threshold, hi) go over once
per scan, each chunk step is one ``window_scan`` kernel launch over the
live rows plus their compaction, and the counts come back once.  It
replaces the reference's jitted ``jax.numpy`` scan (``scan="jax"``).
There is no NumPy fallback: without a card the scan raises.  Counters
equal the NumPy scan's.

Prefetcher configs replay the L2 + prefetcher sequentially over the
vectorized L1's miss stream (same algorithm, same order as the reference),
and their LLC levels replay vectorized over the emitted L2 miss stream,
shared by every LLC geometry behind the same prefetcher.
"""

from __future__ import annotations

import contextlib
import os
import threading
import zlib

import numpy as np

from repro_torch import obs

from .cachesim import (
    WORDS_PER_LINE,
    HierarchyConfig,
    SimResult,
    broadcast_l3_factor,
    broadcast_names,
)

__all__ = ["simulate", "simulate_batch", "simulate_many", "StreamProfile"]


class StreamProfile:
    """Geometry-independent factorization of one (or many) demand streams.

    Holds everything :func:`_replay_ways` needs that does not depend on
    ``sets``/``ways``: the consecutive-duplicate collapse, the previous
    occurrence of each collapsed access, the cold (first-touch) mask and
    the distinct-line count.  Computed once per stream; every cache
    geometry the stream flows through reuses it.

    With ``seg_offsets`` (start index of each segment in ``lines``,
    first entry 0) the profile covers a *concatenation* of independent
    streams: reuse windows never cross a boundary — the collapse keeps
    every segment-first ref, and ``prev`` groups by ``(segment, line)``
    so each segment's first touch of a line is cold.  ``seg`` maps every
    collapsed ref to its segment and ``seg_distinct`` counts distinct
    lines per segment, so per-segment results slice out exactly.
    """

    __slots__ = ("n", "keep", "cl", "prev", "cold", "distinct",
                 "seg", "nseg", "seg_distinct")

    def __init__(self, lines: np.ndarray,
                 seg_offsets: np.ndarray | None = None) -> None:
        n = int(lines.size)
        # Structural counters (the README's glossary): every profile
        # construction is one ``profile.scan``; segmented construction
        # covers many (trace, geometry) cells at once, which is why a cold
        # run has ``profile.scan <= profile.geom``.
        obs.count("profile.scan")
        obs.count("profile.refs", n)
        nseg = 1 if seg_offsets is None else max(int(len(seg_offsets)), 1)
        if nseg > 1:
            obs.count("profile.segments", nseg)
        self.nseg = nseg
        if n == 0:
            self.n = 0
            self.keep = np.zeros(0, dtype=bool)
            self.cl = np.asarray(lines, dtype=np.int64)[:0]
            self.prev = np.zeros(0, dtype=np.int64)
            self.cold = np.zeros(0, dtype=bool)
            self.distinct = 0
            self.seg = None if seg_offsets is None else np.zeros(
                0, dtype=np.int64)
            self.seg_distinct = None if seg_offsets is None else np.zeros(
                nseg, dtype=np.int64)
            return
        self.n = n

        # -- collapse consecutive duplicates (guaranteed hits) -------------
        keep = np.empty(n, dtype=bool)
        keep[0] = True
        np.not_equal(lines[1:], lines[:-1], out=keep[1:])
        if seg_offsets is not None:
            # a segment's first ref is never a repeat of the previous
            # segment's last line: boundaries reset the collapse
            keep[seg_offsets[seg_offsets < n]] = True
        cl = lines[keep]
        m = int(cl.size)

        if seg_offsets is None:
            seg_c = None
        else:
            # collapsed ref -> owning segment (duplicate offsets = empty
            # segments resolve to the non-empty owner via side="right")
            seg_c = np.searchsorted(
                seg_offsets, np.flatnonzero(keep), side="right") - 1

        # -- previous occurrence of the same line (collapsed index) --------
        # Stable grouping by (segment, line): pack (group, time) into one
        # int64 key when it fits (one fast introsort); otherwise fall back
        # to lexsort.  prev is segment-local by construction, so the first
        # touch in each segment is cold.
        shift = max(m - 1, 1).bit_length()
        cmax = int(cl.max())
        cmin = int(cl.min())
        if seg_c is None:
            gkey = cl
            packable = cmin >= 0 and cmax < (1 << (62 - shift))
        else:
            span = cmax - cmin + 1
            packable = nseg * span < (1 << (62 - shift))
            gkey = (seg_c * span + (cl - cmin)) if packable else None
        if gkey is not None and packable:
            order = np.argsort((gkey << shift) | np.arange(m, dtype=np.int64))
            sorted_g = gkey[order]
        elif seg_c is None:
            order = np.lexsort((np.arange(m, dtype=np.int64), cl))
            sorted_g = cl[order]
        else:
            order = np.lexsort((np.arange(m, dtype=np.int64), cl, seg_c))
            sorted_g = None  # compare (seg, line) pairwise below
        if sorted_g is not None:
            same = sorted_g[1:] == sorted_g[:-1]
        else:
            same = ((cl[order][1:] == cl[order][:-1])
                    & (seg_c[order][1:] == seg_c[order][:-1]))
        prev = np.full(m, -1, dtype=np.int64)
        prev[order[1:][same]] = order[:-1][same]

        self.keep = keep
        self.cl = cl
        self.prev = prev
        self.cold = prev < 0
        self.distinct = int(self.cold.sum())
        self.seg = seg_c
        if seg_c is None:
            self.seg_distinct = None
        else:
            self.seg_distinct = np.bincount(
                seg_c[self.cold], minlength=nseg)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the profile's arrays (memo accounting)."""
        total = self.keep.nbytes + self.cl.nbytes + self.prev.nbytes
        total += self.cold.nbytes
        if self.seg is not None:
            total += self.seg.nbytes
        return total


def _replay_ways(
    profile: StreamProfile, sets: int, ways_list: list[int],
    scan: str | None = None,
) -> dict[int, np.ndarray]:
    """Exact LRU hit masks for one set count at several associativities.

    The expensive part — the contested-revisit stack-distance scan — runs
    once, capped at ``max(ways_list)``; each requested ``ways`` is answered
    by thresholding the capped distances (LRU inclusion).  Returns
    ``{ways: hit_mask}`` with every mask aligned to the profile's original
    (uncollapsed) stream.
    """
    ways_list = sorted(set(int(w) for w in ways_list))
    m = int(profile.cl.size)
    hit_c: dict[int, np.ndarray] = {w: np.zeros(m, dtype=bool)
                                    for w in ways_list}
    revisit = np.flatnonzero(~profile.cold)
    if revisit.size:
        cl = profile.cl
        sidx = cl % sets
        # -- sets that never fill past `ways` never evict -------------------
        # (per (segment, set) under a segmented profile: a revisit's whole
        # reuse window lies inside its own segment)
        if profile.seg is None:
            per_set_distinct = np.bincount(sidx[profile.cold],
                                           minlength=sets)
            psd_r = per_set_distinct[sidx[revisit]]
        else:
            skey = profile.seg * sets + sidx
            table = np.bincount(skey[profile.cold],
                                minlength=profile.nseg * sets)
            psd_r = table[skey[revisit]]
        min_w, max_w = ways_list[0], ways_list[-1]
        easy = psd_r <= min_w
        queries = revisit[~easy]
        sd = None
        if queries.size:
            sd = _contested_sd(cl, sidx, profile.prev, queries, sets,
                               cap=max_w, skip_below=min_w, scan=scan)
        for w in ways_list:
            hc = hit_c[w]
            hc[revisit[easy]] = True
            if sd is not None:
                # A window in a (segment, set) with <= w lifetime distinct
                # lines has stack distance < w by construction, so
                # thresholding the capped distance also covers the
                # per-ways easy cases.
                hc[queries[sd < w]] = True

    out = {}
    for w in ways_list:
        hit_mask = np.ones(profile.n, dtype=bool)
        hit_mask[profile.keep] = hit_c[w]
        out[w] = hit_mask
    return out


def _scan_device():
    """The card the ``cuda`` scan runs on; raises without one."""
    from repro_torch.device import resolve_device

    return resolve_device("cuda")


def _contested_sd(cl, sidx, prev, queries, sets, cap, skip_below,
                  scan: str | None = None) -> np.ndarray:
    """Capped stack distances for revisits in sets that do evict.

    Works in a set-major layout so every set's access history is one
    contiguous slab, then counts window-first accesses per query window in
    vectorized, geometrically growing chunks.  The returned count ``c``
    satisfies ``c == stack distance`` whenever the distance is ``< cap``
    and ``c >= cap`` otherwise (the scan early-exits at ``cap``), so
    ``c < w`` decides hit/miss exactly for every ``w <= cap``.  Windows
    shorter than ``skip_below`` are not scanned at all: their distance is
    bounded by the window length, hence ``< skip_below`` (a hit at every
    requested associativity); their count is reported as 0.

    Under a segmented profile nothing changes: segments are contiguous in
    time, so every slot of a query's window belongs to the query's own
    segment, and cold accesses inside the window (``q == -1``) count as
    window-first exactly as they should.

    ``scan="cuda"`` runs the chunk loop on the card
    (``window_scan.ops.scan``: the queries' windows go over once, each
    chunk step is one ``window_scan`` kernel launch and the step's
    compaction, the counts come back once; no NumPy fallback: it raises
    without a card); counts are identical either way.
    """
    m = int(cl.size)
    if sets <= (1 << 8):
        sort_key = sidx.astype(np.uint8)      # radix sort
    elif sets <= (1 << 16):
        sort_key = sidx.astype(np.uint16)
    else:
        sort_key = sidx
    order = np.argsort(sort_key, kind="stable")
    pos = np.empty(m, dtype=np.int64)       # global idx -> set-major slot
    pos[order] = np.arange(m, dtype=np.int64)
    starts = np.zeros(sets + 1, dtype=np.int64)
    np.cumsum(np.bincount(sidx, minlength=sets), out=starts[1:])
    loc = pos - starts[sidx]                # position within own set
    # q[slot]: set-local index of that access's previous occurrence (-1 if
    # cold).  Same line -> same set, so prev's local index is comparable.
    q_global = np.where(prev >= 0, loc[prev], -1)
    # set-local indices fit int32 far past any roster stream; the narrow
    # dtype halves the gather-compare traffic of the window scan below
    qdt = np.int32 if m < (1 << 31) else np.int64
    q = np.empty(m, dtype=qdt)
    q[pos] = q_global

    # Window of query i: set-local (q_i, loc_i), i.e. set-major slots
    # [pos[prev[i]]+1, pos[i]).  Window-first accesses j are those with
    # q[j] <= q_i; their count is the stack distance.
    threshold = q_global[queries].astype(qdt)
    win_lo = pos[prev[queries]] + 1
    win_hi = pos[queries]

    if scan == "cuda":
        from repro_torch.kernels.window_scan import ops as window_scan

        obs.count("scan.cuda")
        return window_scan.scan(window_scan.to_device(q, _scan_device()),
                                win_lo, threshold, win_hi, skip_below, cap)

    sd = np.zeros(queries.size, dtype=np.int64)
    # stack distance <= window length: windows below the smallest
    # associativity hit everywhere without scanning
    live = np.flatnonzero(win_hi - win_lo >= skip_below)

    chunk = max(int(skip_below), 1)
    while live.size:
        remaining = win_hi[live] - win_lo[live]
        ending = remaining <= chunk

        enders = live[ending]
        if enders.size:
            # window finishes inside this chunk: masked gather (trimmed to
            # the widest remainder), then the count is final
            lo = win_lo[enders]
            span = win_hi[enders] - lo
            offs = np.arange(int(span.max()), dtype=np.int64)
            idx = lo[:, None] + offs
            first = ((np.take(q, idx, mode="clip")
                      <= threshold[enders][:, None])
                     & (offs < span[:, None]))
            sd[enders] += first.sum(axis=1)

        live = live[~ending]
        if live.size:
            # full-chunk rows: no bounds mask needed (remaining > chunk)
            offs = np.arange(chunk, dtype=np.int64)
            idx = win_lo[live][:, None] + offs
            sd[live] += (np.take(q, idx, mode="clip")
                         <= threshold[live][:, None]).sum(axis=1)
            win_lo[live] += chunk
            live = live[sd[live] < cap]   # monotone: >= cap is a miss at
        chunk *= 4                        # every requested associativity
    return sd


def _replay_level(lines: np.ndarray, sets: int, ways: int) -> tuple[np.ndarray, int]:
    """Exact LRU hit mask for one cache level (single-geometry wrapper)."""
    profile = StreamProfile(lines)
    mask = _replay_ways(profile, sets, [ways])[ways]
    return mask, profile.distinct


def _effective_levels(config: HierarchyConfig, l3_factor: float):
    level_cfgs = list(config.levels)
    if config.shared_llc and len(level_cfgs) >= 2 and l3_factor < 1.0:
        level_cfgs[-1] = level_cfgs[-1].scaled(l3_factor)
    return level_cfgs


def _plans_for(configs, factors) -> list[tuple]:
    """Per-request node plans: LRU levels are ``(sets, ways)``; a
    prefetcher config replaces its L2 with a ``("pf", sets, ways, degree,
    streams)`` node — the sequential L2+prefetcher replay — and its
    remaining LLC levels stay vectorized over that node's miss stream."""
    plans: list[tuple] = []
    for cfg, f in zip(configs, factors):
        level_cfgs = _effective_levels(cfg, f)
        if cfg.prefetcher and len(level_cfgs) >= 2:
            plan = ((level_cfgs[0].sets, level_cfgs[0].ways),
                    ("pf", level_cfgs[1].sets, level_cfgs[1].ways,
                     cfg.prefetch_degree, cfg.prefetch_streams),
                    *((c.sets, c.ways) for c in level_cfgs[2:]))
        else:
            plan = tuple((c.sets, c.ways) for c in level_cfgs)
        plans.append(plan)
    return plans


# --------------------------------------------------------------------------
# Per-trace memo: profiles + per-level results keyed by geometry prefix.
# --------------------------------------------------------------------------
class _TraceMemo:
    """Reusable state for one trace array across hierarchies and calls.

    A characterization sweep runs the *same* trace array through many
    hierarchy variants (host / host+pf / NDP / NUCA, several l3_factors)
    that share level prefixes — all share the 32 KB/8-way L1, the host
    variants share L1+L2, and every LLC geometry consumes the same L2-miss
    stream.  The memo stores, per level *prefix* (a tuple of
    ``(sets, ways)`` LRU nodes and ``("pf", sets, ways, degree, streams)``
    prefetcher nodes):

    - ``levels[prefix]``: the (hit count, miss stream) of the prefix's
      last node — the miss stream is the next level's demand stream;
    - ``profiles[prefix]``: the :class:`StreamProfile` of the demand
      stream entering the next level, shared by every geometry simulated
      at that depth;
    - ``pf_extras[prefix]``: a prefetcher node's (issued, useful)
      counters;
    - ``root_distinct``: the trace's distinct-line count, filled by
      whichever path computes it first (a root profile or a segmented
      root scan's per-segment count) so ``lines_touched`` never forces a
      redundant profile pass.

    Keyed on the address array's *identity* (the memoized SimEngine hands
    out one ndarray per trace); a CRC of the full buffer is re-checked on
    every lookup (~100x cheaper than the replay it saves), so a caller
    that mutates its array in place gets a recompute, not stale counters.
    ``lock`` serializes computation per trace — concurrent
    ``SimEngine.simulate_batch`` workers on *different* traces proceed in
    parallel, while two workers on the same trace share one computation
    instead of duplicating it.
    """

    __slots__ = ("ref", "crc", "lines", "profiles", "levels", "pf_extras",
                 "root_distinct", "lock")

    def __init__(self, addr: np.ndarray) -> None:
        self.ref = addr
        self.crc = _fingerprint(addr)
        self.lines: np.ndarray | None = None
        self.profiles: dict[tuple, StreamProfile] = {}
        self.levels: dict[tuple, tuple[int, np.ndarray]] = {}
        self.pf_extras: dict[tuple, tuple[int, int]] = {}
        self.root_distinct: int | None = None
        self.lock = threading.RLock()

    def nbytes(self) -> int:
        """Resident bytes of memo-owned derived arrays (the eviction
        budget's unit; the caller-owned trace array is not counted)."""
        total = 0 if self.lines is None else self.lines.nbytes
        for p in self.profiles.values():
            total += p.nbytes
        for _, miss in self.levels.values():
            total += miss.nbytes
        return total

    def stream(self, prefix: tuple) -> np.ndarray:
        """Demand stream entering the node after ``prefix``."""
        if not prefix:
            if self.lines is None:
                self.lines = self.ref // WORDS_PER_LINE
            return self.lines
        return self.levels[prefix][1]

    def profile(self, prefix: tuple) -> StreamProfile:
        p = self.profiles.get(prefix)
        if p is None:
            obs.count("profile.geom")
            with obs.span("sim.profile", depth=len(prefix)):
                p = StreamProfile(self.stream(prefix))
            self.profiles[prefix] = p
            if not prefix:
                self.root_distinct = p.distinct
        else:
            obs.count("profile.reuse")
        return p

    def results(self, prefix: tuple, sets: int, ways_list: list[int],
                scan: str | None = None) -> dict[int, tuple[int, np.ndarray]]:
        """(hits, miss stream) for each ``ways`` at one (prefix, sets).

        Missing associativities are computed in one capped scan; already
        memoized ones are recalled.  The caller must have materialized
        ``prefix`` itself (parents are walked root-first).
        """
        out: dict[int, tuple[int, np.ndarray]] = {}
        missing: list[int] = []
        for w in dict.fromkeys(ways_list):  # dedupe, keep order
            got = self.levels.get(prefix + ((sets, w),))
            if got is not None:
                out[w] = got
                obs.count("node.reuse")
            else:
                missing.append(w)
        if missing:
            obs.count("node.compute", len(missing))
            stream = self.stream(prefix)
            with obs.span("sim.scan", sets=sets, ways=len(missing),
                          depth=len(prefix)):
                masks = _replay_ways(self.profile(prefix), sets, missing,
                                     scan=scan)
            for w in missing:
                mask = masks[w]
                res = (int(mask.sum()), stream[~mask])
                self.levels[prefix + ((sets, w),)] = res
                out[w] = res
        return out

    def pf_result(self, prefix: tuple,
                  node: tuple) -> tuple[int, np.ndarray, int, int]:
        """(L2 hits, L2-miss stream, issued, useful) for one prefetcher
        node over the ``prefix`` miss stream, memoized.

        All LLC variants behind the same (L2 geometry, prefetcher
        parameters) share this one sequential replay — the prefetcher's
        feedback loop stops at L2, so the emitted demand-miss stream is
        LLC-independent.
        """
        key = prefix + (node,)
        got = self.levels.get(key)
        if got is None:
            obs.count("pf.replay")
            _, sets, ways, degree, streams = node
            with obs.span("sim.pf_replay", sets=sets, ways=ways):
                hits, miss_stream, issued, useful = _pf_l2_replay(
                    self.stream(prefix), sets, ways, degree, streams)
            self.levels[key] = got = (hits, miss_stream)
            self.pf_extras[key] = (issued, useful)
        else:
            obs.count("pf.reuse")
        return got[0], got[1], *self.pf_extras[key]


# Memo pool budget: resident derived bytes, not entry count — a single
# megaref trace's profile would blow any fixed entry cap's implied size
# while a cap in entries would thrash hundreds of small roster traces.
_MEMO_MAX_BYTES = int(os.environ.get("REPRO_TORCH_MEMO_BYTES", 256 * 2**20))
_MEMOS: list[_TraceMemo] = []
_MEMOS_LOCK = threading.Lock()
_MEMO_BYTES_LAST = 0    # last gauge value emitted to the memo.bytes counter


def _fingerprint(addr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(addr)).cast("B"))


def _memo_for(addr: np.ndarray) -> _TraceMemo:
    """The trace memo for ``addr``, CRC-revalidated and byte-bounded.

    Eviction is LRU by *resident bytes*: after each lookup the pool's
    derived-array footprint is re-measured and the least recently used
    memos are dropped until the pool fits ``_MEMO_MAX_BYTES`` (the most
    recent memo always survives, so a single over-budget megaref trace
    still simulates).  ``memo.bytes`` tracks the pool as a gauge via
    signed deltas.
    """
    global _MEMO_BYTES_LAST
    with _MEMOS_LOCK:
        found = None
        for i, memo in enumerate(_MEMOS):
            if memo.ref is addr:
                if memo.crc == _fingerprint(addr):
                    if i != len(_MEMOS) - 1:
                        _MEMOS.append(_MEMOS.pop(i))  # refresh LRU slot
                    obs.count("memo.hit")
                    found = memo
                    break
                del _MEMOS[i]  # array was mutated in place: recompute
                obs.count("memo.invalidate")
                break
        if found is None:
            obs.count("memo.miss")
            found = _TraceMemo(addr)
            _MEMOS.append(found)
        total = sum(m.nbytes() for m in _MEMOS)
        while len(_MEMOS) > 1 and total > _MEMO_MAX_BYTES:
            total -= _MEMOS.pop(0).nbytes()
            obs.count("memo.evict")
        obs.count("memo.bytes", total - _MEMO_BYTES_LAST)
        _MEMO_BYTES_LAST = total
        return found


def clear_memo() -> None:
    """Drop every trace memo, so the next simulation of any trace profiles
    it afresh (``memo.bytes`` falls to 0)."""
    global _MEMO_BYTES_LAST
    with _MEMOS_LOCK:
        _MEMOS.clear()
        obs.count("memo.bytes", -_MEMO_BYTES_LAST)
        _MEMO_BYTES_LAST = 0


def _pf_l2_replay(stream, l2_nsets: int, l2_ways: int,
                  degree: int, stream_cap: int):
    """Sequential L2 + stream-prefetcher replay over the L1-miss stream.

    The prefetcher's issue decisions feed back through L2 residency and a
    bounded ``prefetched`` set whose eviction order is a Python-set
    ``pop()``, so this loop cannot vectorize without changing counters.
    It is the reference algorithm with the dict/set operations inlined,
    applied to a stream the vectorized L1 has already shrunk — and *only*
    the feedback participants: the L3 never influences an issue decision
    (prefetches probe and fill L2 alone), so instead of simulating it
    here, the L2 demand-miss stream is returned for a vectorized LLC
    replay shared across every L3 geometry.  Counter equivalence with
    ``cachesim.simulate`` is asserted by the differential harness.

    ``stream`` may be one ndarray or a sequence of ndarray blocks (the
    chunk-streaming path in :mod:`repro_torch.core.cachesim_stream` feeds miss
    blocks without concatenating them); the replay's per-line state flows
    across block boundaries, so the counters are block-size invariant.

    Returns ``(l2_hits, l2_miss_stream, issued, useful)``.
    """
    blocks = (stream,) if isinstance(stream, np.ndarray) else stream
    l2_sets = [dict() for _ in range(l2_nsets)]
    hits = 0
    miss_stream: list[int] = []
    add_miss = miss_stream.append
    last: dict[int, int] = {}       # stream-buffer: region -> last miss line
    issued = 0
    useful = 0
    prefetched: set[int] = set()

    for block in blocks:
        for line in block.tolist():
            s = l2_sets[line % l2_nsets]
            if line in s:
                del s[line]             # refresh recency
                s[line] = None
                hits += 1
            else:
                add_miss(line)          # the L3's demand stream, in order
                if len(s) >= l2_ways:
                    s.pop(next(iter(s)))  # evict LRU (first key)
                s[line] = None

            # prefetcher: every line here is an L1 miss
            if line in prefetched:
                useful += 1
                prefetched.discard(line)
            region = line >> 6
            prev = last.get(region)
            last[region] = line
            if len(last) > stream_cap:
                last.pop(next(iter(last)))
            if prev is not None and 0 < line - prev <= 2:
                for i in range(degree):
                    pline = line + i + 1
                    s = l2_sets[pline % l2_nsets]
                    if pline in s:
                        continue        # duplicate filter: already resident
                    issued += 1
                    if len(s) >= l2_ways:
                        s.pop(next(iter(s)))
                    s[pline] = None      # fill without counting
                    prefetched.add(pline)
                    if len(prefetched) > 4096:
                        prefetched.pop()
    return hits, np.asarray(miss_stream, dtype=np.int64), issued, useful


# --------------------------------------------------------------------------
# Cross-trace forest walk: many (trace, configs) requests in one pass.
# --------------------------------------------------------------------------
class _Bucket:
    """All pending work for one (trace memo, level prefix) at one depth."""

    __slots__ = ("memo", "prefix", "items")

    def __init__(self, memo: _TraceMemo, prefix: tuple) -> None:
        self.memo = memo
        self.prefix = prefix
        self.items: list[tuple[int, int, tuple]] = []  # (req, cfg, rest)


class _Request:
    __slots__ = ("addr", "configs", "factors", "names", "ai", "instr",
                 "plans", "memo", "level_counts", "pf_meta")


def simulate_many(requests, *, scan: str | None = None) -> list[list[SimResult]]:
    """Run many (trace, configs) requests in one segmented pass.

    ``requests`` is a sequence of ``(addresses, configs, opts)`` tuples
    where ``opts`` is a dict with the keyword arguments of
    :func:`simulate_batch` (``ai_ops_per_access``, ``instr_per_access``,
    ``l3_factor``, ``names``).  Returns one ``list[SimResult]`` per
    request, each exactly equal to a separate :func:`simulate_batch` call.

    The hierarchy forests of all requests are walked depth-synchronously:
    at each depth, every (trace, prefix) still needing a given set count
    is stacked into one segmented :class:`StreamProfile` and resolved by
    one capped window scan — one profile pass per unique geometry across
    the whole roster.  Traces whose work at a node is already memoized
    (or whose stream profile already exists) take the per-trace path, so
    warm counters are unchanged.
    """
    if scan == "cuda":
        _scan_device()  # no card: raise before any work
    reqs: list[_Request] = []
    for addresses, configs, opts in requests:
        r = _Request()
        r.addr = np.asarray(addresses, dtype=np.int64)
        r.configs = list(configs)
        r.factors = broadcast_l3_factor(opts.get("l3_factor", 1.0),
                                        len(r.configs))
        r.names = broadcast_names(opts.get("names"), len(r.configs))
        r.ai = float(opts.get("ai_ops_per_access", 1.0))
        r.instr = float(opts.get("instr_per_access", 2.0))
        r.plans = _plans_for(r.configs, r.factors)
        r.level_counts = [[] for _ in r.configs]
        r.pf_meta = [(0, 0)] * len(r.configs)
        reqs.append(r)
    if not reqs:
        return []

    for r in reqs:
        r.memo = _memo_for(r.addr)
    memos = {id(r.memo): r.memo for r in reqs}
    total_refs = sum(int(r.addr.size) for r in reqs)

    with obs.span("sim.many", requests=len(reqs), refs=total_refs), \
            contextlib.ExitStack() as stack:
        # all memo locks, in a global order so concurrent callers that
        # overlap on traces cannot deadlock
        for mid in sorted(memos):
            stack.enter_context(memos[mid].lock)

        buckets: dict[tuple, _Bucket] = {}

        def bucket_for(tree: dict, memo: _TraceMemo, prefix: tuple) -> _Bucket:
            key = (id(memo), prefix)
            b = tree.get(key)
            if b is None:
                b = tree[key] = _Bucket(memo, prefix)
            return b

        for ri, r in enumerate(reqs):
            for ci, plan in enumerate(r.plans):
                if plan:
                    bucket_for(buckets, r.memo, ()).items.append(
                        (ri, ci, plan))

        depth = 0
        while buckets:
            nxt: dict[tuple, _Bucket] = {}

            def emit(b: _Bucket, node: tuple, hits: int, stream_len: int,
                     its: list) -> None:
                for ri, ci, rem in its:
                    reqs[ri].level_counts[ci].append(
                        (hits, stream_len - hits))
                    if len(rem) > 1:
                        bucket_for(nxt, b.memo, b.prefix + (node,)
                                   ).items.append((ri, ci, rem[1:]))

            # group LRU nodes across buckets by set count; prefetcher
            # nodes stay per-trace (their replay is sequential anyway)
            lru_groups: dict[int, list] = {}
            for b in buckets.values():
                lru: dict[int, dict[int, list]] = {}
                pf: dict[tuple, list] = {}
                for it in b.items:
                    node = it[2][0]
                    if node[0] == "pf":
                        pf.setdefault(node, []).append(it)
                    else:
                        lru.setdefault(node[0], {}).setdefault(
                            node[1], []).append(it)
                for sets, by_ways in lru.items():
                    lru_groups.setdefault(sets, []).append((b, by_ways))
                for node, its in pf.items():
                    hits, _, issued, useful = b.memo.pf_result(b.prefix,
                                                               node)
                    for ri, ci, _ in its:
                        reqs[ri].pf_meta[ci] = (issued, useful)
                    emit(b, node, hits,
                         int(b.memo.stream(b.prefix).size), its)

            for sets, members in lru_groups.items():
                seg: list[tuple[_Bucket, dict, list]] = []
                solo: list[tuple[_Bucket, dict]] = []
                for b, by_ways in members:
                    missing = [w for w in by_ways
                               if b.prefix + ((sets, w),)
                               not in b.memo.levels]
                    if missing and b.prefix not in b.memo.profiles:
                        seg.append((b, by_ways, missing))
                    else:
                        # everything cached, or a per-trace profile
                        # already exists: the memoized path is cheaper
                        # than re-profiling inside a segment
                        solo.append((b, by_ways))
                if len(seg) == 1:
                    solo.append(seg[0][:2])
                    seg = []

                if seg:
                    streams = [b.memo.stream(b.prefix) for b, _, _ in seg]
                    offsets = np.zeros(len(seg) + 1, dtype=np.int64)
                    np.cumsum([s.size for s in streams], out=offsets[1:])
                    union = sorted({w for _, _, miss in seg for w in miss})
                    obs.count("profile.geom", len(seg))
                    obs.count("node.compute",
                              sum(len(miss) for _, _, miss in seg))
                    cat = np.concatenate(streams)
                    with obs.span("sim.profile", depth=depth,
                                  segments=len(seg)):
                        prof = StreamProfile(cat, seg_offsets=offsets[:-1])
                    with obs.span("sim.scan", sets=sets, ways=len(union),
                                  depth=depth, segments=len(seg)):
                        masks = _replay_ways(prof, sets, union, scan=scan)
                    for k, (b, by_ways, missing) in enumerate(seg):
                        lo, hi = int(offsets[k]), int(offsets[k + 1])
                        if not b.prefix:
                            b.memo.root_distinct = int(prof.seg_distinct[k])
                        for w in missing:
                            sub = masks[w][lo:hi]
                            b.memo.levels[b.prefix + ((sets, w),)] = (
                                int(sub.sum()), streams[k][~sub])
                        for w, its in by_ways.items():
                            if w not in missing:
                                obs.count("node.reuse")
                            hits = b.memo.levels[
                                b.prefix + ((sets, w),)][0]
                            emit(b, (sets, w), hits,
                                 int(streams[k].size), its)

                for b, by_ways in solo:
                    res = b.memo.results(b.prefix, sets, list(by_ways),
                                         scan=scan)
                    stream_len = int(b.memo.stream(b.prefix).size)
                    for w, its in by_ways.items():
                        emit(b, (sets, w), res[w][0], stream_len, its)

            buckets = nxt
            depth += 1

        out: list[list[SimResult]] = []
        for r in reqs:
            rd = r.memo.root_distinct
            if rd is None:
                p = r.memo.profiles.get(())
                if p is None:
                    p = r.memo.profile(())
                rd = r.memo.root_distinct = p.distinct
            n = int(r.addr.size)
            instructions = int(round(n * max(1.0, r.instr)))
            results = []
            for ci, cfg in enumerate(r.configs):
                results.append(SimResult(
                    name=r.names[ci] or cfg.name,
                    accesses=n,
                    instructions=instructions,
                    ai=float(r.ai),
                    level_misses=tuple(m for _, m in r.level_counts[ci]),
                    level_hits=tuple(h for h, _ in r.level_counts[ci]),
                    lines_touched=rd,
                    prefetch_issued=r.pf_meta[ci][0],
                    prefetch_useful=r.pf_meta[ci][1],
                ))
            out.append(results)
    return out


def simulate_batch(
    addresses: np.ndarray,
    configs,
    *,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor=1.0,
    names=None,
    scan: str | None = None,
) -> list[SimResult]:
    """Run one trace through many hierarchy configs in a single pass.

    ``configs`` is a sequence of :class:`HierarchyConfig`; ``l3_factor``
    is a scalar shared by all of them or a per-config sequence.  Counters
    are exactly those of per-config :func:`simulate` calls (and hence of
    the reference loop), but shared level prefixes — the same L1 in every
    paper hierarchy, the same L1+L2 in every LLC variant — are replayed
    once, and geometries differing only in associativity share one capped
    stack-distance scan.  (The cross-*trace* sharing lives in
    :func:`simulate_many`; this is its single-request form.)
    """
    configs = list(configs)
    if not configs:
        return []
    addr = np.asarray(addresses, dtype=np.int64)
    with obs.span("sim.batch", configs=len(configs), refs=int(addr.size)):
        return simulate_many(
            [(addr, configs,
              {"ai_ops_per_access": ai_ops_per_access,
               "instr_per_access": instr_per_access,
               "l3_factor": l3_factor, "names": names})],
            scan=scan)[0]


def simulate(
    addresses: np.ndarray,
    config: HierarchyConfig,
    *,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor: float = 1.0,
    name: str | None = None,
    scan: str | None = None,
) -> SimResult:
    """Vectorized drop-in for :func:`repro_torch.core.cachesim.simulate`."""
    return simulate_batch(
        addresses,
        [config],
        ai_ops_per_access=ai_ops_per_access,
        instr_per_access=instr_per_access,
        l3_factor=l3_factor,
        names=[name],
        scan=scan,
    )[0]
