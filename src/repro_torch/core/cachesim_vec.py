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
Multi-level hierarchies factor exactly: level N+1's demand stream is level
N's ordered miss sub-sequence.  A per-trace memo (:class:`_TraceMemo`,
keyed on array identity and revalidated by CRC) keeps every level prefix's
miss stream and profile, so a core sweep recomputes only what is new.

Prefetcher configs replay the L2 + prefetcher sequentially over the
vectorized L1's miss stream (same algorithm, same order as the reference),
and their LLC levels replay vectorized over the emitted L2 miss stream.
"""

from __future__ import annotations

import threading
import zlib

import numpy as np

from .cachesim import (
    WORDS_PER_LINE,
    HierarchyConfig,
    SimResult,
    broadcast_l3_factor,
    broadcast_names,
)

__all__ = ["simulate", "simulate_batch", "StreamProfile"]


class StreamProfile:
    """Geometry-independent factorization of one demand stream.

    Holds the consecutive-duplicate collapse, the previous occurrence of
    each collapsed access, the cold (first-touch) mask and the
    distinct-line count.
    """

    __slots__ = ("n", "keep", "cl", "prev", "cold", "distinct")

    def __init__(self, lines: np.ndarray) -> None:
        n = int(lines.size)
        self.n = n
        if n == 0:
            self.keep = np.zeros(0, dtype=bool)
            self.cl = np.asarray(lines, dtype=np.int64)[:0]
            self.prev = np.zeros(0, dtype=np.int64)
            self.cold = np.zeros(0, dtype=bool)
            self.distinct = 0
            return

        # -- collapse consecutive duplicates (guaranteed hits) -------------
        keep = np.empty(n, dtype=bool)
        keep[0] = True
        np.not_equal(lines[1:], lines[:-1], out=keep[1:])
        cl = lines[keep]
        m = int(cl.size)

        # -- previous occurrence of the same line (collapsed index) --------
        # Stable grouping by line: pack (line, time) into one int64 key when
        # it fits (one fast introsort); otherwise fall back to lexsort.
        shift = max(m - 1, 1).bit_length()
        packable = int(cl.min()) >= 0 and int(cl.max()) < (1 << (62 - shift))
        if packable:
            order = np.argsort((cl << shift) | np.arange(m, dtype=np.int64))
        else:
            order = np.lexsort((np.arange(m, dtype=np.int64), cl))
        sorted_g = cl[order]
        same = sorted_g[1:] == sorted_g[:-1]
        prev = np.full(m, -1, dtype=np.int64)
        prev[order[1:][same]] = order[:-1][same]

        self.keep = keep
        self.cl = cl
        self.prev = prev
        self.cold = prev < 0
        self.distinct = int(self.cold.sum())

    @property
    def nbytes(self) -> int:
        """Resident bytes of the profile's arrays (memo accounting)."""
        return (self.keep.nbytes + self.cl.nbytes + self.prev.nbytes
                + self.cold.nbytes)


def _replay_ways(profile: StreamProfile, sets: int,
                 ways_list: list[int]) -> dict[int, np.ndarray]:
    """Exact LRU hit masks for one set count at several associativities.

    The contested-revisit scan runs once, capped at ``max(ways_list)``;
    each requested ``ways`` is answered by thresholding the capped
    distances (LRU inclusion).  Returns ``{ways: hit_mask}`` aligned to the
    profile's original (uncollapsed) stream.
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
        per_set_distinct = np.bincount(sidx[profile.cold], minlength=sets)
        psd_r = per_set_distinct[sidx[revisit]]
        min_w, max_w = ways_list[0], ways_list[-1]
        easy = psd_r <= min_w
        queries = revisit[~easy]
        sd = None
        if queries.size:
            sd = _contested_sd(cl, sidx, profile.prev, queries, sets,
                               cap=max_w, skip_below=min_w)
        for w in ways_list:
            hc = hit_c[w]
            hc[revisit[easy]] = True
            if sd is not None:
                # A window in a set with <= w lifetime distinct lines has
                # stack distance < w by construction, so thresholding the
                # capped distance also covers the per-ways easy cases.
                hc[queries[sd < w]] = True

    out = {}
    for w in ways_list:
        hit_mask = np.ones(profile.n, dtype=bool)
        hit_mask[profile.keep] = hit_c[w]
        out[w] = hit_mask
    return out


def _contested_sd(cl, sidx, prev, queries, sets, cap,
                  skip_below) -> np.ndarray:
    """Capped stack distances for revisits in sets that do evict.

    Works in a set-major layout so every set's access history is one
    contiguous slab, then counts window-first accesses per query window in
    vectorized, geometrically growing chunks.  The returned count ``c``
    equals the stack distance whenever it is ``< cap`` and is ``>= cap``
    otherwise, so ``c < w`` decides hit/miss exactly for every
    ``w <= cap``.  Windows shorter than ``skip_below`` are not scanned:
    their distance is below every requested associativity (count 0).
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
    qdt = np.int32 if m < (1 << 31) else np.int64
    q = np.empty(m, dtype=qdt)
    q[pos] = q_global

    # Window of query i: set-major slots [pos[prev[i]]+1, pos[i]).
    # Window-first accesses j are those with q[j] <= q_i; their count is
    # the stack distance.
    threshold = q_global[queries].astype(qdt)
    win_lo = pos[prev[queries]] + 1
    win_hi = pos[queries]

    sd = np.zeros(queries.size, dtype=np.int64)
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


def _effective_levels(config: HierarchyConfig, l3_factor: float):
    level_cfgs = list(config.levels)
    if config.shared_llc and len(level_cfgs) >= 2 and l3_factor < 1.0:
        level_cfgs[-1] = level_cfgs[-1].scaled(l3_factor)
    return level_cfgs


def _plans_for(configs, factors) -> list[tuple]:
    """Per-config node plans: LRU levels are ``(sets, ways)``; a
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


class _TraceMemo:
    """Reusable state for one trace array across hierarchies and calls.

    Per level *prefix* (a tuple of ``(sets, ways)`` LRU nodes and
    ``("pf", ...)`` prefetcher nodes) it keeps ``levels[prefix]``, the
    (hit count, miss stream) of the prefix's last node — the next level's
    demand stream — and ``profiles[prefix]``, the :class:`StreamProfile`
    of the stream entering the next level.  Keyed on the address array's
    identity; a CRC of the buffer is re-checked on every lookup, so a
    caller that mutates its array in place gets a recompute.
    """

    __slots__ = ("ref", "crc", "lines", "profiles", "levels", "pf_extras",
                 "lock")

    def __init__(self, addr: np.ndarray) -> None:
        self.ref = addr
        self.crc = _fingerprint(addr)
        self.lines: np.ndarray | None = None
        self.profiles: dict[tuple, StreamProfile] = {}
        self.levels: dict[tuple, tuple[int, np.ndarray]] = {}
        self.pf_extras: dict[tuple, tuple[int, int]] = {}
        self.lock = threading.RLock()

    def nbytes(self) -> int:
        """Resident bytes of memo-owned derived arrays."""
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
            p = self.profiles[prefix] = StreamProfile(self.stream(prefix))
        return p

    def results(self, prefix: tuple, sets: int, ways_list: list[int]) -> None:
        """Materialize (hits, miss stream) for each ``ways`` at one
        (prefix, sets); missing associativities share one capped scan."""
        missing = [w for w in dict.fromkeys(ways_list)
                   if prefix + ((sets, w),) not in self.levels]
        if not missing:
            return
        stream = self.stream(prefix)
        masks = _replay_ways(self.profile(prefix), sets, missing)
        for w in missing:
            mask = masks[w]
            self.levels[prefix + ((sets, w),)] = (int(mask.sum()),
                                                  stream[~mask])

    def pf_result(self, prefix: tuple,
                  node: tuple) -> tuple[int, np.ndarray, int, int]:
        """(L2 hits, L2-miss stream, issued, useful) for one prefetcher
        node over the ``prefix`` miss stream, memoized."""
        key = prefix + (node,)
        got = self.levels.get(key)
        if got is None:
            _, sets, ways, degree, streams = node
            hits, miss_stream, issued, useful = _pf_l2_replay(
                self.stream(prefix), sets, ways, degree, streams)
            self.levels[key] = got = (hits, miss_stream)
            self.pf_extras[key] = (issued, useful)
        return got[0], got[1], *self.pf_extras[key]


# Memo pool budget in resident derived bytes.
_MEMO_MAX_BYTES = 256 * 2**20
_MEMOS: list[_TraceMemo] = []
_MEMOS_LOCK = threading.Lock()


def _fingerprint(addr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(addr)).cast("B"))


def _memo_for(addr: np.ndarray) -> _TraceMemo:
    """The trace memo for ``addr``, CRC-revalidated, LRU-evicted by
    resident bytes (the most recent memo always survives)."""
    with _MEMOS_LOCK:
        found = None
        for i, memo in enumerate(_MEMOS):
            if memo.ref is addr:
                if memo.crc == _fingerprint(addr):
                    if i != len(_MEMOS) - 1:
                        _MEMOS.append(_MEMOS.pop(i))  # refresh LRU slot
                    found = memo
                    break
                del _MEMOS[i]  # array was mutated in place: recompute
                break
        if found is None:
            found = _TraceMemo(addr)
            _MEMOS.append(found)
        total = sum(m.nbytes() for m in _MEMOS)
        while len(_MEMOS) > 1 and total > _MEMO_MAX_BYTES:
            total -= _MEMOS.pop(0).nbytes()
        return found


def _pf_l2_replay(stream: np.ndarray, l2_nsets: int, l2_ways: int,
                  degree: int, stream_cap: int):
    """Sequential L2 + stream-prefetcher replay over the L1-miss stream.

    The prefetcher's issue decisions feed back through L2 residency and a
    bounded ``prefetched`` set whose eviction order is a Python-set
    ``pop()``, so this loop cannot vectorize without changing counters.
    The L3 never influences an issue decision, so the L2 demand-miss
    stream is returned for a vectorized LLC replay.

    Returns ``(l2_hits, l2_miss_stream, issued, useful)``.
    """
    l2_sets = [dict() for _ in range(l2_nsets)]
    hits = 0
    miss_stream: list[int] = []
    add_miss = miss_stream.append
    last: dict[int, int] = {}       # stream-buffer: region -> last miss line
    issued = 0
    useful = 0
    prefetched: set[int] = set()

    for line in stream.tolist():
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


def simulate_batch(
    addresses: np.ndarray,
    configs,
    *,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor=1.0,
    names=None,
) -> list[SimResult]:
    """Run one trace through many hierarchy configs in a single pass.

    The configs' level plans are walked depth by depth: at each depth the
    LRU nodes sharing a (prefix, set count) are resolved by one capped
    scan, prefetcher nodes by one sequential replay each, and everything
    lands in the trace's memo so later calls recall it.
    """
    configs = list(configs)
    if not configs:
        return []
    addr = np.asarray(addresses, dtype=np.int64)
    factors = broadcast_l3_factor(l3_factor, len(configs))
    names = broadcast_names(names, len(configs))
    plans = _plans_for(configs, factors)
    memo = _memo_for(addr)
    level_counts: list[list[tuple[int, int]]] = [[] for _ in configs]
    pf_meta = [(0, 0)] * len(configs)
    with memo.lock:
        pending = [(ci, (), plan) for ci, plan in enumerate(plans) if plan]
        while pending:
            lru: dict[tuple, list[int]] = {}
            for _, prefix, rem in pending:
                if rem[0][0] != "pf":
                    lru.setdefault((prefix, rem[0][0]), []).append(rem[0][1])
            for (prefix, sets), ways in lru.items():
                memo.results(prefix, sets, ways)
            nxt = []
            for ci, prefix, rem in pending:
                node = rem[0]
                if node[0] == "pf":
                    hits, _, issued, useful = memo.pf_result(prefix, node)
                    pf_meta[ci] = (issued, useful)
                else:
                    hits = memo.levels[prefix + (node,)][0]
                stream_len = int(memo.stream(prefix).size)
                level_counts[ci].append((hits, stream_len - hits))
                if len(rem) > 1:
                    nxt.append((ci, prefix + (node,), rem[1:]))
            pending = nxt
        distinct = memo.profile(()).distinct

    n = int(addr.size)
    instructions = int(round(n * max(1.0, instr_per_access)))
    return [
        SimResult(
            name=names[ci] or cfg.name,
            accesses=n,
            instructions=instructions,
            ai=float(ai_ops_per_access),
            level_misses=tuple(m for _, m in level_counts[ci]),
            level_hits=tuple(h for h, _ in level_counts[ci]),
            lines_touched=distinct,
            prefetch_issued=pf_meta[ci][0],
            prefetch_useful=pf_meta[ci][1],
        )
        for ci, cfg in enumerate(configs)
    ]


def simulate(
    addresses: np.ndarray,
    config: HierarchyConfig,
    *,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor: float = 1.0,
    name: str | None = None,
) -> SimResult:
    """Vectorized drop-in for :func:`repro_torch.core.cachesim.simulate`."""
    return simulate_batch(
        addresses,
        [config],
        ai_ops_per_access=ai_ops_per_access,
        instr_per_access=instr_per_access,
        l3_factor=l3_factor,
        names=[name],
    )[0]
