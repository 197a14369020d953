"""Chunk-streaming cache simulation for megaref traces, in bounded memory
(counterpart of ``repro.core.cachesim_stream``).

The in-memory vectorized backend (:mod:`repro_torch.core.cachesim_vec`)
materializes, per level, the full collapsed stream plus its sort/window
intermediates — roughly 50-80 bytes per reference.  Whole-model captures
emit 10M+-ref traces, where that footprint dwarfs the trace itself.  This
module simulates the same LRU stack
algorithm over fixed-size *blocks* with peak memory

    O(chunk) + O(distinct lines) + ~1 byte per collapsed reference,

independent of trace length, and counter-identical to the in-memory path
(asserted by ``tests/test_torch_cachesim_stream.py`` on truncated
prefixes).

How the passes fit together, per cache level:

1. **Collapse + previous-occurrence, block by block.**  Consecutive
   duplicates collapse with the last line carried across block
   boundaries.  Each block's previous-occurrence array is resolved
   in-block by the same packed (line, time) sort the in-memory profile
   uses, then block-cold refs consult a persistent sorted
   ``line -> last collapsed index`` table (two ``O(distinct)`` arrays,
   merged per block).  The per-block ``(line, prev)`` partials are kept
   in a spill-aware block store (:class:`_Blocks`) that writes past-
   budget blocks to a temporary directory.
2. **Stripe partition.**  Sets are grouped into contiguous *stripes*
   sized so one stripe's collapsed refs fit the chunk budget.  Same line
   -> same set -> same stripe, so every reuse window is stripe-local.
3. **Per-stripe window scan.**  Each collapsed ref is routed to its
   stripe (spill-aware again); each stripe then replays exactly the
   in-memory contested-revisit scan (:func:`cachesim_vec._contested_sd`)
   over its own slice — a stripe holds *all* accesses of its sets in
   time order, so per-set distinct counts and stack distances are
   identical to a whole-trace scan.  Results land in one global
   1-byte-per-collapsed-ref hit array.
4. **Miss emission.**  The stored collapse partials are re-read block by
   block and the miss sub-stream — the next level's demand stream — is
   emitted into a fresh spill-aware store, so deep hierarchies never
   hold two levels in memory at once.

The stream prefetcher's sequential replay consumes the spilled L1-miss
blocks lazily (``cachesim_vec._pf_l2_replay`` accepts any iterable of
blocks), unchanged counters included.  ``scan="cuda"`` runs each stripe's
window scan in the ``window_scan`` kernel on the card, as the in-memory
``cuda`` backend does.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from repro_torch import obs

from .cachesim import WORDS_PER_LINE, HierarchyConfig, SimResult
from . import cachesim_vec
from .cachesim_vec import _contested_sd, _pf_l2_replay, _plans_for

__all__ = ["simulate_chunked", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 18          # collapsed refs per in-memory unit of work
DEFAULT_SPILL_BYTES = 64 * 2**20  # resident budget per block store


class _Blocks:
    """Ordered, spill-aware store of ndarray blocks.

    Appends keep blocks in memory until the resident budget is exceeded,
    then the oldest resident blocks are written to ``.npy`` files in a
    lazily created temporary directory (``stream.spill.bytes`` counts
    the traffic).  Iteration yields every block in append order, loading
    spilled blocks one at a time — peak memory stays at one block plus
    the resident tail regardless of total size.
    """

    def __init__(self, budget: int = DEFAULT_SPILL_BYTES,
                 tag: str = "blk") -> None:
        self.budget = budget
        self.tag = tag
        self._items: list = []       # ndarray (resident) or str (path)
        self._resident = 0
        self._spilled = 0            # index of first resident item
        self._tmp: tempfile.TemporaryDirectory | None = None
        self.total = 0               # total rows appended

    def append(self, arr: np.ndarray) -> None:
        self.total += int(arr.shape[0])
        self._items.append(arr)
        self._resident += arr.nbytes
        while self._resident > self.budget and self._spilled < len(self._items) - 1:
            i = self._spilled
            block = self._items[i]
            if self._tmp is None:
                self._tmp = tempfile.TemporaryDirectory(
                    prefix=f"repro-torch-stream-{self.tag}-")
            path = os.path.join(self._tmp.name, f"{i}.npy")
            np.save(path, block)
            obs.count("stream.spill.bytes", block.nbytes)
            self._resident -= block.nbytes
            self._items[i] = path
            self._spilled += 1

    def __iter__(self):
        for item in self._items:
            yield np.load(item) if isinstance(item, str) else item

    def __len__(self) -> int:
        return len(self._items)

    def close(self) -> None:
        self._items.clear()
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None


def _block_prev(cl: np.ndarray) -> np.ndarray:
    """In-block previous-occurrence indices (-1 for block-cold refs) —
    the in-memory profile's packed (line, time) sort, per block."""
    k = int(cl.size)
    if k == 0:
        return np.zeros(0, dtype=np.int64)
    shift = max(k - 1, 1).bit_length()
    cmin = int(cl.min())
    cmax = int(cl.max())
    if cmax - cmin < (1 << (62 - shift)):
        order = np.argsort(((cl - cmin) << shift)
                           | np.arange(k, dtype=np.int64))
    else:  # pragma: no cover - astronomically wide address range
        order = np.lexsort((np.arange(k, dtype=np.int64), cl))
    sorted_cl = cl[order]
    same = sorted_cl[1:] == sorted_cl[:-1]
    prev = np.full(k, -1, dtype=np.int64)
    prev[order[1:][same]] = order[:-1][same]
    return prev


def _merge_table(tbl_lines: np.ndarray, tbl_gidx: np.ndarray,
                 lines_u: np.ndarray, gidx_u: np.ndarray):
    """Merge a block's (sorted) line->last-gidx updates into the
    persistent sorted table, keeping the newest gidx per line."""
    if not tbl_lines.size:
        return lines_u, gidx_u
    lines = np.concatenate([tbl_lines, lines_u])
    gidx = np.concatenate([tbl_gidx, gidx_u])
    order = np.argsort(lines, kind="stable")  # table first, updates after
    lines = lines[order]
    gidx = gidx[order]
    last = np.ones(lines.size, dtype=bool)
    last[:-1] = lines[1:] != lines[:-1]       # keep last (newest) per line
    return lines[last], gidx[last]


def _stripes_for(set_counts: np.ndarray, chunk: int) -> np.ndarray:
    """Contiguous set->stripe partition with ~``chunk`` collapsed refs
    per stripe (a single hot set always gets its own stripe)."""
    stripe_of_set = np.zeros(set_counts.size, dtype=np.int64)
    sid = 0
    acc = 0
    for s in range(set_counts.size):
        c = int(set_counts[s])
        if acc and acc + c > chunk:
            sid += 1
            acc = 0
        stripe_of_set[s] = sid
        acc += c
    return stripe_of_set


def _replay_level_chunked(blocks, sets: int, ways: int, *, chunk: int,
                          spill: int, scan: str | None):
    """One LRU level over a stream of line blocks.

    Returns ``(hits, misses, miss_blocks, distinct, n)`` with counters
    identical to the in-memory ``_replay_ways`` path.
    """
    obs.count("stream.level")
    # -- pass 1: collapse + prev per block, persistent line table ---------
    collapsed = _Blocks(spill, tag=f"lvl{sets}")
    tbl_lines = np.zeros(0, dtype=np.int64)
    tbl_gidx = np.zeros(0, dtype=np.int64)
    set_counts = np.zeros(sets, dtype=np.int64)
    last_line: int | None = None
    n = 0
    m = 0
    distinct = 0
    for blk in blocks:
        b = int(blk.size)
        n += b
        if not b:
            continue
        keep = np.empty(b, dtype=bool)
        keep[0] = last_line is None or int(blk[0]) != last_line
        np.not_equal(blk[1:], blk[:-1], out=keep[1:])
        last_line = int(blk[-1])
        cl = blk[keep]
        k = int(cl.size)
        if not k:
            continue
        prev_in = _block_prev(cl)
        prev_g = np.where(prev_in >= 0, prev_in + m, -1)
        bcold = np.flatnonzero(prev_in < 0)
        if bcold.size:
            ccl = cl[bcold]
            pos = np.searchsorted(tbl_lines, ccl)
            inb = pos < tbl_lines.size
            match = np.zeros(bcold.size, dtype=bool)
            match[inb] = tbl_lines[pos[inb]] == ccl[inb]
            prev_g[bcold[match]] = tbl_gidx[pos[match]]
        cold = prev_g < 0
        distinct += int(cold.sum())
        set_counts += np.bincount(cl % sets, minlength=sets)
        # newest occurrence per line in this block -> table update
        order = np.argsort(cl, kind="stable")
        sorted_cl = cl[order]
        ends = np.ones(k, dtype=bool)
        ends[:-1] = sorted_cl[1:] != sorted_cl[:-1]
        tbl_lines, tbl_gidx = _merge_table(
            tbl_lines, tbl_gidx, sorted_cl[ends], order[ends] + m)
        collapsed.append(np.stack([cl, prev_g], axis=1))
        m += k
    del tbl_lines, tbl_gidx

    # -- pass 2: route collapsed refs to set stripes ----------------------
    stripe_of_set = _stripes_for(set_counts, chunk)
    nstripes = int(stripe_of_set[-1]) + 1 if sets else 1
    stripes = [_Blocks(max(spill // max(nstripes, 1), 1 << 20),
                       tag=f"stripe{sets}")
               for _ in range(nstripes)]
    g = 0
    for arr in collapsed:
        cl = arr[:, 0]
        k = int(cl.size)
        sid = stripe_of_set[cl % sets]
        order = np.argsort(sid, kind="stable")
        counts = np.bincount(sid, minlength=nstripes)
        gidx = np.arange(g, g + k, dtype=np.int64)[order]
        cl_o = cl[order]
        prev_o = arr[:, 1][order]
        lo = 0
        for s in range(nstripes):
            c = int(counts[s])
            if c:
                stripes[s].append(np.stack(
                    [gidx[lo:lo + c], cl_o[lo:lo + c], prev_o[lo:lo + c]],
                    axis=1))
            lo += c
        g += k

    # -- pass 3: per-stripe window scans into one global hit array --------
    hit = np.zeros(m, dtype=bool)
    for s in range(nstripes):
        parts = list(stripes[s])
        stripes[s].close()
        if not parts:
            continue
        obs.count("stream.stripe")
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
        del parts
        gidx = arr[:, 0]
        cl_s = arr[:, 1]
        prev_g = arr[:, 2]
        k = int(cl_s.size)
        has_prev = prev_g >= 0
        prev_l = np.full(k, -1, dtype=np.int64)
        prev_l[has_prev] = np.searchsorted(gidx, prev_g[has_prev])
        cold = ~has_prev
        hit_c = np.zeros(k, dtype=bool)
        revisit = np.flatnonzero(has_prev)
        if revisit.size:
            sidx = cl_s % sets
            per_set_distinct = np.bincount(sidx[cold], minlength=sets)
            psd_r = per_set_distinct[sidx[revisit]]
            easy = psd_r <= ways
            hit_c[revisit[easy]] = True
            queries = revisit[~easy]
            if queries.size:
                sd = _contested_sd(cl_s, sidx, prev_l, queries, sets,
                                   cap=ways, skip_below=ways, scan=scan)
                hit_c[queries[sd < ways]] = True
        hit[gidx] = hit_c

    # -- pass 4: emit the ordered miss sub-stream, block by block ---------
    miss_blocks = _Blocks(spill, tag=f"miss{sets}")
    g = 0
    for arr in collapsed:
        cl = arr[:, 0]
        k = int(cl.size)
        sub = hit[g:g + k]
        if k - int(sub.sum()):
            miss_blocks.append(cl[~sub])
        g += k
    collapsed.close()
    hits = (n - m) + int(hit.sum())
    return hits, n - hits, miss_blocks, distinct, n


def _line_blocks(addresses, chunk: int):
    """Yield ``// WORDS_PER_LINE`` line blocks from an ndarray or any
    iterable of address blocks (a generator feeding op-by-op walks straight
    in, counted as ``stream.gen.blocks``)."""
    if isinstance(addresses, np.ndarray):
        addr = addresses
        for lo in range(0, int(addr.size), chunk):
            yield np.asarray(addr[lo:lo + chunk],
                             dtype=np.int64) // WORDS_PER_LINE
        return
    for blk in addresses:
        obs.count("stream.gen.blocks")
        yield np.asarray(blk, dtype=np.int64) // WORDS_PER_LINE


def simulate_chunked(
    addresses,
    config: HierarchyConfig,
    *,
    chunk: int = DEFAULT_CHUNK,
    spill_bytes: int = DEFAULT_SPILL_BYTES,
    ai_ops_per_access: float = 1.0,
    instr_per_access: float = 2.0,
    l3_factor: float = 1.0,
    name: str | None = None,
    scan: str | None = None,
) -> SimResult:
    """Streamed counterpart of :func:`repro_torch.core.cachesim.simulate`.

    ``addresses`` may be one ndarray (processed in ``chunk``-sized
    blocks) or an iterable of address blocks — a generator over a walk
    never needs the full trace in memory.  ``scan="cuda"`` runs the window
    scans on the card (it raises without one).  Counters
    are identical to the in-memory backends; peak memory is bounded by
    the chunk size, the distinct-line count and ~1 byte per collapsed
    ref (block stores spill to disk past ``spill_bytes``).
    """
    if scan == "cuda":
        cachesim_vec._scan_device()  # no card: raise before any work
    plan = _plans_for([config], [float(l3_factor)])[0]
    hits_l: list[int] = []
    misses_l: list[int] = []
    issued = useful = 0
    lines_touched = 0
    n = 0
    with obs.span("sim.chunked", chunk=chunk, levels=len(plan)):
        blocks = _line_blocks(addresses, chunk)
        owned: _Blocks | None = None
        for depth, node in enumerate(plan):
            if node[0] == "pf":
                obs.count("pf.replay")
                _, sets, ways, degree, streams = node
                with obs.span("sim.pf_replay", sets=sets, ways=ways):
                    h, miss_stream, issued, useful = _pf_l2_replay(
                        blocks, sets, ways, degree, streams)
                if owned is not None:
                    owned.close()
                    owned = None
                # the pf node always follows the L1 filter, so its demand
                # stream length is the previous level's miss count
                stream_len = misses_l[-1]
                hits_l.append(h)
                misses_l.append(stream_len - h)
                blocks = iter((miss_stream,))
            else:
                sets, ways = node
                h, miss, miss_blocks, distinct, level_n = \
                    _replay_level_chunked(blocks, sets, ways, chunk=chunk,
                                          spill=spill_bytes, scan=scan)
                if owned is not None:
                    owned.close()
                owned = miss_blocks
                if depth == 0:
                    n = level_n
                    lines_touched = distinct
                hits_l.append(h)
                misses_l.append(miss)
                blocks = iter(miss_blocks)
        if owned is not None:
            owned.close()

    instructions = int(round(n * max(1.0, instr_per_access)))
    return SimResult(
        name=name or config.name,
        accesses=n,
        instructions=instructions,
        ai=float(ai_ops_per_access),
        level_misses=tuple(misses_l),
        level_hits=tuple(hits_l),
        lines_touched=lines_touched,
        prefetch_issued=issued,
        prefetch_useful=useful,
    )
