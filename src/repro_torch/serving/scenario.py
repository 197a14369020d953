"""Serving scenarios: traffic shape x captured kernel -> per-window traces
(counterpart of ``repro.serving.scenario``).

A :class:`ServingScenario` composes one :class:`~repro_torch.serving.traffic
.TrafficProcess` with one captured decode-kernel geometry and plays it
through a continuous-batching schedule (FIFO queue, fixed slot pool,
admit-into-free-slots, retire-on-done).  Every scheduling window yields
one fixed-ref HBM trace:

1. the traffic process offers ``arrivals`` requests whose resource keys
   (page-pool pages / expert ids / context-buffer slots) come from its
   popularity distribution;
2. admitted slots each contribute one kernel launch on the requested
   device, made through the kernel's own capture hook (``page_table=`` /
   ``expert_ids=`` carry the traffic draws into the launch) and walked by
   :func:`repro_torch.capture.grid.walk`;
3. the per-slot streams are interleaved in DMA-chunk round-robin order
   (concurrent slots execute on different cores) and length-normalized to
   ``window_refs`` by ``np.resize``, the captured roster's convention.

The whole-trace workload is the window concatenation; the per-window
traces feed the phase timeline in :mod:`repro_torch.serving.phases`.  The
draws, schedule and geometry are the reference's, so the windows are
byte-identical to its mirror-path windows.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.capture.grid import walk
from repro_torch.core.tracegen import TraceSpec, Workload, stable_name_seed
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import capture as flash_capture
from repro_torch.kernels.moe_dispatch import capture as moe_capture
from repro_torch.kernels.paged_kv_decode import capture as paged_capture

from .traffic import TrafficProcess, WindowDemand, make_traffic

__all__ = ["WindowTrace", "ServingScenario", "SCENARIOS",
           "serving_workloads", "window_seed"]

KERNELS = ("pagedkv", "moe", "flashattn")

# Round-robin interleave granularity, words: roughly one DMA burst — small
# enough that a window's prefix covers every concurrent slot, large enough
# to keep each slot's spatial locality intact.
_CHUNK_WORDS = 2048


def window_seed(name: str, seed: int) -> int:
    """Window-composition seed for (scenario, trace seed): the first draw
    of the ``Workload.trace`` rng, so the workload generator and
    :mod:`repro_torch.serving.phases` land on identical windows."""
    rng = np.random.default_rng(seed + stable_name_seed(name))
    return int(rng.integers(1 << 31))


@dataclass(frozen=True)
class WindowTrace:
    """One scheduling window's composed trace + accounting."""

    demand: WindowDemand
    addresses: np.ndarray       # fixed-ref (window_refs) word-address trace
    raw_refs: int               # offered stream length before resize
    flops: float                # arithmetic ops of the window's launches
    batch: int                  # active slots after admission

    @property
    def ai(self) -> float:
        """Ops per offered ref — the window's arithmetic intensity."""
        return self.flops / self.raw_refs if self.raw_refs else 0.0


@dataclass
class _Seq:
    """One admitted request's kernel-side payload."""

    rid: int
    payload: object             # pages | expert ids | (context, sk)
    remaining: int


class _SlotBatch:
    """Continuous-batching slot management: FIFO queue, fixed slot pool
    (LIFO free list), admit until no free slot or empty queue, retire when
    done."""

    def __init__(self, max_batch: int) -> None:
        self.queue: deque[_Seq] = deque()
        self.active: dict[int, _Seq] = {}
        self._free = list(range(max_batch))

    def submit(self, seq: _Seq) -> None:
        self.queue.append(seq)

    def admit(self) -> None:
        while self._free and self.queue:
            self.active[self._free.pop()] = self.queue.popleft()

    def tick(self) -> None:
        """One decode window passes: count down and retire finished slots."""
        for slot in list(self.active):
            seq = self.active[slot]
            seq.remaining -= 1
            if seq.remaining <= 0:
                del self.active[slot]
                self._free.append(slot)


@dataclass(frozen=True)
class ServingScenario:
    """One (kernel, traffic shape, schedule) point of the serving roster."""

    name: str
    kernel: str                                   # one of KERNELS
    traffic: TrafficProcess
    expected_class: str
    geometry: tuple[tuple[str, int | float], ...]  # sorted (key, value)
    n_windows: int = 10
    window_refs: int = 8192
    max_batch: int = 8
    decode_steps: int = 2       # windows a request stays slot-resident
    mlp: float = 4.0
    instr_overhead: float = 2.0

    def __post_init__(self) -> None:
        if self.kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, "
                             f"got {self.kernel!r}")

    def params(self) -> dict:
        """Fingerprint-relevant geometry for the suite registry: any edit
        here (or in ``geometry``/``traffic``) makes stored rows
        unreachable instead of wrongly recalled."""
        p = {
            "kernel": self.kernel,
            "traffic": self.traffic.name,
            "traffic_family": self.traffic.family,
            "keyspace": self.traffic.keyspace,
            "rate": self.traffic.rate,
            "windows": self.n_windows,
            "window_refs": self.window_refs,
            "max_batch": self.max_batch,
            "decode_steps": self.decode_steps,
        }
        p.update(dict(self.geometry))
        return p

    def window_traces(self, *, seed: int = 0,
                      device: str | torch.device = "cuda"
                      ) -> list[WindowTrace]:
        """The per-window composed traces for ``seed``, from launches on
        ``device``, memoized."""
        return _window_traces(self, window_seed(self.name, seed),
                              resolve_device(device))

    def offered_ai(self, *, seed: int = 0,
                   device: str | torch.device = "cuda") -> float:
        """Whole-trace arithmetic intensity: total ops / total offered
        refs over the windows."""
        wts = self.window_traces(seed=seed, device=device)
        refs = sum(wt.raw_refs for wt in wts)
        return sum(wt.flops for wt in wts) / refs if refs else 0.0

    def workload(self, *, device: str | torch.device = "cuda") -> Workload:
        """The whole-trace :class:`Workload` (window concatenation)."""
        dev = resolve_device(device)
        ai = round(self.offered_ai(device=dev), 3)
        return Workload(
            name=self.name,
            family=f"serving-{self.traffic.family}",
            expected_class=self.expected_class,
            ai_ops_per_access=ai,
            instr_per_access=round(ai + self.instr_overhead, 3),
            gen=_make_gen(self, dev),
            core_invariant=True,
        )


def _make_gen(scen: ServingScenario, dev: torch.device):
    def gen(cores: int, rng: np.random.Generator) -> TraceSpec:
        # The fleet-level offered stream: every core serves a slice of the
        # same traffic against the shared resource pool, so the per-thread
        # trace does not repartition with the core count.
        del cores
        wseed = int(rng.integers(1 << 31))  # == window_seed(name, seed)
        wts = _window_traces(scen, wseed, dev)
        addr = np.concatenate([wt.addresses for wt in wts])
        return TraceSpec(addr, l3_factor=1.0, mlp=scen.mlp,
                         dram_rows_irregular=True)

    return gen


# Window composition, memoized per (scenario name, window seed, device):
# the engine regenerates the trace once per core count, and the phase
# timeline needs the same windows again.
_WINDOW_CACHE: OrderedDict[tuple[str, int, str], list[WindowTrace]] = (
    OrderedDict())
_WINDOW_CACHE_MAX = 48


def _window_traces(scen: ServingScenario, wseed: int,
                   dev: torch.device) -> list[WindowTrace]:
    key = (scen.name, wseed, str(dev))
    got = _WINDOW_CACHE.get(key)
    if got is None:
        got = _BUILDERS[scen.kernel](scen, wseed, dev)
        _WINDOW_CACHE[key] = got
        while len(_WINDOW_CACHE) > _WINDOW_CACHE_MAX:
            _WINDOW_CACHE.popitem(last=False)
    return got


def _interleave(chunks: list[np.ndarray], chunk: int) -> np.ndarray:
    """Round-robin the slot streams in ``chunk``-word pieces (concurrent
    slots run on different cores; issue order interleaves their DMA)."""
    if len(chunks) == 1:
        return chunks[0]
    split = [
        [c[i:i + chunk] for i in range(0, c.size, chunk)] for c in chunks
    ]
    order = [
        piece
        for level in itertools.zip_longest(*split)
        for piece in level if piece is not None
    ]
    return np.concatenate(order)


def _finish(scen: ServingScenario, dem: WindowDemand,
            chunks: list[np.ndarray], flops: float,
            batch: int) -> WindowTrace:
    raw = (_interleave(chunks, _CHUNK_WORDS) if chunks
           else np.zeros(1, dtype=np.int64))
    # Fixed-ref sample of the offered stream, starting at a per-window
    # rotation: the MoE hook sorts expert ids, so a head-anchored sample
    # would keep only each window's lowest-id tiles and fake cross-window
    # reuse.
    start = (dem.step * 2654435761) % raw.size
    addresses = np.resize(np.roll(raw, -start), scen.window_refs)
    return WindowTrace(demand=dem, addresses=addresses,
                       raw_refs=int(raw.size), flops=flops, batch=batch)


def _demand_stream(dem: WindowDemand, per_req: int):
    """Per-arrival key slices of one window's demand, cycling if short."""
    keys = dem.keys
    for a in range(dem.arrivals):
        lo = a * per_req
        if lo + per_req <= keys.size:
            yield keys[lo:lo + per_req]
        else:  # cycle: the window's draws are its popularity sample
            idx = (lo + np.arange(per_req)) % keys.size
            yield keys[idx]


def _pagedkv_windows(scen: ServingScenario, wseed: int,
                     dev: torch.device) -> list[WindowTrace]:
    g = dict(scen.geometry)
    n_pages, page, d, h = g["n_pages"], g["page"], g["d"], g["h"]
    n_active = max(1, int(round(g["occupancy"] * g["pages_per_seq"])))
    demands = scen.traffic.windows(scen.n_windows, scen.traffic.rate *
                                   n_active, seed=wseed)
    batch = _SlotBatch(scen.max_batch)
    rid = 0
    out = []
    for dem in demands:
        for pages in _demand_stream(dem, n_active):
            batch.submit(_Seq(rid, pages % n_pages, scen.decode_steps))
            rid += 1
        batch.admit()
        chunks, flops = [], 0.0
        for slot in sorted(batch.active):
            res = walk(paged_capture.capture(
                n_pages=n_pages, page=page, d=d, h=h, n_active=n_active,
                page_table=batch.active[slot].payload, device=dev))
            chunks.append(res.addresses)
            flops += res.flops
        out.append(_finish(scen, dem, chunks, flops, len(batch.active)))
        batch.tick()
    return out


def _moe_windows(scen: ServingScenario, wseed: int,
                 dev: torch.device) -> list[WindowTrace]:
    g = dict(scen.geometry)
    n_experts, d, f = g["n_experts"], g["d"], g["f"]
    tokens = g["tokens_per_req"]
    demands = scen.traffic.windows(scen.n_windows, scen.traffic.rate *
                                   tokens, seed=wseed)
    # One rng across the window's captures: each draws its token order.
    rng = np.random.default_rng(wseed + stable_name_seed(scen.name))
    batch = _SlotBatch(scen.max_batch)
    rid = 0
    out = []
    for dem in demands:
        for eids in _demand_stream(dem, tokens):
            batch.submit(_Seq(rid, eids % n_experts, scen.decode_steps))
            rid += 1
        batch.admit()
        chunks, flops = [], 0.0
        for slot in sorted(batch.active):
            res = walk(moe_capture.capture(
                n_tokens=tokens, d=d, f=f, n_experts=n_experts, rng=rng,
                expert_ids=batch.active[slot].payload, device=dev))
            chunks.append(res.addresses)
            flops += res.flops
        out.append(_finish(scen, dem, chunks, flops, len(batch.active)))
        batch.tick()
    return out


def _flash_windows(scen: ServingScenario, wseed: int,
                   dev: torch.device) -> list[WindowTrace]:
    """Flash attention over a pool of per-context KV buffers.

    The traffic key picks the request's context buffer (prefix-cache slot)
    and the window's offered intensity sets its KV length, rounded up to
    the 128-row block.  A request keeps its context and length while
    slot-resident.
    """
    g = dict(scen.geometry)
    sq, d, base_sk = g["sq"], g["d"], g["base_sk"]
    pool = g["context_pool"]
    # One context buffer's worth of address space, line-aligned like the
    # walker's own operand layout, so buffers never overlap.
    probe = walk(flash_capture.capture(sq=sq, sk=base_sk, d=d, device=dev),
                 count_only=True)
    stride = -(-probe.footprint_words // 8) * 8 + 8 * 4
    demands = scen.traffic.windows(scen.n_windows, scen.traffic.rate,
                                   seed=wseed)
    batch = _SlotBatch(scen.max_batch)
    rid = 0
    out = []
    # Slots sharing a KV length walk identical geometry (only the context
    # base differs, applied below): one walk per distinct length.
    walked: dict[int, object] = {}
    for dem in demands:
        sk = max(128, -(-int(round(dem.intensity * base_sk)) // 128) * 128)
        for key in _demand_stream(dem, 1):
            ctx = int(key[0]) % pool
            batch.submit(_Seq(rid, (ctx, sk), scen.decode_steps))
            rid += 1
        batch.admit()
        chunks, flops = [], 0.0
        for slot in sorted(batch.active):
            ctx, seq_sk = batch.active[slot].payload
            res = walked.get(seq_sk)
            if res is None:
                res = walked[seq_sk] = walk(flash_capture.capture(
                    sq=sq, sk=seq_sk, d=d, device=dev))
            chunks.append(res.addresses + ctx * stride)
            flops += res.flops
        out.append(_finish(scen, dem, chunks, flops, len(batch.active)))
        batch.tick()
    return out


_BUILDERS = {
    "pagedkv": _pagedkv_windows,
    "moe": _moe_windows,
    "flashattn": _flash_windows,
}


# --------------------------------------------------------------------------
# The scenario roster, the reference's geometry verbatim: every kernel's
# resource pool exceeds the simulated 8 MiB LLC, so cold traffic misses
# and hot traffic flips the class.
# --------------------------------------------------------------------------
# paged-KV: 8192 pages x (4 tokens x d=128 x K+V) = 16 MiB pool.
_GEO_PAGED = (("d", 128), ("h", 1), ("n_pages", 8192), ("occupancy", 1.0),
              ("page", 4), ("pages_per_seq", 8))
# MoE: 256 experts x 128x128 fp32 = 16 MiB expert table.
_GEO_MOE = (("d", 128), ("f", 128), ("n_experts", 256),
            ("tokens_per_req", 8))
# flash attention: 32 context buffers x (K+V at base_sk) ~= 37 MiB pool.
_GEO_FLASH = (("base_sk", 1024), ("context_pool", 32), ("d", 128),
              ("sq", 128))


def _scenarios() -> OrderedDict[str, ServingScenario]:
    def paged(name, traffic, expected, *, occupancy=1.0, max_batch=8,
              decode_steps=2):
        geo = tuple(sorted(dict(_GEO_PAGED, occupancy=occupancy).items()))
        return ServingScenario(
            name=name, kernel="pagedkv", traffic=traffic,
            expected_class=expected, geometry=geo, max_batch=max_batch,
            decode_steps=decode_steps, mlp=6.0)

    def moe(name, traffic, expected, *, decode_steps=2):
        return ServingScenario(
            name=name, kernel="moe", traffic=traffic,
            expected_class=expected, geometry=_GEO_MOE,
            decode_steps=decode_steps, mlp=4.0)

    def flash(name, traffic, expected, *, decode_steps=2):
        return ServingScenario(
            name=name, kernel="flashattn", traffic=traffic,
            expected_class=expected, geometry=_GEO_FLASH, max_batch=4,
            decode_steps=decode_steps, mlp=8.0)

    pages, experts, ctxs = 8192, 256, 32
    entries = [
        # paged-KV decode: the page-popularity axis.
        paged("srv.pagedkv.unif",
              make_traffic("uniform", keyspace=pages, rate=4), "1a"),
        paged("srv.pagedkv.zipf1.1",
              make_traffic("zipfian", keyspace=pages, rate=4, alpha=1.1),
              "1b"),
        paged("srv.pagedkv.zipf1.4",
              make_traffic("zipfian", keyspace=pages, rate=4, alpha=1.4),
              "1b"),
        paged("srv.pagedkv.hot95",
              make_traffic("hotspot", keyspace=pages, rate=4,
                           hot_frac=0.01, hot_prob=0.95), "1b"),
        paged("srv.pagedkv.seq",
              make_traffic("sequential", keyspace=pages, rate=4), "1a"),
        paged("srv.pagedkv.burst",
              make_traffic("bursty", keyspace=pages, rate=8), "1a",
              decode_steps=1),
        paged("srv.pagedkv.diurnal.occ50",
              make_traffic("diurnal", keyspace=pages, rate=8), "1a",
              occupancy=0.5, decode_steps=1),
        paged("srv.pagedkv.zipf1.1.occ25.bs4",
              make_traffic("zipfian", keyspace=pages, rate=2, alpha=1.1,
                           name="zipfian(alpha=1.1,occ25)"), "1b",
              occupancy=0.25, max_batch=4),
        # MoE dispatch: the expert-popularity axis.
        moe("srv.moe.unif",
            make_traffic("uniform", keyspace=experts, rate=4), "1a"),
        moe("srv.moe.zipf1.4",
            make_traffic("zipfian", keyspace=experts, rate=4, alpha=1.4),
            "1b"),
        moe("srv.moe.hot90",
            make_traffic("hotspot", keyspace=experts, rate=4,
                         hot_frac=0.02, hot_prob=0.9), "1b"),
        moe("srv.moe.burst",
            make_traffic("bursty", keyspace=experts, rate=8), "1a",
            decode_steps=1),
        # flash attention: the context-reuse / load-level axis.
        flash("srv.flash.unif",
              make_traffic("uniform", keyspace=ctxs, rate=4), "1b"),
        flash("srv.flash.zipf1.2",
              make_traffic("zipfian", keyspace=ctxs, rate=4, alpha=1.2),
              "1b"),
        flash("srv.flash.burst",
              make_traffic("bursty", keyspace=ctxs, rate=4), "1b",
              decode_steps=1),
        flash("srv.flash.diurnal",
              make_traffic("diurnal", keyspace=ctxs, rate=4), "1b",
              decode_steps=1),
    ]
    return OrderedDict((s.name, s) for s in entries)


SCENARIOS: OrderedDict[str, ServingScenario] = _scenarios()


def serving_workloads(*, device: str | torch.device = "cuda"
                      ) -> list[Workload]:
    """One whole-trace :class:`Workload` per registered scenario."""
    return [s.workload(device=device) for s in SCENARIOS.values()]
