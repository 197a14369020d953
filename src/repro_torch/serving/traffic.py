"""Serving-traffic processes: request arrivals + key popularity per window
(counterpart of ``repro.serving.traffic``; pure numpy, the same draws).

A production serving fleet's memory behavior is driven by *traffic shape*,
not kernel geometry alone: the same paged-KV decode kernel is
latency-bound streaming under cold uniform traffic and cache-resident
under Zipfian prefix reuse.  This module models that axis as a
:class:`TrafficProcess` — a named, seeded generator of per-window
:class:`WindowDemand` records (how many requests arrive, at what offered
intensity, touching which keys).

The family roster mirrors the cxl-fabric-sim ``WorkloadPattern`` set
(UniformRandom / Zipfian / Hotspot / Bursty / Sequential) plus a mixed
``diurnal`` shape, re-expressed as window-level demand rather than raw
memory requests — the scenarios in :mod:`repro_torch.serving.scenario` turn
demand into HBM traces by composing it with captured kernel geometries.

Keys are abstract resource indices: page-pool slots for paged-KV decode,
expert ids for MoE dispatch.  Seeding follows the repo-wide crc32
convention (:func:`repro_torch.core.tracegen.stable_name_seed`), so every
window's draws are PYTHONHASHSEED-independent and identical across
interpreter launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.tracegen import stable_name_seed

__all__ = ["WindowDemand", "TrafficProcess", "TRAFFIC_FAMILIES",
           "make_traffic"]

# family -> one-line description (traffic *shapes* over captured kernels,
# not standalone address generators).
TRAFFIC_FAMILIES = {
    "uniform":    "cold uniform keys at steady peak rate (no reuse)",
    "zipfian":    "rank-alpha key popularity at steady rate (head reuse)",
    "hotspot":    "hot_prob of traffic inside a hot_frac key set",
    "bursty":     "on/off Markov: cold uniform bursts vs hot lulls",
    "sequential": "contiguous key scan advancing window to window",
    "diurnal":    "sinusoidal load; off-peak traffic stays on hot keys",
}


@dataclass(frozen=True)
class WindowDemand:
    """Offered traffic of one scheduling window."""

    step: int
    arrivals: int           # new requests this window (>= 1)
    intensity: float        # offered-load fraction of peak, in (0, 1]
    keys: np.ndarray        # int64 key draws in [0, keyspace), demand order


@dataclass(frozen=True)
class TrafficProcess:
    """One named traffic shape over an abstract keyspace.

    ``params`` is a sorted (name, value) tuple so the process is hashable
    (it rides inside frozen scenario dataclasses and the suite fingerprint
    params) and so two processes differing only in a shape parameter never
    alias.
    """

    name: str
    family: str
    keyspace: int
    rate: int                                       # peak arrivals/window
    params: tuple[tuple[str, float], ...] = ()

    def __post_init__(self) -> None:
        if self.family not in TRAFFIC_FAMILIES:
            raise ValueError(f"unknown traffic family {self.family!r}; "
                             f"expected one of {sorted(TRAFFIC_FAMILIES)}")
        if self.keyspace < 1 or self.rate < 1:
            raise ValueError("keyspace and rate must be >= 1")

    def param(self, key: str, default: float) -> float:
        return dict(self.params).get(key, default)

    def windows(self, n_windows: int, draws: int, *,
                seed: int = 0) -> list[WindowDemand]:
        """``n_windows`` demand records, ``draws`` key draws per window.

        The rng is derived from ``seed + stable_name_seed(name)`` — the
        same convention ``Workload.trace`` uses — so demand streams are
        deterministic per (process name, seed) and independent of
        PYTHONHASHSEED.
        """
        rng = np.random.default_rng(seed + stable_name_seed(self.name))
        return _GENERATORS[self.family](self, n_windows, draws, rng)


# --------------------------------------------------------------------------
# Per-family sequence generators.  Each builds the whole window sequence
# from one rng, window by window in order — the draw order is part of the
# family's contract (changing it changes every downstream trace).
# --------------------------------------------------------------------------
def _zipf_weights(keyspace: int, alpha: float) -> np.ndarray:
    w = np.arange(1, keyspace + 1, dtype=np.float64) ** -alpha
    return w / w.sum()


def _hot_set(p: TrafficProcess, default_frac: float) -> int:
    return max(1, int(round(p.keyspace * p.param("hot_frac", default_frac))))


def _uniform(p: TrafficProcess, n: int, draws: int,
             rng: np.random.Generator) -> list[WindowDemand]:
    return [
        WindowDemand(w, p.rate, 1.0,
                     rng.integers(0, p.keyspace, size=draws, dtype=np.int64))
        for w in range(n)
    ]


def _zipfian(p: TrafficProcess, n: int, draws: int,
             rng: np.random.Generator) -> list[WindowDemand]:
    weights = _zipf_weights(p.keyspace, p.param("alpha", 1.1))
    return [
        WindowDemand(w, p.rate, 1.0,
                     rng.choice(p.keyspace, size=draws,
                                p=weights).astype(np.int64))
        for w in range(n)
    ]


def _hotspot(p: TrafficProcess, n: int, draws: int,
             rng: np.random.Generator) -> list[WindowDemand]:
    hot_n = _hot_set(p, 0.02)
    hot_prob = p.param("hot_prob", 0.9)
    cold_lo = min(hot_n, p.keyspace - 1)
    out = []
    for w in range(n):
        hot = rng.random(draws) < hot_prob
        keys = np.where(
            hot,
            rng.integers(0, hot_n, size=draws, dtype=np.int64),
            rng.integers(cold_lo, p.keyspace, size=draws, dtype=np.int64),
        )
        out.append(WindowDemand(w, p.rate, 1.0, keys))
    return out


def _bursty(p: TrafficProcess, n: int, draws: int,
            rng: np.random.Generator) -> list[WindowDemand]:
    """On/off Markov chain over windows.

    ON windows are a cold burst — peak arrivals, uniform keys over the
    whole space; OFF windows are the lull — a trickle of requests from
    the hot working set (regulars keep their prefixes warm).  One state
    draw per window keeps the phase pattern deterministic per
    (name, seed).
    """
    p_on_off = p.param("p_on_off", 0.5)
    p_off_on = p.param("p_off_on", 0.5)
    off_level = p.param("off_level", 0.125)
    hot_n = _hot_set(p, 1.0 / 64.0)
    on = bool(p.param("start_on", 0.0))
    out = []
    for w in range(n):
        flip = rng.random()
        on = (flip >= p_on_off) if on else (flip < p_off_on)
        if on:
            keys = rng.integers(0, p.keyspace, size=draws, dtype=np.int64)
            out.append(WindowDemand(w, p.rate, 1.0, keys))
        else:
            keys = rng.integers(0, hot_n, size=draws, dtype=np.int64)
            out.append(WindowDemand(
                w, max(1, int(round(p.rate * off_level))), off_level, keys))
    return out


def _sequential(p: TrafficProcess, n: int, draws: int,
                rng: np.random.Generator) -> list[WindowDemand]:
    del rng  # fully deterministic scan
    out = []
    for w in range(n):
        start = (w * draws) % p.keyspace
        keys = (start + np.arange(draws, dtype=np.int64)) % p.keyspace
        out.append(WindowDemand(w, p.rate, 1.0, keys))
    return out


def _diurnal(p: TrafficProcess, n: int, draws: int,
             rng: np.random.Generator) -> list[WindowDemand]:
    """Sinusoidal offered load; the key mix tracks it — peak windows are
    dominated by cold one-off keys, troughs by the hot regulars."""
    period = max(2.0, p.param("period", 8.0))
    floor = p.param("floor", 0.1)
    hot_n = _hot_set(p, 1.0 / 64.0)
    out = []
    for w in range(n):
        intensity = floor + (1.0 - floor) * 0.5 * (
            1.0 - np.cos(2.0 * np.pi * w / period))
        cold = rng.random(draws) < intensity
        keys = np.where(
            cold,
            rng.integers(0, p.keyspace, size=draws, dtype=np.int64),
            rng.integers(0, hot_n, size=draws, dtype=np.int64),
        )
        arrivals = max(1, int(round(p.rate * intensity)))
        out.append(WindowDemand(w, arrivals, float(intensity), keys))
    return out


_GENERATORS = {
    "uniform": _uniform,
    "zipfian": _zipfian,
    "hotspot": _hotspot,
    "bursty": _bursty,
    "sequential": _sequential,
    "diurnal": _diurnal,
}


def make_traffic(family: str, *, keyspace: int, rate: int,
                 name: str | None = None, **params: float) -> TrafficProcess:
    """Build a :class:`TrafficProcess` with a canonical derived name.

    The default name folds the shape parameters in
    (``zipfian(alpha=1.1)``) so two parameterizations never share a seed
    offset; pass ``name`` to pin a scenario-specific one instead.
    """
    items = tuple(sorted(params.items()))
    if name is None:
        inner = ",".join(f"{k}={v:g}" for k, v in items)
        name = f"{family}({inner})" if inner else family
    return TrafficProcess(name=name, family=family, keyspace=keyspace,
                          rate=rate, params=items)
