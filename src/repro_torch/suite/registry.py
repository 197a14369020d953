"""Benchmark-suite registry: many workloads, several sources, one record
(counterpart of ``repro.suite.registry``).

A :class:`SuiteEntry` per workload — synthetic (parameterized expansions
of the seven access-pattern families in :mod:`repro_torch.core.tracegen`),
captured (HBM word streams walked from launches of the port's CUDA kernels,
:mod:`repro_torch.capture.kernels`) or serving (production-traffic
scenarios, :mod:`repro_torch.serving`) — with the domain / source /
expected-class / parameter metadata the Table-3-style roster reports.

:func:`default_registry` builds the standard roster: a footprint / stride /
reuse-depth grid over every synthetic family (three points per family)
plus every captured kernel — 45 entries (21 synthetic + 24 captured), the
reference's roster entry for entry.

Identity invariants:

- **Name uniqueness** — :meth:`SuiteRegistry.register` rejects duplicate
  names; the engine keys its memo on the name.
- **Content-addressed fingerprints** — :meth:`SuiteEntry.fingerprint`
  hashes everything that determines a stored roster row, with the
  reference's recipe, so a CPU entry's digest equals the reference's.  A
  card entry adds ``device``, so a run on the card never recalls a row
  that the plain versions computed on the CPU.
- **Reconstructibility** — a registry carrying the ``refs`` and ``device``
  markers is rebuilt bit-identically by :func:`registry_for` in a worker
  process; the runner cross-checks entry and workload fingerprints before
  trusting a worker with an entry.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Iterator

import torch

from repro_torch.capture.kernels import CAPTURED_KERNELS, captured_workloads
from repro_torch.core import tracegen
from repro_torch.core.tracegen import Workload
from repro_torch.device import resolve_device

__all__ = ["SuiteEntry", "SuiteRegistry", "default_registry",
           "serving_registry", "models_registry", "registry_for",
           "SUITE_SCHEMA", "LEGACY_SCHEMA"]

# Bumped whenever capture geometry or roster methodology changes in a way
# that invalidates stored results.
SUITE_SCHEMA = 1

# Records without an in-record schema marker were written at schema 1;
# readers (and ``--gc``) treat a missing marker as this value.
LEGACY_SCHEMA = 1

SOURCES = ("synthetic", "captured", "serving", "model")

_L1_WORDS = 32 * 1024 // 8
_MiB_WORDS = 2**20 // 8


@dataclass(frozen=True)
class SuiteEntry:
    """One registered workload + its Table-3 metadata."""

    workload: Workload
    domain: str
    source: str            # "synthetic" | "captured" | "serving" | "model"
    params: tuple[tuple[str, object], ...]   # sorted (key, value) pairs
    device: str = "cpu"    # device type of the registry that built it

    def __post_init__(self) -> None:
        if self.source not in SOURCES:
            raise ValueError(f"source must be one of {'|'.join(SOURCES)}, "
                             f"got {self.source!r}")

    @property
    def name(self) -> str:
        return self.workload.name

    @property
    def expected_class(self) -> str:
        return self.workload.expected_class

    def fingerprint(self, *, seed: int, cores: tuple[int, ...],
                    backend: str = "vectorized",
                    sections: tuple[str, ...] = ()) -> str:
        """Content address of this entry's characterization record.

        ``backend`` is part of the key so an explicit ``--backend
        reference`` cross-check runs the reference loop instead of
        recalling vectorized rows.  ``sections`` joins the key only when
        non-empty and ``device`` only when it is ``"cuda"``, so a plain
        CPU roster's keys equal the reference's digests.
        """
        payload = {
            "schema": SUITE_SCHEMA,
            "name": self.name,
            "source": self.source,
            "domain": self.domain,
            "expected": self.expected_class,
            "params": [[k, repr(v)] for k, v in self.params],
            "ai": self.workload.ai_ops_per_access,
            "ipa": self.workload.instr_per_access,
            "seed": seed,
            "cores": list(cores),
            "backend": backend,
        }
        if sections:
            payload["sections"] = list(sections)
        if self.device == "cuda":
            payload["device"] = self.device
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


@dataclass
class SuiteRegistry:
    """Ordered, name-unique collection of suite entries.

    ``refs`` marks a registry that :func:`registry_for` can rebuild from
    its synthetic trace length alone, and ``device`` the device its
    captured kernels launch on: the two markers let
    :class:`~repro_torch.suite.runner.SuiteRunner` fan whole entries across
    a process pool (workload generators close over functions and devices,
    so entries cannot cross a pickle boundary; a worker rebuilds the
    registry instead).  Hand-built registries leave ``refs`` ``None`` and
    characterize in-process; one that registers workloads built on the
    card must say so with ``device``, which keys its stored rows.
    """

    entries: list[SuiteEntry] = field(default_factory=list)
    refs: int | None = None
    device: str = "cpu"
    # The --filter applied when this registry was built (models roster
    # only), carried so process-pool workers rebuild the *filtered*
    # roster: filtering subsets a roster without changing any entry.
    only: tuple[str, ...] | None = None

    def register(self, workload: Workload, *, domain: str, source: str,
                 **params: object) -> SuiteEntry:
        if any(e.name == workload.name for e in self.entries):
            raise ValueError(f"suite entry {workload.name!r} already "
                             f"registered")
        entry = SuiteEntry(
            workload=workload, domain=domain, source=source,
            params=tuple(sorted(params.items())),
            device=torch.device(self.device).type,
        )
        self.entries.append(entry)
        return entry

    def __iter__(self) -> Iterator[SuiteEntry]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def workloads(self) -> list[Workload]:
        return [e.workload for e in self.entries]

    def by_source(self, source: str) -> list[SuiteEntry]:
        return [e for e in self.entries if e.source == source]


# --------------------------------------------------------------------------
# The synthetic expansion: three parameter points per family, inside the
# envelope make_suite's jitter covers (so the family's class is preserved).
# --------------------------------------------------------------------------
def _synthetic_grid(refs: int) -> list[tuple[Workload, dict]]:
    out: list[tuple[Workload, dict]] = []

    def add(name: str, family: str, ai: float, ipa: float, gen, **params):
        out.append((
            Workload(name, family, tracegen.FAMILIES[family], ai, ipa, gen),
            dict(params, refs=refs),
        ))

    # STREAM's trace is footprint-invariant (one sequential sweep, no
    # reuse), so the grid axis is the op mix: copy/scale/triad differ in
    # arithmetic per word moved (AI) and instruction overhead (MPKI).
    for op, ai, ipa in (("copy", 0.55, 2.0), ("scale", 1.0, 2.3),
                        ("triad", 1.3, 2.6)):
        add(f"syn.stream.{op}", "stream", ai, ipa,
            tracegen._stream(64 * _MiB_WORDS, refs),
            op=op, footprint_mib=64)
    for mib in (32, 64, 96):  # footprint grid (edge/hash tables)
        add(f"syn.irregular.{mib}MiB", "irregular", 1.1, 2.5,
            tracegen._irregular(mib * _MiB_WORDS, refs), footprint_mib=mib)
    for mib, every, ipa in ((64, 8, 16.0), (32, 8, 18.0), (64, 10, 14.0)):
        add(f"syn.chase.{mib}MiB.e{every}", "chase", 1.0, ipa,
            tracegen._chase(mib * _MiB_WORDS, refs, cold_every=every),
            footprint_mib=mib, cold_every=every)
    for mib in (12, 24, 48):  # per-problem tile footprints
        add(f"syn.blocked.{mib}MiB", "blocked", 1.1, 15.0,
            tracegen._blocked(mib * _MiB_WORDS, 2 * refs),
            footprint_mib=mib, trace_refs=2 * refs)
    for lines, sweeps in ((8000, 5), (6000, 6), (7000, 5)):
        add(f"syn.contended.{lines}l.s{sweeps}", "contended", 1.4, 11.0,
            tracegen._contended(lines, run=3, sweeps=sweeps),
            distinct_lines=lines, sweeps=sweeps)
    for factor in (1.4, 1.7, 2.0):  # working set vs the 32 KB L1
        ws = int(_L1_WORDS * factor)
        add(f"syn.l1cap.{factor:.1f}xL1", "l1cap", 1.4, 9.0,
            tracegen._l1cap(ws, refs, run=9, stream_every=6),
            ws_over_l1=factor)
    for factor, ai in ((1.8, 16.0), (2.2, 24.0), (2.8, 32.0)):
        blk = int(_L1_WORDS * factor)
        add(f"syn.gemm.{factor:.1f}xL1", "gemm", ai, 22.0,
            tracegen._gemm(blk, refs, run=9), block_over_l1=factor)
    return out


_SYNTH_DOMAINS = {
    "stream": "HPC/streaming",
    "irregular": "graph/analytics",
    "chase": "data-structure/pointer",
    "blocked": "image/tiled-stencil",
    "contended": "HPC/shared-LLC",
    "l1cap": "linear-algebra/small-ws",
    "gemm": "linear-algebra/blocked",
}


def default_registry(*, refs: int | None = None,
                     device: str | torch.device = "cuda") -> SuiteRegistry:
    """The standard roster: 21 synthetic grid points + 24 captured kernels.

    ``refs`` is the synthetic trace length (default
    :data:`repro_torch.core.tracegen.DEFAULT_REFS`); captured traces carry
    their own per-kernel lengths and do not shrink with it.  The captured
    entries launch their kernels on ``device`` (a count-only walk of each
    at construction, for its AI; raises without a card when it is
    ``"cuda"``).
    """
    refs = tracegen.DEFAULT_REFS if refs is None else refs
    dev = resolve_device(device)
    reg = SuiteRegistry(refs=refs, device=str(dev))
    for w, params in _synthetic_grid(refs):
        reg.register(w, domain=_SYNTH_DOMAINS[w.family], source="synthetic",
                     **params)
    for spec, w in zip(CAPTURED_KERNELS, captured_workloads(device=dev)):
        reg.register(w, domain=spec.domain, source="captured",
                     **spec.params())
    return reg


def serving_registry(*, refs: int | None = None,
                     device: str | torch.device = "cuda") -> SuiteRegistry:
    """The serving roster: one entry per registered traffic scenario, its
    windows composed from kernel launches on ``device``.

    Serving traces do not scale with ``refs``; the marker is carried so a
    process-pool worker can rebuild this registry via :func:`registry_for`.
    """
    from repro_torch.serving.scenario import SCENARIOS, serving_workloads

    refs = tracegen.DEFAULT_REFS if refs is None else refs
    dev = resolve_device(device)
    reg = SuiteRegistry(refs=refs, device=str(dev))
    for scen, w in zip(SCENARIOS.values(), serving_workloads(device=dev)):
        reg.register(w, domain=f"serving/{scen.kernel}", source="serving",
                     **scen.params())
    return reg


def models_registry(*, refs: int | None = None,
                    only: tuple[str, ...] | None = None,
                    device: str | torch.device = "cuda") -> SuiteRegistry:
    """The whole-model roster: one entry per swept model-zoo point —
    (config, mode, batch, cache/sequence geometry), 176 entries over the
    10 smoke configs.

    Every entry's AI and expected class are pinned in the zoo
    declarations, so building the registry captures nothing; a step is
    captured (abstractly, on ``meta``) when its trace is first simulated.
    Model traces do not scale with ``refs`` (the marker is carried for
    worker reconstruction).  ``device`` is where the roster runs (it keys
    card rows, as the other rosters' do; raises without a card when it is
    ``"cuda"``).  ``only`` keeps entries whose name contains any of the
    substrings; filtering changes neither traces nor fingerprints, so
    store rows recall across differently filtered runs.
    """
    from repro_torch.capture.zoo import model_workloads, select

    refs = tracegen.DEFAULT_REFS if refs is None else refs
    dev = resolve_device(device)
    reg = SuiteRegistry(refs=refs, device=str(dev), only=only)
    specs = select(only)
    for spec, w in zip(specs, model_workloads(specs)):
        reg.register(w, domain=spec.domain, source="model", **spec.params())
    return reg


def registry_for(*, refs: int | None = None,
                 sections: tuple[str, ...] = (),
                 only: tuple[str, ...] | None = None,
                 device: str | torch.device = "cuda") -> SuiteRegistry:
    """The registry a roster request resolves to: the serving roster when
    the ``serving`` section is requested, the whole-model roster for the
    ``models`` section, the default roster otherwise.  Both the CLI and
    the process-pool workers route through here; workers pass the parent
    registry's ``only`` marker, which subsets the models roster without
    changing any entry."""
    if "serving" in sections:
        return serving_registry(refs=refs, device=device)
    if "models" in sections:
        return models_registry(refs=refs, only=only, device=device)
    return default_registry(refs=refs, device=device)
