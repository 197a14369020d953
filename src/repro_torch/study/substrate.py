"""Pluggable characterization substrates (counterpart of
``repro.study.substrate``).

DAMOV Step 3 asks one question — *where does this program's data movement
stall?* — and the port answers it on two substrates:

=============  ===========================================================
substrate      evidence
=============  ===========================================================
``trace``      word-address traces through the functional cache simulator
               (``repro_torch.core.cachesim``): AI / MPKI / LFMR -> six
               classes
``suite``      the registered benchmark roster (``repro_torch.suite``):
               synthetic family expansions + traces walked from launches
               of the port's CUDA kernels, characterized like ``trace``
               and persisted to the content-addressed result store
=============  ===========================================================

The reference's third substrate, ``hlo`` (compiled-XLA roofline terms
against a TPU), has no port yet: :func:`get_substrate` raises for it and
names the ROADMAP item that ports the cost substrate.

Both implement the :class:`Substrate` protocol — ``characterize()``
returns a columnar :class:`~repro_torch.study.result.StudyResult` whose
rows always start with ``(name, class)`` — so callers (the ``python -m
repro_torch.study`` CLI, the benchmark driver) can swap backends with a
flag.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from .result import StudyResult
from .study import Study

__all__ = ["Substrate", "TraceSubstrate", "SuiteSubstrate", "get_substrate",
           "HLO_NOT_PORTED"]

HLO_NOT_PORTED = (
    "the 'hlo' substrate (XLA cost analysis against a TPU) is not ported "
    "yet: it waits for ROADMAP.md's \"the cost substrate\"")


@runtime_checkable
class Substrate(Protocol):
    """A backend that assigns every item a data-movement bottleneck class."""

    name: str

    def items(self) -> list[str]:
        """Names of the items this substrate characterizes."""
        ...

    def characterize(self) -> StudyResult:
        """One record per item; rows start with (name, class)."""
        ...


class TraceSubstrate:
    """Trace-driven cache-simulation backend (the paper's methodology)."""

    name = "trace"

    def __init__(self, study: Study):
        self.study = study

    def items(self) -> list[str]:
        return self.study.names()

    def characterize(self) -> StudyResult:
        cols = ("name", "class", "expected", "spatial", "temporal", "ai",
                "mpki", "lfmr_mean", "lfmr_slope")
        res = StudyResult("trace_characterization", cols)
        for w in self.study:
            s, t = self.study.locality(w)
            m = self.study.metrics(w)
            res.append((w.name, self.study.classify(w), w.expected_class,
                        round(s, 3), round(t, 3), round(m.ai, 3),
                        round(m.mpki, 2), round(m.lfmr_mean, 3),
                        round(m.lfmr_slope, 3)))
        return res


class SuiteSubstrate:
    """The registered benchmark roster (synthetic workloads + traces walked
    from the port's kernel launches) as a substrate: one row per suite
    entry, rows starting with (name, class), metrics identical to the
    ``trace`` path.

    ``repro_torch.suite`` imports are deferred to call time so importing
    this module stays cheap; pass ``runner`` to share an existing
    engine/store.  A self-built runner launches the captured entries'
    kernels on ``device`` (default ``"cuda"``, which raises without a
    card) and persists to the default result store (as ``python -m
    repro_torch.suite`` does); pass ``store=None`` for pure compute.
    """

    name = "suite"

    _DEFAULT_STORE = object()

    def __init__(self, *, runner=None, refs: int | None = None,
                 store=_DEFAULT_STORE, device: str = "cuda"):
        if runner is None:
            from repro_torch.suite import (ResultStore, SuiteRunner,
                                           default_registry)
            if store is self._DEFAULT_STORE:
                store = ResultStore()
            runner = SuiteRunner(default_registry(refs=refs, device=device),
                                 store=store)
        self.runner = runner

    def items(self) -> list[str]:
        return [e.name for e in self.runner.registry]

    def characterize(self) -> StudyResult:
        roster = self.runner.roster()
        cols = ("name", "class") + tuple(
            c for c in roster.columns if c not in ("name", "assigned"))
        res = StudyResult("suite_characterization", cols)
        idx = [roster.columns.index(c if c != "class" else "assigned")
               for c in cols]
        for row in roster:
            res.append(tuple(row[i] for i in idx))
        return res


def get_substrate(name: str, *, study: Study | None = None,
                  refs: int | None = None) -> Substrate:
    """Factory behind the ``--substrate trace|suite`` CLI flag; ``hlo``
    raises ``NotImplementedError`` (ROADMAP.md's "the cost substrate")."""
    if name == "trace":
        return TraceSubstrate(study if study is not None else Study())
    if name == "hlo":
        raise NotImplementedError(HLO_NOT_PORTED)
    if name == "suite":
        return SuiteSubstrate(refs=refs)
    raise ValueError(
        f"unknown substrate {name!r}; expected 'trace', 'hlo' or 'suite'")
