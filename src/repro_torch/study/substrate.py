"""Pluggable characterization substrates (counterpart of
``repro.study.substrate``).

DAMOV Step 3 asks one question — *where does this program's data movement
stall?* — and the port answers it on three substrates:

=============  ===========================================================
substrate      evidence
=============  ===========================================================
``trace``      word-address traces through the functional cache simulator
               (``repro_torch.core.cachesim``): AI / MPKI / LFMR -> six
               classes
``hlo``        the cost terms of the launch layer's cells
               (``repro_torch.core.hlo_analysis`` +
               ``repro_torch.core.analytic``) against the H100 SXM:
               compute / HBM / collective roofline -> compute | hbm |
               collective | latency classes
``suite``      the registered benchmark roster (``repro_torch.suite``):
               synthetic family expansions + traces walked from launches
               of the port's CUDA kernels, characterized like ``trace``
               and persisted to the content-addressed result store
=============  ===========================================================

All implement the :class:`Substrate` protocol — ``characterize()``
returns a columnar :class:`~repro_torch.study.result.StudyResult` whose
rows always start with ``(name, class)`` — so callers (the ``python -m
repro_torch.study`` CLI, the benchmark driver) can swap backends with a
flag.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.hlo_analysis import H100_SXM

from .result import StudyResult
from .study import Study

__all__ = ["Substrate", "TraceSubstrate", "HloSubstrate", "SuiteSubstrate",
           "get_substrate", "DEFAULT_HW"]

# The card the ``hlo`` substrate's roofline terms are taken against.
DEFAULT_HW = H100_SXM


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


class HloSubstrate:
    """The cost backend: the same Step-3 question answered from analytic
    FLOP / HBM-byte / collective-byte roofline terms per (arch x shape x
    mesh) cell of the launch layer (``repro_torch.launch.cells``), against
    ``hw`` (default :data:`DEFAULT_HW`, the H100 SXM, read when the
    substrate is made)."""

    name = "hlo"

    def __init__(self, *, meshes: tuple[str, ...] = ("16x16", "2x16x16"),
                 model_shards: int = 16, hw=None):
        self.meshes = meshes
        self.model_shards = model_shards
        self.hw = hw if hw is not None else DEFAULT_HW

    @staticmethod
    def _chips(mesh_name: str) -> int:
        """Chip count is the product of the mesh dims ('2x16x16' -> 512)."""
        n = 1
        for d in mesh_name.split("x"):
            n *= int(d)
        return n

    def _plans(self):
        from repro_torch.launch.cells import all_cells
        return list(all_cells())

    def items(self) -> list[str]:
        return [f"{p.name}@{m}" for p in self._plans() for m in self.meshes]

    def characterize(self) -> StudyResult:
        from repro_torch.core import analytic, hlo_analysis

        cols = ("name", "class", "arch", "shape", "mesh", "ai",
                "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                "mfu_bound")
        res = StudyResult("hlo_characterization", cols)
        for plan in self._plans():
            for mesh_name in self.meshes:
                chips = self._chips(mesh_name)
                model_shards = self.model_shards
                c = analytic.cell_cost(
                    plan.cfg, plan.shape, kind=plan.kind,
                    microbatches=plan.microbatches,
                    data_shards=chips // model_shards,
                    model_shards=model_shards,
                    infer_fsdp=plan.infer_fsdp,
                )
                tokens = plan.shape.global_batch * (
                    plan.shape.seq_len if plan.kind != "decode" else 1)
                rt = hlo_analysis.RooflineTerms(
                    name=f"{plan.name}@{mesh_name}", chips=chips,
                    hlo_flops=c.flops, hlo_bytes=c.hbm_bytes,
                    collective_bytes=c.collective_bytes,
                    model_flops=plan.cfg.model_flops(
                        tokens, training=plan.kind == "train"),
                    hw=self.hw,
                )
                res.append((rt.name, rt.bottleneck_class, plan.arch,
                            plan.shape.name, mesh_name,
                            round(rt.arithmetic_intensity, 3),
                            f"{rt.t_compute:.3e}", f"{rt.t_memory:.3e}",
                            f"{rt.t_collective:.3e}", rt.dominant,
                            round(rt.mfu_bound, 3)))
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
    """Factory behind the ``--substrate trace|hlo|suite`` CLI flag."""
    if name == "trace":
        return TraceSubstrate(study if study is not None else Study())
    if name == "hlo":
        return HloSubstrate()
    if name == "suite":
        return SuiteSubstrate(refs=refs)
    raise ValueError(
        f"unknown substrate {name!r}; expected 'trace', 'hlo' or 'suite'")
