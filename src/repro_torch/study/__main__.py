"""CLI entry point: ``python -m repro_torch.study`` (counterpart of
``python -m repro.study``).

Runs a characterization study and emits columnar tables as CSV or JSON.

Examples::

    # classify the synthetic DAMOV suite (fast traces), CSV to stdout
    python -m repro_torch.study --refs 20000 --sections classify

    # full metric + scalability tables, the window scans on the card
    python -m repro_torch.study --sections metrics,scalability,energy \
        --backend cuda --format json --out study.json

    # restrict the core sweep / suite, add jittered variants
    python -m repro_torch.study --cores 1,4,16 --workloads STRCpy,CHAHsti

    # the registered benchmark suite (synthetic + traces of the port's
    # CUDA kernels launched on the card; --device cpu runs their plain
    # PyTorch versions)
    python -m repro_torch.study --substrate suite --refs 20000

The reference's ``--substrate hlo`` (XLA cost analysis against a TPU) has
no port yet and exits non-zero naming ROADMAP.md's "the cost substrate".
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import obs
from repro_torch.core.cachesim import BACKENDS
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.core.tracegen import DEFAULT_REFS

from .cliutil import emit_tables, parse_cores
from .result import StudyResult
from .study import Study
from .substrate import HLO_NOT_PORTED, SuiteSubstrate, get_substrate

SECTIONS = ("characterize", "metrics", "classify", "scalability", "energy")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.study",
        description="Unified DAMOV characterization pipeline "
                    "(PyTorch/CUDA port)",
    )
    ap.add_argument("--substrate", choices=("trace", "hlo", "suite"),
                    default="trace",
                    help="trace-driven cache simulation, or the registered "
                         "benchmark suite (synthetic + traces of the port's "
                         "CUDA kernels); 'hlo' is not ported yet")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="cache-simulation implementation; default: "
                         "$REPRO_SIM_BACKEND or 'vectorized' ('cuda' runs "
                         "the window scans on the card)")
    ap.add_argument("--refs", type=int, default=DEFAULT_REFS,
                    help="references per synthetic trace")
    ap.add_argument("--variants", type=int, default=1,
                    help="jittered clones per workload family")
    ap.add_argument("--suite-seed", type=int, default=0,
                    help="suite-generation (jitter) seed")
    ap.add_argument("--seed", type=int, default=0, help="trace seed")
    ap.add_argument("--cores", type=parse_cores, default=CORE_SWEEP,
                    metavar="1,4,16,...", help="core sweep")
    ap.add_argument("--workloads", default=None,
                    metavar="NAME[,NAME...]",
                    help="restrict the suite to these workloads")
    ap.add_argument("--sections", default="characterize",
                    metavar=",".join(SECTIONS),
                    help="which tables to emit (trace substrate)")
    ap.add_argument("--format", choices=("csv", "json"), default="csv")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a repro_torch.obs span/counter trace "
                         "(JSONL); read it with `python -m repro_torch.obs "
                         "report FILE`")
    ap.add_argument("--stats", action="store_true",
                    help="print engine hit/miss stats to stderr")
    ap.add_argument("--device", default=None,
                    help="where the suite substrate's kernels run: cuda "
                         "(default; raises without a card) or cpu (plain "
                         "PyTorch versions); suite substrate only")
    return ap


def _trace_tables(study: Study, sections: list[str]) -> list[StudyResult]:
    out: list[StudyResult] = []
    for sec in sections:
        if sec == "characterize":
            out.append(get_substrate("trace", study=study).characterize())
        elif sec == "metrics":
            out.append(study.metrics_table())
        elif sec == "classify":
            out.append(study.classification_table())
        elif sec == "scalability":
            out.append(study.scalability_table())
        elif sec == "energy":
            out.append(study.energy_table())
        else:
            raise SystemExit(
                f"unknown section {sec!r}; expected one of {SECTIONS}")
    return out


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.trace:
        obs.enable(args.trace)
    try:
        with obs.span("study.run", substrate=args.substrate):
            return _main(args)
    finally:
        if args.trace:
            obs.disable()


def _main(args: argparse.Namespace) -> int:
    trace_only = {"--sections": args.sections != "characterize",
                  "--workloads": bool(args.workloads),
                  "--variants": args.variants != 1,
                  "--suite-seed": args.suite_seed != 0}
    if args.substrate != "trace" and any(trace_only.values()):
        # These flags shape the trace pipeline only; silently emitting the
        # default table instead would mislead the caller.
        bad = ", ".join(k for k, v in trace_only.items() if v)
        raise SystemExit(
            f"error: {bad} applies to the trace substrate; the "
            f"{args.substrate!r} substrate always emits its "
            f"characterization table")
    if args.substrate != "suite" and args.device is not None:
        # Only the suite substrate launches kernels; ignoring the flag
        # would mislead the caller as the trace-only flags would.
        raise SystemExit(
            f"error: --device applies to the suite substrate; the "
            f"{args.substrate!r} substrate does not take it")

    if args.substrate == "hlo":
        raise SystemExit(f"error: {HLO_NOT_PORTED}")
    if args.substrate == "suite":
        from repro_torch.suite import (ResultStore, SuiteRunner,
                                       default_registry)

        runner = SuiteRunner(default_registry(refs=args.refs,
                                              device=args.device or "cuda"),
                             seed=args.seed, cores=args.cores,
                             backend=args.backend, store=ResultStore())
        tables = [SuiteSubstrate(runner=runner).characterize()]
        stats = runner.study.stats
    else:
        study = Study(refs=args.refs, variants=args.variants,
                      suite_seed=args.suite_seed, seed=args.seed,
                      cores=args.cores, backend=args.backend)
        if args.workloads:
            try:
                suite = [study.workload(n) for n in args.workloads.split(",")]
            except KeyError as e:
                raise SystemExit(f"error: {e.args[0]}")
            study = Study(suite=suite, seed=args.seed, cores=args.cores,
                          engine=study.engine)
        sections = [s for s in args.sections.split(",") if s]
        tables = _trace_tables(study, sections)
        stats = study.stats

    emit_tables(tables, fmt=args.format, out=args.out)

    if args.stats:
        print(f"# engine: {stats.as_dict()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
