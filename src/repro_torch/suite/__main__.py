"""CLI entry point: ``python -m repro_torch.suite``.

Characterizes the registered benchmark suite — synthetic family expansions
plus captured traces walked from launches of the port's CUDA kernels on
the device — and emits the Table-3-style roster (name, domain, source,
metrics, assigned vs expected class) with a per-class histogram, in the
reference CLI's output format.

Examples::

    # on the card: short synthetic traces, exit 2 if any captured entry's
    # class diverges from its expected one
    python -m repro_torch.suite --fast --check

    # plain PyTorch versions on the CPU, JSON, no result store
    python -m repro_torch.suite --device cpu --fast --json --no-store

    # per-entry scalability + energy columns, whole entries over 4 processes
    python -m repro_torch.suite --sections scalability,energy --processes 4

    # the serving roster: traffic scenarios with phase timelines and the
    # best-mitigation columns
    python -m repro_torch.suite --sections serving --fast --check

    # the window scans on the card, with a span/counter trace
    python -m repro_torch.suite --fast --backend cuda --trace t.jsonl
    python -m repro_torch.obs report t.jsonl

    # prune store records from old schema versions
    python -m repro_torch.suite --gc
"""

from __future__ import annotations

import argparse
import sys

from repro_torch import obs
from repro_torch.core.cachesim import BACKENDS
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.core.tracegen import DEFAULT_REFS
from repro_torch.study.cliutil import emit_tables, parse_cores

from .registry import LEGACY_SCHEMA, SOURCES, SUITE_SCHEMA, registry_for
from .runner import SECTION_COLUMNS, SuiteRunner
from .store import ResultStore, default_store_root

FAST_REFS = 20_000


def parse_sections(text: str) -> tuple[str, ...]:
    """Comma list of roster sections -> validated tuple.  ``table3`` (the
    plain roster's paper name) adds no columns and is dropped."""
    sections = tuple(s.strip() for s in text.split(",") if s.strip()
                     and s.strip() != "table3")
    unknown = set(sections) - set(SECTION_COLUMNS)
    if unknown:
        raise argparse.ArgumentTypeError(
            f"unknown section(s) {sorted(unknown)}; "
            f"choose from {sorted(SECTION_COLUMNS) + ['table3']}")
    return sections


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.suite",
        description="DAMOV benchmark-suite roster: synthetic workloads and "
                    "the port's CUDA kernels under one methodology")
    ap.add_argument("--fast", action="store_true",
                    help=f"short synthetic traces ({FAST_REFS} refs; "
                         "captured traces keep their real lengths)")
    ap.add_argument("--refs", type=int, default=None,
                    help="synthetic trace length "
                         f"(default {DEFAULT_REFS}, --fast {FAST_REFS})")
    ap.add_argument("--seed", type=int, default=0, help="trace seed")
    ap.add_argument("--cores", type=parse_cores, default=CORE_SWEEP,
                    metavar="1,4,16,...", help="core sweep")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="cache-simulation implementation; default: "
                         "$REPRO_SIM_BACKEND or 'vectorized'")
    ap.add_argument("--sections", type=parse_sections, default=(),
                    metavar="S[,S]",
                    help="append per-entry roster sections: "
                         f"{','.join(sorted(SECTION_COLUMNS))} (computed "
                         "from the same memoized engine cells; stored "
                         "under section-specific record keys)")
    ap.add_argument("--processes", type=int, default=1, metavar="N",
                    help="fan whole entries across N worker processes "
                         "(0 = one per CPU; default 1 = in-process)")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="result-store root (default "
                         "$REPRO_TORCH_SUITE_STORE or "
                         f"{default_store_root()})")
    ap.add_argument("--no-store", action="store_true",
                    help="do not read or write the on-disk result store")
    ap.add_argument("--gc", action="store_true",
                    help="prune result-store records from old schema "
                         "versions plus corrupt records, then exit")
    ap.add_argument("--list", action="store_true",
                    help="print the roster entries without simulating")
    ap.add_argument("--check", action="store_true",
                    help="exit 2 if any captured or serving entry's "
                         "assigned class diverges from its expected class")
    ap.add_argument("--format", choices=("csv", "json"), default="csv")
    ap.add_argument("--json", action="store_const", dest="format",
                    const="json", help="shorthand for --format json")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--stats", action="store_true",
                    help="print store/engine hit-miss stats to stderr")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a repro_torch.obs span/counter trace "
                         "(JSONL, appended; worker processes merge into the "
                         "same file); read it with `python -m "
                         "repro_torch.obs report FILE`")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (default; raises "
                         "without a card) or cpu (plain PyTorch versions)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    refs = args.refs if args.refs is not None else (
        FAST_REFS if args.fast else DEFAULT_REFS)
    if args.trace:
        # Before the runner exists: enable() exports REPRO_TORCH_TRACE, so
        # --processes workers append to the same file.
        obs.enable(args.trace)
    try:
        return _main(args, refs)
    finally:
        if args.trace:
            obs.disable()  # flush counters, close the stream


def _main(args: argparse.Namespace, refs: int) -> int:
    if args.gc:
        store = ResultStore(args.store)
        removed = store.prune(
            lambda key, rec: rec.get("schema", LEGACY_SCHEMA) == SUITE_SCHEMA)
        print(f"# gc: pruned {removed} stale record(s), "
              f"{len(store)} kept in {store.root}", file=sys.stderr)
        return 0

    with obs.span("suite.registry", refs=refs,
                  sections=",".join(args.sections) or "-"):
        registry = registry_for(refs=refs, sections=args.sections,
                                device=args.device)
    if args.list:
        for e in registry:
            params = ", ".join(f"{k}={v}" for k, v in e.params)
            print(f"{e.name:40s} {e.source:9s} {e.domain:24s} "
                  f"expected={e.expected_class}  [{params}]")
        split = ", ".join(f"{len(registry.by_source(s))} {s}"
                          for s in SOURCES if registry.by_source(s))
        print(f"# {len(registry)} entries ({split})")
        return 0

    store = None if args.no_store else ResultStore(args.store)
    runner = SuiteRunner(registry, seed=args.seed, cores=args.cores,
                         backend=args.backend, store=store,
                         processes=args.processes, sections=args.sections)
    # suite.run is the CLI's end-to-end stage: the per-entry spans and the
    # emission fall inside it.
    with obs.span("suite.run", entries=len(registry),
                  sections=",".join(args.sections) or "-",
                  processes=args.processes):
        emit_tables([runner.roster(), runner.histogram()], fmt=args.format,
                    out=args.out)

    if args.stats:
        print(f"# store: {runner.stats.as_dict()} "
              f"engine: {runner.study.stats.as_dict()}", file=sys.stderr)

    if args.check:
        bad = [rec for source in ("captured", "serving")
               for rec in runner.divergent(source=source)]
        for rec in bad:
            print(f"# DIVERGENT {rec['source']} entry {rec['name']}: "
                  f"assigned {rec['assigned']} != expected "
                  f"{rec['expected']}", file=sys.stderr)
        if bad:
            return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
