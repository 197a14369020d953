"""Benchmark driver of the port: one section per DAMOV table/figure, the §5
case studies and the Hopper-kernel tables (counterpart of the reference's
``benchmarks/run.py``).

Usage::

    # on the card (the default device; raises without one)
    python -m repro_torch.benchmarks.run [--fast] [--only S[,S...]]
        [--backend vectorized|reference|cuda] [--bench-json PATH]

    # the plain PyTorch versions on the host
    python -m repro_torch.benchmarks.run --fast --device cpu

All figure sections are queries over ONE shared
:class:`repro_torch.study.Study`: the memoized engine simulates each
(workload, cores, config) cell exactly once and every section reuses it.

Sections, in the reference's order:

- fig1   — roofline + MPKI vs NDP speedup (Fig. 1)
- fig3   — locality-based clustering (Fig. 3)
- fig4   — LFMR/MPKI per function (Fig. 4)
- fig5, fig5_nuca — scalability curves, 3 systems (Figs. 5, 16)
- fig7   — energy breakdowns (Figs. 7-17)
- fig18  — per-class NDP-speedup summary + §3.5 validation accuracy
           (dropped by ``--fast``: a 70-workload held-out sweep)
- table3 — the registered roster (``repro_torch.suite``): synthetic
           family expansions + traces walked from the port's CUDA kernel
           launches on ``--device``
- suite  — the per-class histogram over table3's runner (one runner, one
           engine, one result store)
- serving / serving_warm — the 16 serving scenarios with phase-timeline
           columns: cold against a throwaway store, then recalled from it
- megaref — ``cachesim_stream.simulate_chunked`` over one long
           bounded-footprint trace (2M refs fast / 10M full), always cold;
           ``--backend cuda`` runs its window scans on the card
- case1..case4 — §5 case studies
- kernels_stream, kernels_attention — the port's STREAM and bf16 flash
           kernels timed on the card beside their library calls and the
           card's roof (``kernel_bench.PEAKS``, by the card's name; an
           unknown card raises); on the CPU their plain versions

The reference's ``models`` and ``models_sweep`` (ROADMAP.md's "the
whole-model zoo") and ``roofline`` (its "the cost substrate")
are not ported yet: ``--only`` naming one of them exits non-zero.

Every run writes a machine-readable perf record (default
``build/repro_torch_bench.json`` in the checkout; ``''`` disables):
per-section wall-clock and row counts, the resolved backend and device,
the engine's cell statistics and, on the card, its name and power limit.
The file is merge-updated per configuration bucket, as the reference's
is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.study import Study, StudyResult
from repro_torch.suite import ResultStore

from . import kernel_bench, paper_figures

FAST_REFS = 20_000
DEFAULT_BENCH_JSON = (Path(__file__).resolve().parents[3] / "build"
                      / "repro_torch_bench.json")
# Sections of the reference's driver that wait for later slices.
NOT_PORTED = {
    "models": "ROADMAP.md's \"the whole-model zoo\"",
    "models_sweep": "ROADMAP.md's \"the whole-model zoo\"",
    "roofline": "ROADMAP.md's \"the cost substrate\"",
}


def emit(section: str, result) -> tuple[tuple, list[tuple]]:
    """Print one CSV section; returns its (header, rows)."""
    if isinstance(result, StudyResult):
        rows, header = result.to_rows(), result.columns
    else:
        rows, header = result
    print(f"\n## {section}")
    print(",".join(str(h) for h in header))
    for r in rows:
        print(",".join(str(x) for x in r))
    sys.stdout.flush()
    return tuple(header), rows


def write_bench_json(path: str, config_key: str, payload: dict,
                     *, partial: bool) -> None:
    """Merge-update the perf record.

    Section timings are only comparable under one configuration, so runs
    are bucketed under ``runs[config_key]`` (fast mode + refs + backend +
    device): a ``partial`` (``--only``) run refreshes just its own entries
    inside its own bucket, a full run replaces its bucket's sections
    wholesale (so renamed/removed sections cannot linger), and runs under
    a *different* configuration can never clobber another bucket.  Keys
    this driver does not own are preserved.
    """
    existing: dict = {}
    try:
        with open(path) as f:
            existing = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        pass
    runs = existing.setdefault("runs", {})
    bucket = runs.setdefault(config_key, {})
    sections = bucket.get("sections", {}) if partial else {}
    sections.update(payload.pop("sections"))
    bucket.update(payload)
    bucket["sections"] = sections
    with open(path, "w") as f:
        json.dump(existing, f, indent=2, sort_keys=True)
        f.write("\n")


def calibration_seconds() -> float:
    """Wall-clock of a fixed NumPy workload, recorded into the perf
    record's meta so section timings can be normalized across machines of
    different speed."""
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2**21)
    t0 = time.time()
    for _ in range(3):
        np.sort(a)
        np.argsort(a[: 2**19])
    return time.time() - t0


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.core.cachesim import BACKENDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.run",
        description="DAMOV figure, table and case-study sections and the "
                    "Hopper-kernel tables of the PyTorch/CUDA port")
    ap.add_argument("--fast", action="store_true",
                    help=f"reduced trace length ({FAST_REFS} refs) and no "
                         "fig18")
    ap.add_argument("--only", default=None, metavar="S[,S...]",
                    help="run only these sections")
    ap.add_argument("--backend", choices=BACKENDS, default=None,
                    help="cache-simulation implementation; default: "
                         "$REPRO_SIM_BACKEND or 'vectorized'")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (default; raises "
                         "without a card) or cpu (plain PyTorch versions)")
    ap.add_argument("--bench-json", default=str(DEFAULT_BENCH_JSON),
                    metavar="PATH",
                    help="perf-record output path ('' disables)")
    return ap


def sections_for(args: argparse.Namespace, study: Study, refs: int) -> dict:
    """Section name -> a callable returning a StudyResult or (rows,
    header), in the reference driver's order."""
    device = args.device

    # table3 and suite share one runner (engine + content-addressed result
    # store), so the suite section is free once table3 ran.
    runner_box: list = []

    def suite_runner():
        if not runner_box:
            from repro_torch.suite import SuiteRunner, default_registry
            runner_box.append(SuiteRunner(
                default_registry(refs=refs, device=device),
                store=ResultStore(), backend=args.backend))
        return runner_box[0]

    def suite_histogram():
        res = suite_runner().histogram()
        res.name = "suite"
        return res

    # serving roster: cold composition+classification vs pure store recall.
    # The cold section owns a throwaway store so repeat benchmark runs stay
    # cold.
    serving_store_box: list = []

    def _serving_store() -> ResultStore:
        if not serving_store_box:
            import atexit
            import shutil
            import tempfile

            tmp = tempfile.mkdtemp(prefix="bench-serving-store-")
            atexit.register(shutil.rmtree, tmp, ignore_errors=True)
            serving_store_box.append(ResultStore(tmp))
        return serving_store_box[0]

    def serving_roster(section: str):
        from repro_torch.suite import SuiteRunner, serving_registry

        runner = SuiteRunner(serving_registry(refs=refs, device=device),
                             store=_serving_store(), backend=args.backend,
                             sections=("serving",))
        res = runner.roster()
        res.name = section
        return res

    # megaref: the chunk-streaming path over a single long trace with a
    # bounded footprint.  Deterministic synthetic stream so the section is
    # comparable across runs; always cold.
    def megaref_rows():
        import numpy as np

        from repro_torch.core import cachesim
        from repro_torch.core.cachesim_stream import (DEFAULT_CHUNK,
                                                      simulate_chunked)

        n = 2_000_000 if args.fast else 10_000_000
        rng = np.random.default_rng(0)
        sweep = (np.arange(n, dtype=np.int64) * 3) % (1 << 19)
        hot = rng.integers(0, 4_096, n, dtype=np.int64)
        addr = np.where(rng.random(n) < 0.3, hot, sweep) * 8
        header = ("name", "refs", "chunk", "l1_misses", "llc_misses",
                  "lfmr", "mpki")
        rows = []
        for cfg in (cachesim.host_config(4), cachesim.ndp_config(4)):
            sim = simulate_chunked(addr, cfg, chunk=DEFAULT_CHUNK,
                                   name=f"megaref.{cfg.name}",
                                   scan="cuda" if args.backend == "cuda"
                                   else None)
            rows.append((sim.name, n, DEFAULT_CHUNK, sim.l1_misses,
                         sim.level_misses[-1], round(sim.lfmr, 4),
                         round(sim.mpki, 2)))
        return rows, header

    sections = {
        "fig1": lambda: paper_figures.fig1_roofline_mpki(study),
        "fig3": lambda: paper_figures.fig3_locality_clustering(study),
        "fig4": lambda: paper_figures.fig4_lfmr_mpki(study),
        "fig5": lambda: paper_figures.fig5_scalability(study),
        "fig5_nuca": lambda: paper_figures.fig5_scalability(study, nuca=True),
        "fig7": lambda: paper_figures.fig7_energy(study),
        "fig18": lambda: paper_figures.fig18_summary_and_validation(study),
        "table3": lambda: paper_figures.table3_suite_roster(suite_runner()),
        "suite": suite_histogram,
        # warm must follow cold in dict order
        "serving": lambda: serving_roster("serving"),
        "serving_warm": lambda: serving_roster("serving_warm"),
        "megaref": megaref_rows,
        "case1": lambda: paper_figures.case1_noc(study),
        "case2": lambda: paper_figures.case2_accelerators(study),
        "case3": lambda: paper_figures.case3_core_models(study),
        "case4": lambda: paper_figures.case4_offload(study),
        "kernels_stream": lambda: kernel_bench.stream_rows(device),
        "kernels_attention": lambda: kernel_bench.attention_rows(device),
    }
    return sections


def run(args: argparse.Namespace) -> dict:
    """Run the selected sections, printing each as a CSV section and its
    ``# <name>: N rows in Xs`` line; returns ``{"study", "refs",
    "sections": {name: {"header", "rows", "seconds"}}, "total_seconds"}``.
    Each section runs inside a ``bench.section`` span of
    ``repro_torch.obs``."""
    from repro_torch.core.tracegen import DEFAULT_REFS

    resolve_device(args.device)   # raises for cuda without a card
    only = [s for s in (args.only or "").split(",") if s]
    waiting = [s for s in only if s in NOT_PORTED]
    if waiting:
        raise SystemExit("error: " + "; ".join(
            f"section {s!r} is not ported yet: it waits for {NOT_PORTED[s]}"
            for s in waiting))
    refs = FAST_REFS if args.fast else DEFAULT_REFS
    study = Study(refs=refs, backend=args.backend)
    sections = sections_for(args, study, refs)
    unknown = [s for s in only if s not in sections]
    if unknown:
        raise SystemExit(f"error: unknown section(s) {unknown}; expected "
                         f"some of {list(sections)}")
    if args.fast:
        sections.pop("fig18")  # the 70-workload held-out sweep is slow

    out: dict = {}
    t_start = time.time()
    for name, fn in sections.items():
        if only and name not in only:
            continue
        t0 = time.time()
        with obs.span("bench.section", section=name):
            result = fn()
        header, rows = emit(name, result)
        dt = time.time() - t0
        out[name] = {"header": header, "rows": rows, "seconds": dt}
        print(f"# {name}: {len(rows)} rows in {dt:.1f}s")

    s = study.stats
    print(f"# engine: {study.engine.cells} cells, "
          f"{s.sim_runs} simulated, {s.sim_hits} cache hits "
          f"({s.sim_hit_rate:.0%} hit rate)")
    return {"study": study, "refs": refs, "sections": out,
            "total_seconds": time.time() - t_start}


def write_record(args: argparse.Namespace, res: dict) -> str:
    """Merge ``run``'s section timings into the perf record at
    ``args.bench_json``; returns the configuration bucket's key."""
    from repro_torch.core.cachesim import default_backend

    backend = args.backend or default_backend()
    device = resolve_device(args.device).type
    config_key = (f"{'fast' if args.fast else 'full'}"
                  f"-refs{res['refs']}-{backend}-{device}")
    meta = {
        "fast": args.fast,
        "refs": res["refs"],
        "backend": backend,
        "device": device,
        "batch": "simulate_batch",  # single-pass engine batching
        "cpus": os.cpu_count(),
        "calibration_seconds": round(calibration_seconds(), 4),
    }
    if device == "cuda":
        meta["card"], meta["power_limit"] = kernel_bench.card_identity()
    payload = {
        "meta": meta,
        "sections": {name: {"seconds": round(sec["seconds"], 2),
                            "rows": len(sec["rows"])}
                     for name, sec in res["sections"].items()},
    }
    if not args.only:
        # total wall-clock and engine stats describe a *complete* run
        payload["total_seconds"] = round(res["total_seconds"], 2)
        payload["engine"] = res["study"].stats.as_dict()
    path = Path(args.bench_json)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_bench_json(str(path), config_key, payload, partial=bool(args.only))
    return config_key


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    res = run(args)
    if args.bench_json:
        key = write_record(args, res)
        print(f"# perf record -> {args.bench_json} [{key}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
