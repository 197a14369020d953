"""CLI entry point: ``python -m repro_torch.serving`` (counterpart of
``python -m repro.serving``).

Prints the phase timeline of one serving scenario, from kernel launches
on the device: a per-window table (traffic intensity, batch, offered AI,
assigned class), the timeline string, the phase-transition matrix and the
whole-trace verdict with the matching mitigations.

Examples::

    # the bursty paged-KV scenario (default), on the card
    python -m repro_torch.serving

    # any registered scenario through the plain versions on the CPU
    python -m repro_torch.serving --scenario srv.moe.hot90 --device cpu

    # the scenario roster without simulating
    python -m repro_torch.serving --list
"""

from __future__ import annotations

import argparse

from repro_torch import obs
from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.study.cliutil import parse_cores

from .phases import MITIGATIONS, measure_windows
from .scenario import SCENARIOS

DEFAULT_SCENARIO = "srv.pagedkv.burst"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving",
        description="Phase timeline of one serving scenario from the "
                    "port's kernels: a DAMOV class verdict per window")
    ap.add_argument("--scenario", default=DEFAULT_SCENARIO,
                    choices=sorted(SCENARIOS), metavar="NAME",
                    help=f"scenario name (default {DEFAULT_SCENARIO}; "
                         "--list shows the roster)")
    ap.add_argument("--seed", type=int, default=0, help="trace seed")
    ap.add_argument("--cores", type=parse_cores, default=CORE_SWEEP,
                    metavar="1,4,16,...", help="core sweep")
    ap.add_argument("--list", action="store_true",
                    help="print the scenario roster and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (default; raises "
                         "without a card) or cpu (plain PyTorch versions)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a repro_torch.obs span/counter trace "
                         "(JSONL); read it with `python -m repro_torch.obs "
                         "report FILE`")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.trace:
        obs.enable(args.trace)
    try:
        with obs.span("serving.run", scenario=args.scenario):
            return _main(args)
    finally:
        if args.trace:
            obs.disable()


def _main(args: argparse.Namespace) -> int:
    if args.list:
        for s in SCENARIOS.values():
            print(f"{s.name:28s} {s.kernel:9s} "
                  f"{s.traffic.family:10s} expected={s.expected_class}  "
                  f"[{s.traffic.name}, windows={s.n_windows}, "
                  f"bs={s.max_batch}]")
        print(f"# {len(SCENARIOS)} scenarios")
        return 0

    scen = SCENARIOS[args.scenario]
    tl = measure_windows(scen, seed=args.seed, cores=args.cores,
                         device=args.device)

    print(f"# scenario {scen.name}: kernel={scen.kernel} "
          f"traffic={scen.traffic.name} windows={scen.n_windows} "
          f"window_refs={scen.window_refs} max_batch={scen.max_batch}")
    print(f"{'window':>6s} {'intensity':>9s} {'arrivals':>8s} "
          f"{'batch':>5s} {'ai':>7s} {'mpki':>8s} {'class':>5s} "
          f"{'mitigation':>14s}")
    for i, (wt, m, lab) in enumerate(zip(tl.windows, tl.metrics,
                                         tl.labels)):
        print(f"{i:6d} {wt.demand.intensity:9.3f} "
              f"{wt.demand.arrivals:8d} {wt.batch:5d} {wt.ai:7.3f} "
              f"{m.mpki:8.2f} {lab:>5s} {MITIGATIONS[lab]:>14s}")

    print(f"\nphase timeline : {tl.timeline()}")
    print(f"phases         : {tl.n_phases} distinct, "
          f"{tl.switches} switch(es), dominant {tl.dominant}")
    classes, mat = tl.transition_matrix()
    print(f"transitions    : classes {', '.join(classes)}")
    for cls, row in zip(classes, mat):
        cells = " ".join(f"{int(v):3d}" for v in row)
        print(f"                 {cls} -> [{cells}]")
    print(f"whole-trace    : {tl.whole_label} "
          f"(mitigation {MITIGATIONS[tl.whole_label]}) — a single label "
          f"for a {tl.n_phases}-phase mixture")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
