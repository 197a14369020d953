"""CLI entry point: ``python -m repro_torch.suite``.

Launches the ported kernels on the device, walks their launch geometry
into word traces, and emits the captured Table-3-style roster (name,
domain, source, metrics, assigned vs expected class) with a per-class
histogram, in the reference CLI's output format.

Examples::

    # on the card: exit 2 if any entry's class diverges from its expected one
    python -m repro_torch.suite --fast --check

    # plain PyTorch versions on the CPU, JSON to a file
    python -m repro_torch.suite --device cpu --format json --out roster.json
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.sweep import CORE_SWEEP
from repro_torch.study.cliutil import parse_cores

from .runner import SuiteRunner


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.suite",
        description="DAMOV captured roster from the port's CUDA kernels")
    ap.add_argument("--fast", action="store_true",
                    help="short synthetic traces in the reference CLI; the "
                         "captured roster keeps its real trace lengths, so "
                         "the flag changes nothing until the synthetic "
                         "families are ported")
    ap.add_argument("--check", action="store_true",
                    help="exit 2 if any entry's assigned class diverges "
                         "from its expected class")
    ap.add_argument("--cores", type=parse_cores, default=CORE_SWEEP,
                    metavar="1,4,16,...", help="core sweep")
    ap.add_argument("--format", choices=("csv", "json"), default="csv")
    ap.add_argument("--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (default; raises "
                         "without a card) or cpu (plain PyTorch versions)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    runner = SuiteRunner(cores=args.cores, device=args.device)
    tables = [runner.roster(), runner.histogram()]
    if args.format == "json":
        text = json.dumps([t.to_dict() for t in tables], indent=2)
    else:
        text = "\n".join(f"## {t.name}\n{t.to_csv()}" for t in tables)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")

    if args.check:
        bad = runner.divergent()
        for rec in bad:
            print(f"# DIVERGENT {rec['source']} entry {rec['name']}: "
                  f"assigned {rec['assigned']} != expected {rec['expected']}",
                  file=sys.stderr)
        if bad:
            return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
