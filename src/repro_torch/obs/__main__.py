"""CLI entry point: ``python -m repro_torch.obs`` (counterpart of
``python -m repro_torch.obs``).

Reads ``repro_torch.obs`` JSONL trace files (recorded with ``--trace
FILE`` on the ``repro_torch.suite`` / ``repro_torch.serving`` CLIs, or
``REPRO_TORCH_TRACE=path``); the reference's files have the same schema.

Subcommands::

    # per-stage wall-clock + counter breakdown (one or more trace files)
    python -m repro_torch.obs report t.jsonl [more.jsonl ...]

    # machine-readable aggregate, diffable next to --format json rosters
    python -m repro_torch.obs report --json t.jsonl

    # Chrome trace-event conversion; open the output in Perfetto
    python -m repro_torch.obs chrome t.jsonl -o t.trace.json
"""

from __future__ import annotations

import argparse
import json
import sys

from .report import aggregate, format_report, load_events, to_chrome


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="read repro_torch.obs trace files: aggregate report or "
                    "Chrome trace-event export",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser(
        "report", help="per-stage wall-clock/counter breakdown table")
    rep.add_argument("files", nargs="+", metavar="TRACE.jsonl",
                     help="trace file(s); multiple files merge into one "
                          "report")
    rep.add_argument("--json", action="store_true",
                     help="emit the aggregate as JSON instead of a table")
    rep.add_argument("--sort", choices=("total", "count", "name"),
                     default="total", help="span table order "
                                           "(default: total time)")
    rep.add_argument("--out", default=None,
                     help="output path (default: stdout)")

    chrome = sub.add_parser(
        "chrome", help="convert to Chrome trace-event JSON (Perfetto)")
    chrome.add_argument("files", nargs="+", metavar="TRACE.jsonl")
    chrome.add_argument("-o", "--out", default=None,
                        help="output path (default: stdout)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.cmd == "report":
        rep = aggregate(args.files)
        text = (json.dumps(rep.to_dict(), indent=2) if args.json
                else format_report(rep, sort=args.sort))
    else:
        events, skipped = load_events(args.files)
        if skipped:
            print(f"# {skipped} corrupt line(s) skipped", file=sys.stderr)
        text = json.dumps(to_chrome(events))

    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
