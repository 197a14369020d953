"""Time paged decode, MoE dispatch, flash attention (float32), the
state-expanded scan and the gated EMA scan of one checkout of the port on
the card, at full width and at every main-path geometry (float32), each
first held against its plain version.

It runs ``chip_smoke.py``'s own timing functions (phase 3's
``paged_full_width``, ``moe_full_width``, ``flash_full_width`` (causal and
not), ``chunked_full_width`` and ``ema_full_width``, phase 8's
``geometry_timings``: the same seeded inputs, CUDA events, L2 flushed
before each run, median of 10 after 3 warm-ups) on the ``repro_torch``
package found under ``--src``, so that two versions of the kernels can be
compared on one card in one call, in turns::

    git archive <parent> | tar -x -C build/parent
    for side in parent change change parent; do
        src=src; [ $side = parent ] && src=build/parent/src
        python3 scripts/kernel_ab.py --src $src --label $side
    done

Each run prints the card's name and power limit, one ``timing`` line a
full-width case and one ``geometry-timing`` line a main-path case, each
with ``label``; rows carry the checkout's plan (paged and flash
``n_splits``, the scans' rows, channels and stages) where it has one.
The main-path flash and scan launches are those the checkout's roster and
serving roster record when run on the CPU (``--only`` picks kernels:
``paged``, ``moe``, ``flash``, ``scan``, ``ema``, ``window``).

``--only window`` runs the checkout's roster on the card with
``backend="cuda"``, recording its window counts, and times the window
kernel of ``--src`` and that of ``--against`` (another checkout's
``src``, by default this one's, imported beside it under another name)
in turns on the same recorded (q, rows, chunk), at the three largest
geometries, each first held exactly against the plain version::

    python3 scripts/kernel_ab.py --only window --against build/parent/src
    python3 scripts/kernel_ab.py --only window --src build/parent/src

(this checkout's geometries, then the parent's).  It prints one
``window-ab`` line a geometry with both times, the bound of
``chip_smoke.py``'s phase 14 and the slots and sectors the windows read.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WINDOW_ROUNDS = 10   # in-turns rounds of the window timings


def paged_splits(chip_smoke, itemsize: int) -> dict:
    """``n_splits`` of the checkout's split plan at full width, or nothing
    for a checkout from before the split design."""
    try:
        return {"n_splits": chip_smoke.paged_splits(chip_smoke.FULL_PAGED,
                                                    itemsize)}
    except ImportError:
        return {}


def load_window_kernel(src: Path):
    """``window_count_cuda`` of the ``repro_torch`` package under ``src``,
    imported beside the one on ``sys.path`` under another name (it builds
    its library in its own checkout's build directory)."""
    name = "_window_ab_kernels"
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(src / "repro_torch" / "kernels")]
    sys.modules[name] = pkg
    return importlib.import_module(f"{name}.window_scan.kernel"
                                   ).window_count_cuda


def window_ab(chip_smoke, bench, smi: str, against: Path, label: str
              ) -> int:
    """Time the imported checkout's window kernel and ``against``'s in
    turns on the window counts of the imported checkout's cuda roster;
    returns the number of geometries timed."""
    from repro_torch.kernels import window_scan
    from repro_torch.suite import SuiteRunner, default_registry

    other = load_window_kernel(against)
    with window_scan.record() as calls:
        SuiteRunner(default_registry(device="cuda"), store=None,
                    backend="cuda").roster()
    torch.cuda.synchronize()
    mine = window_scan.window_count_cuda
    largest = chip_smoke.largest_window_calls(calls)
    for (n_rows, chunk), (q, rows, _) in largest:
        case = f"rows={n_rows} chunk={chunk} m={q.numel()}"
        want = chip_smoke.window_ref(q, rows, chunk)
        for side, fn in (("src", mine), ("against", other)):
            chip_smoke.check_close(chip_smoke.SCAN_KERNEL, f"{side} {case}",
                                   fn(q, rows, chunk), want, exact=True)
        ms = bench.turns([("src", lambda: mine(q, rows, chunk)),
                          ("against", lambda: other(q, rows, chunk)),
                          ("against", lambda: other(q, rows, chunk)),
                          ("src", lambda: mine(q, rows, chunk))],
                         WINDOW_ROUNDS)
        nbytes, ops, traffic = chip_smoke.window_bound(q, rows, chunk)
        bound_ms, bound_by = bench.bound(nbytes, ops, "f32")
        chip_smoke.say({"phase": "window-ab", "label": label, "case": case,
                        "order": "src, against, against, src",
                        "src_ms": ms["src"], "against_ms": ms["against"],
                        "against": str(against), "bound_ms": bound_ms,
                        "bound_by": bound_by, **traffic,
                        "window_counts": len(calls), "card": smi})
    return len(largest)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--only", default="paged,moe,flash,scan,ema",
                    help="comma-separated kernels to time")
    ap.add_argument("--against", default=str(ROOT / "src"),
                    help="with --only window: the other checkout's src")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke   # puts ROOT/src on sys.path; --src goes before it

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch imported from outside {src}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.say(smi)
    bench = chip_smoke.Bench(
        chip_smoke.card_peaks(torch.cuda.get_device_name(0)))
    only = set(args.only.split(","))
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        if "paged" in only:
            chip_smoke.paged_full_width(
                bench, smi, dtype, label=args.label,
                **paged_splits(chip_smoke, 4 if dtype == torch.float32 else 2))
        if "moe" in only:
            chip_smoke.moe_full_width(bench, smi, dtype, label=args.label)
        if "scan" in only:
            chip_smoke.chunked_full_width(bench, smi, dtype, label=args.label)
        if "ema" in only:
            chip_smoke.ema_full_width(bench, smi, dtype, label=args.label)
        cases += len(only & {"paged", "moe", "scan", "ema"})
        torch.cuda.empty_cache()
    if "flash" in only:
        for causal in (True, False):
            chip_smoke.flash_full_width(bench, smi, torch.float32, 128, causal,
                                        label=args.label)
            torch.cuda.empty_cache()
        cases += 2
    if "window" in only:
        cases += window_ab(chip_smoke, bench, smi,
                           Path(args.against).resolve(), args.label)
    if not only & set(chip_smoke.GEOMETRY_KERNELS):
        chip_smoke.say({"phase": "kernel-ab", "label": args.label,
                        "src": str(src), "cases": cases})
        return 0
    launched = chip_smoke.record_main_paths("cpu")
    rows = chip_smoke.geometry_timings(bench, smi, launched, only=only,
                                       label=args.label)
    chip_smoke.say({"phase": "kernel-ab", "label": args.label,
                    "src": str(src), "cases": len(rows) + cases})
    return 0


if __name__ == "__main__":
    sys.exit(main())
