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
``paged``, ``moe``, ``flash``, ``scan``, ``ema``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def paged_splits(chip_smoke, itemsize: int) -> dict:
    """``n_splits`` of the checkout's split plan at full width, or nothing
    for a checkout from before the split design."""
    try:
        return {"n_splits": chip_smoke.paged_splits(chip_smoke.FULL_PAGED,
                                                    itemsize)}
    except ImportError:
        return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--only", default="paged,moe,flash,scan,ema",
                    help="comma-separated kernels to time")
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
    launched = chip_smoke.record_main_paths("cpu")
    rows = chip_smoke.geometry_timings(bench, smi, launched, only=only,
                                       label=args.label)
    chip_smoke.say({"phase": "kernel-ab", "label": args.label,
                    "src": str(src), "cases": len(rows) + cases})
    return 0


if __name__ == "__main__":
    sys.exit(main())
