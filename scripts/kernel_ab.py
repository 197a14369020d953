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
compared on one card in one call, in turns (the timer and the card's
peaks come from the ``--src`` package's ``benchmarks/kernel_bench.py``, so
``--src`` is a checkout that has it)::

    git archive <parent> | tar -x -C build/parent
    for side in parent change change parent; do
        src=src; [ $side = parent ] && src=build/parent/src
        python3 scripts/kernel_ab.py --src $src --label $side
    done

Each run prints the card's name and power limit, one ``timing`` line a
full-width case and one ``geometry-timing`` line a main-path case, each
with ``label``; rows carry the checkout's plan (paged and flash
``n_splits`` where it has one; the scans' plan as its own fields).
The main-path flash and scan launches are those the checkout's roster and
serving roster record when run on the CPU (``--only`` picks kernels:
``paged``, ``moe``, ``flash``, ``scan``, ``ema``, ``window``, and
``widths``: flash, causal, in both dtypes, at each head width of
``chip_smoke.WIDTH_FLASH`` on its model's full-width shape, D 256, 16
and 96 at PaliGemma-3B's, 112 at Zamba2-7B's and 192 at
Nemotron-4-340B's, the same rows phase 3 times, and D 64 and 128 at
qwen2.5-14b's; ``wide``: the wide kernels, flash, causal, in both dtypes,
at each head width of ``chip_smoke.WIDE_FLASH``, D 320 and 512 at
PaliGemma-3B's shape, the rows phase 3 times, each with its cluster size
where the checkout has the cluster design; ``ragged``: flash at lengths
that are not multiples of 128, ``chip_smoke.RAGGED_FLASH``'s whisper-large-
v3 encoder (1500 positions, non-causal) and causal qwen2.5-14b row (2000
tokens), in both dtypes; ``paged_wide``: paged decode at
``chip_smoke.WIDE_PAGED``'s groups and widths (granite-20b's 48 heads,
zamba2-7b's D 112, nemotron-4-340b's 12 heads at D 192, D 512), in both
dtypes; these two only for a checkout that takes those shapes;
``gather``: the token gather at full width, qwen2.5-14b's 152 064-row
embedding table and 8 192 tokens at D 5120, in both dtypes, beside
``index_select``; ``odd``: the four kernels at full width off the
reference's kernel route, ``chip_smoke.ODD_FULL``: the gather at D 5118,
the EMA scan at D 7166, the chunked scan at D 7166 and N 96 (rows that
are not 16-byte multiples), MoE dispatch at D 2040 and F 1400 (a K and an
N tail), in both dtypes, only for a checkout that takes them);
``stream``: STREAM's four ops at full width (2^28 elements) in both
dtypes, in turns with their torch calls (``chip_smoke.stream_full_width``,
phase 3's rows); ``f16``: float16 at full width, STREAM's four ops, the
EMA and chunked scans at Zamba2-7B's layer (``chip_smoke.FULL_SCAN``) and
MoE at DeepSeek-MoE-16B's (``chip_smoke.FULL_MOE``), each held within one
float16 ulp of its plain version's largest magnitude and printed with it,
its bound at 2-byte elements or at the tensor cores' f16 rate, STREAM
beside its torch calls, only for a checkout that takes float16).

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


def describe_plans(chip_smoke) -> None:
    """Let ``chip_smoke``'s scan rows carry the imported checkout's scan
    plans, each as that checkout's own fields (``_asdict()``), so that a
    plan of another version needs nothing of ``chip_smoke``."""
    from repro_torch.kernels.ssm_scan import plan

    def fields(make):
        return lambda *args: {
            "plan": make(*args, n_sm=chip_smoke.sm_count())._asdict()}

    chip_smoke.scan_plan_of = fields(plan.scan_plan)
    chip_smoke.ema_plan_of = fields(plan.ema_plan)


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
    from repro_torch.benchmarks.kernel_bench import CardBench, card_identity

    describe_plans(chip_smoke)

    smi = ", ".join(card_identity())
    chip_smoke.say(smi)
    bench = CardBench()
    only = set(args.only.split(","))
    cases = 0
    odd = chip_smoke.ODD_FULL if "odd" in only else {}
    for dtype in (torch.float32, torch.bfloat16):
        if "stream" in only:
            chip_smoke.stream_full_width(bench, smi, dtype, label=args.label)
            torch.cuda.empty_cache()
        if "gather" in only:
            chip_smoke.gather_full_width(bench, smi, dtype, label=args.label)
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
        cases += len(only & {"stream", "gather", "paged", "moe", "scan",
                             "ema"})
        for kernel, timing in (
                ("token_gather", chip_smoke.gather_full_width),
                ("ssm_ema_scan", chip_smoke.ema_full_width),
                ("ssm_chunked_scan", chip_smoke.chunked_full_width),
                ("moe_dispatch", chip_smoke.moe_full_width)):
            if kernel in odd:
                timing(bench, smi, dtype, odd[kernel], label=args.label,
                       shape="odd")
                torch.cuda.empty_cache()
                cases += 1
        torch.cuda.empty_cache()
    if "f16" in only:
        f16 = torch.float16
        chip_smoke.stream_full_width(bench, smi, f16, label=args.label)
        for timing in (chip_smoke.ema_full_width,
                       chip_smoke.chunked_full_width,
                       chip_smoke.moe_full_width):
            torch.cuda.empty_cache()
            timing(bench, smi, f16, label=args.label)
        torch.cuda.empty_cache()
        cases += 4
    if "flash" in only:
        for causal in (True, False):
            chip_smoke.flash_full_width(bench, smi, torch.float32, 128, causal,
                                        label=args.label)
            torch.cuda.empty_cache()
        cases += 2
    if "widths" in only:
        for dtype in (torch.float32, torch.bfloat16):
            for d, shape in chip_smoke.WIDTH_FLASH.items():
                chip_smoke.flash_full_width(bench, smi, dtype, d, True,
                                            shape=shape, timed=True,
                                            label=args.label)
                torch.cuda.empty_cache()
            for d in (64, 128):
                chip_smoke.flash_full_width(bench, smi, dtype, d, True,
                                            timed=True, label=args.label)
            cases += len(chip_smoke.WIDTH_FLASH) + 2
    if "wide" in only:
        for dtype in (torch.float32, torch.bfloat16):
            for d, shape in chip_smoke.WIDE_FLASH.items():
                chip_smoke.flash_full_width(bench, smi, dtype, d, True,
                                            shape=shape, timed=True,
                                            label=args.label)
                torch.cuda.empty_cache()
            cases += len(chip_smoke.WIDE_FLASH)
    if "ragged" in only:
        for dtype in (torch.float32, torch.bfloat16):
            for shape, d, causal in chip_smoke.RAGGED_FLASH.values():
                chip_smoke.flash_full_width(bench, smi, dtype, d, causal,
                                            shape=shape, timed=True,
                                            label=args.label)
                torch.cuda.empty_cache()
            cases += len(chip_smoke.RAGGED_FLASH)
    if "paged_wide" in only:
        for dtype in (torch.float32, torch.bfloat16):
            for geo in chip_smoke.WIDE_PAGED.values():
                chip_smoke.paged_full_width(bench, smi, dtype, geo,
                                            label=args.label)
                torch.cuda.empty_cache()
            cases += len(chip_smoke.WIDE_PAGED)
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
