"""Render §Dry-run / §Roofline markdown tables from a directory of dry-run
entries (the port of the reference's ``benchmarks/render_experiments.py``;
the same markdown from the same entries).

Usage::

    python -m repro_torch.benchmarks.render_experiments [build/dryrun]
"""

from __future__ import annotations

import glob
import json
import os
import sys

DEFAULT_DIR = "build/dryrun"


def load(d):
    rows = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        if "_skips" in f:
            continue
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def main(d=DEFAULT_DIR):
    rows = load(d)
    print("| arch | shape | mesh | compile_s | arg GB/chip | temp GB/chip |"
          " t_comp | t_mem | t_coll | class | MFU-bound | useful |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        if r["status"] != "ok":
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR "
                  f"{r.get('error','')[:60]} |")
            continue
        m = r["memory"]
        print(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compile_s']} "
            f"| {m.get('argument_size_in_bytes', 0)/1e9:.1f} "
            f"| {m.get('temp_size_in_bytes', 0)/1e9:.1f} "
            f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
            f"| {r['t_collective_s']:.2e} | {r['class']} "
            f"| {r['mfu_bound']:.3f} | {r['useful_compute_ratio']:.2f} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
