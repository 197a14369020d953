"""Time the build of the port's kernel libraries, one or more checkouts.

Each round compiles every ``csrc/*.cu`` of a checkout with the nvcc line
of this checkout's ``kernels/_build.py``, all nvcc processes started
together as ``_build.build`` starts them (``chip_smoke.py``'s phase 1),
into a temporary directory, so the checkouts' own build directories are
left as they are.  Rounds go in turns: the checkouts in the order given,
then reversed, and so on::

    git archive <parent> | tar -x -C build/parent
    python3 scripts/build_times.py --src src --src build/parent/src \\
        --rounds 4 --registers ssm_chunked

Prints the machine's CPU count, then one JSON line a round and checkout:
the round's wall seconds, and per library its nvcc's wall seconds and CPU
seconds (user + system, its compiler's processes included), and the
ptxas register count of every entry function whose name holds a
``--registers`` string.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
REGS = re.compile(r"Used (\d+) registers")


def registers(log: str, parts: list[str]) -> dict[str, int]:
    """ptxas's register count of each entry function naming a part."""
    found, fn = {}, None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            fn = m.group(1)
            continue
        m = REGS.search(line)
        if m and fn and any(p in fn for p in parts):
            found[fn] = int(m.group(1))
    return found


def build_round(src: Path, parts: list[str]) -> dict:
    """Compile every library of ``src``'s port at once; their times."""
    from repro_torch.kernels import _build

    sources = sorted((src / "repro_torch" / "csrc").glob("*.cu"))
    with tempfile.TemporaryDirectory(prefix="build-times-") as out:
        t0 = time.perf_counter()
        procs = {}
        for cu in sources:
            log = open(Path(out) / f"{cu.stem}.log", "w+")
            proc = subprocess.Popen(
                _build.nvcc_command(cu, Path(out) / f"lib{cu.stem}.so"),
                stdout=log, stderr=subprocess.STDOUT)
            procs[proc.pid] = (cu.stem, log)
        libs = {}
        while procs:
            pid, status, usage = os.wait4(-1, 0)
            if pid not in procs:
                continue
            name, log = procs.pop(pid)
            log.seek(0)
            text = log.read()
            log.close()
            libs[name] = {
                "wall_s": round(time.perf_counter() - t0, 2),
                "cpu_s": round(usage.ru_utime + usage.ru_stime, 2),
                "rc": os.waitstatus_to_exitcode(status),
                **({"log_tail": text[-2000:]} if status else {}),
                **({"registers": registers(text, parts)} if parts else {})}
        wall = time.perf_counter() - t0
    return {"src": str(src), "wall_s": round(wall, 2),
            "cpu_s": round(sum(v["cpu_s"] for v in libs.values()), 2),
            "libraries": dict(sorted(libs.items(),
                                     key=lambda kv: kv[1]["wall_s"]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="a checkout's src directory (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--registers", action="append", default=[],
                    help="report registers of entry functions naming this")
    args = ap.parse_args()
    srcs = [Path(s).resolve() for s in args.src or [str(ROOT / "src")]]
    print(json.dumps({"cpu_count": os.cpu_count(),
                      "usable_cpus": len(os.sched_getaffinity(0))}))
    failed = False
    for r in range(args.rounds):
        for src in srcs if r % 2 == 0 else srcs[::-1]:
            row = build_round(src, args.registers)
            print(json.dumps({"round": r, **row}), flush=True)
            failed |= any(v["rc"] for v in row["libraries"].values())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
