"""What each of the model's mesh-aware pieces changes in a dry run.

``repro_torch.models.shard_ops`` runs a few operations otherwise than
DTensor's own strategies would on a mesh.  For each piece named in
``PIECES`` this runs a cell's dry-run step (``launch.dryrun.record_step``,
on the fake production mesh) with that piece swapped back for the plain
operation, whose DTensor strategy then decides the layout, and prints
one JSON line a variant: status, seconds to place and to step, argument,
temp and collective bytes a card, local ops.  ``none`` is the port as it
is.  Each variant runs in a process of its own (the fake process group
lives and dies there); ``--workers`` of them at once, so their seconds
share the host.

    PYTHONPATH=src python -m repro_torch.benchmarks.dryrun_ablation \\
        --cells deepseek-moe-16b:train_4k,mamba2-780m:train_4k \\
        [--only none,pin] [--workers 7] [--smoke]

``--smoke`` runs the smoke configs at batch 4 x 64 on a 2x2 mesh (seconds
on a CPU).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import time
import traceback
import warnings

import torch

__all__ = ["PIECES", "run_variant", "main"]


def _plain_rows(x, y, chunk: int, n: int):
    for c in range(n):
        yield x[c * chunk:(c + 1) * chunk], y[c * chunk:(c + 1) * chunk]


def _swap(piece: str) -> None:
    """Put the plain operation in place of ``piece`` in the model."""
    from repro_torch.models import model, shard_ops

    if piece == "pin":            # the SSM projection's gradient layout
        shard_ops.pin = lambda x: x
    elif piece == "row_chunks":   # the loss chunks: global row slices
        model.row_chunks = _plain_rows
    elif piece == "take_last":    # the gold logit: torch.gather
        model.take_last = lambda x, idx: torch.gather(
            x, -1, idx[:, None])[:, 0]
    elif piece == "logsumexp_last":
        model.logsumexp_last = lambda x: torch.logsumexp(x, dim=-1)
    elif piece == "take_rows":    # the embedding lookup: table[idx]
        model.take_rows = lambda table, idx: table[idx]
    elif piece != "none":
        raise KeyError(piece)


PIECES = ("none", "pin", "row_chunks", "take_last", "logsumexp_last",
          "take_rows")


def run_variant(arch: str, shape: str, piece: str, smoke: bool) -> dict:
    """One cell's dry-run step with ``piece`` swapped out."""
    from repro_torch import configs
    from repro_torch.launch.cells import CellPlan, plan_for
    from repro_torch.launch.dryrun import record_step
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, fake_mesh
    from repro_torch.models.config import SHAPES, ShapeSpec

    _swap(piece)
    if smoke:
        kind = SHAPES[shape].kind
        plan = CellPlan(arch=arch, shape=ShapeSpec("t", 64, 4, kind),
                        cfg=configs.get_smoke(arch), kind=kind,
                        microbatches=2 if kind == "train" else 1)
        mesh_shape = ((2, 2), ("data", "model"))
    else:
        plan = plan_for(arch, shape)
        mesh_shape = PRODUCTION_SHAPES[False]
    row = {"cell": f"{arch}:{shape}", "piece": piece,
           "mesh": "x".join(map(str, mesh_shape[0]))}
    t0 = time.time()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with fake_mesh(*mesh_shape) as mesh:
                e = record_step(plan, mesh)
    except Exception as exc:  # noqa: BLE001
        return {**row, "status": "error", "seconds": time.time() - t0,
                "error": f"{type(exc).__name__}: {exc}"[:500],
                "traceback": traceback.format_exc()[-1500:]}
    m = e["memory"]
    return {**row, "status": "ok", "seconds": time.time() - t0,
            "place_s": e["lower_s"], "step_s": e["compile_s"],
            "arg_bytes": m["argument_size_in_bytes"],
            "temp_bytes": m["temp_size_in_bytes"],
            "collective_bytes": e["hlo_collective_bytes_per_iter"],
            "collective_by_op": e["hlo_collective_by_op"],
            "local_ops": e["hlo_ops"], "local_flops": e["hlo_cost_analysis"][
                "flops"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.dryrun_ablation")
    ap.add_argument("--cells", default="deepseek-moe-16b:train_4k,"
                                       "mamba2-780m:train_4k")
    ap.add_argument("--only", default=",".join(PIECES))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    pieces = args.only.split(",")
    for p in pieces:
        if p not in PIECES:
            ap.error(f"unknown piece {p!r}; choose from {PIECES}")
    jobs = [(*c.split(":"), p, args.smoke) for c in args.cells.split(",")
            for p in pieces]
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(args.workers, mp_context=ctx,
                                max_tasks_per_child=1) as pool:
        futs = [pool.submit(run_variant, *j) for j in jobs]
        rows = []
        for f in cf.as_completed(futs):      # each row as it is done
            rows.append(f.result())
            print(json.dumps(rows[-1]), flush=True)
    return 0 if all(r["status"] == "ok" for r in rows
                    if r["piece"] == "none") else 1


if __name__ == "__main__":
    raise SystemExit(main())
