"""Perf hill-climb variants of three cells (the port of
``repro.launch.perfvariants``).

Each variant is a (cell, sharding-rule or knob change).  For every variant
the cell is placed on the fake production mesh
(``launch.mesh.make_production_mesh``) and its step recorded once by
``launch.dryrun.record_step``: collective bytes by op, argument and temp
GB a card.  Beside the record stands the analytic three-term roofline
under the changed configuration (``core.analytic.cell_cost`` with the
reference's adjustments, float for float), summarized as
``RooflineTerms`` on ``H100_SXM`` (``hw=`` for another spec).  One JSON
file a variant goes to ``build/perf/<tag>.json``.

The cells (the reference's choice, from its roofline table):

1. deepseek-moe-16b ``train_4k``: the paper's own technique (compute near
   the shard, MoE), collective-bound.  ``ds_train_ep_only``: experts stay
   on the model axis, attention, shared MLP and vocab go data-parallel (no
   TP activation all-reduces); ``ds_train_ep_int8``: the same plus int8
   error-feedback gradient compression.
2. nemotron-4-340b ``train_4k``: the most collective-bound in absolute
   time.  ``nmt_train_mb4``: 16 microbatches cut to 4;
   ``nmt_train_mb4_int8``: the same plus int8-EF.
3. zamba2-7b ``long_500k``: the worst roofline fraction (an HBM-bound
   decode).  ``zmb_long_nocachelen``: the shared attention's KV cache no
   longer sharded over the model axis, against the default that shards
   it.

What the record shows.  DTensor reduces the gradients in the backward
pass, before the train step's int8 round trip, so no recorded collective
of an ``_int8`` variant carries an int8 payload: what differs from its
uncompressed twin is where the round trip's own reductions land (each
leaf's scale, a max over its shards; the error buffers' layout).  Only
the analytic term carries the compression, as in the reference, whose
compiled HLO reduces the gradients before the round trip too.  Likewise
the EP-only variants' analytic TP and FSDP terms are the reference's
arithmetic, where the record shows what DTensor's layouts of the changed
rules move.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.perfvariants \\
        [--only TAG[,TAG]] [--out build/perf]

It needs no card and leaves no process group behind.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.core import analytic, hlo_analysis
from repro_torch.core.hlo_analysis import H100_SXM, HardwareSpec

from .cells import CellPlan, plan_for
from .dryrun import record_step
from .mesh import make_production_mesh

__all__ = ["EP_ONLY", "VARIANTS", "run_variant", "variant_plan",
           "analytic_terms", "main", "DEFAULT_OUT"]

DEFAULT_OUT = os.path.join("build", "perf")

# EP-only: replicate attention/MLP weights over the model axis (no TP
# activation all-reduces); experts + vocab stay model-sharded.
EP_ONLY = (("heads", None), ("kv_heads", None), ("qkv", None),
           ("ffn", None), ("ssm_inner", None), ("ssm_heads", None),
           ("seq_residual", None))

# tag -> (arch, shape, run_variant's keywords): the reference's main()
VARIANTS = {
    "ds_train_base": ("deepseek-moe-16b", "train_4k", {}),
    "ds_train_ep_only": ("deepseek-moe-16b", "train_4k",
                         dict(rules_override=EP_ONLY, tp_layers=False)),
    "ds_train_ep_int8": ("deepseek-moe-16b", "train_4k",
                         dict(rules_override=EP_ONLY, tp_layers=False,
                              compress="int8_ef")),
    "nmt_train_mb4": ("nemotron-4-340b", "train_4k", dict(microbatches=4)),
    "nmt_train_mb4_int8": ("nemotron-4-340b", "train_4k",
                           dict(microbatches=4, compress="int8_ef")),
    "zmb_long_base": ("zamba2-7b", "long_500k", {}),
    "zmb_long_nocachelen": ("zamba2-7b", "long_500k",
                            dict(rules_override=(("cache_len", None),))),
}


def variant_plan(arch: str, shape: str, *, rules_override=(),
                 microbatches: int | None = None) -> CellPlan:
    """The cell's plan with the variant's knobs."""
    plan = plan_for(arch, shape)
    if microbatches is not None:
        plan = dataclasses.replace(plan, microbatches=microbatches)
    if rules_override:
        plan = dataclasses.replace(
            plan, rules_override=plan.rules_override + tuple(rules_override))
    return plan


def analytic_terms(tag: str, plan: CellPlan, chips: int, *,
                   compress: str | None = None, tp_layers: bool = True,
                   hw: HardwareSpec = H100_SXM) -> dict:
    """The variant's analytic roofline: ``cell_cost`` on 16 model shards
    with the reference's EP-only and int8 adjustments, summarized."""
    costs = analytic.cell_cost(
        plan.cfg, plan.shape, kind=plan.kind,
        microbatches=plan.microbatches,
        data_shards=chips // 16, model_shards=16,
        infer_fsdp=plan.infer_fsdp)
    if not tp_layers:
        # EP-only: remove the TP activation all-reduce term; keep MoE a2a +
        # FSDP (params no longer model-sharded -> larger fsdp gathers).
        tokens = plan.shape.global_batch * plan.shape.seq_len
        act_row = plan.cfg.d_model * 2
        passes = 3.0
        tp_term = (4.0 * (tokens / (chips // 16)) * act_row
                   * plan.cfg.n_layers * passes) * chips
        p_nonexpert = costs.notes["p_total"] - (
            plan.cfg.n_layers * plan.cfg.n_routed_experts * 3
            * plan.cfg.d_model * (plan.cfg.d_ff_expert or plan.cfg.d_ff))
        extra_fsdp = (plan.microbatches * 2.0 + 1.0) * p_nonexpert * 2 * (
            1 - 1 / 16) * chips
        costs = dataclasses.replace(
            costs, collective_bytes=costs.collective_bytes - tp_term
            + extra_fsdp)
    if compress == "int8_ef":
        # the gradient reduce-scatter's payload: int8 is half of bf16
        p_loc = costs.notes["p_total"] / 16 * 2
        costs = dataclasses.replace(
            costs, collective_bytes=costs.collective_bytes - 0.5 * p_loc * chips)

    tokens = plan.shape.global_batch * (
        plan.shape.seq_len if plan.kind != "decode" else 1)
    rt = hlo_analysis.RooflineTerms(
        name=tag, chips=chips, hlo_flops=costs.flops,
        hlo_bytes=costs.hbm_bytes, collective_bytes=costs.collective_bytes,
        model_flops=plan.cfg.model_flops(tokens,
                                         training=plan.kind == "train"),
        hw=hw)
    return rt.summary()


def run_variant(tag, arch, shape, *, rules_override=(), microbatches=None,
                compress=None, multi_pod=False, model_shards_for_analytic=16,
                tp_layers=True, out_dir=DEFAULT_OUT,
                hw: HardwareSpec = H100_SXM) -> dict:
    """Place and record one variant, write ``<out_dir>/<tag>.json`` and
    return its entry.  ``model_shards_for_analytic`` is the reference's
    parameter, which its analytic term does not read (it costs 16 model
    shards); kept so the variants' calls are the reference's."""
    del model_shards_for_analytic
    os.makedirs(out_dir, exist_ok=True)
    plan = variant_plan(arch, shape, rules_override=rules_override,
                        microbatches=microbatches)
    with make_production_mesh(multi_pod=multi_pod) as mesh:
        chips = mesh.size()
        measured = record_step(plan, mesh, compress=compress)
    mem = measured["memory"]
    entry = {
        "tag": tag, "arch": arch, "shape": shape, "status": "ok",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "microbatches": plan.microbatches, "compress": compress,
        "rules_override": [list(x) for x in plan.rules_override],
        "compile_s": round(measured["lower_s"] + measured["compile_s"], 1),
        "hlo_collective_bytes_per_iter":
            measured["hlo_collective_bytes_per_iter"],
        "hlo_collective_by_op": measured["hlo_collective_by_op"],
        "temp_gb": mem["temp_size_in_bytes"] / 1e9,
        "arg_gb": mem["argument_size_in_bytes"] / 1e9,
        **analytic_terms(tag, plan, chips, compress=compress,
                         tp_layers=tp_layers, hw=hw),
    }
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(entry, f, indent=1)
    print(f"[perf] {tag}: class={entry['class']} mfu={entry['mfu_bound']:.3f} "
          f"tc={entry['t_compute_s']:.3e} tm={entry['t_memory_s']:.3e} "
          f"tx={entry['t_collective_s']:.3e} temp={entry['temp_gb']:.1f}GB "
          f"hlo_coll/iter={entry['hlo_collective_bytes_per_iter']/1e9:.2f}GB",
          flush=True)
    return entry


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perfvariants")
    ap.add_argument("--only", default=None,
                    help="comma-separated tags (default: all seven)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    tags = args.only.split(",") if args.only else list(VARIANTS)
    unknown = sorted(set(tags) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    failed = []
    for tag in tags:
        arch, shape, kw = VARIANTS[tag]
        t0 = time.time()
        try:
            run_variant(tag, arch, shape, out_dir=args.out, **kw)
        except Exception as e:  # noqa: BLE001
            failed.append(tag)
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump({"tag": tag, "arch": arch, "shape": shape,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:],
                           "seconds": round(time.time() - t0, 1)}, f,
                          indent=1)
            print(f"[perf] {tag}: error {type(e).__name__}: {e}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
