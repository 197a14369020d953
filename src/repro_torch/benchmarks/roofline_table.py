"""§Roofline: the per-(arch x shape x mesh) three-term table (the port of
the reference's ``benchmarks/roofline_table.py``).

Reads the port's dry-run artifacts (``build/dryrun/*.json``, or
``$DRYRUN_DIR``; ``python -m repro_torch.launch.dryrun``).  Falls back to
computing the analytic terms directly against the H100 SXM when a cell's
artifact is missing, so ``python -m repro_torch.benchmarks.run --only
roofline`` works even without the 512-way dry run having been executed in
this checkout.
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch import configs
from repro_torch.core import analytic, hlo_analysis
from repro_torch.launch.cells import all_cells

RESULTS_DIR = os.environ.get("DRYRUN_DIR", "build/dryrun")

HEADER = ("arch", "shape", "mesh", "t_compute_s", "t_memory_s",
          "t_collective_s", "dominant", "class", "mfu_bound",
          "useful_ratio", "roofline_fraction")


def _from_artifacts(results_dir: str) -> dict[tuple, dict]:
    out = {}
    for f in glob.glob(os.path.join(results_dir, "*.json")):
        if "_skips" in f:
            continue
        with open(f) as fh:
            d = json.load(fh)
        if d.get("status") == "ok":
            out[(d["arch"], d["shape"], d["mesh"])] = d
    return out


def _analytic_entry(plan, mesh_name: str, hw) -> dict:
    chips = 512 if mesh_name == "2x16x16" else 256
    model_shards = 16
    data_shards = chips // model_shards
    c = analytic.cell_cost(plan.cfg, plan.shape, kind=plan.kind,
                           microbatches=plan.microbatches,
                           data_shards=data_shards,
                           model_shards=model_shards,
                           infer_fsdp=plan.infer_fsdp)
    tokens = plan.shape.global_batch * (
        plan.shape.seq_len if plan.kind != "decode" else 1)
    rt = hlo_analysis.RooflineTerms(
        name=f"{plan.name}@{mesh_name}", chips=chips,
        hlo_flops=c.flops, hlo_bytes=c.hbm_bytes,
        collective_bytes=c.collective_bytes,
        model_flops=plan.cfg.model_flops(tokens,
                                         training=plan.kind == "train"),
        hw=hw)
    return {"arch": plan.arch, "shape": plan.shape.name, "mesh": mesh_name,
            **rt.summary()}


def rows(*, results_dir: str | None = None, hw=hlo_analysis.H100_SXM):
    """(rows, HEADER): one row a cell and mesh, from its artifact in
    ``results_dir`` (default :data:`RESULTS_DIR`) or the analytic terms
    against ``hw``, then the ``long_500k`` skips."""
    arts = _from_artifacts(RESULTS_DIR if results_dir is None
                           else results_dir)
    out = []
    for plan in all_cells():
        for mesh_name in ("16x16", "2x16x16"):
            d = arts.get((plan.arch, plan.shape.name, mesh_name))
            if d is None:
                d = _analytic_entry(plan, mesh_name, hw)
            out.append((d["arch"], d["shape"], d["mesh"],
                        f"{d['t_compute_s']:.3e}", f"{d['t_memory_s']:.3e}",
                        f"{d['t_collective_s']:.3e}", d["dominant"],
                        d["class"], round(d["mfu_bound"], 3),
                        round(d.get("useful_compute_ratio", 0.0), 3),
                        round(d.get("roofline_fraction", 0.0), 3)))
    # assignment-mandated skips, for table completeness
    for arch in configs.ARCHS:
        if "long_500k" not in configs.shapes_for(arch):
            out.append((arch, "long_500k", "-", "-", "-", "-", "-",
                        "skipped (full attention)", "-", "-", "-"))
    return out, HEADER
