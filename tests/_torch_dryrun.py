"""The mini dry run shared by ``tests/test_torch_dryrun_*.py``: the
reference's ``TestMiniDryrun`` cells (``tests/test_launch.py``) —
smoke configs x ``train_4k`` (two microbatches) and ``decode_32k`` at
``ShapeSpec("t", 64, 4)`` — each placed by ``build_cell`` on a fake 2x2
("data", "model") mesh and stepped once under the dry run's recorder, in
a child process (the fake process group lives and dies there).  Each
cell's entry comes back with the sum of its argument leaves' local shard
bytes as the child computes them from the abstract mesh, independently
of the DTensors, and whether a group was left up."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "decode_32k")

_CHILD = r'''
import json, sys, warnings
warnings.simplefilter("ignore")
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.launch.cells import CellPlan
from repro_torch.launch.dryrun import record_step
from repro_torch.launch.mesh import fake_mesh, make_abstract_mesh
from repro_torch.launch.specs import flat_axes, input_specs, rules_for
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.model import LM, flat_spec
from repro_torch.models.sharding import logical_to_spec, shard_shape
from repro_torch.capture.zoo import meta_lm

AXES = ("data", "model")
abstract = make_abstract_mesh((2, 2), AXES)


def local(logical, shape, itemsize, rules):
    n = itemsize
    for d in shard_shape(abstract, logical_to_spec(abstract, logical, shape,
                                                   rules), shape):
        n *= d
    return n


def expected(plan):
    cfg, rules = plan.cfg, rules_for(plan.kind)
    axes = flat_axes(meta_lm(cfg).axes())
    pdt = 4 if plan.kind == "train" else 2
    total = sum(local(axes[n], i.shape, pdt, rules)
                for n, i in flat_spec(cfg).items())
    if plan.kind == "train":
        total += 2 * sum(local(axes[n], i.shape, 2, rules)
                         for n, i in flat_spec(cfg).items()) + 4
    for v in input_specs(plan).values():
        total += local(("batch",) + (None,) * (len(v.shape) - 1), v.shape,
                       v.dtype.itemsize, rules)
    if plan.kind == "decode":
        lm = meta_lm(cfg)
        cache = lm.init_cache(plan.shape.global_batch, plan.shape.seq_len,
                              device="meta")

        def walk(c, a):
            if isinstance(c, dict):
                return sum(walk(c[k], a[k]) for k in c)
            return local(a, tuple(c.shape), c.element_size(), rules)
        total += walk(cache, lm.cache_axes())
    return total


out = {}
for arch in sys.argv[1].split(","):
    for shape in sys.argv[2].split(","):
        kind = SHAPES[shape].kind
        plan = CellPlan(arch=arch, shape=ShapeSpec("t", 64, 4, kind),
                        cfg=configs.get_smoke(arch), kind=kind,
                        microbatches=2 if kind == "train" else 1)
        with fake_mesh((2, 2), AXES) as mesh:
            entry = record_step(plan, mesh)
        entry["expected_arg_bytes"] = expected(plan)
        entry["group_left"] = dist.is_initialized()
        out[f"{arch}:{shape}"] = entry
print(json.dumps(out))
'''


def mini_dryrun(archs: tuple[str, ...]) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", _CHILD, ",".join(archs), ",".join(SHAPES)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def check_entry(entry: dict, kind: str) -> None:
    """``ok``, exact argument bytes, non-zero collectives, FLOPs and
    bytes, an output, and no group left behind."""
    assert not entry["group_left"]
    mem = entry["memory"]
    assert mem["argument_size_in_bytes"] == entry["expected_arg_bytes"]
    assert mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert entry["hlo_collective_bytes_per_iter"] > 0
    assert entry["hlo_collective_bytes_per_iter"] == sum(
        entry["hlo_collective_by_op"].values())
    assert set(entry["hlo_collective_by_op"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert entry["hlo_cost_analysis"]["flops"] > 0
    assert entry["hlo_cost_analysis"]["bytes accessed"] > 0
    assert entry["hlo_ops"] > 0
    if kind == "train":
        # the parameters (updated in place) are among the outputs
        assert mem["output_size_in_bytes"] > mem["argument_size_in_bytes"] / 3
