"""The placed step over four ranks (gloo, a 2x2 ("data", "model") mesh,
one process a rank) against the plain LM on the gathered parameters, in
float32: the mesh-aware pieces the one-rank tests cannot reach — each
rank's own expert slots and their partial sums (MoE), cache rows written
into each rank's shard of a length-sharded cache, the vocab-parallel
embedding, head and loss, the scan and the attention loop run on each
rank's shard.  Decode and prefill logits (and the cache they write) within
1e-5 of the rms.  A train step's loss and gradient norm, and every leaf of
its AdamW moments (the first holds the leaf's clipped gradient) and of the
parameters it updated: each element within 1e-5 of its leaf's rms plus 16
float32 ulps of itself (the moments' own rounding).  The train cells
compute in float64 and keep their gradients and moments in float32 here:
in float32 the mesh's and the plain LM's sums, in another order, part by
up to 1e-4 of a moment's rms, and the step's default bf16 gradients round
those parts up to 2^-8.  The SSM family's cells compute in float64 too:
in float32 the first layer's gated norm and output projection sum over
the sharded inner width, which leaves 2.5e-6 of the rms between the two
runs' x entering the second layer's scan, and the states the scan writes
from those two inputs part by 1.2e-5 of their rms in exact arithmetic,
before float32 rounds either scan."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r'''
import json, os, sys, tempfile, warnings
warnings.simplefilter("ignore")
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, path, cells, out):
    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.launch.cells import CellPlan
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import build_cell, plain_lm
    from repro_torch.models.config import SHAPES, ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.train import AdamWConfig
    from repro_torch.train import build_train_step as train_step_of

    def build_train_step(*a, **kw):
        return train_step_of(*a, grad_dtype="float32", **kw)

    specs.build_train_step = build_train_step

    dist.init_process_group("gloo", rank=rank, world_size=4,
                            init_method=f"file://{path}")

    def full(x):
        if isinstance(x, dict):
            return {k: full(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(full(v) for v in x)
        return x.full_tensor() if isinstance(x, DTensor) else x

    def clone(x):
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        return x.clone()

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from leaves(v)
        elif isinstance(x, torch.Tensor):
            yield x

    res = {}
    for arch, shape in cells:
        kind = SHAPES[shape].kind
        cfg = configs.get_smoke(arch)
        wide = kind == "train" or cfg.family == "ssm"
        cfg = cfg.replace(dtype="float64" if wide else "float32")
        plan = CellPlan(arch=arch, shape=ShapeSpec("t", 64, 4, kind),
                        cfg=cfg, kind=kind,
                        microbatches=2 if kind == "train" else 1)
        opt_cfg = AdamWConfig(state_dtype="float32")
        with make_local_mesh(model_axis=2, device="cpu") as mesh:
            fn, args, *_ = build_cell(plan, mesh, opt_cfg=opt_cfg)
            plain = clone(full(args))
            got = full(fn(*args))
            if kind == "train":
                # the parameters the step updated in place
                got = (full(args[0]),) + tuple(got)
            if rank == 0:
                lm = plain_lm(cfg, plain[0], "cpu")
                if kind == "decode":
                    want = lm.decode_step(*plain[1:])
                elif kind == "prefill":
                    want = lm.prefill(plain[1]["tokens"], plain[2])
                else:
                    step = build_train_step(lm, opt_cfg,
                                            microbatches=plan.microbatches)
                    # the plain LM updates plain[0] in place
                    want = (plain[0],) + tuple(step(*plain[1:]))
                    assert list(got[0]) == list(want[0])
                errs = []
                assert len(list(leaves(got))) == len(list(leaves(want)))
                for g, w in zip(leaves(got), leaves(want)):
                    g, w = g.double(), w.double()
                    rms = w.pow(2).mean().sqrt()
                    ulps = 16 * 2.0 ** -24 * w.abs() if kind == "train" \
                        else 0
                    errs.append(float(((g - w).abs() - ulps).clamp(min=0)
                                      .max() / (rms + 1e-30)))
                res[f"{arch}:{shape}"] = errs
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    cells = [tuple(c.split(":")) for c in sys.argv[1].split(",")]
    tmp = tempfile.mkdtemp()
    mp.spawn(rank_main, args=(os.path.join(tmp, "store"), cells,
                              sys.argv[2]), nprocs=4)
'''

CELLS = ("deepseek-moe-16b:decode_32k", "deepseek-moe-16b:prefill_32k",
         "deepseek-moe-16b:train_4k",
         "mamba2-780m:prefill_32k", "mamba2-780m:train_4k")


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    out = tmp_path_factory.mktemp("multirank") / "errs.json"
    script = out.parent / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(script), ",".join(CELLS),
                          str(out)], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_four_rank_step_equals_the_plain_lm(errors, cell):
    errs = errors[cell]
    assert errs and max(errs) <= 1e-5, errs
