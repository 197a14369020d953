"""``launch.specs.build_cell`` on a local mesh: on a one-rank gloo mesh
(``launch.mesh.make_local_mesh(device="cpu")``) a cell's step over
DTensors equals the same step of a plain ``LM`` on the same parameters,
bit for bit (the logits, the caches it writes, and a train step's
parameters, moments and metrics); the meshes' process groups live only
inside their blocks."""

import warnings

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.launch.cells import CellPlan
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.specs import build_cell, plain_lm
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.train import AdamWConfig, build_train_step


def _local(x):
    if isinstance(x, dict):
        return {k: _local(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_local(v) for v in x)
    return x.to_local() if isinstance(x, DTensor) else x


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x.clone()


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, torch.Tensor):
        yield x


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-780m", "decode_32k"), ("qwen2.5-14b", "prefill_32k"),
    ("deepseek-moe-16b", "decode_32k"), ("zamba2-7b", "prefill_32k"),
    ("qwen2.5-14b", "train_4k"),
])
def test_one_rank_step_equals_the_plain_lm(arch, shape):
    check_one_rank_step(arch, shape)


def check_one_rank_step(arch, shape):
    kind = SHAPES[shape].kind
    cfg = configs.get_smoke(arch)
    plan = CellPlan(arch=arch, shape=ShapeSpec("t", 64, 4, kind), cfg=cfg,
                    microbatches=2 if kind == "train" else 1, kind=kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_local_mesh(device="cpu") as mesh:
            assert dist.get_world_size() == 1
            fn, args, _, donate, _ = build_cell(plan, mesh)
            plain_args = _clone(_local(args))
            lm = plain_lm(cfg, plain_args[0], "cpu")
            if kind == "decode":
                want = lm.decode_step(*plain_args[1:])
            elif kind == "prefill":
                want = lm.prefill(plain_args[1]["tokens"], plain_args[2])
            else:
                step = build_train_step(lm, AdamWConfig(),
                                        microbatches=plan.microbatches)
                want = (step(*plain_args[1:]), dict(lm.named_parameters()))
            got = fn(*args)
            if kind == "train":
                got = (got, args[0])
            got = list(_leaves(_local(got)))
            want = list(_leaves(want))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # serving cells carry the compute dtype's weights, training float32
    dt = torch.float32 if kind == "train" else torch.bfloat16
    assert all(p.dtype == dt for p in args[0].values())


def test_a_mesh_refuses_to_replace_a_group():
    with make_local_mesh(device="cpu"):
        with pytest.raises(RuntimeError, match="already initialized"):
            with make_production_mesh():
                pass
        assert dist.get_world_size() == 1
    with make_production_mesh(multi_pod=True) as mesh:
        assert mesh.size() == 512 and mesh.mesh_dim_names == (
            "pod", "data", "model")
        assert dist.get_backend() == "fake"


def test_a_card_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        with make_local_mesh():
            pass
