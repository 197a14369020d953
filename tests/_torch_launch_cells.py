"""Shared by ``tests/test_torch_launch_cells*.py``:
``launch.specs.build_cell`` on a production mesh, held leaf for leaf
against the reference's sharding: every parameter, optimizer-state,
cache and batch leaf of all 32 cells is a ``meta`` DTensor whose local
shard shape equals ``jax.sharding.NamedSharding(reference abstract mesh,
reference spec).shard_shape(global shape)``, the spec resolved by the
reference's ``logical_to_spec`` from the reference's own axes (its
leading stack axes dropped for the port's per-layer parameters).  The
fake process group of each mesh lives in a module fixture that destroys
it.
"""

import functools
import warnings

import jax
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.launch.cells import all_cells as ref_all_cells
from repro.launch.cells import plan_for as ref_plan_for
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.launch.specs import rules_for as ref_rules_for
from repro.models import LM as RefLM
from repro.models.sharding import logical_to_spec as ref_logical_to_spec
from repro_torch.launch.cells import plan_for
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.convert import reference_key

CELLS = [(p.arch, p.shape.name) for p in ref_all_cells()]


def _flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = v
    return out


def _is_axes(x):
    return isinstance(x, tuple)


@functools.lru_cache(maxsize=None)
def _ref_axes(arch_shape):
    """The reference's parameter axes, cache axes and shapes of a cell."""
    plan = ref_plan_for(*arch_shape)
    lm = RefLM(plan.cfg)
    axes = _flat(jax.tree.map(lambda a: a, lm.axes(), is_leaf=_is_axes))
    return axes, _flat(jax.tree.map(lambda a: a, lm.cache_axes(),
                                    is_leaf=_is_axes))


def built_cells(multi_pod):
    """{cell: [(kind, name, global shape, local shape, dtype)]}."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_production_mesh(multi_pod=multi_pod) as mesh:
            for arch, shape in CELLS:
                _, args, shardings, donate, rules = build_cell(
                    plan_for(arch, shape), mesh)
                kind = plan_for(arch, shape).kind
                groups = {"train": ("params", "opt", "batch"),
                          "prefill": ("params", "batch", "cache"),
                          "decode": ("params", "tokens", "cache", "pos")}
                leaves = []
                for group, tree in zip(groups[kind], args):
                    flat = _flat(tree) if isinstance(tree, dict) \
                        else {"": tree}
                    for name, t in flat.items():
                        leaves.append((group, name, tuple(t.shape),
                                       tuple(t.to_local().shape),
                                       t.to_local().device.type, donate))
                out[(arch, shape)] = leaves
                del args
    assert not dist.is_initialized()
    return out


def _ref_spec(arch_shape, group, name, shape, rm):
    plan = ref_plan_for(*arch_shape)
    rules = ref_rules_for(plan.kind, dict(plan.rules_override))
    p_axes, c_axes = _ref_axes(arch_shape)
    if group == "params" or group == "opt" and name.split(".")[1] in (
            "mu", "nu"):
        pname = name if group == "params" else name.split(".", 2)[2]
        key, idx = reference_key(pname)
        axes = p_axes[key][len(idx):]
    elif group == "opt":                                  # the step count
        axes = ()
    elif group == "cache":
        axes = c_axes[name]
    else:
        axes = ("batch",) + (None,) * (len(shape) - 1)
    return P(*ref_logical_to_spec(rm, axes, shape, rules))


def check_every_leaf(built):
    mesh_name, cells = built
    rm = ref_abstract_mesh(*PRODUCTION_SHAPES[mesh_name == "2x16x16"])
    assert set(cells) == set(CELLS)
    n = 0
    for cell, leaves in cells.items():
        for group, name, shape, local, device, _ in leaves:
            spec = _ref_spec(cell, group, name, shape, rm)
            want = tuple(NamedSharding(rm, spec).shard_shape(shape))
            assert local == want, (cell, group, name, shape, spec)
            assert device == "meta"
            n += 1
    assert n > 10_000


def check_donation_and_groups(built):
    _, cells = built
    for (arch, shape), leaves in cells.items():
        kind = plan_for(arch, shape).kind
        donate = leaves[0][5]
        assert donate == ((0, 1) if kind == "train" else (2,))
        groups = {g for g, *_ in leaves}
        assert ("cache" in groups) == (kind != "train")
        assert ("opt" in groups) == (kind == "train")
