"""The port's logical-axis sharding (``repro_torch.models.sharding``) and
its parameter axes, against the reference's (``repro.models.sharding``,
``LM.axes()``, ``LM.cache_axes()``), on device-free meshes.

- the reference's own resolution cases (``tests/test_launch.py``,
  ``TestShardingResolution``) on the port's abstract meshes;
- ``LM.axes()`` equal to the reference's leaf for leaf, its leading stack
  axes dropped, for all ten full configs;
- ``logical_to_spec`` equal to the reference's for every parameter and
  cache leaf of all ten full configs, under both rule sets, on both
  production meshes, with each cell's rule override;
- specs resolve to DTensor placements and shard shapes as the reference's
  ``NamedSharding.shard_shape`` does;
- ``constrain`` and the mesh-aware operations (``models.shard_ops``)
  give plain tensors the plain results, with or without a context.
"""

import functools

import jax
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.launch.cells import all_cells as ref_all_cells
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models import LM as RefLM
from repro.models import sharding as ref_sharding
from repro_torch import configs
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_abstract_mesh
from repro_torch.launch.specs import rules_for
from repro_torch.models import shard_ops, sharding
from repro_torch.models.convert import reference_key
from repro_torch.models.model import axes_spec, flat_spec
from repro_torch.models.sharding import (DEFAULT_RULES, INFER_RULES,
                                         logical_to_spec)

MESHES = {"16x16": False, "2x16x16": True}


def _port_mesh(name):
    return make_abstract_mesh(*PRODUCTION_SHAPES[MESHES[name]])


def _ref_mesh(name):
    return ref_abstract_mesh(*PRODUCTION_SHAPES[MESHES[name]])


def _flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = v
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """(axes, shapes) of the reference's full config, flattened, shapes
    from ``jax.eval_shape`` (nothing is allocated)."""
    lm = RefLM(ref_configs.get(arch))
    shapes = jax.eval_shape(lm.init, jax.random.PRNGKey(0))
    axes = _flat(jax.tree.map(lambda a: a, lm.axes(),
                              is_leaf=lambda x: isinstance(x, tuple)))
    return axes, {k: tuple(v.shape) for k, v in _flat(shapes).items()}


# --------------------------------------------------------------------------
# The reference's resolution cases
# --------------------------------------------------------------------------
def test_divisibility_fallbacks_16x16():
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    # qwen: 40 heads NOT divisible by 16 -> replicate that dim
    assert logical_to_spec(mesh, ("fsdp", "heads", None),
                           (5120, 40, 128)) == ("data",)
    # nemotron: 96 heads divisible
    assert logical_to_spec(mesh, ("fsdp", "heads", None),
                           (18432, 96, 192)) == ("data", "model")
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        if cfg.d_ff:
            spec = logical_to_spec(mesh, ("fsdp", "ffn"),
                                   (cfg.d_model, cfg.d_ff))
            assert spec[1] == "model", arch


def test_experts_shard_over_model():
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    spec = logical_to_spec(mesh, ("experts", "fsdp", "expert_ffn"),
                           (64, 2048, 1408))
    assert spec[0] == "model"


def test_multipod_fsdp_joins_pod_and_data():
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    spec = logical_to_spec(mesh, ("fsdp", "ffn"), (18432, 73728))
    assert spec[0] == ("pod", "data")


def test_batch_1_replicates():
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    assert logical_to_spec(mesh, ("batch", None), (1, 1)) == ()


def test_rules_tables_equal_the_references():
    assert DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    assert INFER_RULES == ref_sharding.INFER_RULES


# --------------------------------------------------------------------------
# Axes and specs of every leaf of the ten full configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_lm_axes_equal_the_references_without_stack_axes(arch):
    ref_axes, ref_shapes = _ref_params(arch)
    cfg = configs.get(arch)
    port_axes = _flat(axes_spec(cfg))
    shapes = {n: s.shape for n, s in flat_spec(cfg).items()}
    assert set(port_axes) == set(shapes)
    seen = set()
    for name, axes in port_axes.items():
        key, idx = reference_key(name)
        seen.add(key)
        assert ref_axes[key][:len(idx)] == ("layers",) * len(idx), name
        assert axes == ref_axes[key][len(idx):], name
        assert shapes[name] == ref_shapes[key][len(idx):], name
    assert seen == set(ref_axes)


def _cases():
    out = []
    for plan in ref_all_cells():
        for mesh in MESHES:
            out.append((plan.arch, plan.shape.name, mesh))
    return out


@pytest.mark.parametrize("arch,shape,mesh", _cases())
def test_param_and_cache_specs_equal_the_references(arch, shape, mesh):
    """Each cell's parameters and (serving) caches under its rules, on
    the port's and the reference's abstract production meshes."""
    from repro.launch.cells import plan_for as ref_plan_for
    from repro.launch.specs import rules_for as ref_rules_for
    from repro_torch.capture.zoo import meta_lm

    plan = ref_plan_for(arch, shape)
    ref_rules = ref_rules_for(plan.kind, dict(plan.rules_override))
    rules = rules_for(plan.kind, dict(plan.rules_override))
    assert rules == ref_rules
    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    ref_axes, ref_shapes = _ref_params(arch)
    for name, axes in _flat(axes_spec(configs.get(arch))).items():
        key, idx = reference_key(name)
        ref = tuple(ref_sharding.logical_to_spec(
            rm, ref_axes[key], ref_shapes[key], ref_rules))
        port = logical_to_spec(pm, axes, ref_shapes[key][len(idx):], rules)
        assert ref[:len(idx)] == (None,) * min(len(idx), len(ref)), name
        assert port == ref[len(idx):], (name, port, ref)
    if plan.kind == "train":
        return
    b, s = plan.shape.global_batch, plan.shape.seq_len
    cfg = plan.cfg
    extra = cfg.n_img_tokens if cfg.family == "vlm" else 0
    max_len = s + extra + 1 if plan.kind == "prefill" else s
    ref_lm = RefLM(cfg)
    ref_cache = jax.eval_shape(lambda: ref_lm.init_cache(b, max_len))
    lm = meta_lm(configs.get(arch), smoke=False)
    cache = _flat(lm.init_cache(b, max_len, device="meta"))
    cache_axes = _flat(lm.cache_axes())
    ref_flat = _flat(ref_cache)
    ref_cax = _flat(jax.tree.map(lambda a: a, ref_lm.cache_axes(),
                                 is_leaf=lambda x: isinstance(x, tuple)))
    assert set(cache) == set(ref_flat) == set(cache_axes) == set(ref_cax)
    for name, t in cache.items():
        assert tuple(t.shape) == tuple(ref_flat[name].shape), name
        assert t.dtype == getattr(torch, str(ref_flat[name].dtype)), name
        assert cache_axes[name] == ref_cax[name], name
        ref = tuple(ref_sharding.logical_to_spec(
            rm, ref_cax[name], ref_flat[name].shape, ref_rules))
        assert logical_to_spec(pm, cache_axes[name], tuple(t.shape),
                               rules) == ref, name


# --------------------------------------------------------------------------
# Placements and shard shapes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("spec,shape", [
    ((), (7, 3)),
    (("data",), (64, 5)),
    ((None, "model"), (3, 32)),
    ((("pod", "data"), "model"), (64, 32)),
    (("model", None, "data"), (16, 2, 32)),
])
def test_shard_shape_and_placements_follow_the_spec(mesh, spec, shape):
    from torch.distributed.tensor import Replicate, Shard

    pm, rm = _port_mesh(mesh), _ref_mesh(mesh)
    names = list(pm.shape)
    spec = tuple(tuple(a for a in e if a in names) or None
                 if isinstance(e, tuple) else (e if e in names or e is None
                                                else None) for e in spec)
    spec = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)
    ns = sharding.NamedSharding(pm, spec)
    assert ns.shard_shape(shape) == tuple(
        JaxNamedSharding(rm, P(*spec)).shard_shape(shape))
    want = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else e or ()):
            want[names.index(a)] = Shard(d)
    assert ns.placements == tuple(want)


def test_placements_refuse_an_order_dtensor_cannot_shard():
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(mesh, (("data", "pod"),))


# --------------------------------------------------------------------------
# Plain tensors pass through
# --------------------------------------------------------------------------
def test_constrain_and_helpers_leave_plain_tensors_alone():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 8, generator=g)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    for ctx in (None, mesh):
        with (sharding.activate(ctx) if ctx is not None
              else torch.no_grad()):
            assert sharding.constrain(x, "batch", "seq_residual", None) is x
            table = torch.randn(10, 8, generator=g)
            idx = torch.tensor([[1, 9], [0, 3]])
            assert torch.equal(shard_ops.take_rows(table, idx), table[idx])
            logits = torch.randn(5, 10, generator=g)
            lab = torch.tensor([1, 0, 9, 4, 4])
            assert torch.equal(shard_ops.take_last(logits, lab),
                               torch.gather(logits, -1, lab[:, None])[:, 0])
            assert torch.equal(shard_ops.logsumexp_last(logits),
                               torch.logsumexp(logits, -1))
            buf = torch.zeros(2, 5, 3)
            shard_ops.write_rows(buf, torch.arange(2), torch.tensor([4, 1]),
                                torch.ones(2, 3))
            assert buf[0, 4].sum() == 3 and buf[1, 1].sum() == 3
            assert buf.sum() == 6
            shard_ops.write_block(buf, torch.full((2, 2, 3), 2.0))
            assert torch.equal(buf[:, :2], torch.full((2, 2, 3), 2.0))
    assert sharding.active() is None
