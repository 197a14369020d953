"""Logical-axis sharding: MaxText-style logical -> physical resolution, on
DTensor (the port of ``repro.models.sharding``).

Every parameter and activation carries a tuple of *logical* axis names;
:func:`logical_to_spec` maps them to mesh axes through a rules table,
dropping any mapping whose dimension is not divisible by the mesh-axis size
(e.g. 40 attention heads cannot split across a 16-way model axis — the
resolver falls back to replication for that dimension instead of failing,
which is what lets one rules table serve all ten architectures).

Default rules implement: batch data-parallel over ("pod", "data"), tensor
parallel over "model" (heads / ffn / vocab / experts), FSDP weight sharding
over ("pod", "data") on the embed dimension.

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
tensor dimension, each ``None``, a mesh-axis name or a tuple of them,
trailing ``None``s trimmed.  :func:`placements` turns it into DTensor
placements, ``Shard(d)`` on every mesh dimension named for tensor
dimension d; DTensor shards over several mesh dimensions in mesh order,
which is jax's major-to-minor order for ``P(("pod", "data"))``.  A mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` or the planning mesh of
``repro_torch.launch.mesh.make_abstract_mesh``: anything with axis names
and sizes.

:func:`constrain` is the port's ``with_sharding_constraint``: with a
``(mesh, rules)`` context active (:func:`activate`) it redistributes a
DTensor to the spec; on a plain tensor, or with no context active, it
returns its input unchanged, so the single-device path gains nothing but a
thread-local check.  The model's other mesh-aware operations are in
``repro_torch.models.shard_ops``.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from collections.abc import Mapping
from typing import Any, Sequence

import torch

__all__ = [
    "DEFAULT_RULES",
    "INFER_RULES",
    "logical_to_spec",
    "placements",
    "shard_shape",
    "named_sharding",
    "NamedSharding",
    "tree_shardings",
    "activate",
    "active",
    "carried",
    "suspended",
    "constrain",
    "is_dtensor",
    "mesh_axes",
    "Axes",
    "Spec",
]

Axes = tuple[str | None, ...]
Spec = tuple[Any, ...]

# logical axis -> mesh axis (or tuple of mesh axes) or None (replicate)
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),     # flattened batch*seq (MoE routing)
    "seq": None,
    "embed": None,
    "fsdp": ("pod", "data"),       # weight sharding over the data axes
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",                # fused head*dim projection columns
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "kv_lora": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,
    "conv": None,
    # Sequence parallelism on the inter-layer residual stream (Megatron-SP):
    # the saved activations between layers shard over the model axis on
    # the sequence dim; sharding propagation inserts the all-gather at the
    # q/k/v projections and the reduce-scatter after the output
    # projections.
    "seq_residual": "model",
}

# Inference: weights stay resident, sharded over the model axis only — no
# per-step FSDP all-gather.  KV caches shard their *length* dimension over
# the model axis (flash-decode style: each chip attends over its cache
# shard and the softmax statistics are reduced across it) — this is what
# lets 32k-context x large-batch caches fit HBM even when kv_heads < model
# shards.
INFER_RULES: dict[str, Any] = dict(DEFAULT_RULES, fsdp=None,
                                   cache_len="model")
# Training/prefill never shard cache length (written in one shot).
DEFAULT_RULES["cache_len"] = None


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or an abstract mesh."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _mesh_axes_size(axes_of: dict[str, int], axes: Any) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= axes_of.get(a, 1)
    return size


def logical_to_spec(
    mesh,
    logical: Sequence[str | None],
    shape: Sequence[int] | None = None,
    rules: dict[str, Any] | None = None,
) -> Spec:
    """Resolve logical axes to a spec (the reference's PartitionSpec as a
    tuple), enforcing divisibility."""
    rules = rules or DEFAULT_RULES
    axes_of = mesh_axes(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for i, name in enumerate(logical):
        target = rules.get(name) if name else None
        if target is None:
            out.append(None)
            continue
        targets = (target,) if isinstance(target, str) else tuple(target)
        # Drop mesh axes that are absent/trivial in this mesh or already used.
        targets = tuple(t for t in targets
                        if axes_of.get(t, 1) > 1 and t not in used)
        if not targets:
            out.append(None)
            continue
        size = _mesh_axes_size(axes_of, targets)
        if shape is not None and shape[i] % size != 0:
            # Try a shrinking prefix of the target axes.
            while targets and shape[i] % _mesh_axes_size(axes_of, targets) != 0:
                targets = targets[:-1]
            if not targets:
                out.append(None)
                continue
        used.update(targets)
        out.append(targets[0] if len(targets) == 1 else targets)
    # Trim trailing Nones for tidiness.
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that spec entry d names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}; DTensor cannot shard so")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def shard_shape(mesh, spec: Spec, shape: Sequence[int]) -> tuple[int, ...]:
    """The local shard's shape of a ``shape`` tensor laid out by
    ``spec``: each dimension over the product of its mesh axes' sizes."""
    axes_of = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _mesh_axes_size(axes_of, _entry_axes(entry) or None)
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {entry!r} ({n})")
        out[d] //= n
    return tuple(out)


class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``, with
    its ``shard_shape`` and the DTensor ``placements`` it resolves to."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return shard_shape(self.mesh, self.spec, shape)

    def __repr__(self) -> str:
        return f"NamedSharding(spec={self.spec})"


def named_sharding(
    mesh,
    logical: Sequence[str | None],
    shape: Sequence[int] | None = None,
    rules: dict[str, Any] | None = None,
) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(mesh, logical, shape, rules))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(
    mesh,
    tree_struct: Any,
    logical_tree: Any,
    rules: dict[str, Any] | None = None,
) -> Any:
    """Map a tree (nested dicts, lists) of logical-axes tuples and a
    matching tree of tensors (or anything with ``.shape``, or shape
    tuples) to :class:`NamedSharding`\\ s."""
    if _is_axes(logical_tree):
        shape = getattr(tree_struct, "shape", tree_struct)
        return named_sharding(mesh, logical_tree, tuple(shape), rules)
    if isinstance(logical_tree, Mapping):
        if set(logical_tree) != set(tree_struct):
            raise KeyError(f"axes {sorted(logical_tree)} do not match the "
                           f"tree's {sorted(tree_struct)}")
        return {k: tree_shardings(mesh, tree_struct[k], v, rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        if len(logical_tree) != len(tree_struct):
            raise ValueError("axes and tree differ in length")
        return [tree_shardings(mesh, t, a, rules)
                for t, a in zip(tree_struct, logical_tree)]
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


# --------------------------------------------------------------------------
# Run-time sharding constraints.  Model code calls ``constrain(x, "tokens",
# None)``; it is a no-op unless a (mesh, rules) context is active and ``x``
# is a DTensor.
# --------------------------------------------------------------------------
_TLS = threading.local()


@contextlib.contextmanager
def activate(mesh, rules: dict[str, Any] | None = None):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _TLS.ctx = prev


def active():
    """The active ``(mesh, rules)``, or None."""
    return getattr(_TLS, "ctx", None)


def carried(fn):
    """``fn`` itself with no context active; else ``fn`` that runs under
    this context wherever it is called: a recomputation in the backward
    pass, on autograd's thread."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return fn

    def under(*args):
        with activate(*ctx):
            return fn(*args)
    return under


def is_dtensor(x) -> bool:
    """True for a DTensor.  None exists before ``torch.distributed.tensor``
    is imported, so the plain path never imports it: one lookup, then one
    ``isinstance`` once it is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    want = placements(mesh, logical_to_spec(mesh, logical, x.shape, rules))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def suspended():
    """No context active inside the block (each rank's own shard)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = None
    try:
        yield
    finally:
        _TLS.ctx = prev
